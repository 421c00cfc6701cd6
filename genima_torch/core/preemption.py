"""Preemption-safe training: notice SIGTERM, checkpoint, exit clean, resume.

Counterpart of ``genima_tpu/core/preemption.py``. A scheduler that reclaims
the machine sends SIGTERM with a grace window; the trainer then writes one
checkpoint through its ordinary retention path and stops, and the restarted
job resumes from ``latest``. The signal handler only sets a flag; the
training loop polls ``requested`` between steps. A handler installed before
is chained, so outer supervisors still see the signal.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Flag-setting signal watcher for cooperative shutdown.

    Only the main thread may install signal handlers; ``install`` elsewhere
    returns a guard that no signal sets (``request`` still does)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._prev: dict[int, object] = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Ask for the shutdown the signal asks for (the handler's body)."""
        self._event.set()

    @classmethod
    def install(cls, signals=(signal.SIGTERM,)) -> "PreemptionGuard":
        guard = cls()
        if threading.current_thread() is not threading.main_thread():
            return guard
        for sig in signals:
            prev = signal.getsignal(sig)
            guard._prev[sig] = prev

            def handler(signum, frame, _prev=prev):
                guard.request()
                if callable(_prev):
                    _prev(signum, frame)

            signal.signal(sig, handler)
        return guard

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
