"""Environments in child processes, for lockstep-parallel eval on real simulators.

Counterpart of ``genima_tpu/envs/subprocess_env.py``. CoppeliaSim binds one
simulator per OS process, so N lockstep episodes on the real simulator need
each environment in a process of its own. ``SubprocessEnv`` spawns a child
that builds a fully wrapped env from a picklable ``(ctor, kwargs)`` spec and
serves the surface the parallel workspace drives:

* ``reset() -> (obs, info)`` and ``step(actions)``;
* ``reset_to_demo_wrapped(idx) -> (obs, info)``: the demo restore and the
  observation's re-wrap, done inside the child, where the wrapper chain
  lives (``envs.wrappers.rewrap_obs``);
* ``initial_object_pose()`` and ``render_frame()``;
* ``observation_space`` / ``action_space``, fetched once at start-up.

The child is spawned, never forked: the parent holds a CUDA context, which
does not survive a fork. It runs the simulator and numpy only and never
initialises CUDA. Errors cross the pipe as tracebacks and re-raise in the
parent as ``RuntimeError``; the parallel workspace ends the episode on one,
as the serial harness does on a simulator failure.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback

import numpy as np


def _child_main(conn, ctor, kwargs) -> None:
    try:
        env = ctor(**kwargs)
    except Exception:
        conn.send(("err", traceback.format_exc()))
        conn.close()
        return
    conn.send(("ok", (env.observation_space, env.action_space)))
    while True:
        try:
            cmd, payload = conn.recv()
        except (EOFError, KeyboardInterrupt):
            break
        if cmd == "close":
            # leave the loop even when close() raises: the parent is about
            # to join, and a wedged simulator must not stall shutdown
            try:
                if hasattr(env, "close"):
                    env.close()
                conn.send(("ok", None))
            except Exception:
                conn.send(("err", traceback.format_exc()))
            break
        try:
            if cmd == "reset":
                res = env.reset()
            elif cmd == "step":
                res = env.step(payload)
            elif cmd == "reset_to_demo_wrapped":
                from genima_torch.envs.wrappers import rewrap_obs

                obs, info = env.reset()
                if hasattr(env.unwrapped, "reset_to_demo"):
                    _, raw = env.unwrapped.reset_to_demo(idx=payload)
                    obs = rewrap_obs(env, raw, obs)
                res = (obs, info)
            elif cmd == "initial_object_pose":
                fn = getattr(env.unwrapped, "initial_object_pose", None)
                res = fn() if callable(fn) else None
            elif cmd == "render_frame":
                from genima_torch.eval.video import frame_from_env

                res = frame_from_env(env)  # None when there is no frame
            else:
                raise ValueError(f"unknown SubprocessEnv command {cmd!r}")
            conn.send(("ok", res))
        except Exception:
            conn.send(("err", traceback.format_exc()))
    conn.close()


class SubprocessEnv:
    """The parent's proxy for a wrapped env living in a spawned child.

    ``ctor`` must be a module-level callable (pickled by reference) that
    builds and returns the wrapped env; ``kwargs`` must pickle.
    """

    def __init__(self, ctor, _defer_handshake: bool = False, **kwargs):
        self._ctor = ctor
        self._kwargs = kwargs
        self._ctor_name = getattr(ctor, "__qualname__", repr(ctor))
        self._spawn()
        if not _defer_handshake:
            self._handshake()

    def _spawn(self) -> None:
        ctx = mp.get_context("spawn")
        self._parent, child = ctx.Pipe()
        self._proc = ctx.Process(target=_child_main, args=(child, self._ctor, self._kwargs),
                                 daemon=True)
        self._proc.start()
        child.close()

    def respawn(self) -> None:
        """Tear down the (possibly dead) child and build a fresh one from the
        stored spec: a crashed simulator takes its whole process with it,
        and respawning lets the lockstep workspace keep the slot."""
        self.close()
        self._spawn()
        self._handshake()

    def _handshake(self) -> None:
        """Block until the child has built its env; ``start_subprocess_envs``
        defers this so that N start-ups overlap."""
        status, payload = self._recv("startup")
        if status == "err":
            raise RuntimeError(f"SubprocessEnv child ({self._ctor_name}) failed:\n{payload}")
        self.observation_space, self.action_space = payload

    def _recv(self, what: str):
        try:
            return self._parent.recv()
        except EOFError:
            # the child died without reaching Python's error handling (a
            # simulator abort, or an import crash while unpickling the spec)
            raise RuntimeError(
                f"SubprocessEnv child ({self._ctor_name}) died during {what} without a "
                f"traceback (exitcode {self._proc.exitcode}); see the child's stderr"
            ) from None

    def _call(self, cmd, payload=None):
        try:
            self._parent.send((cmd, payload))
        except (BrokenPipeError, ConnectionResetError, OSError):
            raise RuntimeError(
                f"SubprocessEnv child ({self._ctor_name}) is gone "
                f"(exitcode {self._proc.exitcode})") from None
        status, res = self._recv(cmd)
        if status == "err":
            raise RuntimeError(f"SubprocessEnv child error:\n{res}")
        return res

    def reset(self):
        return self._call("reset")

    def step(self, actions):
        return self._call("step", np.asarray(actions))

    def reset_to_demo_wrapped(self, idx: int):
        return self._call("reset_to_demo_wrapped", int(idx))

    def initial_object_pose(self):
        return self._call("initial_object_pose")

    def render_frame(self):
        return self._call("render_frame")

    @property
    def unwrapped(self):
        # the wrapper chain lives in the child; the proxy is its own base
        return self

    def close(self) -> None:
        """Ask the child to close its env, wait at most 10 s for it, then
        terminate it: shutdown never waits on a wedged simulator."""
        if self._proc.is_alive():
            try:
                self._parent.send(("close", None))
                if self._parent.poll(10):
                    self._parent.recv()  # its close() failing is not the parent's error
            except (OSError, EOFError):
                pass  # already gone
        self._proc.join(timeout=10)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)
        self._parent.close()


def start_subprocess_envs(ctor, n: int, **kwargs) -> list[SubprocessEnv]:
    """Spawn N children first, then collect their start-up handshakes, so
    that N simulator launches overlap."""
    envs = [SubprocessEnv(ctor, _defer_handshake=True, **kwargs) for _ in range(n)]
    try:
        for env in envs:
            env._handshake()
    except RuntimeError:
        for env in envs:
            env.close()
        raise
    return envs
