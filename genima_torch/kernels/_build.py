"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at the repository root, at
its first use, then loaded with ``ctypes``. The file name carries a hash of
the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing here runs at import time: a CPU-only host without
``nvcc`` imports every kernel module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # compiler output (ptxas register/smem report)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    # the source, the shared headers it may include, and the flags
    src = b"".join(
        path.read_bytes()
        for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    )
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{build_logs[name]}")
    out.with_suffix(".log").write_text(build_logs[name])
    os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """The compiler output of ``csrc/<name>.cu``'s current library, from this
    process's build or, for a library built earlier, from the log kept
    beside it."""
    if name not in build_logs:
        log = library_path(name).with_suffix(".log")
        build_logs[name] = log.read_text() if log.exists() else ""
    return build_logs[name]


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then ``ctypes``-load the library (once per process)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def build_all(names) -> None:
    """Compile several sources at once, one ``nvcc`` process each."""
    pending = [n for n in names if not library_path(n).exists()]
    threads = [threading.Thread(target=build, args=(n,)) for n in pending]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for n in pending:  # surface a failed build with its log
        build(n)
