"""Native (C++) host code, loaded through ctypes: the PNG decoder.

Counterpart of ``genima_tpu/native/__init__.py``. ``image_ops.cpp`` (a copy
of the JAX package's) decodes PNGs, resizes / center-crops and normalizes
them, threaded across the batch, for the diffusion data loader. It is
built with ``g++ ... -lpng -lz`` at its first use into
``build/lib_image_ops-<hash>.so`` at the repository root (the hash covers
the source and the flags), never beside the source. Where it cannot be
built or loaded (no compiler, no libpng), ``get_lib`` returns None and
``build_error`` says why; the loader then decodes with PIL and records
that it did. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lpng", "-lz", "-pthread")

_lock = threading.Lock()
_lib = None
_load_attempted = False
build_error: str | None = None  # why the library is unavailable, once tried


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib_image_ops-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *LINK_FLAGS],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees the old name or the whole file


def get_lib():
    """The loaded C library, or None when the native decoder is unavailable
    (``build_error`` says why)."""
    global _lib, _load_attempted, build_error
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
            return None
        lib.genima_decode_batch.restype = ctypes.c_int
        lib.genima_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.genima_decode_batch_u8.restype = ctypes.c_int
        lib.genima_decode_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _buffers(png_bytes: list[bytes]):
    n = len(png_bytes)
    ptrs = (ctypes.c_char_p * n)(*png_bytes)
    sizes = (ctypes.c_ulong * n)(*[len(b) for b in png_bytes])
    return ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)), sizes


def decode_png_batch(png_bytes: list[bytes], resolution: int, mode: int,
                     n_threads: int = 8) -> np.ndarray | None:
    """(N,) PNG byte strings -> (N, res, res, 3) float32 NHWC; None if the
    library is unavailable or any decode failed (the caller falls back).
    mode 0 -> [0, 1] (conditioning image); mode 1 -> [-1, 1] (target)."""
    lib = get_lib()
    if lib is None or not png_bytes:
        return None
    out = np.empty((len(png_bytes), resolution, resolution, 3), np.float32)
    failed = lib.genima_decode_batch(
        *_buffers(png_bytes), len(png_bytes), resolution, mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return None if failed else out


def decode_png_batch_u8(png_bytes: list[bytes], resolution: int,
                        n_threads: int = 8) -> np.ndarray | None:
    """uint8 variant: (N, res, res, 3) in [0, 255], not normalized (the
    trainer normalizes on the device). None -> the caller falls back."""
    lib = get_lib()
    if lib is None or not png_bytes:
        return None
    out = np.empty((len(png_bytes), resolution, resolution, 3), np.uint8)
    failed = lib.genima_decode_batch_u8(
        *_buffers(png_bytes), len(png_bytes), resolution,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return None if failed else out
