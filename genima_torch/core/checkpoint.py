"""Checkpoints in the reference's on-disk contracts, without flax or msgpack.

Counterpart of ``genima_tpu/core/checkpoint.py``. Parameter trees are files
in flax's msgpack format (``flax.serialization.to_bytes`` /
``msgpack_restore``), read and written here by a small codec of the port's
own on ``struct`` and ``memoryview``:

- maps, arrays, str, bin, int, float, bool and nil;
- ext type 1, an ndarray packed as ``(shape, dtype name, raw C-order
  bytes)``, and ext type 3, a numpy scalar packed the same way;
- lists and tuples stored as ``{"0": ...}`` maps (what flax's state dicts
  make of them, and what ``msgpack_restore`` hands back);
- flax's chunked arrays (``__msgpack_chunked_array__``) above
  ``MAX_CHUNK_SIZE`` bytes;
- dtype ``bfloat16``: numpy has none without ``ml_dtypes``, so such a leaf
  decodes straight into a ``torch.bfloat16`` tensor (and a bf16 tensor
  writes as one). Every other leaf is a numpy array viewing the file's
  buffer, with no per-element Python.

Two contracts sit on top:

1. Diffusion trainers: ``checkpoint-<step>/`` directories holding the
   trained submodel in its own subdirectory (``controlnet/params.msgpack``),
   ``train_state.msgpack`` and ``metadata.json``, pruned to a retention
   limit *before* each save; a final model directory at the output root;
   ``find_model_checkpoint`` to pick one. ``AsyncCheckpointer`` copies the
   trees at ``submit`` and writes them on one background thread.
2. The controller trainer: ``latest.ckpt`` rotated to ``<epoch>.ckpt``
   and pruned to ``num_checkpoints`` (``save_epoch_checkpoint``), each
   holding ``epoch``, ``num_iters``, the ``agent`` tree and the train
   config as UTF-8 JSON bytes (``config_json``); eval picks latest / last /
   last_three / an epoch (``select_eval_checkpoints``).
"""

from __future__ import annotations

import json
import re
import shutil
import struct
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from genima_torch.core.distributed import is_main_process

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return struct.pack("B", x)
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for limit, code, fmt in ((2**8, 0xCC, ">B"), (2**16, 0xCD, ">H"),
                                 (2**32, 0xCE, ">I"), (2**64, 0xCF, ">Q")):
            if x < limit:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for limit, code, fmt in ((2**7, 0xD0, ">b"), (2**15, 0xD1, ">h"),
                                 (2**31, 0xD2, ">i"), (2**63, 0xD3, ">q")):
            if x >= -limit:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit msgpack")


def _sized(n: int, fix: tuple[int, int] | None, codes: tuple[int, int, int]) -> bytes:
    """A length header: the fix form below ``fix[1]``, else 8/16/32-bit."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for limit, code, fmt in zip((2**8, 2**16, 2**32), codes, (">B", ">H", ">I")):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, (0xC4, 0xC5, 0xC6))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), (None, 0xDE, 0xDF))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), (None, 0xDC, 0xDD))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _sized(n, None, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _leaf_bytes(x) -> tuple[tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), _BF16, memoryview(t.view(torch.int16).numpy()).cast("B")
        x = t.numpy()
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # (np.ascontiguousarray would make 0-d arrays 1-d)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be serialized")
    return arr.shape, arr.dtype.name, memoryview(arr).cast("B") if arr.size else memoryview(b"")


def _ndarray_ext(x, code: int, out: list) -> None:
    shape, name, data = _leaf_bytes(x)
    inner = (_array_header(3) + _array_header(len(shape)) + b"".join(map(_int, shape))
             + _str(name) + _bin_header(data.nbytes))
    out += [_ext_header(code, len(inner) + data.nbytes), inner, data]


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat array cut into MAX_CHUNK_SIZE-byte pieces."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": dict(enumerate(x.shape)), "chunks": dict(enumerate(chunks))}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _encode(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        out.append(_str(obj))
    elif isinstance(obj, (bytes, bytearray)):
        out += [_bin_header(len(obj)), bytes(obj)]
    elif isinstance(obj, (list, tuple)):
        _encode(dict(enumerate(obj)), out)
    elif isinstance(obj, dict):
        out.append(_map_header(len(obj)))
        for k, v in obj.items():
            out.append(_str(str(k)))
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _encode(v, out)
    elif isinstance(obj, np.generic):
        _ndarray_ext(np.asarray(obj), _EXT_NPSCALAR, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _ndarray_ext(obj, _EXT_NDARRAY, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def save_pytree(tree: Any, path: str | Path) -> None:
    """Write a tree of dicts, lists, scalars and arrays in flax's msgpack
    format, atomically (tempfile + rename), streaming each array's buffer to
    the file without joining them in memory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out: list = []
    _encode(tree, out)
    with tempfile.NamedTemporaryFile(dir=path.parent, delete=False) as tmp:
        for piece in out:
            tmp.write(piece)
        tmp_path = tmp.name
    Path(tmp_path).replace(path)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytearray | bytes):
        self.data = data
        self.view = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.view):
            raise ValueError("truncated msgpack data")
        return start

    def unpack(self, fmt: str) -> int:
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, self.view, self.take(size))[0]

    def text(self, n: int) -> str:
        start = self.take(n)
        return str(self.view[start:start + n], "utf-8")

    def blob(self, n: int) -> tuple[int, int]:
        return self.take(n), n

    def read(self) -> Any:
        b = self.view[self.take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        n = self.unpack(sizes[b]) if b in sizes else fixext.get(b)
        if n is None:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
        if b in (0xC4, 0xC5, 0xC6):
            start, n = self.blob(n)
            return bytes(self.view[start:start + n])
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(n)
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(n)
        code = self.unpack(">b")
        return self.ext(code, n)

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return _unchunk(out) if _CHUNKED in out else out

    def ext(self, code: int, n: int) -> Any:
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        # (shape, dtype name, buffer); flax reads the name raw (bytes or str)
        if self.read_header_len(0x90, 0xDC, 0xDD) != 3:
            raise ValueError("malformed ndarray ext")
        shape = tuple(self.read())
        name = self.read()
        name = name.decode() if isinstance(name, bytes) else name
        hb = self.view[self.take(1)]
        if hb not in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB) and not 0xA0 <= hb <= 0xBF:
            raise ValueError("malformed ndarray buffer")
        size = hb & 0x1F if 0xA0 <= hb <= 0xBF else self.unpack(
            {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[hb])
        start, size = self.blob(size)
        if self.pos != end:
            raise ValueError("ndarray ext length mismatch")
        arr = self.array(shape, name, start, size)
        return arr[()] if code == _EXT_NPSCALAR else arr

    def read_header_len(self, fix: int, c16: int, c32: int) -> int:
        b = self.view[self.take(1)]
        if fix <= b <= fix + 0x0F:
            return b & 0x0F
        if b == c16:
            return self.unpack(">H")
        if b == c32:
            return self.unpack(">I")
        raise ValueError(f"expected an array header, got 0x{b:02x}")

    def array(self, shape, name: str, start: int, size: int):
        if name == _BF16:
            count = size // 2
            if count == 0:
                return torch.empty(shape, dtype=torch.bfloat16)
            # copied out: a bf16 tensor must start on an even address
            buf = bytearray(self.view[start:start + size])
            return torch.frombuffer(buf, dtype=torch.bfloat16, count=count).reshape(shape)
        dtype = np.dtype(name)
        return np.frombuffer(self.data, dtype, size // dtype.itemsize, start).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def loads(data: bytes | bytearray) -> Any:
    """Decode flax msgpack bytes, as ``flax.serialization.msgpack_restore``."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_pytree(path: str | Path) -> Any:
    """Read a flax msgpack file. Array leaves view one writable buffer read
    in a single call (bf16 leaves are torch tensors)."""
    path = Path(path)
    data = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        if f.readinto(data) != len(data):
            raise OSError(f"short read of {path}")
    return loads(data)


# ---------------------------------------------------------------------------
# contract 1: step checkpoints (diffusion trainers)
# ---------------------------------------------------------------------------

_STEP_DIR_RE = re.compile(r"^checkpoint-(\d+)$")


def list_step_checkpoints(output_dir: str | Path) -> list[tuple[int, Path]]:
    """All ``checkpoint-<step>`` dirs sorted by step."""
    output_dir = Path(output_dir)
    found = []
    if output_dir.is_dir():
        for child in output_dir.iterdir():
            m = _STEP_DIR_RE.match(child.name)
            if m and child.is_dir():
                found.append((int(m.group(1)), child))
    return sorted(found)


def latest_step_checkpoint(output_dir: str | Path) -> Path | None:
    ckpts = list_step_checkpoints(output_dir)
    return ckpts[-1][1] if ckpts else None


def save_step_checkpoint(
    output_dir: str | Path,
    step: int,
    *,
    model_params: Any,
    model_subdir: str = "controlnet",
    train_state: Any | None = None,
    total_limit: int | None = None,
    extra: dict | None = None,
) -> Path:
    """Write ``checkpoint-<step>/``: ``<model_subdir>/params.msgpack``,
    ``train_state.msgpack``, each tree of ``extra`` as ``<name>.msgpack``
    (the pix2pix trainer's ``ema``) and ``metadata.json`` (``{"step":
    step}``). With ``total_limit``, the oldest step checkpoints are removed
    first, down to ``total_limit - 1``. Only the main process writes; the
    others get the path and touch nothing."""
    output_dir = Path(output_dir)
    if not is_main_process():
        return output_dir / f"checkpoint-{step}"
    if total_limit is not None:
        existing = list_step_checkpoints(output_dir)
        for _, old in existing[:max(len(existing) - (total_limit - 1), 0)]:
            shutil.rmtree(old)
    ckpt_dir = output_dir / f"checkpoint-{step}"
    save_pytree(model_params, ckpt_dir / model_subdir / "params.msgpack")
    if train_state is not None:
        save_pytree(train_state, ckpt_dir / "train_state.msgpack")
    for name, tree in (extra or {}).items():
        save_pytree(tree, ckpt_dir / f"{name}.msgpack")
    with open(ckpt_dir / "metadata.json", "w") as f:
        json.dump({"step": step}, f, indent=2)
    return ckpt_dir


def save_final_model(output_dir: str | Path, model_params: Any,
                     model_subdir: str | None = None) -> Path:
    """The final model at the output root: ``[<model_subdir>/]params.msgpack``
    (written by the main process only)."""
    output_dir = Path(output_dir)
    target = output_dir / model_subdir if model_subdir else output_dir
    if not is_main_process():
        return target
    save_pytree(model_params, target / "params.msgpack")
    return target


def snapshot(tree: Any) -> Any:
    """A copy of every tensor of ``tree`` on its own device, contiguous; the
    trainer updates its tensors in place, so an asynchronous write must be
    handed copies. The copies are queued on the current stream, before any
    later in-place update."""
    return _map_tensors(lambda t: t.detach().clone(memory_format=torch.contiguous_format), tree)


def _map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


class AsyncCheckpointer:
    """Writes checkpoints on one background thread, overlapping the next
    train steps. ``submit`` copies the trees' tensors before it returns (the
    trainer updates them in place), so the caller hands it live tensors. At
    most one write is in flight: ``submit`` first waits for the previous one
    and raises its error. Directory pruning happens inside the submitted
    function, so disk operations keep submission order. Call ``wait``
    before reading checkpoints, and ``close`` at the end.

    On the card the copy is one device-to-device copy per tensor into a
    flat device arena, queued on the submitter's stream; the writer then
    brings the arena to a pinned host arena in one copy on a stream of its
    own, after an event recorded behind the first copy, and writes from
    views of it. Both arenas live as long as the writer and grow at the
    ``submit`` that needs more. A copy into pageable memory instead holds
    the driver while it stages, and the train step's launches wait behind
    it; one copy per tensor from the writer thread contends for the GIL.

    On a rank other than the main process ``submit`` does nothing: the
    writers it runs write only there, so it takes no copy and builds no
    arena (at full width the arenas hold ~14 GB)."""

    ALIGN = 64  # bytes between two tensors' slices of the arenas

    def __init__(self) -> None:
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Future | None = None
        self._stream = None
        self._device_arena: torch.Tensor | None = None
        self._host_arena: torch.Tensor | None = None

    def submit(self, fn, /, *args, **kwargs) -> None:
        self.wait()
        if not is_main_process():
            return
        tree = (args, kwargs)
        cuda = []
        _map_tensors(lambda t: cuda.append(t) if t.is_cuda else None, tree)
        if not cuda:
            self._pending = self._executor.submit(self._write, None, 0, fn, snapshot(tree))
            return
        spans, total = {}, 0
        for t in cuda:
            spans[id(t)] = (total, t.numel() * t.element_size())
            total += -(-spans[id(t)][1] // self.ALIGN) * self.ALIGN
        if self._device_arena is None or self._device_arena.numel() < total:
            self._device_arena = self._host_arena = None
            self._device_arena = torch.empty(total, dtype=torch.uint8, device=cuda[0].device)
            self._host_arena = torch.empty(total, dtype=torch.uint8, pin_memory=True)

        def place(arena, t):
            start, n = spans[id(t)]
            return arena[start:start + n].view(t.dtype).view(t.shape) if n else None

        dst = [place(self._device_arena, t) for t in cuda if spans[id(t)][1]]
        torch._foreach_copy_(dst, [t.detach() for t in cuda if spans[id(t)][1]])
        ready = torch.cuda.Event()
        ready.record()
        host = _map_tensors(lambda t: (place(self._host_arena, t) if spans[id(t)][1]
                                       else torch.empty(t.shape, dtype=t.dtype))
                            if t.is_cuda else t.detach().clone(), tree)
        self._pending = self._executor.submit(self._write, ready, total, fn, host)

    def _write(self, ready, nbytes: int, fn, tree):
        if ready is not None:
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            self._stream.wait_event(ready)
            with torch.cuda.stream(self._stream):
                self._host_arena[:nbytes].copy_(self._device_arena[:nbytes], non_blocking=True)
            self._stream.synchronize()
        args, kwargs = tree
        return fn(*args, **kwargs)

    def wait(self) -> None:
        if self._pending is not None:
            try:
                self._pending.result()
            finally:
                self._pending = None

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._executor.shutdown(wait=True)
            self._device_arena = self._host_arena = None


def find_model_checkpoint(ckpt_path: str | Path, model_subdir: str = "controlnet") -> Path:
    """An output dir with ``checkpoint-*`` subdirs (the latest wins), one
    ``checkpoint-<step>`` dir, or a final model dir -> the directory that
    holds the submodel's ``params.msgpack``."""
    ckpt_path = Path(ckpt_path)
    latest = latest_step_checkpoint(ckpt_path)
    if latest is not None:
        ckpt_path = latest
    for candidate in (ckpt_path / model_subdir / "params.msgpack", ckpt_path / "params.msgpack"):
        if candidate.exists():
            return candidate.parent
    raise FileNotFoundError(f"No {model_subdir} checkpoint under {ckpt_path}")


# ---------------------------------------------------------------------------
# contract 2: epoch checkpoints (controller trainer)
# ---------------------------------------------------------------------------

LATEST_NAME = "latest.ckpt"
_EPOCH_CKPT_RE = re.compile(r"^(\d+)\.ckpt$")


def list_epoch_checkpoints(ckpt_dir: str | Path) -> list[tuple[int, Path]]:
    ckpt_dir = Path(ckpt_dir)
    found = []
    if ckpt_dir.is_dir():
        for child in ckpt_dir.iterdir():
            m = _EPOCH_CKPT_RE.match(child.name)
            if m:
                found.append((int(m.group(1)), child))
    return sorted(found)


def epoch_payload(epoch: int, num_iters: int, agent_params: Any,
                  config: dict | None = None) -> dict:
    """What the controller trainer writes to ``latest.ckpt``."""
    payload = {"epoch": int(epoch), "num_iters": int(num_iters), "agent": agent_params}
    if config is not None:
        payload["config_json"] = np.frombuffer(json.dumps(config).encode("utf-8"), np.uint8)
    return payload


def save_epoch_checkpoint(ckpt_dir: str | Path, *, epoch: int, num_iters: int,
                          agent_params: Any, config: dict | None = None,
                          num_checkpoints: int = 3) -> Path:
    """Rotate ``latest.ckpt`` to ``<its epoch>.ckpt``, write the new
    ``latest.ckpt`` (``epoch_payload``), then remove the oldest rotated
    files down to ``num_checkpoints``. Only the main process writes."""
    ckpt_dir = Path(ckpt_dir)
    if not is_main_process():
        return ckpt_dir / LATEST_NAME
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    latest = ckpt_dir / LATEST_NAME
    if latest.exists():
        prev_epoch = int(load_pytree(latest).get("epoch", -1))
        if prev_epoch >= 0:
            shutil.move(str(latest), str(ckpt_dir / f"{prev_epoch}.ckpt"))
    save_pytree(epoch_payload(epoch, num_iters, agent_params, config), latest)
    rotated = list_epoch_checkpoints(ckpt_dir)
    for _, old in rotated[:max(len(rotated) - num_checkpoints, 0)]:
        old.unlink()
    return latest


def load_epoch_checkpoint(path: str | Path) -> dict:
    payload = load_pytree(path)
    if "config_json" in payload:
        payload["config"] = json.loads(np.asarray(payload["config_json"]).tobytes().decode("utf-8"))
    return payload


def select_eval_checkpoints(ckpt_dir: str | Path, eval_type: str) -> list[str]:
    """``latest`` -> [latest.ckpt]; ``last`` -> the newest rotated;
    ``last_three`` -> the newest three rotated; an integer string -> that
    epoch."""
    ckpt_dir = Path(ckpt_dir)
    rotated = [p.name for _, p in list_epoch_checkpoints(ckpt_dir)]
    if eval_type == "latest":
        return [LATEST_NAME]
    if eval_type in ("last", "last_three"):
        if not rotated:
            raise FileNotFoundError(f"No rotated checkpoints in {ckpt_dir}")
        return rotated[-1:] if eval_type == "last" else rotated[-3:]
    if eval_type.isdigit():
        name = f"{int(eval_type)}.ckpt"
        if not (ckpt_dir / name).exists():
            raise FileNotFoundError(f"{name} not found in {ckpt_dir}")
        return [name]
    raise ValueError(f"Unknown eval_type: {eval_type}")
