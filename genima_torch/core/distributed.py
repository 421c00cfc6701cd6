"""Multi-process distribution: process wiring, the one-writer guards, the
per-process sample striding and the gradient all-reduce.

Counterpart of ``genima_tpu/core/distributed.py`` on ``torch.distributed``.
The JAX package runs one process per host over a mesh of its devices; the
port trains with one process per GPU, PyTorch's own idiom:

    torchrun --nproc_per_node=N -m genima_torch.cli.train_controlnet_genima ...

* ``initialize()`` joins the process group named by ``RANK`` /
  ``WORLD_SIZE`` (with ``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun``
  sets them) or by explicit arguments (``init_method``, e.g. a
  ``file://`` rendezvous). ``nccl`` on CUDA, ``gloo`` on the CPU. When
  nothing names a topology it is a no-op, so every CLI calls it
  unconditionally.
* ``process_index()`` / ``process_count()`` are the rank and the world
  size, and ``is_main_process()`` guards the metric logger and the
  checkpoint writers, so N ranks write one metrics stream and one
  checkpoint tree.
* ``shard_samples()`` is the per-process striding of the host loaders.
* ``all_reduce_mean_`` turns every rank's gradients and loss into their
  mean over the group, in one ``all_reduce`` of one flat f32 buffer.
* ``force_process()`` simulates a rank so the guards can be tested without
  a process group.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as tdist

from genima_torch import resolve_device

# (index, count) installed by force_process(); None = ask torch.distributed
_FORCED: Optional[tuple[int, int]] = None


def group_active() -> bool:
    """Whether this process is in an initialized process group."""
    return tdist.is_available() and tdist.is_initialized()


def process_device(device: Any = "cuda") -> torch.device:
    """The device this process owns: ``cuda`` without an index becomes
    ``cuda:<LOCAL_RANK>`` under a launcher that sets it; anything else is
    kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and os.environ.get("LOCAL_RANK"):
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device: Any = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Idempotent ``torch.distributed.init_process_group``; returns whether
    more than one process takes part. Explicit arguments win over
    ``WORLD_SIZE`` / ``RANK`` (then ``env://``, which reads ``MASTER_ADDR``
    and ``MASTER_PORT``). With neither, nothing happens. ``backend``
    defaults to ``nccl`` when ``device`` (default: ``cuda``; raises where
    there is no card, the CPU only when named) is a card, else ``gloo``; a
    card becomes the current device.
    ``timeout_s`` bounds each collective (PyTorch's default otherwise)."""
    if group_active():
        return tdist.get_world_size() > 1
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and world_size is None:
        return False
    device = resolve_device(process_device("cuda" if device is None else device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        world_size=1 if world_size is None else world_size,
        rank=0 if rank is None else rank,
        **({"timeout": datetime.timedelta(seconds=timeout_s)} if timeout_s else {}),
    )
    return tdist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group, if any."""
    if group_active():
        tdist.destroy_process_group()


def process_index() -> int:
    if _FORCED is not None:
        return _FORCED[0]
    return tdist.get_rank() if group_active() else 0


def process_count() -> int:
    if _FORCED is not None:
        return _FORCED[1]
    return tdist.get_world_size() if group_active() else 1


def is_main_process() -> bool:
    """Exactly one process writes metrics, checkpoints and config snapshots."""
    return process_index() == 0


@contextlib.contextmanager
def force_process(index: int, count: int):
    """Simulate rank ``index`` of ``count`` for the helpers of this module;
    the real process group (if any) is untouched."""
    global _FORCED
    prev = _FORCED
    _FORCED = (index, count)
    try:
        yield
    finally:
        _FORCED = prev


def shard_samples(samples, index: Optional[int] = None, count: Optional[int] = None):
    """This process's strided slice of a host-side sample list. Every process
    must hold the same full list (same indexing and shuffle seed) for the
    slices to be disjoint and exhaustive."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return samples
    return samples[index::count]


def all_reduce_mean_(grads: dict[str, torch.Tensor], *scalars: torch.Tensor
                     ) -> tuple[torch.Tensor, ...]:
    """Replace every tensor of ``grads`` by its mean over the process group
    and return the means of ``scalars``: one ``all_reduce`` of one flat f32
    buffer (the gradients are views of it afterwards). Every rank gets the
    same bits. Without a process group, nothing changes."""
    if not group_active():
        return scalars
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1).float() for k in names]
                     + [s.detach().float().reshape(1) for s in scalars])
    tdist.all_reduce(flat)
    flat /= tdist.get_world_size()
    start = 0
    for k in names:
        n = grads[k].numel()
        grads[k] = flat[start:start + n].view(grads[k].shape)
        start += n
    return tuple(flat[start + i] for i in range(len(scalars)))


def any_process(flag: bool, device: Any = "cpu") -> bool:
    """Whether ``flag`` is set on any process of the group (a collective:
    every rank must call it); ``flag`` itself without a group."""
    if not group_active():
        return flag
    if tdist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return bool(t.item() > 0)


def make_global_batch(batch: Any, devices: list) -> list:
    """This process's local batch onto its data devices: the leading axis
    split into ``len(devices)`` contiguous chunks, one per device (with one
    device, the whole batch). Across processes the global batch is the
    concatenation of every rank's local batch, in rank order."""
    n = len(devices)

    def leaf(x, i):
        if isinstance(x, dict):
            return {k: leaf(v, i) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(leaf(v, i) for v in x)
        if x is None:
            return None
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        if n > 1:
            if t.shape[0] % n:
                raise ValueError(f"a batch of {t.shape[0]} rows does not split over {n} devices")
            step = t.shape[0] // n
            t = t[i * step:(i + 1) * step]
        return t.to(devices[i], non_blocking=True)

    return [leaf(batch, i) for i in range(n)]
