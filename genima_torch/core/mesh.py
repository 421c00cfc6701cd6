"""Device meshes and their placements.

Counterpart of ``genima_tpu/core/mesh.py``. A ``Mesh`` is a (data, fsdp)
grid of torch devices, as JAX's ``make_mesh(n_data, n_fsdp, devices)``
builds it; a device may appear more than once (two shards on one card).
The port places tensors itself where JAX lets GSPMD do it:

* serving (one process over a list of devices): ``shard_batch`` splits the
  lockstep batch into ``data`` contiguous chunks, one per data row, and
  ``replicated(mesh).place`` copies a model onto each row's device;
  ``core/tp.py`` splits the diffusion weights over a row's ``fsdp``
  devices;
* training (one process per GPU): ``process_mesh(device)`` is this
  process's view of the data axis over the process group: one local row
  (its own device), ``data`` = the world size, its rows starting at its
  rank. ``shard_batch`` then moves the local batch to that device.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from genima_torch import resolve_device
from genima_torch.core import distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


class Mesh:
    """``devices``: the (rows, n_fsdp) object array of the devices this
    process drives; ``n_data``: the size of the data axis (the rows of every
    process); ``data_offset``: the index of this process's first row."""

    def __init__(self, devices: np.ndarray, n_data: Optional[int] = None, data_offset: int = 0):
        self.devices = devices
        self.n_data = devices.shape[0] if n_data is None else n_data
        self.data_offset = data_offset

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.n_data, FSDP_AXIS: self.devices.shape[1]}

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each local data row (its first fsdp device)."""
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    def row(self, i: int) -> list[torch.device]:
        """The fsdp devices of local data row ``i``."""
        return list(self.devices[i])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def _default_devices() -> list[torch.device]:
    """Every visible card; raises where there is none (the CPU only when a
    caller lists it)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_fsdp: int = 1,
              devices: Optional[list] = None) -> Mesh:
    """A (data, fsdp) mesh over ``devices`` (default: every visible card;
    none raises, the CPU is used only when listed). With ``n_data=None``
    every device goes to the data axis; extra devices are left out; too few
    raise."""
    devices = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    if n_data is None:
        n_data = len(devices) // n_fsdp
    needed = n_data * n_fsdp
    if len(devices) < needed:
        raise ValueError(
            f"make_mesh needs {needed} devices for a {n_data}x{n_fsdp} "
            f"(data x fsdp) mesh but only {len(devices)} are available "
            f"({[d.type for d in devices]}). Provision more devices or list "
            "one device more than once."
        )
    grid = np.empty((n_data, n_fsdp), dtype=object)
    for i, d in enumerate(devices[:needed]):
        grid[i // n_fsdp, i % n_fsdp] = d
    return Mesh(grid)


def process_mesh(device: Any) -> Mesh:
    """The training mesh of this process: its own device as its one row of
    a data axis over the process group."""
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = torch.device(device)
    return Mesh(grid, n_data=dist.process_count(), data_offset=dist.process_index())


def place_module(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` itself when it already lives on ``device``, else a copy there."""
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device == device for t in tensors):
        return module
    return copy.deepcopy(module).to(device)


def _place(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, nn.Module):
        return place_module(tree, device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    return tree


class Sharding(NamedTuple):
    """A placement over ``mesh``: ``spec`` () replicates, (DATA_AXIS,)
    splits the leading axis over the data rows. ``place`` returns one tree
    per local data row."""

    mesh: Mesh
    spec: tuple

    def place(self, tree: Any) -> list:
        if self.spec == (DATA_AXIS,):
            return dist.make_global_batch(tree, self.mesh.data_devices)
        return [_place(tree, d) for d in self.mesh.data_devices]


def data_sharding(mesh: Mesh) -> Sharding:
    """A batch: the leading axis split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    """Parameters: a whole copy on every data row."""
    return Sharding(mesh, ())


def shard_batch(batch: Any, mesh: Mesh) -> list:
    """This process's batch onto its data rows, one contiguous chunk each
    (the one host-to-device transfer of a step)."""
    return data_sharding(mesh).place(batch)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
