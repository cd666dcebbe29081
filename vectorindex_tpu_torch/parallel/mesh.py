"""Device meshes and row sharding for one process that holds many devices.

Counterpart of vectorindex_tpu.parallel.mesh. The JAX package is single
controller: one Python process owns a `Mesh` and runs `shard_map` over its
devices. The port keeps that model without `torch.distributed`: a `Mesh` is
a 1-D or 2-D grid of `torch.device`s with named axes, each shard's tensors
live on their own device, and each shard's work is enqueued on that
device's current stream. A device may appear more than once, so one card
(or the CPU) can hold several shards.

  - `make_mesh` / `make_mesh_2d`: the grid (default: the visible CUDA
    devices; with no card the caller passes `devices`);
  - `corpus_sharding` / `replicated`: placements (`Placement.put` is
    jax.device_put's counterpart);
  - `shard_rows`: a [N, ...] tensor split into equal row blocks, one on
    each device of a mesh axis (`ShardedRows`); `pad_rows` pads N first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

DATA_AXIS = "data"
REPLICA_AXIS = "replica"


class Mesh:
    """A grid of devices with named axes (jax.sharding.Mesh's counterpart):
    `devices` is an object ndarray of torch.device, `shape` maps each axis
    name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(np.asarray(devices, dtype=object)[pos])
        if grid.ndim != len(axis_names) or grid.ndim not in (1, 2) or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 1-D or 2-D grid, got {grid.shape} "
                             f"for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` of the first row (1-D: all of them);
        the other rows along the remaining axis hold replicas."""
        i = self.axis_names.index(axis)
        line = np.moveaxis(self.devices, i, 0)
        return list(line.reshape(line.shape[0], -1)[:, 0])

    @property
    def first(self) -> torch.device:
        """The device results are gathered on."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _visible(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=[...] "
                           "(a device may repeat)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS, devices=None) -> Mesh:
    """1-D mesh over the first n devices of `devices` (default: every
    visible CUDA device)."""
    devs = _visible(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs, dtype=object), (axis,))


def make_mesh_2d(
    n_replicas: int,
    n_data: Optional[int] = None,
    axes: tuple = (REPLICA_AXIS, DATA_AXIS),
    devices=None,
) -> Mesh:
    """2-D (replica × data) mesh: the corpus shards along `data` and
    replicates across `replica`; query batches shard across `replica`, so
    each replica group serves its own requests (the JAX package's DCN-ready
    layout, SURVEY.md §5.8)."""
    devs = _visible(devices)
    if n_data is None:
        n_data = len(devs) // n_replicas
    need = n_replicas * n_data
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    grid = np.empty((n_replicas, n_data), dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i // n_data, i % n_data] = d
    return Mesh(grid, axes)


class ShardedRows(NamedTuple):
    """A [N, ...] array split into equal row blocks, block s on the s-th
    device of its mesh axis."""

    shards: tuple  # of tensors [N / S, ...]

    @property
    def shape(self) -> tuple:
        return (sum(t.shape[0] for t in self.shards),) + tuple(self.shards[0].shape[1:])

    def gather(self, device) -> Tensor:
        """The whole array on one device."""
        return torch.cat([t.to(device) for t in self.shards])


@dataclass(frozen=True)
class Placement:
    """Where an array lives on a mesh (NamedSharding's counterpart): rows
    split along `axis`, or every device holding the whole array (axis
    None)."""

    mesh: Mesh
    axis: Optional[str] = None

    def put(self, x):
        """jax.device_put's counterpart: a [N, ...] tensor (or numpy array)
        as ShardedRows along `axis`, N divisible by the axis size (pad
        first: pad_rows); replicated, a tuple of whole copies, one on each
        device of the mesh."""
        x = torch.as_tensor(x)
        if self.axis is None:
            return tuple(x.to(d) for d in self.mesh.devices.flat)
        devs = self.mesh.axis_devices(self.axis)
        n, s = x.shape[0], len(devs)
        if n % s:
            raise ValueError(f"{n} rows do not split into {s} shards: pad_rows first")
        per = n // s
        return ShardedRows(tuple(x[i * per : (i + 1) * per].to(d) for i, d in enumerate(devs)))


def corpus_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> Placement:
    """Rows (N) of a [N, ...] corpus split across `axis`."""
    return Placement(mesh, axis)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def shard_rows(mesh: Mesh, x, axis: str = DATA_AXIS) -> ShardedRows:
    """Place a [N, ...] tensor (or numpy array) row-sharded along `axis`
    (corpus_sharding(mesh, axis).put). An already sharded array is returned
    as it is."""
    if isinstance(x, ShardedRows):
        return x
    return corpus_sharding(mesh, axis).put(x)


def pad_rows(x, multiple: int):
    """Pad N up to a multiple (shard divisibility), returning (padded, n)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))]), n
