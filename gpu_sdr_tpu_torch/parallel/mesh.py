"""A mesh of torch devices, driven by one process (port of
gpu_sdr_tpu/parallel/mesh.py).

JAX runs a sharded step as one SPMD program (``shard_map``) over a
``jax.sharding.Mesh``.  Here one Python process drives every shard: a
:class:`Mesh` is an ndarray of ``torch.device`` with axis names, and a
sharded step is a loop over the shards, each shard's work queued on its
device's current stream.  A device may appear more than once: such
shards are virtual, the counterpart of the JAX tests' 8 virtual CPU
devices, so a ``(2, 4)`` mesh of ``"cpu"`` or a ``(2, 2)`` mesh of one
card runs the same shard arithmetic as a mesh of distinct cards.

The collectives of the sharded layer are the two below, written as
copies between the shards' devices (a no-op between virtual shards of
one device): ``ppermute`` (the overlap-save halo ring of the time axis)
and ``psum`` (the owner-local tone selections of the channel axis).
``Sharded`` is a sharded result; ``gather`` is the global view the
pipeline's fetch takes (gpu_sdr_tpu/parallel/fused_sharded._to_np_global).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device


class Mesh:
    """An ndarray of torch devices with named axes (``time``,
    ``channels``).  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does, so ``mesh.shape.get("time", 1)``
    reads as in the JAX package."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[i] = torch.device(d)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(f"{arr.ndim}-axis device array, axis names "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def T(self) -> int:
        """Time shards."""
        return self.shape.get("time", 1)

    @property
    def Kc(self) -> int:
        """Channel shards."""
        return self.shape.get("channels", 1)

    def device(self, t: int = 0, c: int = 0) -> torch.device:
        """The device of time shard t, channel shard c."""
        idx = tuple(t if a == "time" else c if a == "channels" else 0
                    for a in self.axis_names)
        return self.devices[idx]

    @property
    def first(self) -> torch.device:
        """Shard (0, 0)'s device: where host blocks land and results
        are gathered."""
        return self.device(0, 0)

    def grid(self, fn) -> List[list]:
        """[[fn(t, c, device(t, c)) for each channel shard] for each time
        shard]."""
        return [[fn(t, c, self.device(t, c)) for c in range(self.Kc)]
                for t in range(self.T)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape: Tuple[int, ...],
              axis_names: Sequence[str] = ("time", "channels"),
              devices=None) -> Mesh:
    """A mesh of the given logical shape.  `devices=None` takes every
    visible CUDA device; a listed device may repeat (virtual shards).
    Raises when there are too few devices, and for a CUDA device when
    there is no card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "name the devices (e.g. ['cpu'] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} devices, have "
            f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names[:len(shape)]))


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A (time, channels) mesh over all (or n) CUDA devices: time gets
    the smaller factor, channels the larger (the JAX package's rule)."""
    n = n_devices if n_devices is not None else (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if n <= 0:
        raise RuntimeError("default_mesh: no CUDA device is available")
    t = 2 if (n % 2 == 0 and n >= 4) else 1
    return make_mesh((t, n // t), ("time", "channels"))


@dataclasses.dataclass
class Sharded:
    """A sharded result: ``parts[t][c]`` is shard (t, c)'s block of rows
    (time) and columns (channels); a result replicated over the channel
    axis has one part per time shard."""

    parts: List[list]

    def map(self, fn) -> "Sharded":
        """fn applied to every part (a shard-local operation)."""
        return Sharded([[fn(p) for p in row] for row in self.parts])

    def columns(self, n: int) -> "Sharded":
        """The first n global columns (channel padding dropped)."""
        rows = []
        for row in self.parts:
            keep, c0 = [], 0
            for p in row:
                w = min(p.shape[-1], n - c0)
                if w > 0:
                    keep.append(p if w == p.shape[-1] else p[..., :w])
                c0 += p.shape[-1]
            rows.append(keep)
        return Sharded(rows)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on `device` (default: shard (0, 0)'s):
        columns joined within each time shard, then rows."""
        dev = torch.device(device) if device is not None else \
            self.parts[0][0].device
        rows = [torch.cat([p.to(dev) for p in row], dim=-1)
                if len(row) > 1 else row[0].to(dev) for row in self.parts]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def shard_input(mesh: Mesh, x) -> List[list]:
    """A block on the time axis: shard (t, c) gets samples
    [t*L/T, (t+1)*L/T) of x (L,) on its device, replicated over the
    channel shards.  A grid already sharded (from a resident recording)
    is returned as it is."""
    if isinstance(x, list):
        return x
    Lt = x.shape[0] // mesh.T
    return mesh.grid(lambda t, c, d: x[t * Lt:(t + 1) * Lt].to(d))


def ppermute(parts: Sequence[torch.Tensor],
             devices: Sequence[torch.device]) -> list:
    """One step around the time ring: shard t+1 receives parts[t] (shard
    0 receives the last shard's), copied to its device."""
    T = len(parts)
    return [parts[(t - 1) % T].to(devices[t]) for t in range(T)]


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the channel shards' parts, on `device`."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total
