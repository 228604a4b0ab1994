"""A mesh of torch devices, driven by one process or by one process a
host (port of gpu_sdr_tpu/parallel/mesh.py).

JAX runs a sharded step as one SPMD program (``shard_map``) over a
``jax.sharding.Mesh``.  Here each process drives the shards it owns: a
:class:`Mesh` is an ndarray of ``torch.device`` with axis names and the
rank that owns each entry, and a sharded step is a loop over the
process's own shards, each shard's work queued on its device's current
stream.  A device may appear more than once: such shards are virtual,
the counterpart of the JAX tests' 8 virtual CPU devices, so a ``(2, 4)``
mesh of ``"cpu"`` or a ``(2, 2)`` mesh of one card runs the same shard
arithmetic as a mesh of distinct cards.

Without a process group the mesh is one process's (every entry rank 0)
and the collectives are copies between the shards' devices (a no-op
between virtual shards of one device).  Under ``torch.distributed``
(parallel/distributed.py) ``make_mesh`` joins every rank's local devices
in rank order, JAX's process-major default, and the collectives run
between the processes: ``Mesh.ring`` (the overlap-save halo ring of the
time axis, ``isend`` / ``irecv`` where the ends are on two ranks),
``Mesh.psum_row`` (the owner-local tone selections of the channel axis,
one ``all_reduce`` on the ranks of a time row) and ``Mesh.gather`` (one
``all_gather`` of equal-shaped shards, the global view every rank's
sinks take, gpu_sdr_tpu/parallel/fused_sharded._to_np_global).  Over
gloo, which moves host tensors only, device tensors are staged through
pinned host tensors, so the same code runs in the CPU tests, between
ranks that share one card, and over NCCL between cards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device


def _dist():
    import torch.distributed as dist
    return dist


def distributed_world() -> int:
    """The process group's size, 1 without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _real(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its (..., 2) real view; others as they are."""
    return torch.view_as_real(x) if x.is_complex() else x


class Mesh:
    """An ndarray of torch devices with named axes (``time``,
    ``channels``).  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does, so ``mesh.shape.get("time", 1)``
    reads as in the JAX package.  ``ranks`` holds the rank that owns each
    entry (all 0 in one process) and ``rank`` this process's; a device
    is named as its owner names it."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None,
                 rank: int = 0):
        arr = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[i] = torch.device(d)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(f"{arr.ndim}-axis device array, axis names "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.ranks = (np.zeros(arr.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(
                          arr.shape))
        self.rank = int(rank)
        self.multiprocess = len(np.unique(self.ranks)) > 1
        self.backend = None
        self._row_groups = {}
        self.gathers = 0                 # Mesh.gather's calls
        self._gather_host_s = 0.0        # and its time: on the host clock
        self._gather_events = []         # or, for CUDA parts, on the card
        if self.multiprocess:
            if not (self.ranks == self.rank).any():
                raise ValueError(f"rank {self.rank} owns no entry of the "
                                 "mesh")
            dist = _dist()
            if dist.is_available() and dist.is_initialized():
                self.backend = str(dist.get_backend())
                # one group a time row that spans ranks, made by every
                # rank in the same order (new_group is collective)
                for t in range(self.T):
                    members = sorted({int(r) for r in self._row_ranks(t)})
                    if len(members) > 1:
                        g = dist.new_group(members)
                        if self.rank in members:
                            self._row_groups[t] = g

    # -- geometry --------------------------------------------------------
    @property
    def T(self) -> int:
        """Time shards."""
        return self.shape.get("time", 1)

    @property
    def Kc(self) -> int:
        """Channel shards."""
        return self.shape.get("channels", 1)

    def _index(self, t: int, c: int):
        return tuple(t if a == "time" else c if a == "channels" else 0
                     for a in self.axis_names)

    def device(self, t: int = 0, c: int = 0) -> torch.device:
        """The device of time shard t, channel shard c (as its owner
        names it)."""
        return self.devices[self._index(t, c)]

    def owner(self, t: int = 0, c: int = 0) -> int:
        """The rank that owns shard (t, c)."""
        return int(self.ranks[self._index(t, c)])

    def is_local(self, t: int = 0, c: int = 0) -> bool:
        """Whether this process owns shard (t, c)."""
        return self.owner(t, c) == self.rank

    def _row_ranks(self, t: int):
        return [self.owner(t, c) for c in range(self.Kc)]

    def row_device(self, t: int) -> Optional[torch.device]:
        """Where this process computes a result of time row t that is
        replicated over the channel axis: shard (t, 0)'s device in one
        process; across processes the first local shard's of the row
        (every rank that owns a shard of the row computes it, as every
        device of the row does in JAX's shard_map), None where this
        rank owns none of the row."""
        c = self.row_shard(t)
        return None if c is None else self.device(t, c)

    def rows(self, fn) -> list:
        """[fn(t, row_device(t)) for each time row], fn called for the
        rows this process computes, None elsewhere."""
        return [None if self.row_device(t) is None
                else fn(t, self.row_device(t)) for t in range(self.T)]

    def row_shard(self, t: int) -> Optional[int]:
        """The channel shard of row_device(t), or None."""
        for c in range(self.Kc):
            if self.is_local(t, c):
                return c
        return None

    @property
    def first(self) -> torch.device:
        """This process's first shard's device: where host blocks land
        and results are gathered (shard (0, 0)'s in one process)."""
        for t in range(self.T):
            for c in range(self.Kc):
                if self.is_local(t, c):
                    return self.device(t, c)
        raise ValueError(f"rank {self.rank} owns no shard of the mesh")

    def grid(self, fn) -> List[list]:
        """[[fn(t, c, device(t, c)) for each channel shard] for each time
        shard], fn called for this process's shards only, None
        elsewhere."""
        return [[fn(t, c, self.device(t, c)) if self.is_local(t, c)
                 else None for c in range(self.Kc)] for t in range(self.T)]

    def __repr__(self) -> str:
        ranks = (f", ranks={self.ranks.ravel().tolist()}, rank={self.rank}"
                 if self.multiprocess else "")
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}{ranks})")

    @property
    def gather_seconds(self) -> float:
        """Mesh.gather's time so far.  For parts on a card, the device
        time between two CUDA events on the parts' current stream: from
        the end of the work queued before the gather (the block's own
        kernels) to the gathered tensor's arrival; it covers the gloo
        staging copies and the host collective, and NCCL's collective,
        which returns to the host once queued.  Reading it waits for the
        gathers queued so far.  For host parts, the host clock."""
        for start, end in self._gather_events:
            end.synchronize()
            self._gather_host_s += start.elapsed_time(end) / 1e3
        self._gather_events.clear()
        return self._gather_host_s

    # -- collectives -----------------------------------------------------
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """`x` as the backend moves it: a pinned host copy over gloo, the
        tensor itself over NCCL."""
        x = x.contiguous()
        if self.backend == "gloo" and x.device.type != "cpu":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return host
        return x

    def _wire_empty(self, like: torch.Tensor, shape=None) -> torch.Tensor:
        shape = tuple(like.shape) if shape is None else tuple(shape)
        if self.backend == "gloo":
            return torch.empty(shape, dtype=like.dtype,
                               pin_memory=like.device.type == "cuda")
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def ring(self, c: int, parts: Sequence) -> list:
        """One step around the time ring of channel column c: shard t+1
        receives parts[t], shard 0 the last shard's, on its device; None
        for the shards of other processes.  A hop whose ends are both
        this process's is a copy (every hop in one process); one whose
        ends are on two ranks is an isend / irecv pair, posted on every
        rank in one order (t ascending)."""
        T = len(parts)
        dist = _dist()
        out, ops, recvs = [None] * T, [], []
        for t in range(T):
            s = (t - 1) % T
            src, dst = self.owner(s, c), self.owner(t, c)
            if src == self.rank and dst == self.rank:
                out[t] = parts[s].to(self.device(t, c))
            elif src == self.rank:
                ops.append(dist.P2POp(dist.isend, _real(self._wire(parts[s])),
                                      dst, tag=t))
            elif dst == self.rank:
                buf = self._wire_empty(parts[t])
                ops.append(dist.P2POp(dist.irecv, _real(buf), src, tag=t))
                recvs.append((t, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for t, buf in recvs:
            out[t] = buf.to(self.device(t, c))
        return out

    def psum_row(self, t: int, parts: Sequence):
        """The sum of time row t's channel-shard parts on row_device(t)
        (device (t, 0) in one process; None where this rank owns none of
        the row): the local parts' sum, then, where the row spans ranks,
        one all_reduce on the ranks of the row.  The tone selections it
        joins are owner-local, every other shard's part exactly 0, so the
        sum is the same bits in any order."""
        d = self.row_device(t)
        if d is None:
            return None
        local = [p for p in parts if p is not None]
        total = psum(local, d)
        group = self._row_groups.get(t)
        if group is not None:
            dist = _dist()
            wire = self._wire(total)
            dist.all_reduce(_real(wire), op=dist.ReduceOp.SUM, group=group)
            total = wire.to(d)
        return total

    def gather(self, parts: Sequence[list], device=None,
               ncols: Optional[int] = None) -> torch.Tensor:
        """The global tensor of a multi-process Sharded's parts, on every
        rank: one all_gather of equal-shaped shards (each rank's own
        parts stacked, padded to the most any rank owns), then columns
        joined within each time shard, then rows, then the first `ncols`
        columns kept (the channel padding is cut after the gather).  A
        part per channel shard is its owner's; a part per time row (a
        result replicated over the channel axis) the row's lowest
        rank's."""
        dist = _dist()
        ref = next(p for row in parts for p in row if p is not None)
        if ref.device.type == "cuda":
            stream = torch.cuda.current_stream(ref.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        else:
            t0 = time.perf_counter()
        slots = [(t, c) for t in range(len(parts))
                 for c in range(len(parts[t]))]

        def owner(t, c):
            if len(parts[t]) == self.Kc:
                return self.owner(t, c)
            return min(self._row_ranks(t))

        owners = {s: owner(*s) for s in slots}
        world = dist.get_world_size()
        counts = [sum(1 for s in slots if owners[s] == r)
                  for r in range(world)]
        mine = [s for s in slots if owners[s] == self.rank]
        buf = self._wire_empty(ref, (max(counts),) + tuple(ref.shape))
        for i, (t, c) in enumerate(mine):
            buf[i].copy_(parts[t][c])
        if len(mine) < buf.shape[0]:
            buf[len(mine):].zero_()
        outs = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather([_real(o) for o in outs], _real(buf))
        taken = [0] * world
        got = {}
        for s in slots:
            r = owners[s]
            got[s] = outs[r][taken[r]]
            taken[r] += 1
        rows = []
        for t, row in enumerate(parts):
            cols = [got[(t, c)] for c in range(len(row))]
            rows.append(torch.cat(cols, dim=-1) if len(cols) > 1
                        else cols[0])
        y = torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]
        if ncols is not None:
            y = y[..., :ncols]
        dev = torch.device(device) if device is not None else self.first
        y = y.to(dev) if y.device != dev else y.contiguous()
        self.gathers += 1
        if ref.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._gather_events.append((start, end))
        else:
            self._gather_host_s += time.perf_counter() - t0
        return y


def make_mesh(shape: Tuple[int, ...],
              axis_names: Sequence[str] = ("time", "channels"),
              devices=None) -> Mesh:
    """A mesh of the given logical shape.  `devices=None` takes every
    visible CUDA device; a listed device may repeat (virtual shards).
    Under a process group of more than one rank (parallel/distributed.
    py), `devices` are this rank's own, and the mesh takes every rank's
    in rank order (gathered with all_gather_object): JAX's process-major
    default order, so each rank owns one contiguous time span.  Raises
    when there are too few devices, when a rank would own none, and for
    a CUDA device when there is no card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "name the devices (e.g. ['cpu'] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = int(np.prod(shape))
    world = distributed_world()
    ranks, rank = [0] * len(devices), 0
    if world > 1:
        dist = _dist()
        names = [None] * world
        dist.all_gather_object(names, [str(d) for d in devices])
        rank = dist.get_rank()
        devices = [torch.device(d) for r in range(world) for d in names[r]]
        ranks = [r for r in range(world) for _ in names[r]]
        if len(set(ranks[:n])) < world:
            raise ValueError(
                f"mesh shape {tuple(shape)} leaves a rank without a shard "
                f"(local devices {[len(x) for x in names]} a rank)")
    if n > len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} devices, have "
            f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names[:len(shape)]),
                ranks=np.asarray(ranks[:n]).reshape(tuple(shape)),
                rank=rank)


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A (time, channels) mesh over all (or n) CUDA devices, every rank's
    under a process group: time gets the smaller factor, channels the
    larger (the JAX package's rule)."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices if n_devices is not None else local * distributed_world()
    if n <= 0:
        raise RuntimeError("default_mesh: no CUDA device is available")
    t = 2 if (n % 2 == 0 and n >= 4) else 1
    return make_mesh((t, n // t), ("time", "channels"))


@dataclasses.dataclass
class Sharded:
    """A sharded result: ``parts[t][c]`` is shard (t, c)'s block of rows
    (time) and columns (channels); a result replicated over the channel
    axis has one part per time shard.  Under a multi-process `mesh` the
    parts of other ranks are None, and ``ncols`` the global columns kept
    at the gather."""

    parts: List[list]
    mesh: Optional[Mesh] = None
    ncols: Optional[int] = None

    @property
    def multiprocess(self) -> bool:
        return self.mesh is not None and self.mesh.multiprocess

    def map(self, fn) -> "Sharded":
        """fn applied to every (local) part (a shard-local operation)."""
        return Sharded([[None if p is None else fn(p) for p in row]
                        for row in self.parts], self.mesh, self.ncols)

    def columns(self, n: int) -> "Sharded":
        """The first n global columns (channel padding dropped); across
        processes the cut is made after the gather."""
        if self.multiprocess:
            return Sharded(self.parts, self.mesh, n)
        rows = []
        for row in self.parts:
            keep, c0 = [], 0
            for p in row:
                w = min(p.shape[-1], n - c0)
                if w > 0:
                    keep.append(p if w == p.shape[-1] else p[..., :w])
                c0 += p.shape[-1]
            rows.append(keep)
        return Sharded(rows, self.mesh)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on `device` (default: shard (0, 0)'s):
        columns joined within each time shard, then rows.  Across
        processes every rank gets it (Mesh.gather)."""
        if self.multiprocess:
            return self.mesh.gather(self.parts, device, self.ncols)
        if any(p is None for row in self.parts for p in row):
            raise ValueError("Sharded.gather: parts of other processes "
                             "and no multi-process mesh to gather them")
        dev = torch.device(device) if device is not None else \
            self.parts[0][0].device
        rows = [torch.cat([p.to(dev) for p in row], dim=-1)
                if len(row) > 1 else row[0].to(dev) for row in self.parts]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def shard_input(mesh: Mesh, x) -> List[list]:
    """A block on the time axis: shard (t, c) gets samples
    [t*L/T, (t+1)*L/T) of x (L,) on its device, replicated over the
    channel shards (this process's shards only: every rank holds the
    whole host block, as JAX's device_put with a NamedSharding takes
    it).  A grid already sharded (from a resident recording or the
    per-host ingest) is returned as it is."""
    if isinstance(x, list):
        return x
    Lt = x.shape[0] // mesh.T
    return mesh.grid(lambda t, c, d: x[t * Lt:(t + 1) * Lt].to(d))


def ppermute(parts: Sequence[torch.Tensor],
             devices: Sequence[torch.device]) -> list:
    """One step around the time ring in one process: shard t+1 receives
    parts[t] (shard 0 receives the last shard's), copied to its
    device."""
    T = len(parts)
    return [parts[(t - 1) % T].to(devices[t]) for t in range(T)]


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the channel shards' parts, on `device`."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total
