"""The process group of a mesh across hosts (port of
gpu_sdr_tpu/parallel/distributed.py).

The reference is strictly single-node (SURVEY.md section 2.4).  The JAX
package scales across hosts with ``jax.distributed``; the port runs one
process a host (or a card) on ``torch.distributed``: every process calls
:func:`initialize_distributed`, after which ``parallel.make_mesh`` joins
every rank's local devices into one (time, channels) mesh, and the
sharded chains run their collectives between the processes (parallel/
mesh.py): NCCL between cards, gloo in the CPU tests and between ranks
that share one card (NCCL refuses two ranks on one device).

Ingest in a multi-host deployment is per-host: each host feeds the time
shards its devices own (`host_local_block` gives the slice of a global
block a host supplies; parallel/host_ingest.py streams it), the
"per-host shard of the IQ stream" of SURVEY.md section 7.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import numpy as np
import torch

_CPU_GROUP = None


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 60.0) -> None:
    """Join the process group (idempotent: a second call returns, as the
    JAX package's "already initialized" check).

    With no arguments torch's ``env://`` variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) name the group; else `init_method`
    (e.g. ``tcp://127.0.0.1:29500``), `world_size` and `rank` do.
    `backend` defaults to NCCL where a card is visible and gloo on the
    CPU; name gloo for ranks that share one card.  A failure raises: the
    backend is never swapped.  `timeout_s` bounds every collective, so a
    mismatched one fails in seconds, not after NCCL's default minutes.
    A gloo group of every rank is made beside the default group for the
    host-side agreements (parallel/host_ingest.py)."""
    global _CPU_GROUP
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=float(timeout_s))
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            timeout=timeout, **kw)
    _CPU_GROUP = (dist.group.WORLD if backend == "gloo"
                  else dist.new_group(backend="gloo", timeout=timeout))


def cpu_group():
    """The gloo group of every rank (CPU tensors), or None without a
    process group."""
    return _CPU_GROUP


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _CPU_GROUP
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _CPU_GROUP = None


def host_time_span(mesh, axis: str = "time") -> Tuple[int, int, int]:
    """(start, stop, T): the contiguous span of `axis` shards this
    process owns, out of T.  Raises when the mesh layout gives this
    process a non-contiguous span (lay the mesh out with the default
    device order so each process owns one contiguous time span)."""
    t_axis = list(mesh.axis_names).index(axis)
    T = mesh.shape[axis]
    owned = sorted({idx[t_axis] for idx, r in np.ndenumerate(mesh.ranks)
                    if r == mesh.rank})
    if not owned:
        return 0, 0, T
    start, stop = owned[0], owned[-1] + 1
    if owned != list(range(start, stop)):
        raise ValueError(
            f"this host's '{axis}' shards {owned} are not contiguous in "
            f"mesh order; lay the mesh out so each host owns a "
            f"contiguous time span (e.g. make_mesh with the default "
            f"device order)")
    return start, stop, T


def host_local_block(x_global: np.ndarray, mesh,
                     axis: str = "time") -> Tuple[np.ndarray, int]:
    """The contiguous slice of a global IQ block this process provides:
    (local_samples, global_offset).  With T time shards over P
    processes, each owns the segments of its shards, contiguous in mesh
    order."""
    start, stop, T = host_time_span(mesh, axis)
    seg = len(x_global) // T
    if start == stop:
        return np.zeros(0, dtype=x_global.dtype), 0
    return x_global[start * seg: stop * seg], start * seg
