"""Per-host sharded ingest: one TCP feed a process -> one globally
time-sharded IQ stream (port of gpu_sdr_tpu/parallel/host_ingest.py).

The reference's host->device transport is a single-host pinned-pool
pipeline (preallocator + cudaMemcpyAsync,
headers/USRP_server_memory_management.hpp:210-272).  Across hosts (SURVEY.md
section 2.4, "per-host shard of the IQ stream") each process runs one
native TCP receiver (native/stream_ingest.cpp through engine/ingest.
SocketIngestSource, the port's own g++ build), fed only the time span
its shards own (distributed.host_time_span), and puts each block
straight onto its own shards: samples never cross processes.  Between
the processes runs only the per-block liveness agreement, one MIN
all_reduce of one flag on the gloo group of CPU tensors
(distributed.cpu_group); the sharded demodulator's own halo ring runs
as ever.

Failure semantics follow the reference's "USRP is not streaming" abort
(cpp/USRP_hardware_manager.cpp:1546-1560): when any process's producer
dies or stalls, every process ends the measurement short together, with
the same ``shortfall_blocks``: the sharded step needs every process to
advance in lock-step, so liveness is agreed per block before it does.
The process group's timeout must exceed the receiver's `timeout`, or a
stalled producer's wait would end the agreement first.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .distributed import cpu_group, host_time_span

log = logging.getLogger("gpu_sdr_tpu_torch.host_ingest")


class PerHostIngest:
    """One native TCP ingest receiver a process, yielding this process's
    shards of every global block.

    Each process tells its producer to connect to `.port` and stream the
    raw complex64 samples of its span of every global block: samples
    [b*L + offset, b*L + offset + local_len) of the global stream, back
    to back (`host_stream_for`).  `device_blocks()` yields (grid, local
    errors) pairs: the grid holds, for each of this process's shards
    (t, c), its Lt samples on its device (None elsewhere), the form a
    sharded demodulator's step takes (parallel/mesh.shard_input)."""

    def __init__(self, mesh, block_len: int, axis: str = "time",
                 port: int = 0, queue_len: int = 16,
                 timeout: float = 30.0):
        from ..engine.ingest import SocketIngestSource
        self.mesh = mesh
        self.axis = axis
        self.block_len = int(block_len)
        start, stop, T = host_time_span(mesh, axis)
        if self.block_len % T:
            raise ValueError(
                f"block_len {block_len} must split over the {T} '{axis}' "
                f"shards")
        self.start = start
        self.seg = self.block_len // T
        self.local_len = (stop - start) * self.seg
        self.offset = start * self.seg
        if self.local_len == 0:
            raise ValueError("this host owns no devices on the mesh")
        self.source = SocketIngestSource(self.local_len, port=port,
                                         queue_len=queue_len,
                                         timeout=timeout)
        self.port = self.source.port
        self.aborted = False
        self.shortfall_blocks = 0

    def _all_alive(self, ok: bool) -> bool:
        """Per-block liveness agreement across processes: every process
        advances the sharded step together or stops together."""
        if not self.mesh.multiprocess:
            return ok
        import torch.distributed as dist
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=cpu_group())
        return bool(flag.item())

    def device_blocks(self, block_len: int, n_blocks: int):
        """Yield up to n_blocks (shard grid, local errors)."""
        if block_len != self.block_len:
            raise ValueError("per-host ingest block length fixed at "
                             "construction")
        it = self.source.blocks(self.local_len, n_blocks)
        seg, start = self.seg, self.start
        for i in range(n_blocks):
            blk = next(it, None)
            if not self._all_alive(blk is not None):
                # some process's producer is not streaming: end SHORT
                # everywhere, never fabricate samples (reference abort,
                # cpp/USRP_hardware_manager.cpp:1546-1560)
                self.aborted = True
                self.shortfall_blocks = n_blocks - i
                log.error(
                    "per-host ingest is not streaming on at least one "
                    "host: ending measurement %d blocks short (%d/%d "
                    "delivered)", self.shortfall_blocks, i, n_blocks)
                it.close()
                return
            x = torch.from_numpy(blk)
            grid = self.mesh.grid(lambda t, c, d: x[(t - start) * seg:
                                                    (t - start + 1) * seg]
                                  .to(d))
            yield grid, int(self.source.take_errors())

    def close(self) -> None:
        self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def host_stream_for(x_global: np.ndarray, ingest: PerHostIngest,
                    n_blocks: int) -> np.ndarray:
    """The sample stream a producer sends to this process's
    `ingest.port` for a global recording: this process's span of each
    global block, back to back (the per-host shard of the IQ stream,
    SURVEY.md section 2.4)."""
    L, off, n = ingest.block_len, ingest.offset, ingest.local_len
    pieces = [x_global[b * L + off: b * L + off + n]
              for b in range(n_blocks)]
    return np.ascontiguousarray(
        np.concatenate(pieces).astype(np.complex64))
