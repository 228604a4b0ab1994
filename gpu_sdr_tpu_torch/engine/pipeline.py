"""The streaming pipeline host loop (port of gpu_sdr_tpu/engine/pipeline.py).

One host loop over per-block steps.  PyTorch launches asynchronously, so
the loop keeps a short queue of in-flight results: block i's output is
copied to pinned host memory on a separate CUDA stream while block i+1
computes, and handed to the sinks only after block i+depth has been
launched (the reference's pinned-buffer double buffering,
headers/USRP_server_memory_management.hpp:103-273).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .demodulator import Demodulator
from .sinks import PacketMeta, Sink
from .sources import Source


@dataclasses.dataclass
class PipelineResult:
    n_blocks: int
    rows: int
    channels: int
    elapsed_s: float
    samples_in: int

    @property
    def msps(self) -> float:
        """Raw input complex Msamples/s sustained."""
        return self.samples_in / self.elapsed_s / 1e6


class _HostFetch:
    """Device -> host copies of per-block outputs, off the compute
    stream: ``start(y)`` queues the copy of `y` into pinned memory behind
    the work that produced it; ``result()`` waits for that copy alone and
    returns the numpy array (the sinks may keep it).  On the CPU the
    tensor is handed over as it is."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def start(self, y: torch.Tensor):
        if self.stream is None:
            return y, None
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            host.copy_(y, non_blocking=True)
            y.record_stream(self.stream)
            done = torch.cuda.Event()
            done.record(self.stream)
        return host, done

    @staticmethod
    def result(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()


def _end_setup(device) -> None:
    """Set-up ends here: on a card, wait for the work queued so far (an
    oscillator table, a recording), so the sinks start on a finished
    state and the streaming window holds only the stream."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chunked(step, init_state, n_blocks: int, block_len: int,
                channels: int, total_rows: int, device,
                sinks: Sequence[Sink] = (), usrp_number: int = 0,
                front_end: str = "A") -> PipelineResult:
    """Acquisition loop of the on-device chains (engine/fused.py): no
    host input; `step(state) -> (state, y)` produces one block's
    (rows, channels) output, `n_blocks` times, with one block in flight
    while the previous drains to the sinks.  The state is built before
    the sinks start: it is set-up.  (The JAX package scans K blocks per
    launch to amortize dispatch; PyTorch runs eagerly, so a step here is
    one block.)"""
    state = init_state()
    _end_setup(device)
    for s in sinks:
        s.on_start(channels, total_rows)
    fetch = _HostFetch(device)
    rows = pkt = 0
    t0 = time.perf_counter()

    def drain(pending):
        nonlocal rows, pkt
        d = fetch.result(pending)
        meta = PacketMeta(usrp_number=usrp_number, front_end_code=front_end,
                          packet_number=pkt, length=int(d.size), errors=0,
                          channels=int(d.shape[1]))
        for s in sinks:
            s.on_packet(meta, d)
        rows += d.shape[0]
        pkt += 1

    pending = None
    for _ in range(n_blocks):
        state, y = step(state)
        nxt = fetch.start(y)
        if pending is not None:
            drain(pending)
        pending = nxt
    if pending is not None:
        drain(pending)
    elapsed = time.perf_counter() - t0
    for s in sinks:
        s.on_end()
    return PipelineResult(n_blocks=pkt, rows=rows, channels=channels,
                          elapsed_s=elapsed, samples_in=pkt * block_len)


def run_pipeline(demod: Demodulator, source: Source,
                 sinks: Sequence[Sink] = (), n_blocks: Optional[int] = None,
                 usrp_number: int = 0, front_end: str = "A",
                 depth: int = 2, feed_depth: int = 2) -> PipelineResult:
    """Stream `n_blocks` blocks from `source` through the demodulator
    into the sinks.  Ingest runs through a HostFeed (engine/ingest.py)
    `feed_depth` blocks ahead, so the host->device copy of block i+1
    overlaps the compute of block i.  The demodulator's state is built
    before the sinks start: it is set-up."""
    from .ingest import HostFeed
    plan = demod.plan
    nb = n_blocks if n_blocks is not None else plan.n_blocks
    state = demod.init_state()
    _end_setup(demod.device)
    for s in sinks:
        s.on_start(demod.n_channels, plan.total_out_rows)
    stream = HostFeed(source, demod.device, depth=feed_depth).device_blocks(
        plan.block_len, nb)
    fetch = _HostFetch(demod.device)
    inflight = collections.deque()
    rows = 0
    pkt = 0
    t0 = time.perf_counter()

    def drain_one():
        nonlocal rows, pkt
        pending, errs = inflight.popleft()
        data = fetch.result(pending)
        meta = PacketMeta(
            usrp_number=usrp_number, front_end_code=front_end,
            packet_number=pkt, length=int(data.size),
            errors=errs, channels=int(data.shape[1]))
        for s in sinks:
            s.on_packet(meta, data)
        rows += data.shape[0]
        pkt += 1

    try:
        for x, errs in stream:
            state, y = demod.step(state, x)
            inflight.append((fetch.start(y), errs))
            if len(inflight) > depth:
                drain_one()
        while inflight:
            drain_one()
    finally:
        # on interruption still flush what was computed and close the
        # sinks (the reference's keyboard_disconnect path,
        # pyUSRP/USRP_connections.py:976-993)
        elapsed = time.perf_counter() - t0
        stream.close()            # stops and joins the feeder thread
        try:
            while inflight:
                drain_one()
        finally:
            for s in sinks:
                s.on_end()
    return PipelineResult(n_blocks=pkt, rows=rows, channels=demod.n_channels,
                          elapsed_s=elapsed,
                          samples_in=pkt * plan.block_len)
