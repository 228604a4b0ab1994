"""The streaming pipeline host loop (port of gpu_sdr_tpu/engine/pipeline.py).

One host loop over per-block steps.  PyTorch launches asynchronously, so
the loop keeps a short queue of in-flight results: block i's output is
copied to pinned host memory on a separate CUDA stream while block i+1
computes (the reference's pinned-buffer double buffering,
headers/USRP_server_memory_management.hpp:103-273).  The host-fed loop
hands block i to the sinks as soon as its copy has landed whenever the
feed has no next block waiting (the reference's RX worker synchronises
on each buffer's own copy and pushes that buffer to its stream queue at
once, cpp/USRP_server_link_threads.cpp:604-702), and at the latest once
block i+depth has been launched, when blocks keep arriving and block
i+1's kernels can overlap block i's copy.  Packets go out in block
order either way.  A mixed-mode antenna's groups (run_pipeline_mixed)
share each staged block and fetch their outputs one by one.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import spans
from ..parallel.mesh import Sharded
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
    tensor is handed over as it is.  A mesh's sharded result
    (parallel/mesh.Sharded) is gathered onto `device` first: the global
    view gpu_sdr_tpu/parallel/fused_sharded._to_np_global took; across
    processes every rank gathers it (parallel/mesh.Mesh.gather), onto
    the host where the backend is gloo."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def start(self, y):
        if isinstance(y, Sharded):      # a mesh's sharded result
            if y.multiprocess and y.mesh.backend == "gloo":
                # gloo gathers on the host: the global block is there
                return y.gather("cpu"), None
            y = y.gather(self.device)
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


def _start(init_state, device, sinks_per_output, starts):
    """The set-up's end and the stream's start of a loop: the state
    built (``sdr.setup.state``), the card synchronised
    (``sdr.setup.sync``), then ``sdr.stream`` opened and each of
    sinks_per_output[k] started with starts[k] (channels, rows).  The
    state."""
    with spans.once("sdr.setup.state"):
        state = init_state()
    with spans.once("sdr.setup.sync"):
        _end_setup(device)
    spans.stream_started(device)
    for sinks, (channels, rows) in zip(sinks_per_output, starts):
        for s in sinks:
            s.on_start(channels, rows)
    return state


def _finish(sinks_per_output, device) -> None:
    """The sinks ended, then ``sdr.stream`` closed."""
    for sinks in sinks_per_output:
        for s in sinks:
            s.on_end()
    spans.stream_ended(device)


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
    state = _start(init_state, device, [sinks], [(channels, total_rows)])
    fetch = _HostFetch(device)
    rows = pkt = 0
    t0 = time.perf_counter()

    def drain(pending, t_in):
        nonlocal rows, pkt
        spans.interval("sdr.inflight", pkt, t_in)
        tok = spans.begin("sdr.drain.wait", pkt)
        d = fetch.result(pending)
        spans.end(tok)
        meta = PacketMeta(usrp_number=usrp_number, front_end_code=front_end,
                          packet_number=pkt, length=int(d.size), errors=0,
                          channels=int(d.shape[1]))
        tok = spans.begin("sdr.drain.sinks", pkt)
        for s in sinks:
            s.on_packet(meta, d)
        spans.end(tok)
        rows += d.shape[0]
        pkt += 1

    pending = t_fetched = None
    for k in range(n_blocks):
        blk = spans.begin("sdr.loop.block", k)
        tok = spans.begin("sdr.loop.step")
        state, y = step(state)
        spans.end(tok)
        tok = spans.begin("sdr.fetch.start")
        nxt = fetch.start(y)
        t_nxt = spans.end(tok)
        if pending is not None:
            drain(pending, t_fetched)
        pending, t_fetched = nxt, t_nxt
        spans.end(blk)
    if pending is not None:
        drain(pending, t_fetched)
    elapsed = time.perf_counter() - t0
    _finish([sinks], device)
    return PipelineResult(n_blocks=pkt, rows=rows, channels=channels,
                          elapsed_s=elapsed, samples_in=pkt * block_len)


def run_pipeline(demod: Demodulator, source: Source,
                 sinks: Sequence[Sink] = (), n_blocks: Optional[int] = None,
                 usrp_number: int = 0, front_end: str = "A",
                 depth: int = 2, feed_depth: int = 2) -> PipelineResult:
    """Stream `n_blocks` blocks from `source` through the demodulator
    into the sinks.  Ingest runs through a HostFeed (engine/ingest.py)
    `feed_depth` blocks ahead, so the host->device copy of block i+1
    overlaps the compute of block i.  A block goes to the sinks once its
    device->host copy has landed if the feed has no block waiting, else
    once `depth` later blocks have been launched (_host_fed).  The
    demodulator's state is built before the sinks start: it is set-up."""
    def step(state, x):
        state, y = demod.step(state, x)
        return state, (y,)
    return _host_fed(demod, step, source, [sinks],
                     [(demod.n_channels, demod.plan.total_out_rows)],
                     n_blocks, usrp_number, front_end, depth, feed_depth)


def run_pipeline_mixed(mdemod, source: Source,
                       sinks_per_group: Sequence[Sequence[Sink]],
                       n_blocks: Optional[int] = None, usrp_number: int = 0,
                       front_end: str = "A", depth: int = 2,
                       feed_depth: int = 2) -> PipelineResult:
    """Stream blocks through a MixedDemodulator (engine/demodulator.py):
    each block is staged on the device once and every wave-type group's
    step reads it; each group's output takes its own device -> host copy
    and drains to sinks_per_group[g], packet by packet in block order,
    with the block's error count.  Accounting as in run_pipeline, the
    rows counted every group's.  (Mixed wave types exceed the
    reference, which rejects them, cpp/USRP_demodulator.cpp:36-39.)"""
    return _host_fed(mdemod, mdemod.step, source, sinks_per_group,
                     [(g.demod.n_channels, g.demod.plan.total_out_rows)
                      for g in mdemod.groups],
                     n_blocks, usrp_number, front_end, depth, feed_depth)


def _host_fed(demod, step, source, sinks_per_output, starts, n_blocks,
              usrp_number, front_end, depth, feed_depth) -> PipelineResult:
    """The host-fed loop: `step(state, x) -> (state, outputs)`, output k
    to sinks_per_output[k], which start with starts[k] (channels, rows).

    After each launch the oldest block in flight is drained while more
    than `depth` are in flight, or while the feed has no staged block
    waiting (``HostFeed.starved``): the loop would wait for the next
    block anyway, so it waits on the oldest block's copy instead and
    hands it over at once, as the reference's RX worker pushes each
    buffer after its own copy (SURVEY.md:236-239).  A saturated feed
    keeps `depth` blocks in flight; a paced one (the radio) drains each
    block as soon as it is done.  Only the deque's head is drained, so
    the packets, their order and their stamps do not depend on which
    rule drained them; the drains the starved feed forced are counted
    as ``drains_starved``."""
    from .ingest import HostFeed
    plan = demod.plan
    nb = n_blocks if n_blocks is not None else plan.n_blocks
    state = _start(demod.init_state, demod.device, sinks_per_output, starts)
    feed = HostFeed(source, demod.device, depth=feed_depth)
    stream = feed.device_blocks(plan.block_len, nb)
    fetch = _HostFetch(demod.device)
    inflight = collections.deque()
    rows = 0
    pkt = 0
    t0 = time.perf_counter()

    def drain_one():
        nonlocal rows, pkt
        pendings, errs, t_in = inflight.popleft()
        spans.interval("sdr.inflight", pkt, t_in)
        for pending, sinks in zip(pendings, sinks_per_output):
            tok = spans.begin("sdr.drain.wait", pkt)
            data = fetch.result(pending)
            spans.end(tok)
            meta = PacketMeta(
                usrp_number=usrp_number, front_end_code=front_end,
                packet_number=pkt, length=int(data.size), errors=errs,
                channels=int(data.shape[1]))
            tok = spans.begin("sdr.drain.sinks", pkt)
            for s in sinks:
                s.on_packet(meta, data)
            spans.end(tok)
            rows += data.shape[0]
        pkt += 1

    try:
        for k, (x, errs) in enumerate(stream):
            blk = spans.begin("sdr.loop.block", k)
            tok = spans.begin("sdr.loop.step")
            state, ys = step(state, x)
            spans.end(tok)
            tok = spans.begin("sdr.fetch.start")
            outs = tuple(fetch.start(y) for y in ys)
            inflight.append((outs, errs, spans.end(tok)))
            spans.high("inflight_max", len(inflight))
            while len(inflight) > depth or (inflight and feed.starved()):
                if len(inflight) <= depth:
                    spans.add("drains_starved", 1)
                drain_one()
            spans.end(blk)
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
            _finish(sinks_per_output, demod.device)
    return PipelineResult(n_blocks=pkt, rows=rows, channels=demod.n_channels,
                          elapsed_s=elapsed,
                          samples_in=pkt * plan.block_len)
