"""The streaming pipeline host loop (port of gpu_sdr_tpu/engine/pipeline.py).

One host loop over per-block steps (_loop), for every path: the
host-fed demodulators (run_pipeline, run_pipeline_mixed), the device
chains and replays (run_chunked) and the front ends in lock-step
(engine/dual.py).  PyTorch launches asynchronously, so the loop keeps a
short queue of in-flight results: block i's output is copied to pinned
host memory on a separate CUDA stream while block i+1 computes (the
reference's pinned-buffer double buffering,
headers/USRP_server_memory_management.hpp:103-273).  A host-fed block
goes to the sinks as soon as its copy has landed whenever the feed has
no next block waiting (the reference's RX worker synchronises on each
buffer's own copy and pushes that buffer to its stream queue at once,
cpp/USRP_server_link_threads.cpp:604-702), and at the latest once block
i+depth has been launched, when blocks keep arriving and block i+1's
kernels can overlap block i's copy.  Packets go out in block order
either way.  A step may give several outputs (a mixed-mode antenna's
groups, the lock-step front ends): each takes its own copy and its own
sinks.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import spans
from ..parallel.mesh import Sharded
from .demodulator import Demodulator
from .ingest import HostFeed
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


def _loop(step, init_state, device, outputs, n_blocks: int,
          block_len: int, usrp_number: int = 0, feed=None,
          depth: int = 1, group: int = 1) -> List[PipelineResult]:
    """The host loop of every path: `step(state, x) -> (state, outputs)`,
    output k drained to the sinks of outputs[k], a (sinks, front_end,
    (channels, rows)) triple, whose sinks start with (channels, rows).
    With a HostFeed `feed`, x is each of its device blocks (n_blocks at
    most) and its error count stamps the block's packets; without one
    (the device chains), x is the block count of each step: `group`,
    n_blocks // group times, then the rest.  A step of nb blocks gives
    each output as the nb blocks' outputs stacked, one copy to the host
    a step; each block is drained as its own packet, from its rows of
    that copy.

    After each launch the oldest block in flight is drained while more
    than `depth` are in flight, or while the feed has no staged block
    waiting (``HostFeed.starved``): the loop would wait for the next
    block anyway, so it waits on the oldest block's copy instead and
    hands it over at once, as the reference's RX worker pushes each
    buffer after its own copy (SURVEY.md:236-239).  A saturated feed
    keeps `depth` blocks in flight; a paced one (the radio) drains each
    block as soon as it is done; a device chain at depth 1 launches
    block k, starts its copy, then drains block k-1.  Only the deque's
    head is drained, so the packets, their order and their stamps do
    not depend on which rule drained them; the drains the starved feed
    forced are counted as ``drains_starved``.  The state is built
    (``sdr.setup.state``) and the card synchronised (``sdr.setup.sync``)
    before ``sdr.stream`` opens and the sinks start: it is set-up.  The
    deque holds a block an entry, and a step of nb blocks drains down to
    depth * nb, so a device chain of K-block steps keeps one step in
    flight.  One PipelineResult an output."""
    with spans.once("sdr.setup.state"):
        state = init_state()
    with spans.once("sdr.setup.sync"):
        # set-up ends here: on a card, wait for the work queued so far
        # (an oscillator table, a recording), so the sinks start on a
        # finished state and the streaming window holds only the stream
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    spans.stream_started(device)
    for sinks, _fe, (channels, total_rows) in outputs:
        for s in sinks:
            s.on_start(channels, total_rows)
    if feed is not None:
        stream = feed.device_blocks(block_len, n_blocks)
    else:
        q, r = divmod(n_blocks, group)
        stream = itertools.chain(itertools.repeat((group, 0), q),
                                 [(r, 0)] if r else [])
    fetch = _HostFetch(device)
    inflight = collections.deque()
    rows = [0] * len(outputs)
    pkt = 0
    t0 = time.perf_counter()

    def drain_one():
        nonlocal pkt
        pendings, errs, t_in, j, nb = inflight.popleft()
        n, pkt = pkt, pkt + 1      # a block keeps its number if a sink raises
        spans.interval("sdr.inflight", n, t_in)
        for i, (pending, (sinks, front_end, _)) in enumerate(
                zip(pendings, outputs)):
            tok = spans.begin("sdr.drain.wait", n)
            data = fetch.result(pending)
            spans.end(tok)
            if nb > 1:             # block j's rows of its step's copy
                m = data.shape[0] // nb
                data = data[j * m:(j + 1) * m]
            meta = PacketMeta(
                usrp_number=usrp_number, front_end_code=front_end,
                packet_number=n, length=int(data.size), errors=errs,
                channels=int(data.shape[1]))
            tok = spans.begin("sdr.drain.sinks", n)
            for s in sinks:
                s.on_packet(meta, data)
            spans.end(tok)
            rows[i] += data.shape[0]

    try:
        k = 0                      # the step's first block
        for x, errs in stream:
            nb = 1 if feed is not None else x
            blk = spans.begin("sdr.loop.block", k)
            tok = spans.begin("sdr.loop.step")
            state, ys = step(state, x)
            spans.end(tok)
            tok = spans.begin("sdr.fetch.start")
            outs = tuple(map(fetch.start, ys))
            t_in = spans.end(tok)
            if nb == 1:
                inflight.append((outs, errs, t_in, 0, 1))
            else:
                inflight.extend((outs, errs, t_in, j, nb) for j in range(nb))
            spans.high("inflight_max", len(inflight))
            held = depth * nb
            while len(inflight) > held or (
                    feed is not None and inflight and feed.starved()):
                if len(inflight) <= held:
                    spans.add("drains_starved", 1)
                drain_one()
            spans.end(blk)
            k += nb
        while inflight:
            drain_one()
    finally:
        # on interruption still flush what was computed and close the
        # sinks (the reference's keyboard_disconnect path,
        # pyUSRP/USRP_connections.py:976-993)
        elapsed = time.perf_counter() - t0
        if feed is not None:
            stream.close()        # stops and joins the feeder thread
        try:
            while inflight:
                drain_one()
        finally:
            for sinks, _fe, _st in outputs:
                for s in sinks:
                    s.on_end()
            spans.stream_ended(device)
    return [PipelineResult(n_blocks=pkt, rows=r, channels=start[0],
                           elapsed_s=elapsed, samples_in=pkt * block_len)
            for r, (_sinks, _fe, start) in zip(rows, outputs)]


def run_chunked(step, init_state, n_blocks: int, block_len: int,
                channels: int, total_rows: int, device,
                sinks: Sequence[Sink] = (), usrp_number: int = 0,
                front_end: str = "A", group: int = 1) -> PipelineResult:
    """Acquisition loop of the on-device chains (engine/fused.py): no
    host input; `step(state) -> (state, y)` produces one block's
    (rows, channels) output, `n_blocks` times, with one block in flight
    while the previous drains to the sinks (_loop at depth 1).  With
    `group` K above 1, `step(state, nb) -> (state, y)` produces nb <= K
    blocks' outputs stacked, (nb * rows, channels), and one step of
    blocks is in flight (engine/replay.DeviceReplay's CUDA graphs of K
    blocks).  The state is built before the sinks start: it is set-up."""
    def step_one(state, nb):
        state, y = step(state, nb) if group > 1 else step(state)
        return state, (y,)
    return _loop(step_one, init_state, device,
                 [(sinks, front_end, (channels, total_rows))], n_blocks,
                 block_len, usrp_number, group=group)[0]


def run_pipeline(demod: Demodulator, source: Source,
                 sinks: Sequence[Sink] = (), n_blocks: Optional[int] = None,
                 usrp_number: int = 0, front_end: str = "A",
                 depth: int = 2, feed_depth: int = 2) -> PipelineResult:
    """Stream `n_blocks` blocks from `source` through the demodulator
    into the sinks.  Ingest runs through a HostFeed (engine/ingest.py)
    `feed_depth` blocks ahead, so the host->device copy of block i+1
    overlaps the compute of block i.  A block goes to the sinks once its
    device->host copy has landed if the feed has no block waiting, else
    once `depth` later blocks have been launched (_loop).  The
    demodulator's state is built before the sinks start: it is set-up."""
    def step(state, x):
        state, y = demod.step(state, x)
        return state, (y,)
    plan = demod.plan
    return _loop(step, demod.init_state, demod.device,
                 [(sinks, front_end,
                   (demod.n_channels, plan.total_out_rows))],
                 n_blocks if n_blocks is not None else plan.n_blocks,
                 plan.block_len, usrp_number,
                 HostFeed(source, demod.device, depth=feed_depth), depth)[0]


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
    plan = mdemod.plan
    res = _loop(mdemod.step, mdemod.init_state, mdemod.device,
                [(sinks, front_end, (g.demod.n_channels,
                                     g.demod.plan.total_out_rows))
                 for sinks, g in zip(sinks_per_group, mdemod.groups)],
                n_blocks if n_blocks is not None else plan.n_blocks,
                plan.block_len, usrp_number,
                HostFeed(source, mdemod.device, depth=feed_depth), depth)
    return dataclasses.replace(res[0], rows=sum(r.rows for r in res),
                               channels=mdemod.n_channels)
