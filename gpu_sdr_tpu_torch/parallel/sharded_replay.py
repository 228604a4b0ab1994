"""Device-resident replay under a mesh (port of
gpu_sdr_tpu/parallel/sharded_replay.py).

The single-device DeviceReplay (engine/replay.py) uploads a recording
once.  Under a mesh the recording is uploaded once with the blocks'
time axis already sharded: time shard t holds its span [b*L + t*Lt,
b*L + (t+1)*Lt) of every block b.  ``ShardedDeviceReplay`` picks one
sub-path per recording, in the JAX package's order:

* ``replay_kernel``: a looped DIRECT recording of whole blocks on a
  time-only mesh, the replay DDC kernel #10 per shard on its span, each
  block's FIR history rows staged at upload (ops/replay_ddc.
  ShardedReplayDDC);
* ``channelizer_at``: a looped TONES / NOISE recording on a time-only
  mesh, the channelizer kernel #5 per shard on its span, each block's
  halo frames staged at upload (ops/channelizer.channelizer_at_halo);
* ``scan``: anything else, the sharded demodulator's own step over the
  shards' resident spans, its halos riding the demodulator's ring.

The kernel sub-paths need no collective: the recording is static, so
the rows a shard's first output needs from the previous shard (or the
previous block) are copied once at upload.  ``ShardedSegmentedReplay``
serves a recording over the device budget: segments staged per shard
through pinned memory on a copy stream, as engine/replay.
SegmentedDeviceReplay does on one device.  The JAX package's K blocks
per execution, its lane padding and its Pallas / TF32 gates have no
counterpart (ROADMAP Queue 3).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..engine.demodulator import direct_config, make_demodulator, pfb_config
from ..engine.pipeline import PipelineResult, run_chunked
from ..engine import replay as replay_mod
from ..engine.replay import upload
from ..ops import pfb as pfb_ops
from ..ops.channelizer import (can_channelizer_at_halo, channelizer_at_halo,
                               channelizer_consts)
from ..ops.presum import shard_spans, staged_halos
from ..ops.replay_ddc import ShardedReplayDDC
from ..params import AntennaParams, WaveType
from .mesh import Mesh, Sharded


def _wave(rx: AntennaParams):
    return rx.wave_type[0] if rx.wave_type else None


def plan_sharded_replay_kernel(rx: AntennaParams, n: int, L: int,
                               loop: bool, mesh: Mesh) -> bool:
    """The gate of the replay_kernel sub-path: a looped DIRECT recording
    of whole blocks into a decimating receiver with pf_average >= 2, on
    a time-only mesh, that ShardedReplayDDC tiles."""
    if not (loop and n % L == 0 and _wave(rx) == WaveType.DIRECT and
            int(rx.decim) > 0 and int(rx.pf_average) >= 2):
        return False
    if mesh.Kc != 1:
        return False                 # the channel axis stays device-local
    return ShardedReplayDDC.plan_tiles(direct_config(rx), n, L,
                                       mesh.T) is not None


def plan_sharded_channelizer_replay(rx: AntennaParams, n: int, L: int,
                                    loop: bool, mesh: Mesh) -> bool:
    """The gate of the channelizer_at sub-path: a looped TONES / NOISE
    recording of whole blocks on a time-only mesh, whole frames and
    decimation groups per shard, that the channelizer takes."""
    if not (loop and n % L == 0 and
            _wave(rx) in (WaveType.TONES, WaveType.NOISE) and
            int(rx.fft_tones) > 0):
        return False
    if mesh.Kc != 1:
        return False
    nfft, decim = int(rx.fft_tones), int(rx.decim)
    if L % (mesh.T * nfft):
        return False
    ftl = L // (mesh.T * nfft)       # frames per shard per block
    if decim > 0 and ftl % decim:
        return False
    return can_channelizer_at_halo(pfb_config(rx), ftl, (n // L) * ftl)


class _ReplayKernel:
    """DIRECT through kernel #10 per time shard.  State: the replay
    DDC's (block index, int64 phase, started flag)."""

    path_name = "replay_kernel"

    def __init__(self, rx, X: torch.Tensor, L: int, mesh: Mesh):
        self.rk = ShardedReplayDDC(direct_config(rx), X, L,
                                   [mesh.device(t, 0) for t in range(mesh.T)])

    def init_state(self):
        return self.rk.init_state()

    def step(self, state):
        state, ys = self.rk.step(state)
        return state, Sharded([[y] for y in ys])


class _ChannelizerAtHalo:
    """TONES / NOISE through kernel #5 per time shard.  State: (block
    index, started flag); only shard 0 owns the stream's first frames,
    so the others' halo is always the stream's."""

    path_name = "channelizer_at"

    def __init__(self, rx, X: torch.Tensor, L: int, mesh: Mesh):
        cfg = pfb_config(rx)
        T, nfft = mesh.T, cfg.nfft
        self.T, self.decim = T, cfg.decim
        self.ftl = L // (T * nfft)
        frames = X.reshape(-1, nfft)
        self.nblk = frames.shape[0] // (T * self.ftl)
        devs = [mesh.device(t, 0) for t in range(T)]
        self.X = [s.to(d) for s, d in zip(
            shard_spans(frames, self.nblk, T), devs)]
        self.H = [h.to(d) for h, d in zip(
            staged_halos(frames, self.nblk, T, cfg.avg - 1), devs)]
        self.consts = [channelizer_consts(cfg, d) for d in devs]
        self.bins = [cfg.bins_tensor(d) for d in devs]

    def init_state(self):
        return (0, 0)

    def step(self, state):
        idx, started = state
        ys = []
        for t in range(self.T):
            y = channelizer_at_halo(*self.consts[t], self.X[t], self.H[t],
                                    idx, started if t == 0 else 1, self.ftl)
            if self.bins[t] is not None:
                y = pfb_ops.select_tones(y, self.bins[t])
            if self.decim > 0:
                y = pfb_ops.average_frames(y, self.decim)
            ys.append([y])
        return ((idx + 1) % self.nblk, 1), Sharded(ys)


class _ShardedScan:
    """The sharded demodulator's own step over the shards' spans of the
    resident recording, which holds one trailing zero block when not
    looped (the index wraps when looped and sticks there otherwise).
    State: (demodulator state, block index)."""

    path_name = "scan"

    def __init__(self, demod, X: torch.Tensor, nblk: int, loop: bool):
        mesh = demod.mesh
        self.demod, self.nblk, self.loop = demod, nblk, loop
        spans = shard_spans(X.reshape(-1, 1), X.shape[0] //
                            demod.plan.block_len, mesh.T)
        on = {}                      # one copy per (shard, device)

        def put(t, c, d):
            if (t, d) not in on:
                on[t, d] = spans[t].reshape(-1).to(d)
            return on[t, d]

        self.X = mesh.grid(put)
        self.Lt = demod.plan.block_len // mesh.T

    def init_state(self):
        return (self.demod.init_state(), 0)

    def step(self, state):
        st, idx = state
        Lt = self.Lt
        xs = [[x[idx * Lt:(idx + 1) * Lt] for x in row] for row in self.X]
        st, y = self.demod.step(st, xs)
        nxt = idx + 1
        nxt = nxt % self.nblk if self.loop else min(nxt, self.nblk)
        return (st, nxt), y


class ShardedDeviceReplay:
    """Demodulation of a recording uploaded once to a mesh.  ``path``
    names the sub-path (measure.LAST_DISPATCH's subpath)."""

    def __init__(self, rx: AntennaParams, data, mesh: Mesh,
                 loop: bool = True):
        self.rx, self.data, self.mesh, self.loop = rx, data, mesh, loop
        self.demod = make_demodulator(rx, mesh=mesh)
        L = self.demod.plan.block_len
        n = len(data)
        if n == 0:
            raise ValueError("sharded replay of an empty recording")
        if loop and n % L:
            raise ValueError(f"looped sharded replay needs whole blocks: "
                             f"{n} samples, blocks of {L}")
        if plan_sharded_replay_kernel(rx, n, L, loop, mesh):
            self.path = "replay_kernel"
        elif plan_sharded_channelizer_replay(rx, n, L, loop, mesh):
            self.path = "channelizer_at"
        else:
            self.path = "scan"
        if self.path == "scan":
            nblk = -(-n // L)
            X = upload(data, mesh.first, (nblk + (0 if loop else 1)) * L)
            self._chain = _ShardedScan(self.demod, X, nblk, loop)
        else:
            X = upload(data, mesh.first)
            cls = _ReplayKernel if self.path == "replay_kernel" \
                else _ChannelizerAtHalo
            self._chain = cls(rx, X, L, mesh)

    def init_state(self):
        return self._chain.init_state()

    def step(self, state):
        """One block: (state', Sharded y (rows, channels))."""
        return self._chain.step(state)

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        plan = self.demod.plan
        return run_chunked(self.step, self.init_state, plan.n_blocks,
                           plan.block_len, self.demod.n_channels,
                           plan.total_out_rows, self.mesh.first, sinks,
                           usrp_number=usrp_number, front_end=front_end)


class ShardedSegmentedReplay:
    """Replay of a recording over the device budget under a mesh,
    segment by segment: the sharded form of engine/replay.
    SegmentedDeviceReplay, with its three guards per shard.  Segment s+1
    is copied, each time shard's span of each of its blocks into that
    shard's pinned buffer, and sent to the shard's device on a copy
    stream the moment segment s starts; the sharded demodulator's state
    carries across segments as across blocks.  ``stage_seconds`` keeps
    the host time of each segment's staging."""

    def __init__(self, rx: AntennaParams, data, mesh: Mesh,
                 loop: bool = False, segment_bytes: Optional[int] = None):
        self.rx, self.data, self.mesh, self.loop = rx, data, mesh, loop
        self.demod = make_demodulator(rx, mesh=mesh)
        self.L = L = self.demod.plan.block_len
        n = len(data)
        if n == 0:
            raise ValueError("segmented replay of an empty recording")
        if loop and n % L:
            raise ValueError(f"looped segmented replay needs whole blocks: "
                             f"{n} samples, blocks of {L}")
        self.nblk_rec = -(-n // L)
        budget = segment_bytes or replay_mod.DEVICE_REPLAY_MAX_BYTES // 4
        self.seg_blocks = max(1, budget // (L * 8))
        self.stage_seconds: list = []
        # the devices that receive each time shard's spans, once each
        self._dests = [sorted({mesh.device(t, c) for c in range(mesh.Kc)},
                              key=str) for t in range(mesh.T)]

    def _fill(self, b0: int, out: np.ndarray) -> None:
        """Blocks [b0, b0 + seg_blocks) of the stream into `out` (seg_blocks,
        L): wrapping when looped, zero past the recording when not."""
        n, L = len(self.data), self.L
        flat = out.reshape(-1)
        filled, pos = 0, b0 * L % n if self.loop else b0 * L
        while filled < len(flat):
            if pos >= n:
                if not self.loop:
                    flat[filled:] = 0
                    return
                pos = 0
            take = min(len(flat) - filled, n - pos)
            flat[filled:filled + take] = self.data[pos:pos + take]
            filled, pos = filled + take, pos + take

    def _stage(self, s: int):
        """Start the upload of segment s: per time shard, {device: (tensor
        (seg_blocks, Lt), ready event or None)}."""
        t0 = time.perf_counter()
        S, L, T = self.seg_blocks, self.L, self.mesh.T
        Lt = L // T
        seg = self._host[s % 2] if self._host else np.empty((S, L),
                                                            np.complex64)
        if self._done[s % 2] is not None:
            for ev in self._done[s % 2]:
                ev.synchronize()        # the buffer's last copies landed
        self._fill(s * S, seg)
        out, events = [], []
        for t in range(T):
            span = seg[:, t * Lt:(t + 1) * Lt]
            if self._pinned:
                pinned = self._pinned[s % 2][t]
                pinned.numpy()[:] = span
            shard = {}
            for d in self._dests[t]:
                if d.type != "cuda":
                    shard[d] = (torch.from_numpy(span.copy()).to(d), None)
                    continue
                with torch.cuda.stream(self._copy[d]):
                    x = pinned.to(d, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy[d])
                events.append(ready)
                shard[d] = (x, ready)
            out.append(shard)
        self._done[s % 2] = events or None
        self.stage_seconds.append(time.perf_counter() - t0)
        return out

    def _enter(self, staged):
        """Segment `staged`, ready for the compute streams."""
        out = []
        for shard in staged:
            ready_shard = {}
            for d, (x, ready) in shard.items():
                if ready is not None:
                    compute = torch.cuda.current_stream(d)
                    compute.wait_event(ready)
                    x.record_stream(compute)
                ready_shard[d] = x
            out.append(ready_shard)
        return out

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        plan, mesh = self.demod.plan, self.mesh
        S, L, T = self.seg_blocks, self.L, mesh.T
        n_seg = -(-plan.n_blocks // S)
        slot = {}

        def init():
            self.stage_seconds = []
            cuda = sorted({d for ds in self._dests for d in ds
                           if d.type == "cuda"}, key=str)
            self._copy = {d: torch.cuda.Stream(device=d) for d in cuda}
            self._host = []
            self._pinned = []
            if cuda:
                self._pinned = [[torch.empty((S, L // T),
                                             dtype=torch.complex64,
                                             pin_memory=True)
                                 for _ in range(T)]
                                for _ in range(min(n_seg, 2))]
                self._host = [np.empty((S, L), np.complex64)
                              for _ in range(min(n_seg, 2))]
            self._done = [None, None]
            slot["cur"] = self._enter(self._stage(0))
            slot["nxt"] = self._stage(1) if n_seg > 1 else None
            slot["b"] = 0
            return self.demod.init_state()

        def step(state):
            b = slot["b"]
            if b and b % S == 0:            # entering segment b // S
                s = b // S
                slot["cur"] = self._enter(slot["nxt"])
                slot["nxt"] = self._stage(s + 1) if s + 1 < n_seg else None
            j = b % S
            cur = slot["cur"]
            xs = mesh.grid(lambda t, c, d: cur[t][d][j])
            state, y = self.demod.step(state, xs)
            slot["b"] = b + 1
            return state, y

        return run_chunked(step, init, plan.n_blocks, L,
                           self.demod.n_channels, plan.total_out_rows,
                           mesh.first, sinks, usrp_number=usrp_number,
                           front_end=front_end)
