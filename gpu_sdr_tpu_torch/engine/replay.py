"""Device-resident replay: demodulate a recorded IQ stream from device
memory (port of gpu_sdr_tpu/engine/replay.py).

The host-fed replay (engine/sources.ReplaySource -> run_pipeline) moves
every block over the host link.  A recording that fits the device
budget is instead uploaded once, at set-up, and every block is read
from device memory: no generator, no per-block host->device copy, no
feeder thread.  ``DeviceReplay`` picks one sub-path per recording, in
the JAX package's order (``replay_path``):

* ``replay_kernel_t`` / ``replay_kernel``: DIRECT, the replay DDC
  kernels #9 / #8 over the recording (ops/replay_ddc);
* ``channelizer_at``: TONES / NOISE, the channelizer kernel #4 reading
  each block's frames in place (ops/channelizer.channelizer_at);
* ``pfb_at``: TONES / NOISE where the channelizer does not fit, the
  pre-sum kernel #6 in place (ops/presum.presum_at), then the FFT;
* ``chirp_table``: CHIRP, a one-period oscillator table and the table
  lock-in kernel #17 (ops/lockin_table.lockin_table);
* ``chirp_at``: CHIRP where no table fits, the lock-in kernel #18 with
  the chirp formed in the kernel (ops/lockin_at);
* ``scan``: anything else (a recording that is not looped, or not whole
  blocks), the demodulator's own step over views of the recording.

The kernel sub-paths need a looped recording of whole blocks.  Each
sub-path is a chain (``path_name``, ``init_state``, ``step``) driven by
engine/pipeline.run_chunked, one block per step, as engine/fused.py's
chains are.  Block indices and stream positions are Python ints, so
nothing on the card waits for the host.  On a card, a chain whose
launches depend on the block index alone (``graph_groups``:
``replay_kernel``, ``replay_kernel_t``, ``channelizer_at``) runs K
blocks a step instead, each step the replay of one CUDA graph of its K
per-block steps (_GraphGroups).  ``SegmentedDeviceReplay`` serves a
recording over the budget: segments staged through pinned memory on a
copy stream while the previous one is demodulated.

Not ported: the JAX package's K blocks per kernel launch (a graph here
replays one launch a block; the outputs are the same), its lane padding
of the channel list (``pad_rx_freqs``: outputs carry ``len(rx.freq)``
channels), its Pallas switch and precision gate, and the transposed
recording layout of its channelizer kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import kernels, spans
from ..config import resolve_device
from ..ops import chirp as chirp_ops
from ..ops import pfb as pfb_ops
from ..ops.channelizer import (can_fuse_channelizer, channelizer_at,
                               channelizer_consts)
from ..ops.lockin import lockin_profile
from ..ops.lockin_at import lockin_at
from ..ops.lockin_table import lockin_table
from ..ops.presum import presum_at
from ..ops.replay_ddc import make_replay_ddc, replay_ddc_kind
from ..params import AntennaParams, WaveType
from .demodulator import direct_config, make_demodulator, pfb_config
from .pipeline import PipelineResult, run_chunked
from .sources import ArraySource, ReplaySource

# the device budget of a recording uploaded once (the JAX package's);
# a larger one takes SegmentedDeviceReplay
DEVICE_REPLAY_MAX_BYTES = 2 << 30
UPLOAD_CHUNK = 1 << 22              # samples per host->device copy (32 MB)
GROUP_BLOCKS = 8                    # blocks a CUDA graph replays, at most


def _wave(rx: AntennaParams):
    return rx.wave_type[0] if rx.wave_type else None


def plan_replay_kernel(rx: AntennaParams, n: int, L: int, loop: bool):
    """'replay_kernel_t' / 'replay_kernel' / None: a looped DIRECT
    recording of whole blocks into a decimating receiver with
    pf_average >= 2, through ops/replay_ddc.replay_ddc_kind."""
    if not (loop and n % L == 0 and _wave(rx) == WaveType.DIRECT and
            int(rx.decim) > 0 and int(rx.pf_average) >= 2):
        return None
    return replay_ddc_kind(direct_config(rx), n, L)


def plan_channelizer_replay(rx: AntennaParams, n: int, L: int,
                            loop: bool) -> bool:
    """A looped TONES / NOISE recording of whole blocks that the
    channelizer kernel takes (ops/channelizer.can_fuse_channelizer), its
    frames a whole number of decimation groups per block."""
    if not (loop and n % L == 0 and
            _wave(rx) in (WaveType.TONES, WaveType.NOISE) and
            int(rx.fft_tones) > 0):
        return False
    cfg = pfb_config(rx)
    if cfg.decim > 0 and (L // cfg.nfft) % cfg.decim:
        return False
    return can_fuse_channelizer(cfg, L)


def plan_pfb_replay(rx: AntennaParams, n: int, L: int, loop: bool) -> bool:
    """A looped TONES / NOISE recording of whole blocks of whole frames
    with pf_average >= 2: the pre-sum kernel in place, then the FFT.
    DeviceReplay tries it after the channelizer, which it serves where
    the channelizer's G_k1 does not fit one block's shared memory."""
    nfft, avg, decim = int(rx.fft_tones), int(rx.pf_average), int(rx.decim)
    if not (loop and n % L == 0 and
            _wave(rx) in (WaveType.TONES, WaveType.NOISE) and nfft > 0 and
            avg >= 2 and L % nfft == 0):
        return False
    return decim == 0 or (L // nfft) % decim == 0


def plan_chirp_replay(rx: AntennaParams, n: int, L: int, loop: bool):
    """'chirp_table' / 'chirp_at' / None: a looped CHIRP recording of
    whole blocks of whole lock-in segments takes the table lock-in where
    the one-period table fits (ops/chirp.chirp_table_fits), else the
    lock-in with the chirp formed in the kernel."""
    if not (loop and n % L == 0 and _wave(rx) == WaveType.CHIRP and
            int(rx.decim) >= 1):
        return None
    cfg = chirp_ops.chirp_config(rx)
    ppt = cfg.length * int(rx.decim)
    if L % ppt:
        return None
    return "chirp_table" if chirp_ops.chirp_table_fits(cfg, L, ppt) \
        else "chirp_at"


def replay_path(rx: AntennaParams, n: int, L: int, loop: bool) -> str:
    """The sub-path DeviceReplay takes for a recording of n samples in
    blocks of L, in the JAX package's try-order."""
    kind = plan_replay_kernel(rx, n, L, loop)
    if kind is not None:
        return kind
    if plan_channelizer_replay(rx, n, L, loop):
        return "channelizer_at"
    if plan_pfb_replay(rx, n, L, loop):
        return "pfb_at"
    return plan_chirp_replay(rx, n, L, loop) or "scan"


def upload(data, device, length: Optional[int] = None) -> torch.Tensor:
    """A recording (numpy, or a memmap) as one complex64 tensor on
    `device`, zero-padded to `length` samples: read once, in chunks of
    UPLOAD_CHUNK samples through one staging buffer (pinned for a card),
    so a memmap is never copied whole on the host.  A recording that
    does not fit on the card raises."""
    n = len(data)
    length = n if length is None else int(length)
    X = torch.empty(length, dtype=torch.complex64, device=device)
    stage = torch.empty(min(n, UPLOAD_CHUNK), dtype=torch.complex64,
                        pin_memory=X.device.type == "cuda")
    for a in range(0, n, UPLOAD_CHUNK):
        m = min(UPLOAD_CHUNK, n - a)
        stage.numpy()[:m] = data[a:a + m]
        X[a:a + m].copy_(stage[:m])      # synchronous: the buffer is free
    X[n:].zero_()
    return X


class _ChannelizerAt:
    """TONES / NOISE through the channelizer kernel reading block `idx`
    of the recording's frames in place.  State: (block index, started
    flag); the halo of the stream's first block is zero, of every later
    one the frames before it (the loop seam included).  Spans:
    ``sdr.pfb.channelize``, ``sdr.pfb.select``."""

    path_name = "channelizer_at"
    graph_groups = True

    def __init__(self, cfg: pfb_ops.PFBConfig, X: torch.Tensor, L: int,
                 device):
        self.T, self.decim = L // cfg.nfft, cfg.decim
        self.X = X.reshape(-1, cfg.nfft)
        self.nblk = self.X.shape[0] // self.T
        self.consts = channelizer_consts(cfg, device)
        self.bins = cfg.bins_tensor(device)

    def init_state(self):
        return (0, 0)

    def step(self, state):
        idx, started = state
        tok = spans.begin("sdr.pfb.channelize")
        y = channelizer_at(*self.consts, self.X, idx, started, self.T)
        spans.end(tok)
        if self.bins is not None:
            tok = spans.begin("sdr.pfb.select")
            y = pfb_ops.select_tones(y, self.bins)
            spans.end(tok)
        if self.decim > 0:
            y = pfb_ops.average_frames(y, self.decim)
        return ((idx + 1) % self.nblk, 1), y


class _PfbAt:
    """TONES / NOISE through the pre-sum kernel reading the recording in
    place, then torch.fft.fft, frame averaging and tone selection in the
    host-fed demodulator's order.  State: (block index, started flag), as
    _ChannelizerAt's.  Spans: ``sdr.pfb.presum``, ``.fft``, ``.select``."""

    path_name = "pfb_at"

    def __init__(self, cfg: pfb_ops.PFBConfig, X: torch.Tensor, L: int,
                 device):
        self.T, self.decim = L // cfg.nfft, cfg.decim
        self.X = X.reshape(-1, cfg.nfft)
        self.nblk = self.X.shape[0] // self.T
        self.window2d = cfg.window(device).reshape(cfg.avg, cfg.nfft)
        self.bins = cfg.bins_tensor(device)

    def init_state(self):
        return (0, 0)

    def step(self, state):
        idx, started = state
        tok = spans.begin("sdr.pfb.presum")
        pre = presum_at(self.window2d, self.X, idx, started, self.T)
        spans.end(tok)
        tok = spans.begin("sdr.pfb.fft")
        y = torch.fft.fft(pre, dim=-1)
        spans.end(tok)
        if self.decim > 0:
            y = pfb_ops.average_frames(y, self.decim)
        if self.bins is not None:
            tok = spans.begin("sdr.pfb.select")
            y = pfb_ops.select_tones(y, self.bins)
            spans.end(tok)
        return ((idx + 1) % self.nblk, 1), y


class _ChirpTable:
    """CHIRP through the table lock-in kernel: one period of the chirp
    as oscillator rows, the recording as signal rows.  The oscillator
    block wraps mod period // L, the recording block mod the recording:
    they differ whenever the recording is not one period long.  State:
    (stream position, oscillator block, recording block), Python ints."""

    path_name = "chirp_table"

    def __init__(self, cfg: chirp_ops.ChirpConfig, X: torch.Tensor, L: int,
                 ppt: int, device):
        self.cfg, self.L, self.nseg = cfg, L, L // ppt
        self.X = X.reshape(-1, ppt)
        self.nblk = self.X.shape[0] // self.nseg
        self.nblk_osc = cfg.period // L
        self.profile = torch.from_numpy(lockin_profile(ppt)).to(device)
        self.table = chirp_ops.chirp_period_table(cfg, L, ppt, device=device)

    def init_state(self):
        return (0, 0, 0)

    def step(self, state):
        last, o, i = state
        y = lockin_table(self.profile, self.table, self.X, o, i, self.nseg)
        return ((chirp_ops.advance(self.cfg, last, self.L),
                 (o + 1) % self.nblk_osc, (i + 1) % self.nblk), y[:, None])


class _ChirpAt:
    """CHIRP through the lock-in kernel that forms the chirp from the
    stream position.  State: (stream position, recording block)."""

    path_name = "chirp_at"

    def __init__(self, cfg: chirp_ops.ChirpConfig, X: torch.Tensor, L: int,
                 ppt: int, device):
        self.cfg, self.nseg = cfg, L // ppt
        self.X = X.reshape(-1, ppt)
        self.nblk = self.X.shape[0] // self.nseg
        self.profile = torch.from_numpy(lockin_profile(ppt)).to(device)

    def init_state(self):
        return (0, 0)

    def step(self, state):
        last, i = state
        last, y = lockin_at(self.cfg, self.profile, last, self.X, i,
                            self.nseg)
        return (last, (i + 1) % self.nblk), y[:, None]


class _Scan:
    """The demodulator's own step over views X[idx*L:(idx+1)*L] of the
    resident recording, which holds one trailing zero block when not
    looped: the index wraps when looped and sticks at the zero block
    otherwise, as the host-fed source pads past the recording's end.
    State: (demodulator state, block index)."""

    path_name = "scan"

    def __init__(self, demod, X: torch.Tensor, nblk: int, loop: bool):
        self.demod, self.X, self.nblk, self.loop = demod, X, nblk, loop
        self.L = demod.plan.block_len

    def init_state(self):
        return (self.demod.init_state(), 0)

    def step(self, state):
        st, idx = state
        st, y = self.demod.step(st, self.X[idx * self.L:(idx + 1) * self.L])
        nxt = idx + 1
        nxt = nxt % self.nblk if self.loop else min(nxt, self.nblk)
        return (st, nxt), y


def group_blocks(nblk: int) -> int:
    """The blocks a step of a recording of nblk blocks: the largest
    divisor of nblk up to GROUP_BLOCKS, so that the groups start on the
    same blocks in every pass over the recording."""
    return max(k for k in range(1, GROUP_BLOCKS + 1) if nblk % k == 0)


def _key(state) -> tuple:
    """A chain state's Python numbers: what a captured graph bakes in."""
    return tuple(v for v in state if not isinstance(v, torch.Tensor))


class _GraphGroups:
    """K consecutive blocks of a chain a step, ``step(state, nb)``: the
    nb blocks' outputs stacked, (nb * rows, C).  `step` is the chain's
    one-block step, over a recording of `nblk` blocks; the chain
    declares ``graph_groups``: its launches depend on its state's Python
    numbers (block index, started flag) alone, and its state's tensors
    (the DDC replay's phase) are its only device state.

    The set-up runs the stream's first K blocks eagerly, so the kernels,
    the allocator and the libraries are ready, then captures a CUDA
    graph for each group start the stream reaches from there: nblk / K
    graphs, one memory pool.  A graph runs the K steps as they are,
    copies each block's output into one static (K * rows, C) buffer and
    the last state's tensors back into static tensors, which every graph
    reads.  A step from a state with a graph replays it and returns a
    copy of the buffer, made before the next replay can overwrite it;
    any other step (the stream's first group, its tail) runs the chain
    eagerly.  The kernels' launch counters count one launch a block
    run, the warm-up's included, and none for the capture; spans'
    ``graph_blocks`` counts the blocks replayed."""

    def __init__(self, step, init_state, nblk: int, K: int, device):
        self._step, self._init = step, init_state
        self.nblk, self.K, self.device = nblk, K, device
        self._graphs = {}

    def init_state(self):
        state = self._init()
        self._capture(state)
        return state

    def _capture(self, state) -> None:
        K = self.K
        for _ in range(K):          # the warm-up: its outputs are dropped
            state, y = self._step(state)
        wrappers = kernels.wrappers()
        counts = {k: w.launches for k, w in wrappers.items()}
        rows = y.shape[0]
        self._out = y.new_empty((K * rows,) + tuple(y.shape[1:]))
        self._pos = [i for i, v in enumerate(state)
                     if isinstance(v, torch.Tensor)]
        self._static = [state[i].clone() for i in self._pos]
        state = self._with_static(state)
        with self._capturing() as graph_of:
            while _key(state) not in self._graphs and \
                    len(self._graphs) < self.nblk // K:
                before = kernels.launch_counts()
                graph, st = graph_of(functools.partial(self._group, state,
                                                      rows))
                after = kernels.launch_counts()
                counted = [(wrappers[k], after[k] - before[k])
                           for k in after if after[k] != before[k]]
                st = self._with_static(st)
                self._graphs[_key(state)] = (graph, st, counted)
                state = st
        for k, w in wrappers.items():
            w.launches = counts[k]

    def _group(self, state, rows: int):
        """What a graph holds: K steps from `state`, each output into
        its rows of the static buffer, the last state's tensors into the
        static ones; the last state."""
        for j in range(self.K):
            state, y = self._step(state)
            self._out[j * rows:(j + 1) * rows].copy_(y)
        for i, t in zip(self._pos, self._static):
            t.copy_(state[i])
        return state

    @contextlib.contextmanager
    def _capturing(self):
        """``graph_of(fn) -> (graph, fn())``: a CUDA graph of fn, each
        captured on one side stream into one memory pool."""
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))

        def graph_of(fn):
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
            return graph, out
        with torch.cuda.stream(side):
            yield graph_of
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _with_static(self, state) -> tuple:
        state = list(state)
        for i, t in zip(self._pos, self._static):
            state[i] = t
        return tuple(state)

    def step(self, state, nb: int):
        hit = self._graphs.get(_key(state)) if nb == self.K else None
        if hit is None:
            ys = []
            for _ in range(nb):
                state, y = self._step(state)
                ys.append(y)
            return state, ys[0] if nb == 1 else torch.cat(ys)
        graph, state_out, counted = hit
        for i, t in zip(self._pos, self._static):
            if state[i] is not t:
                t.copy_(state[i])
        graph.replay()
        for w, n in counted:
            w.launches += n
        spans.add("graph_blocks", nb)
        return state_out, self._out.clone()


@dataclasses.dataclass
class DeviceReplay:
    """Demodulation of a recording uploaded once to `device`.  ``path``
    names the sub-path (measure.LAST_DISPATCH's subpath)."""

    rx: AntennaParams
    data: np.ndarray                  # complex64 recording (may be a memmap)
    loop: bool = True
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.demod = make_demodulator(self.rx, self.device)
        L = self.demod.plan.block_len
        n = len(self.data)
        if n == 0:
            raise ValueError("device replay of an empty recording")
        if self.loop and n % L:
            raise ValueError(f"looped device replay needs whole blocks: "
                             f"{n} samples, blocks of {L}")
        self.path = replay_path(self.rx, n, L, self.loop)
        self._chain = self._build(L, n)

    def _build(self, L: int, n: int):
        rx, dev, path = self.rx, self.device, self.path
        if path == "scan":
            nblk = -(-n // L)
            X = upload(self.data, dev, (nblk + (0 if self.loop else 1)) * L)
            return _Scan(self.demod, X, nblk, self.loop)
        X = upload(self.data, dev)
        if path in ("replay_kernel_t", "replay_kernel"):
            return make_replay_ddc(direct_config(rx), X, L, dev)
        if path == "channelizer_at":
            return _ChannelizerAt(pfb_config(rx), X, L, dev)
        if path == "pfb_at":
            return _PfbAt(pfb_config(rx), X, L, dev)
        cfg = chirp_ops.chirp_config(rx)
        ppt = cfg.length * int(rx.decim)
        chain = _ChirpTable if path == "chirp_table" else _ChirpAt
        return chain(cfg, X, L, ppt, dev)

    def init_state(self):
        return self._chain.init_state()

    def step(self, state):
        """One block: (state', y (rows, channels))."""
        return self._chain.step(state)

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        """Demodulate the acquisition (rx.samples) into the sinks, one
        packet per block, graph_group() blocks a step: above 1, each
        step a CUDA graph's replay (_GraphGroups)."""
        plan, K = self.demod.plan, self.graph_group()
        step, init_state = self.step, self.init_state
        if K > 1:
            groups = _GraphGroups(self.step, self.init_state,
                                  self._chain.nblk, K, self.device)
            step, init_state = groups.step, groups.init_state
        return run_chunked(step, init_state, plan.n_blocks,
                           plan.block_len, self.demod.n_channels,
                           plan.total_out_rows, self.device, sinks,
                           usrp_number=usrp_number, front_end=front_end,
                           group=K)

    def graph_group(self) -> int:
        """The blocks a step of run(): on a card, group_blocks(nblk) for
        a chain that declares ``graph_groups``; else 1 (no CUDA graph to
        capture)."""
        chain = self._chain
        if self.device.type != "cuda" or \
                not getattr(chain, "graph_groups", False):
            return 1
        return group_blocks(chain.nblk)


def _recording_bytes(source) -> int:
    """The bytes of a recording source's samples (complex64), 0 for any
    other source."""
    if not isinstance(source, (ReplaySource, ArraySource)):
        return 0
    data = getattr(source, "data", None)
    return 0 if data is None else int(data.size) * 8


def can_device_replay(source) -> bool:
    """A recording within DEVICE_REPLAY_MAX_BYTES: DeviceReplay."""
    return 0 < _recording_bytes(source) <= DEVICE_REPLAY_MAX_BYTES


def can_segmented_replay(source) -> bool:
    """A recording over DEVICE_REPLAY_MAX_BYTES: SegmentedDeviceReplay,
    not the per-block host-fed pipeline."""
    return _recording_bytes(source) > DEVICE_REPLAY_MAX_BYTES


@dataclasses.dataclass
class SegmentedDeviceReplay:
    """Replay of a recording larger than the device budget, segment by
    segment.

    The recording is cut into segments of ``seg_blocks`` blocks
    (``max(1, segment_bytes // (L * 8))``; the default budget is a
    quarter of DEVICE_REPLAY_MAX_BYTES, two segments being on the card
    at once).  On a card, segment s+1 is copied into one of two pinned
    host buffers and sent with a ``non_blocking`` copy on a copy stream
    the moment segment s starts, so the host->device copy overlaps the
    demodulation.  Three guards: the compute stream waits on the copy's
    event before it reads a segment; a pinned buffer is refilled only
    after its last copy has completed; a segment's device memory is
    tied to the compute stream (``record_stream``) so it is not reused
    while still read.  The demodulator's state carries across segments
    as across blocks, so the output equals the host-fed path's.  The
    state is (demodulator state, block index): after init_state, a
    replay resumes from a saved state at any block, a segment boundary
    included.  Each segment's staging is an ``sdr.replay.stage_segment``
    span (spans.py), its id the segment's first block."""

    rx: AntennaParams
    data: np.ndarray                  # complex64 recording (may be a memmap)
    loop: bool = False
    segment_bytes: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.demod = make_demodulator(self.rx, self.device)
        self.L = L = self.demod.plan.block_len
        n = len(self.data)
        if n == 0:
            raise ValueError("segmented replay of an empty recording")
        if self.loop and n % L:
            raise ValueError(f"looped segmented replay needs whole blocks: "
                             f"{n} samples, blocks of {L}")
        self.nblk_rec = -(-n // L)
        budget = self.segment_bytes or DEVICE_REPLAY_MAX_BYTES // 4
        self.seg_blocks = max(1, budget // (L * 8))

    def _fill(self, b0: int, out: np.ndarray) -> None:
        """Blocks [b0, b0 + seg_blocks) of the stream into `out`, copied
        once: wrapping when looped, zero past the recording when not."""
        n, filled = len(self.data), 0
        pos = b0 * self.L % n if self.loop else b0 * self.L
        while filled < len(out):
            if pos >= n:
                if not self.loop:
                    out[filled:] = 0
                    return
                pos = 0
            take = min(len(out) - filled, n - pos)
            out[filled:filled + take] = self.data[pos:pos + take]
            filled, pos = filled + take, pos + take

    def _stage(self, s: int):
        """Start the upload of segment s: (tensor, ready event or None)."""
        b0 = s * self.seg_blocks
        tok = spans.begin("sdr.replay.stage_segment", b0)
        if self.device.type != "cuda":
            seg = np.empty(self.seg_blocks * self.L, dtype=np.complex64)
            self._fill(b0, seg)
            x, ready = torch.from_numpy(seg), None
        else:
            k = s % 2
            if self._done[k] is not None:
                self._done[k].synchronize()     # its last copy has landed
            self._fill(b0, self._pinned[k].numpy())
            with torch.cuda.stream(self._copy):
                x = self._pinned[k].to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._copy)
            self._done[k] = ready
        spans.end(tok)
        return x, ready

    def _enter(self, x: torch.Tensor, ready) -> torch.Tensor:
        """Segment x, ready for the compute stream."""
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            x.record_stream(compute)
        return x

    def init_state(self):
        """(demodulator state, block index) at the stream's start; the
        staging buffers are made anew and the first segment's upload
        started (set-up)."""
        self._reset()
        self._segment(0)
        return (self.demod.init_state(), 0)

    def _reset(self) -> None:
        """Fresh staging: copy stream, pinned buffers, no segment."""
        S, L = self.seg_blocks, self.L
        self._n_seg = -(-self.demod.plan.n_blocks // S)
        if self.device.type == "cuda":
            self._copy = torch.cuda.Stream(device=self.device)
            self._pinned = [torch.empty(S * L, dtype=torch.complex64,
                                        pin_memory=True)
                            for _ in range(min(self._n_seg, 2))]
        self._done = [None, None]
        self._cur = self._nxt = None      # (segment, staged tensor)

    def step(self, state):
        """One block: (state', y (rows, channels))."""
        st, b = state
        S, L = self.seg_blocks, self.L
        if self._cur[0] != b // S:
            self._segment(b // S)
        j = b % S
        st, y = self.demod.step(st, self._cur[1][j * L:(j + 1) * L])
        return (st, b + 1), y

    def _segment(self, s: int) -> None:
        """Enter segment s: take it from the upload started a segment
        earlier (or stage it now, on a restored state) and start the
        next one's."""
        staged = (self._nxt[1] if self._nxt and self._nxt[0] == s
                  else self._stage(s))
        self._cur = (s, self._enter(*staged))
        self._nxt = ((s + 1, self._stage(s + 1))
                     if s + 1 < self._n_seg else None)

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        plan = self.demod.plan
        return run_chunked(self.step, self.init_state, plan.n_blocks,
                           self.L, self.demod.n_channels,
                           plan.total_out_rows, self.device, sinks,
                           usrp_number=usrp_number, front_end=front_end)
