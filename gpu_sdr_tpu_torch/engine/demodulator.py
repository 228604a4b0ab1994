"""RX block demodulator factory (port of gpu_sdr_tpu/engine/demodulator.py).

The reference ``RX_buffer_demodulator`` (cpp/USRP_demodulator.cpp)
becomes a :class:`Demodulator` whose ``step(state, block)`` is called
once per complex64 block on the demodulator's device; every mode emits
a (out_rows, n_channels) tensor per block (sample-major, channel-minor,
the reference's interleaved layout, cpp/USRP_demodulator.cpp:422-433).

Every mode is ported: TONES (channelizer + tone select), NOISE (full
spectrum), DIRECT (fused multi-tone DDC + decimating FIR), CHIRP
(integer-phase chirp mix-down + lock-in) and NODSP (raw passthrough);
all but NODSP also under a mesh (``make_demodulator(p, mesh=...)``: the
sharded steps of parallel/, whose output is a parallel.mesh.Sharded
block the pipeline's fetch gathers).  An antenna of mixed wave types
gets a :class:`MixedDemodulator`: one demodulator a wave type over the
same block, on one device or a mesh.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import spans
from ..ops import chirp as chirp_ops
from ..ops import ddc as ddc_ops
from ..ops import lockin as lockin_ops
from ..ops import pfb as pfb_ops
from ..ops.lockin_table import lockin_table
from ..ops.presum import pfb_presum_block
from ..params import DEFAULT_BUFFER_LEN, AntennaParams, WaveType
from .planner import BlockPlan, _commensurate, mode_stride, plan_blocks


@dataclasses.dataclass
class Demodulator:
    """A streaming demodulator for one antenna on one device.

    Attributes:
      plan:       block geometry (static shapes).
      n_channels: output channels per row.
      init_state: () -> carried state.
      step:       (state, block (L,) complex64) -> (state, out).
    """

    plan: BlockPlan
    n_channels: int
    init_state: Callable[[], Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]]
    wave_type: WaveType
    device: torch.device
    mesh: Optional[Any] = None      # parallel.mesh.Mesh of a sharded step
    sharded: Optional[Any] = None   # its ShardedDDC / ShardedPFB / ...


def direct_config(p: AntennaParams) -> ddc_ops.DirectDDCConfig:
    """The DDC configuration of a DIRECT receiver."""
    freqs = tuple(int(f) for f in p.freq)
    return ddc_ops.DirectDDCConfig(
        rate=int(p.rate), decim=int(p.decim), pf_average=int(p.pf_average),
        freqs=freqs, phases=(0,) * len(freqs))


def pfb_config(p: AntennaParams) -> pfb_ops.PFBConfig:
    """The PFB configuration of a TONES (its tones' bins) or NOISE
    (every bin) receiver."""
    nfft = int(p.fft_tones)
    bins = None if p.wave_type[0] == WaveType.NOISE else tuple(
        int(b) for b in pfb_ops.tone_bins(p.freq, p.rate, nfft))
    return pfb_ops.PFBConfig(nfft=nfft, avg=int(p.pf_average),
                             rate=int(p.rate), bins=bins,
                             decim=int(p.decim))


def _build_direct(p: AntennaParams, plan: BlockPlan, device) -> Demodulator:
    """DIRECT: fused multi-tone DDC + decimating FIR through the DDC
    kernel (reference process_direct, cpp/USRP_demodulator.cpp:400-464).
    State: (int64 phase (C,), ((f-1)*M,) history samples)."""
    cfg = direct_config(p)
    L = plan.block_len
    hmod = cfg.modulated_taps(device)
    ramp = cfg.carrier_ramp(L // cfg.M, device)
    step_v = ddc_ops.ddc_carrier_step(cfg, L, device)

    def init_state():
        return (ddc_ops.ddc_carrier_init(cfg, device),
                torch.zeros((cfg.f - 1) * cfg.M, dtype=torch.complex64,
                            device=device))

    def step(state, x):
        phase, hist = state
        phase, hist, y = ddc_ops.ddc_fused(hmod, ramp, step_v, cfg.rate,
                                           cfg.M, cfg.f, phase, hist, x)
        return (phase, hist), y

    return Demodulator(plan=plan, n_channels=len(cfg.freqs),
                       init_state=init_state, step=step,
                       wave_type=WaveType.DIRECT, device=device)


def _build_pfb(p: AntennaParams, plan: BlockPlan, device) -> Demodulator:
    """TONES (channelizer + tone select) / NOISE (full spectrum)
    (reference process_pfb / process_pfb_spec,
    cpp/USRP_demodulator.cpp:486-649): the pre-sum kernel, then
    ``torch.fft.fft``, frame averaging and tone selection, each launch
    under its span (``sdr.pfb.presum``, ``.fft``, ``.select``)."""
    cfg = pfb_config(p)
    full_spectrum = cfg.bins is None
    window = cfg.window(device)
    bins_t = cfg.bins_tensor(device)
    decim = int(p.decim)

    def step(spare, x):
        tok = spans.begin("sdr.pfb.presum")
        spare, pre = pfb_presum_block(cfg, window, spare, x)
        spans.end(tok)
        tok = spans.begin("sdr.pfb.fft")
        frames = torch.fft.fft(pre, dim=-1)
        spans.end(tok)
        if decim > 0:
            frames = pfb_ops.average_frames(frames, decim)
        if bins_t is not None:
            tok = spans.begin("sdr.pfb.select")
            frames = pfb_ops.select_tones(frames, bins_t)
            spans.end(tok)
        return spare, frames

    return Demodulator(
        plan=plan, n_channels=cfg.nfft if full_spectrum else len(cfg.bins),
        init_state=lambda: pfb_ops.pfb_spare_init(cfg, device), step=step,
        wave_type=WaveType.NOISE if full_spectrum else WaveType.TONES,
        device=device)


def _build_chirp(p: AntennaParams, plan: BlockPlan, device) -> Demodulator:
    """CHIRP: integer-phase chirp mix-down + lock-in segment average
    (reference process_chirp, cpp/USRP_demodulator.cpp:342-397).  With
    decim >= 1, the table step when it fits, else the plain mix-down and
    lock-in; with decim 0, the mixed-down stream itself.  State: the
    stream position, a Python int."""
    cfg = chirp_ops.chirp_config(p)
    decim = int(p.decim)
    if decim > 0:
        ppt = cfg.length * decim
        profile = torch.from_numpy(lockin_ops.lockin_profile(ppt)).to(device)
        if chirp_ops.chirp_table_fits(cfg, plan.block_len, ppt):
            return _chirp_table_step(cfg, profile, plan, ppt, device)

        def step(last, x):
            last, z = chirp_ops.chirp_demod_block(cfg, last, x)
            return last, lockin_ops.lockin_decimate(profile, z)[:, None]
    else:
        def step(last, x):
            last, z = chirp_ops.chirp_demod_block(cfg, last, x)
            return last, z[:, None]

    return Demodulator(plan=plan, n_channels=1, init_state=lambda: 0,
                       step=step, wave_type=WaveType.CHIRP, device=device)


def _chirp_table_step(cfg, profile, plan: BlockPlan, ppt: int,
                      device) -> Demodulator:
    """Host-fed table-oscillator lock-in: each block against the rows of
    a one-period oscillator table through the lock-in kernel's table
    mode (ops/lockin_table.lockin_table, TPU kernel #17).  The table is
    built at the first init_state / step, not here: the fused loopback
    builds this demodulator too and never reads it.  State: (stream
    position, oscillator block), Python ints.

    The JAX package takes this step only under its Pallas switch, for a
    table of at most 64 MB (a limit of its remote-compile relay) and
    8-segment blocks (the TPU's row tile); the port has none of those
    gates (ROADMAP Queue 3)."""
    L = plan.block_len
    nseg, nblk = L // ppt, cfg.period // L

    @functools.cache
    def oscillator():
        return chirp_ops.chirp_period_table(cfg, L, ppt, device=device)

    def init_state():
        oscillator()
        return (0, 0)

    def step(state, x):
        last, o = state
        y = lockin_table(profile, oscillator(), x.reshape(nseg, ppt), o, 0,
                         nseg)
        return (chirp_ops.advance(cfg, last, L), (o + 1) % nblk), y[:, None]

    return Demodulator(plan=plan, n_channels=1, init_state=init_state,
                       step=step, wave_type=WaveType.CHIRP, device=device)


def _mesh_plan(plan: BlockPlan, mesh) -> BlockPlan:
    """Round the block length down to a multiple of (time shards *
    stride), so time segments split evenly."""
    q = plan.stride * mesh.T
    block = max(q, (plan.block_len // q) * q)
    n_blocks = max(1, math.ceil(plan.total_samples / block))
    return BlockPlan(block_len=block, stride=plan.stride,
                     out_rows=block // plan.stride, n_blocks=n_blocks,
                     total_samples=n_blocks * block)


def _build_direct_sharded(p: AntennaParams, plan: BlockPlan,
                          mesh) -> Demodulator:
    """DIRECT over a (time, channels) mesh: channel-sharded modulated
    taps, time-sharded blocks with the halo ring (parallel/sharded.py).
    A tone list the channel axis does not split evenly is padded with
    dummy DC tones, dropped from the output."""
    from ..parallel.sharded import ShardedDDC
    plan = _mesh_plan(plan, mesh)
    freqs = tuple(int(f) for f in p.freq)
    Cg = len(freqs)
    pad = (-Cg) % mesh.Kc
    cfg = ddc_ops.DirectDDCConfig(
        rate=int(p.rate), decim=int(p.decim), pf_average=int(p.pf_average),
        freqs=freqs + (0,) * pad, phases=(0,) * (Cg + pad))
    sd = ShardedDDC(cfg, mesh, plan.block_len)

    def step(state, x):
        state, y = sd.step(state, x)
        return state, (y.columns(Cg) if pad else y)

    return Demodulator(plan=plan, n_channels=Cg, init_state=sd.init_state,
                       step=step, wave_type=WaveType.DIRECT,
                       device=mesh.first, mesh=mesh, sharded=sd)


def _build_pfb_sharded(p: AntennaParams, plan: BlockPlan,
                       mesh) -> Demodulator:
    """TONES / NOISE over a (time, channels) mesh (parallel/sharded_pfb):
    TONES selects owner-locally and joins the channel shards with one
    psum, then averages frames (selection commutes with averaging, both
    linear); NOISE averages each shard's bins.  The plan's stride is
    nfft*decim, so each time shard holds whole decimation groups."""
    from ..parallel.sharded_pfb import ShardedPFB
    plan = _mesh_plan(plan, mesh)
    cfg = pfb_config(p)
    full_spectrum = cfg.bins is None
    sp = ShardedPFB(cfg, mesh, plan.block_len, bins=cfg.bins)
    decim = int(p.decim)

    def step(state, x):
        state, y = sp.step(state, x)
        if decim > 0:
            y = y.map(lambda f: pfb_ops.average_frames(f, decim))
        return state, y

    return Demodulator(
        plan=plan, n_channels=cfg.nfft if full_spectrum else len(cfg.bins),
        init_state=sp.init_state, step=step,
        wave_type=WaveType.NOISE if full_spectrum else WaveType.TONES,
        device=mesh.first, mesh=mesh, sharded=sp)


def _build_chirp_sharded(p: AntennaParams, plan: BlockPlan,
                         mesh) -> Demodulator:
    """CHIRP lock-in over a time mesh (parallel/sharded_chirp): no halo,
    the mix-down is elementwise and the lock-in segments shard-local."""
    from ..parallel.sharded_chirp import ShardedChirpLockin
    if len(p.wave_type) > 1:
        raise NotImplementedError(
            "Multiple chirp demodulation not implemented (matches "
            "reference)")
    if p.decim <= 0:
        raise NotImplementedError(
            "sharded CHIRP requires lock-in decimation (decim >= 1)")
    cfg = chirp_ops.chirp_config(p)
    plan = _mesh_plan(plan, mesh)
    sc = ShardedChirpLockin(cfg, mesh, plan.block_len,
                            cfg.length * int(p.decim))
    return Demodulator(plan=plan, n_channels=1, init_state=sc.init_state,
                       step=sc.step, wave_type=WaveType.CHIRP,
                       device=mesh.first, mesh=mesh, sharded=sc)


def _build_nodsp(plan: BlockPlan, device) -> Demodulator:
    """NODSP: the raw stream, one channel (reference process_nodsp,
    cpp/USRP_demodulator.cpp:335-339).  The output is a view of the
    block: the pipeline's fetch copies it before the block is freed."""

    def step(state, x):
        return state, x[:, None]

    return Demodulator(plan=plan, n_channels=1, init_state=lambda: (),
                       step=step, wave_type=WaveType.NODSP, device=device)


def _build_sharded(p: AntennaParams, plan: BlockPlan, w: WaveType,
                   mesh) -> Demodulator:
    if w == WaveType.DIRECT:
        return _build_direct_sharded(p, plan, mesh)
    if w in (WaveType.TONES, WaveType.NOISE):
        return _build_pfb_sharded(p, plan, mesh)
    if w == WaveType.CHIRP:
        return _build_chirp_sharded(p, plan, mesh)
    raise NotImplementedError(
        f"sharded demodulation for {w} not implemented")


def _build_for(p: AntennaParams, plan: BlockPlan, w: WaveType, device,
               mesh) -> Demodulator:
    """The demodulator of one wave type on `device`, or over `mesh`."""
    if mesh is not None:
        return _build_sharded(p, plan, w, mesh)
    if device is None:
        raise ValueError("make_demodulator: name a device or a mesh")
    if w in (WaveType.TONES, WaveType.NOISE):
        return _build_pfb(p, plan, device)
    if w == WaveType.DIRECT:
        return _build_direct(p, plan, device)
    if w == WaveType.CHIRP:
        return _build_chirp(p, plan, device)
    if w == WaveType.NODSP:
        return _build_nodsp(plan, device)
    raise NotImplementedError(f"demodulation for {w} not implemented")


@dataclasses.dataclass
class MixedGroup:
    """One homogeneous sub-stream of a mixed-mode antenna."""

    wave_type: WaveType
    channel_idx: Tuple[int, ...]    # original positions in p.freq
    demod: Demodulator              # shares the common block geometry
    params: AntennaParams           # the homogeneous sub-antenna


@dataclasses.dataclass
class MixedDemodulator:
    """One demodulator a wave type over the same block (port of
    gpu_sdr_tpu/engine/demodulator.MixedDemodulator).

    The reference rejects mixed wave types on one antenna
    (cpp/USRP_demodulator.cpp:36-39).  Here each homogeneous group runs
    its own demodulator on a common block commensurate with every
    group's stride, so e.g. a DIRECT readout and a CHIRP sweep share one
    RX stream.  ``step(states, x) -> (states, outputs)``: a tuple of the
    groups' states and of their (rows_g, C_g) outputs; every group reads
    the same block and none writes into it.  H5 layout: group 0 writes
    `data`, group k > 0 `mixed_<k>` (client/files.H5Sink)."""

    plan: BlockPlan                 # common geometry (stride = lcm)
    groups: Tuple[MixedGroup, ...]
    init_state: Callable[[], Any]
    step: Callable[[Any, torch.Tensor], Tuple[Any, Tuple[Any, ...]]]
    device: torch.device
    mesh: Optional[Any] = None
    wave_type: WaveType = WaveType.NODSP

    @property
    def n_channels(self) -> int:
        return sum(g.demod.n_channels for g in self.groups)


def _build_mixed(p: AntennaParams, samples, device,
                 mesh=None) -> MixedDemodulator:
    """Partition the channel list by wave type, in first-seen order, and
    run every group's demodulator on the same block.  The common block
    is the multiple of every group's stride (times the time shards under
    `mesh`, so each group's sharded demodulator splits it evenly) nearest
    buffer_len."""
    order: List[WaveType] = []
    members: Dict[WaveType, List[int]] = {}
    for i, w in enumerate(p.wave_type):
        if w not in members:
            members[w] = []
            order.append(w)
        members[w].append(i)
    n_all = len(p.wave_type)

    def _sub(lst, idx):
        """Subset a per-channel list; a list shorter than the channel
        count (one chirp_f for the single CHIRP channel) is taken in
        listed order."""
        if not lst:
            return []
        if len(lst) == n_all:
            return [lst[i] for i in idx]
        return list(lst[:len(idx)])

    subs = []
    for w in order:
        idx = members[w]
        chirp = w == WaveType.CHIRP
        sub = dataclasses.replace(
            p, freq=_sub(p.freq, idx), wave_type=[w] * len(idx),
            ampl=_sub(p.ampl, idx),
            chirp_f=_sub(p.chirp_f, idx) if chirp else list(p.chirp_f or []),
            chirp_t=_sub(p.chirp_t, idx) if chirp else list(p.chirp_t or []),
            swipe_s=_sub(p.swipe_s, idx) if chirp else list(p.swipe_s or []))
        if chirp and len(idx) > 1:
            raise NotImplementedError(
                "Multiple chirp demodulation not implemented (matches "
                "reference)")
        subs.append((w, tuple(idx), sub))

    q = 1
    for _w, _idx, sub in subs:
        q = math.lcm(q, mode_stride(sub))
    t_shards = mesh.T if mesh is not None else 1
    block = _commensurate(p.buffer_len or DEFAULT_BUFFER_LEN, q * t_shards)
    total = int(samples if samples is not None else p.samples)
    if total <= 0:
        total = block
    n_blocks = max(1, math.ceil(total / block))

    groups = []
    for w, idx, sub in subs:
        sg = mode_stride(sub)
        gplan = BlockPlan(block_len=block, stride=sg, out_rows=block // sg,
                          n_blocks=n_blocks, total_samples=n_blocks * block)
        gd = _build_for(sub, gplan, w, device, mesh)
        assert gd.plan.block_len == block, (w, gd.plan.block_len, block)
        groups.append(MixedGroup(wave_type=w, channel_idx=idx, demod=gd,
                                 params=sub))

    def init_state():
        return tuple(g.demod.init_state() for g in groups)

    def step(states, x):
        new_states, outs = [], []
        for g, st in zip(groups, states):
            st, y = g.demod.step(st, x)
            new_states.append(st)
            outs.append(y)
        return tuple(new_states), tuple(outs)

    plan = BlockPlan(block_len=block, stride=q, out_rows=block // q,
                     n_blocks=n_blocks, total_samples=n_blocks * block)
    return MixedDemodulator(plan=plan, groups=tuple(groups),
                            init_state=init_state, step=step,
                            device=groups[0].demod.device, mesh=mesh)


def make_demodulator(p: AntennaParams, device=None, mesh=None,
                     samples: Optional[int] = None):
    """Build the streaming demodulator for one RX antenna on `device`
    (the factory switch of the reference ctor,
    cpp/USRP_demodulator.cpp:56-326), for `samples` raw samples (default
    p.samples).  With `mesh` (parallel.mesh.Mesh) every mode but NODSP
    runs sharded over its devices: ``step`` takes a block on the mesh's
    first device (or a per-shard grid) and returns a parallel.mesh.
    Sharded result, and `device` is the mesh's first.  An antenna of
    mixed wave types gets a MixedDemodulator, on `device` or `mesh`."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    if any(x != w for x in p.wave_type):
        return _build_mixed(p, samples, device, mesh=mesh)
    return _build_for(p, plan_blocks(p, samples), w, device, mesh)
