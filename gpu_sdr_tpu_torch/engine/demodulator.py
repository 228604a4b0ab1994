"""RX block demodulator factory (port of gpu_sdr_tpu/engine/demodulator.py).

The reference ``RX_buffer_demodulator`` (cpp/USRP_demodulator.cpp)
becomes a :class:`Demodulator` whose ``step(state, block)`` is called
once per complex64 block on the demodulator's device; every mode emits
a (out_rows, n_channels) tensor per block (sample-major, channel-minor,
the reference's interleaved layout, cpp/USRP_demodulator.cpp:422-433).

Ported: TONES (channelizer + tone select), NOISE (full spectrum),
DIRECT (fused multi-tone DDC + decimating FIR) and CHIRP (integer-phase
chirp mix-down + lock-in).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Tuple

import torch

from ..ops import chirp as chirp_ops
from ..ops import ddc as ddc_ops
from ..ops import lockin as lockin_ops
from ..ops import pfb as pfb_ops
from ..ops.lockin_table import lockin_table
from ..ops.presum import pfb_frames_fused
from ..params import AntennaParams, WaveType
from .planner import BlockPlan, plan_blocks


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
    ``torch.fft.fft``, frame averaging and tone selection."""
    cfg = pfb_config(p)
    full_spectrum = cfg.bins is None
    window = cfg.window(device)
    bins_t = cfg.bins_tensor(device)
    decim = int(p.decim)

    def step(spare, x):
        spare, frames = pfb_frames_fused(cfg, window, spare, x)
        if decim > 0:
            frames = pfb_ops.average_frames(frames, decim)
        if bins_t is not None:
            frames = pfb_ops.select_tones(frames, bins_t)
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


def make_demodulator(p: AntennaParams, device) -> Demodulator:
    """Build the streaming demodulator for one RX antenna on `device`
    (the factory switch of the reference ctor,
    cpp/USRP_demodulator.cpp:56-326)."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    if any(x != w for x in p.wave_type):
        raise NotImplementedError(
            "mixed wave types on one antenna are not ported yet (ROADMAP "
            "Queue 1 item 3)")
    plan = plan_blocks(p)
    if w in (WaveType.TONES, WaveType.NOISE):
        return _build_pfb(p, plan, device)
    if w == WaveType.DIRECT:
        return _build_direct(p, plan, device)
    if w == WaveType.CHIRP:
        return _build_chirp(p, plan, device)
    if w == WaveType.NODSP:
        raise NotImplementedError(
            "NODSP passthrough is not ported yet (ROADMAP Queue 1 item 3)")
    raise NotImplementedError(f"demodulation for {w} not implemented")
