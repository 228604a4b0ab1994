"""RX block demodulator factory (port of gpu_sdr_tpu/engine/demodulator.py).

The reference ``RX_buffer_demodulator`` (cpp/USRP_demodulator.cpp)
becomes a :class:`Demodulator` whose ``step(state, block)`` is called
once per complex64 block on the demodulator's device; every mode emits
a (out_rows, n_channels) tensor per block (sample-major, channel-minor,
the reference's interleaved layout, cpp/USRP_demodulator.cpp:422-433).

Ported: TONES (channelizer + tone select), NOISE (full spectrum) and
DIRECT (fused multi-tone DDC + decimating FIR).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from gpu_sdr_tpu.params import AntennaParams, WaveType

from ..ops import ddc as ddc_ops
from ..ops import pfb as pfb_ops
from ..ops.presum import pfb_frames_fused
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


def _build_direct(p: AntennaParams, plan: BlockPlan, device) -> Demodulator:
    """DIRECT: fused multi-tone DDC + decimating FIR through the DDC
    kernel (reference process_direct, cpp/USRP_demodulator.cpp:400-464).
    State: (int64 phase (C,), ((f-1)*M,) history samples)."""
    freqs = tuple(int(f) for f in p.freq)
    cfg = ddc_ops.DirectDDCConfig(
        rate=int(p.rate), decim=int(p.decim), pf_average=int(p.pf_average),
        freqs=freqs, phases=(0,) * len(freqs))
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

    return Demodulator(plan=plan, n_channels=len(freqs),
                       init_state=init_state, step=step,
                       wave_type=WaveType.DIRECT, device=device)


def _build_pfb(p: AntennaParams, plan: BlockPlan, full_spectrum: bool,
               device) -> Demodulator:
    """TONES (channelizer + tone select) / NOISE (full spectrum)
    (reference process_pfb / process_pfb_spec,
    cpp/USRP_demodulator.cpp:486-649): the pre-sum kernel, then
    ``torch.fft.fft``, frame averaging and tone selection."""
    nfft, avg = int(p.fft_tones), int(p.pf_average)
    bins = None if full_spectrum else tuple(
        int(b) for b in pfb_ops.tone_bins(p.freq, p.rate, nfft))
    cfg = pfb_ops.PFBConfig(nfft=nfft, avg=avg, rate=int(p.rate),
                            bins=bins, decim=int(p.decim))
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
        plan=plan, n_channels=nfft if full_spectrum else len(bins),
        init_state=lambda: pfb_ops.pfb_spare_init(cfg, device), step=step,
        wave_type=WaveType.NOISE if full_spectrum else WaveType.TONES,
        device=device)


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
    if w == WaveType.TONES:
        return _build_pfb(p, plan, False, device)
    if w == WaveType.NOISE:
        return _build_pfb(p, plan, True, device)
    if w == WaveType.DIRECT:
        return _build_direct(p, plan, device)
    if w == WaveType.CHIRP:
        raise NotImplementedError(
            "CHIRP demodulation is not ported yet (ROADMAP Queue 1 item 5)")
    if w == WaveType.NODSP:
        raise NotImplementedError(
            "NODSP passthrough is not ported yet (ROADMAP Queue 1 item 3)")
    raise NotImplementedError(f"demodulation for {w} not implemented")
