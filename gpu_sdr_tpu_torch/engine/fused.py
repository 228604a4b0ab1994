"""Fused on-device loopback measurements (port of gpu_sdr_tpu/engine/fused.py).

When the measurement's source is the synthetic loopback (TX generator
feeding RX directly, the reference's --sw_loop), the whole chain stays
on the device and nothing touches the host until each block's
demodulated output is fetched.

Ported mode pairs: TONES->DIRECT, CHIRP->CHIRP, TONES->TONES (PFB) and
TONES->NOISE, tried in the JAX package's order: DIRECT first, then the
chirp, then the channelizer, else ``generic_scan`` (the generator and
the demodulator of the host-fed path, run back to back on the device).

* TONES->DIRECT, periodic comb: the loopback is a looped one-block
  recording, demodulated by the replay kernel (``replay_kernel_t`` for
  at most 8 channels, else ``replay_kernel``);
* TONES->DIRECT, any other comb: the shift-fold kernel (``fold_kernel``),
  synthesis, mix-down and FIR contracted into one constant;
* CHIRP->CHIRP (the VNA sweep): one period of the TX chirp as a table
  of segment rows and the lock-in kernel in self mode
  (``chirp_wavetable``);
* TONES->TONES / NOISE, bin-quantized comb: one comb frame and the
  channelizer kernel in const-frame mode (``channelizer_wavetable``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import resolve_device
from ..ops import chirp as chirp_ops
from ..ops import cplx
from ..ops import pfb as pfb_ops
from ..ops.channelizer import (can_fuse_channelizer, channelizer_consts,
                               channelizer_frames)
from ..ops.fold import TonesDirectFold
from ..ops.lockin import lockin_profile
from ..ops.lockin_table import lockin_self
from ..ops.replay_ddc import make_replay_ddc, replay_ddc_kind
from ..ops.tonegen import comb_period, tone_comb_wavetable_block
from ..params import AntennaParams, WaveType
from .demodulator import direct_config, make_demodulator, pfb_config
from .generator import make_generator
from .pipeline import PipelineResult, run_chunked


def plan_tones_direct_chain(tx, rx, L: int) -> Optional[str]:
    """The TONES->DIRECT chain for blocks of L, or None: no burst gating,
    a decimating receiver with pf_average >= 2.  A periodic comb is a
    looped one-block recording through the replay kernel
    (``replay_kernel_t`` / ``replay_kernel``, ops/replay_ddc.
    replay_ddc_kind), any other comb the fold kernel (``fold_kernel``).
    The JAX package sends a periodic comb of fewer than 8 tones that its
    replay refuses to generic_scan (gpu_sdr_tpu/engine/fused.py:144-166);
    the port's replay takes every periodic comb of the planner's
    whole-row blocks, so that rule has no counterpart."""
    if not (tx.wave_type and tx.wave_type[0] == WaveType.TONES
            and rx.wave_type and rx.wave_type[0] == WaveType.DIRECT):
        return None
    if tx.burst_on > 0 or int(rx.decim) <= 0 or int(rx.pf_average) < 2:
        return None
    freqs = tuple(int(f) for f in tx.freq)
    if not freqs or not rx.freq:
        return None
    period = comb_period(freqs, int(tx.rate))
    if L % period == 0 and period <= (1 << 22):
        kind = replay_ddc_kind(direct_config(rx), L, L)
        if kind is not None:
            return kind
    return "fold_kernel"


def plan_chirp_chain(tx, rx, L: int) -> bool:
    """CHIRP->CHIRP with no burst gating into a lock-in receiver
    (decim >= 1) whose chirp is the TX chirp, and a one-period table
    that fits (ops/chirp.chirp_table_fits).  JAX also needs its Pallas
    switch and 8-segment blocks (a TPU row tile); the port needs neither
    (ROADMAP Queue 3)."""
    if not (tx.wave_type and tx.wave_type[0] == WaveType.CHIRP
            and rx.wave_type and rx.wave_type[0] == WaveType.CHIRP):
        return False
    if tx.burst_on > 0 or int(rx.decim) < 1:
        return False
    # the table is the TX signal: the demodulator's chirp must match
    for attr in ("freq", "chirp_f", "chirp_t", "swipe_s"):
        a, b = getattr(tx, attr), getattr(rx, attr)
        if not a or not b or a[0] != b[0]:
            return False
    cfg = chirp_ops.chirp_config(rx)
    return chirp_ops.chirp_table_fits(cfg, L, cfg.length * int(rx.decim))


def plan_channelizer_chain(tx, rx, L: int) -> bool:
    """TONES->TONES / TONES->NOISE with no burst gating, a comb that is
    one-frame periodic (its period divides nfft), blocks the channelizer
    kernel takes (ops/channelizer.can_fuse_channelizer) of whole
    decimation groups."""
    if not (tx.wave_type and tx.wave_type[0] == WaveType.TONES
            and rx.wave_type
            and rx.wave_type[0] in (WaveType.TONES, WaveType.NOISE)):
        return False
    if tx.burst_on > 0 or int(rx.fft_tones) <= 0:
        return False
    freqs = tuple(int(f) for f in tx.freq)
    cfg = pfb_config(rx)
    if not freqs or cfg.nfft % comb_period(freqs, int(tx.rate)) != 0:
        return False
    if not can_fuse_channelizer(cfg, L):
        return False
    return not (cfg.decim > 0 and (L // cfg.nfft) % cfg.decim != 0)


def plan_fused_path(tx, rx, L: int) -> str:
    """The chain FusedLoopback runs for blocks of L, in the JAX
    package's order: DIRECT first, then the chirp, then the channelizer,
    else ``generic_scan``."""
    kind = plan_tones_direct_chain(tx, rx, L)
    if kind is not None:
        return kind
    if plan_chirp_chain(tx, rx, L):
        return "chirp_wavetable"
    if plan_channelizer_chain(tx, rx, L):
        return "channelizer_wavetable"
    return "generic_scan"


@dataclasses.dataclass
class FusedLoopback:
    """A TX -> RX loopback chain run block by block on one device.
    ``path`` names the chain (measure.LAST_DISPATCH's subpath), chosen by
    plan_fused_path."""

    tx: AntennaParams
    rx: AntennaParams
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.demod = make_demodulator(self.rx, self.device)
        L = self.demod.plan.block_len
        self.path = plan_fused_path(self.tx, self.rx, L)
        self._chain = self._build_chain(L)

    def _build_chain(self, L: int):
        """The chain of ``self.path``: an object with init_state and
        step."""
        tx, rx, dev = self.tx, self.rx, self.device
        if self.path == "generic_scan":
            return _GenericScan(make_generator(tx, L, dev), self.demod)
        freqs = tuple(int(f) for f in tx.freq)
        ampls = tuple(float(a) for a in (tx.ampl or [1.0] * len(freqs)))
        if self.path == "fold_kernel":
            return TonesDirectFold(int(tx.rate), freqs, ampls,
                                   direct_config(rx), L, dev)
        if self.path in ("replay_kernel_t", "replay_kernel"):
            # the loopback as a looped one-block recording: the replay
            # object is the chain itself (path_name, init_state, step)
            rec = tone_comb_wavetable_block(freqs, ampls, int(tx.rate), L)
            return make_replay_ddc(direct_config(rx), rec, L, dev)
        if self.path == "chirp_wavetable":
            cfg = chirp_ops.chirp_config(rx)
            scale = float(tx.ampl[0]) if tx.ampl else 1.0
            return _ChirpWavetableChain(cfg, L, cfg.length * int(rx.decim),
                                        scale, dev)
        return _ChannelizerWavetableChain(pfb_config(rx), freqs, ampls, L,
                                          int(rx.decim), dev)

    def init_state(self):
        """The chain's state at the stream's start."""
        return self._chain.init_state()

    def step(self, state):
        """One block: (state', y (rows, channels))."""
        return self._chain.step(state)

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        """Stream the full acquisition through the chain."""
        plan = self.demod.plan
        return run_chunked(self.step, self.init_state, plan.n_blocks,
                           plan.block_len, self.demod.n_channels,
                           plan.total_out_rows, self.device, sinks,
                           usrp_number=usrp_number, front_end=front_end)


class _GenericScan:
    """The host-fed path's generator and demodulator back to back on the
    device.  State: (generator state, demodulator state)."""

    path_name = "generic_scan"

    def __init__(self, gen, demod):
        self.gen, self.demod = gen, demod

    def init_state(self):
        return (self.gen.init_state(), self.demod.init_state())

    def step(self, state):
        g, d = state
        g, x = self.gen.step(g)
        d, y = self.demod.step(d, x)
        return (g, d), y


class _ChannelizerWavetableChain:
    """One comb wavetable frame + the channelizer kernel in const-frame
    mode (ops/channelizer.channelizer_frames).  Streaming state: the
    (avg-1, nfft) spare frames."""

    path_name = "channelizer_wavetable"

    def __init__(self, cfg, freqs, ampls, L: int, decim: int, device):
        nfft = cfg.nfft
        self.T = L // nfft
        self.decim = decim
        self._frame = cplx.from_np(tone_comb_wavetable_block(
            freqs, ampls, cfg.rate, nfft), device).reshape(1, nfft)
        self._consts = channelizer_consts(cfg, device)
        self._bins = cfg.bins_tensor(device)
        self._spare0 = torch.zeros((cfg.avg - 1, nfft),
                                   dtype=torch.complex64, device=device)

    def init_state(self):
        return self._spare0

    def step(self, spare):
        spare, y = channelizer_frames(self._consts, spare, self._frame,
                                      nframes=self.T)
        if self._bins is not None:
            y = pfb_ops.select_tones(y, self._bins)
        if self.decim > 0:
            y = pfb_ops.average_frames(y, self.decim)
        return spare, y


class _ChirpWavetableChain:
    """One period of the TX chirp as (period/ppt, ppt) segment rows in
    device memory, and the lock-in kernel in self mode
    (ops/lockin_table.lockin_self, TPU kernel #16): in the loopback the
    signal is the table, so each block reads its rows once and its
    lock-in points are sum_k w[k] |c|^2.  The TX amplitude is folded
    into the profile: the demodulator's contract is conj(c) * x with a
    unit oscillator, so one factor of the amplitude divides back out.
    The table is generated on the device block by block
    (ops/chirp.chirp_period_table), so the int64 phase temporaries stay
    one block long.  Streaming state: (stream position, period block),
    Python ints; the position is kept for parity with the host-fed
    step.  One launch per block."""

    path_name = "chirp_wavetable"

    def __init__(self, cfg, L: int, ppt: int, scale: float, device):
        self.cfg, self.L, self.nseg = cfg, L, L // ppt
        self.nblk = cfg.period // L
        self.profile = torch.from_numpy(
            lockin_profile(ppt) / (scale if scale else 1.0)).to(device)
        self.table = chirp_ops.chirp_period_table(cfg, L, ppt, scale=scale,
                                                  device=device)

    def init_state(self):
        return (0, 0)

    def step(self, state):
        last, idx = state
        y = lockin_self(self.profile, self.table, idx, self.nseg)
        return ((chirp_ops.advance(self.cfg, last, self.L),
                 (idx + 1) % self.nblk), y[:, None])


_FUSABLE = {
    (WaveType.TONES, WaveType.DIRECT),
    (WaveType.TONES, WaveType.TONES),
    (WaveType.TONES, WaveType.NOISE),
    (WaveType.CHIRP, WaveType.CHIRP),
}


def can_fuse(tx: Optional[AntennaParams], rx: AntennaParams) -> bool:
    """Whether FusedLoopback takes this mode pair."""
    if tx is None or not tx.wave_type or not rx.wave_type:
        return False
    return (tx.wave_type[0], rx.wave_type[0]) in _FUSABLE
