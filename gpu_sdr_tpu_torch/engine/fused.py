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
from ..ops.ddc import DirectDDCConfig
from ..ops.fold import TonesDirectFold
from ..ops.lockin import lockin_profile
from ..ops.lockin_table import lockin_self
from ..ops.replay_ddc import make_replay_ddc
from ..ops.tonegen import comb_period, tone_comb_wavetable_block
from ..params import AntennaParams, WaveType
from .demodulator import make_demodulator
from .generator import make_generator
from .pipeline import PipelineResult, run_chunked


@dataclasses.dataclass
class FusedLoopback:
    """A TX -> RX loopback chain run block by block on one device."""

    tx: AntennaParams
    rx: AntennaParams
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.demod = make_demodulator(self.rx, self.device)
        chain = self._try_tones_direct_chain()
        if chain is None:
            chain = self._try_chirp_chain()
        if chain is None:
            chain = self._try_channelizer_chain()
        # which chain this loopback runs: measure.LAST_DISPATCH subpath
        self.path = (chain.path_name if chain is not None
                     else "generic_scan")
        if chain is not None:
            self._init_state = chain.init_state
            self._step = chain.step
        else:
            gen = make_generator(self.tx, self.demod.plan.block_len,
                                 self.device)
            demod = self.demod

            def step(st):
                g, d = st
                g, x = gen.step(g)
                d, y = demod.step(d, x)
                return (g, d), y

            self._init_state = lambda: (gen.init_state(),
                                        demod.init_state())
            self._step = step

    def _try_tones_direct_chain(self):
        """TONES->DIRECT with no burst gating into a decimating receiver
        with pf_average >= 2: a periodic comb through the replay kernel,
        any other comb through the fold kernel.  The JAX package sends a
        periodic comb of fewer than 8 tones that its replay refuses to
        generic_scan (gpu_sdr_tpu/engine/fused.py:144-166); the port's
        replay takes every periodic comb of the planner's whole-row
        blocks, so that rule has no counterpart."""
        tx, rx = self.tx, self.rx
        if not (tx.wave_type and tx.wave_type[0] == WaveType.TONES
                and rx.wave_type and rx.wave_type[0] == WaveType.DIRECT):
            return None
        if tx.burst_on > 0 or int(rx.decim) <= 0 or int(rx.pf_average) < 2:
            return None
        freqs = tuple(int(f) for f in tx.freq)
        if not freqs or not rx.freq:
            return None
        L = self.demod.plan.block_len
        period = comb_period(freqs, int(tx.rate))
        ampls = tuple(float(a) for a in (tx.ampl or [1.0] * len(freqs)))
        rx_freqs = tuple(int(f) for f in rx.freq)
        cfg = DirectDDCConfig(rate=int(rx.rate), decim=int(rx.decim),
                              pf_average=int(rx.pf_average), freqs=rx_freqs,
                              phases=(0,) * len(rx_freqs))
        if L % period == 0 and period <= (1 << 22):
            chain = self._try_replay_loopback(cfg, freqs, ampls, L)
            if chain is not None:
                return chain
        return TonesDirectFold(int(tx.rate), freqs, ampls, cfg, L,
                               self.device)

    def _try_replay_loopback(self, cfg, freqs, ampls, L):
        """A periodic comb's loopback as a looped one-block recording:
        the replay object is the chain itself (path_name, init_state,
        step)."""
        rec = tone_comb_wavetable_block(freqs, ampls, int(self.tx.rate), L)
        return make_replay_ddc(cfg, rec, L, self.device)

    def _try_chirp_chain(self):
        """CHIRP->CHIRP with no burst gating into a lock-in receiver
        (decim >= 1) whose chirp is the TX chirp: one period of it, a
        table in device memory, serves the whole stream.  JAX also
        needs its Pallas switch and 8-segment blocks (a TPU row tile);
        the port needs neither (ROADMAP Queue 3)."""
        tx, rx = self.tx, self.rx
        if not (tx.wave_type and tx.wave_type[0] == WaveType.CHIRP
                and rx.wave_type and rx.wave_type[0] == WaveType.CHIRP):
            return None
        if tx.burst_on > 0 or int(rx.decim) < 1:
            return None
        # the table is the TX signal: the demodulator's chirp must match
        for attr in ("freq", "chirp_f", "chirp_t", "swipe_s"):
            a, b = getattr(tx, attr), getattr(rx, attr)
            if not a or not b or a[0] != b[0]:
                return None
        cfg = chirp_ops.chirp_config(rx)
        L = self.demod.plan.block_len
        ppt = cfg.length * int(rx.decim)
        if not chirp_ops.chirp_table_fits(cfg, L, ppt):
            return None
        scale = float(tx.ampl[0]) if tx.ampl else 1.0
        return _ChirpWavetableChain(cfg, L, ppt, scale, self.device)

    def _try_channelizer_chain(self):
        """TONES->TONES / TONES->NOISE through the channelizer kernel
        with a bin-quantized comb as one wavetable frame."""
        tx, rx = self.tx, self.rx
        if not (tx.wave_type and tx.wave_type[0] == WaveType.TONES
                and rx.wave_type
                and rx.wave_type[0] in (WaveType.TONES, WaveType.NOISE)):
            return None
        if tx.burst_on > 0 or int(rx.fft_tones) <= 0:
            return None
        nfft, avg = int(rx.fft_tones), int(rx.pf_average)
        full_spectrum = rx.wave_type[0] == WaveType.NOISE
        L = self.demod.plan.block_len
        freqs = tuple(int(f) for f in tx.freq)
        if not freqs or nfft % comb_period(freqs, int(tx.rate)) != 0:
            return None        # comb not one-frame-periodic: generic path
        bins = None if full_spectrum else tuple(
            int(b) for b in pfb_ops.tone_bins(rx.freq, rx.rate, nfft))
        cfg = pfb_ops.PFBConfig(nfft=nfft, avg=avg, rate=int(rx.rate),
                                bins=bins, decim=int(rx.decim))
        if not can_fuse_channelizer(cfg, L):
            return None
        decim = int(rx.decim)
        if decim > 0 and (L // nfft) % decim != 0:
            return None
        ampls = tuple(float(a) for a in (tx.ampl or [1.0] * len(freqs)))
        return _ChannelizerWavetableChain(cfg, freqs, ampls, L, decim,
                                          self.device)

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        """Stream the full acquisition through the chain."""
        plan = self.demod.plan
        return run_chunked(self._step, self._init_state, plan.n_blocks,
                           plan.block_len, self.demod.n_channels,
                           plan.total_out_rows, self.device, sinks,
                           usrp_number=usrp_number, front_end=front_end)


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
