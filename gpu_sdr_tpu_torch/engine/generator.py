"""TX block generator factory (port of gpu_sdr_tpu/engine/generator.py).

TONES: a periodic (bin-quantized) comb is a constant block built once,
an aperiodic comb one (U, C) x (C, S) complex matmul per block
(ops/tonegen.py).  CHIRP: one integer-phase chirp block per step
(ops/chirp.chirp_block), the stream position carried as a Python int.
Either one optionally burst-gated.  NOISE/RAMP/DIRECT TX are
unimplemented in the reference too (cpp/USRP_buffer_generator.cpp:40-58).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ..ops import chirp as chirp_ops
from ..ops import cplx
from ..ops import tonegen as tone_ops
from ..params import AntennaParams, WaveType


@dataclasses.dataclass
class Generator:
    """A streaming TX generator for one antenna on one device."""

    block_len: int
    init_state: Callable[[], Any]
    step: Callable[[Any], Tuple[Any, torch.Tensor]]
    wave_type: WaveType

    def blocks(self, n_blocks: int):
        """Yield n_blocks numpy complex64 blocks."""
        state = self.init_state()
        for _ in range(n_blocks):
            state, x = self.step(state)
            yield cplx.to_np(x)


def _apply_burst(gen: Generator, p: AntennaParams, device) -> Generator:
    """burst_on seconds of signal, burst_off of silence, repeating,
    driven by a carried position in the burst period (the reference's
    timed start/stop-of-burst, cpp/USRP_hardware_manager.cpp:1178-1291)."""
    rate = int(p.rate)
    on = int(round(p.burst_on * rate))
    period = on + int(round(p.burst_off * rate))
    L = gen.block_len
    n = torch.arange(L, dtype=torch.int64, device=device)

    def init_state():
        return (gen.init_state(), 0)

    def step(state):
        inner, off = state
        inner, x = gen.step(inner)
        mask = ((n + off) % period < on).to(torch.float32)
        return (inner, (off + L) % period), x * mask

    return Generator(block_len=L, init_state=init_state, step=step,
                     wave_type=gen.wave_type)


def make_generator(p: AntennaParams, block_len: int, device) -> Generator:
    """Build the TX generator for one antenna, producing blocks on
    `device` (the reference ctor dispatch,
    cpp/USRP_buffer_generator.cpp:39-159)."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    L = int(block_len)
    if w == WaveType.CHIRP:
        cfg = chirp_ops.chirp_config(p)
        scale = float(p.ampl[0]) if p.ampl else 1.0
        gen = Generator(
            block_len=L, init_state=lambda: 0,
            step=lambda last: chirp_ops.chirp_block(cfg, last, L, scale=scale,
                                                    device=device),
            wave_type=w)
        return _apply_burst(gen, p, device) if p.burst_on > 0 else gen
    if w != WaveType.TONES:
        raise NotImplementedError(
            f"TX generation for {w} is not implemented (NOISE/RAMP/DIRECT "
            "TX match the reference's unimplemented cases, "
            "cpp/USRP_buffer_generator.cpp:40-58)")

    freqs = tuple(int(f) for f in p.freq)
    ampls = tuple(float(a) for a in (p.ampl or [1.0] * len(p.freq)))
    period = tone_ops.comb_period(freqs, p.rate)
    if L % period == 0 and period <= (1 << 22):
        xconst = cplx.from_np(tone_ops.tone_comb_wavetable_block(
            freqs, ampls, int(p.rate), L), device)
        gen = Generator(block_len=L, init_state=lambda: (),
                        step=lambda state: (state, xconst), wave_type=w)
    else:
        cfg = tone_ops.ToneCombConfig(rate=int(p.rate), freqs=freqs,
                                      ampls=ampls, block_len=L)
        P, Q = cfg.factors(device)
        step_v = cfg.phase_step(device)
        W = int(p.rate)
        gen = Generator(
            block_len=L, init_state=lambda: cfg.phase_init(device),
            step=lambda phase: tone_ops.tone_comb_block(P, Q, step_v, W,
                                                        phase),
            wave_type=w)
    return _apply_burst(gen, p, device) if p.burst_on > 0 else gen
