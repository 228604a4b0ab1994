"""Parity of the port's shift-fold TONES->DIRECT loopback (ops/fold.py,
kernel #11's plain version on the CPU) with the JAX package's fold
kernel (Pallas, interpret mode) and XLA fold chain, and with the float64
oracle (tone_gen + direct_demodulator_integer + FIR of the reference).

Bars: 85 dB SNR against the JAX Pallas kernel (its 3-pass bf16 split,
tests/test_pallas_ddc.py:93); 90 dB against the XLA fold chain and the
float64 oracle; 80 dB on the stream's startup rows, the partial-fold
correction (tests/test_fold_chain.py:57); exact equality for the carried
synthesis and DDC phases.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import ddc as jddc
from gpu_sdr_tpu.ops.fold_chain import TonesDirectFoldChain
from gpu_sdr_tpu.ops.pallas_chain import TonesDirectFoldKernel
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch.ops import cplx, ddc, fold

torch.set_num_threads(2)

RATE = 1_000_000
M, F = 20, 4
L = 8_000
COMB = [int(f) for f in np.linspace(-0.45 * RATE, 0.45 * RATE, 24)]


def golden_loopback(freqs, ampls, rx_freqs, n_blocks):
    x = golden.tone_block(freqs, ampls, RATE, 0, n_blocks * L)
    g = golden.GoldenDirectDemodulator(rx_freqs, RATE, M, F)
    return np.concatenate(
        [g(x[k * L:(k + 1) * L]) for k in range(n_blocks)], axis=1).T


def build(freqs, ampls, rx_freqs):
    kw = dict(rate=RATE, decim=M, pf_average=F, freqs=tuple(rx_freqs),
              phases=(0,) * len(rx_freqs))
    chain = fold.TonesDirectFold(RATE, tuple(freqs), tuple(ampls),
                                 ddc.DirectDDCConfig(**kw), L, "cpu")
    jargs = dict(rate=RATE, tx_freqs=tuple(freqs), tx_ampls=tuple(ampls),
                 cfg=jddc.DirectDDCConfig(**kw), block_len=L)
    jkernel = TonesDirectFoldKernel(interpret=True, **jargs)
    jchain = TonesDirectFoldChain(**jargs)
    assert jkernel.ok and jchain.ok
    return chain, jkernel, jchain


def run(chain, n_blocks, state=None):
    st = chain.init_state() if state is None else state
    outs, states = [], []
    for _ in range(n_blocks):
        st, y = chain.step(st)
        assert y.dtype == torch.complex64 and y.shape == (L // M, chain.Cp)
        outs.append(y.numpy())
        states.append(st)
    return np.concatenate(outs), states


def run_jax(jchain, n_blocks):
    st = jchain.init_state()
    outs, states = [], []
    for _ in range(n_blocks):
        st, y = jchain.multi_step(st, 1)
        outs.append(jcplx.to_np(y))
        states.append(st)
    return np.concatenate(outs), states


@pytest.mark.parametrize("tx,ampls,rx", [
    (COMB, [0.05] * len(COMB), COMB),                       # self-ramp
    ([100_003, -200_001, 330_007], [0.3, 0.2, 0.1],
     [100_003, -200_001]),                                  # distinct RX
], ids=["self_ramp", "distinct_rx"])
def test_fold_matches_jax_and_golden(tx, ampls, rx):
    chain, jkernel, jchain = build(tx, ampls, rx)
    out, states = run(chain, 3)
    kout, kstates = run_jax(jkernel, 3)
    cout, _ = run_jax(jchain, 3)
    ref = golden_loopback(tx, ampls, rx, 3)
    assert golden.snr_db(kout, out) > 85.0
    assert golden.snr_db(cout, out) > 90.0
    assert golden.snr_db(ref, out) > 90.0
    assert golden.snr_db(ref[:F - 1], out[:F - 1]) > 80.0     # startup
    for (sph, dph, pv), (jsph, jdph, jpv) in zip(states, kstates):
        assert np.array_equal(sph.numpy(), np.asarray(jsph))
        assert np.array_equal(dph.numpy(), np.asarray(jdph))
        assert pv == float(jpv) == 1.0


def test_fold_plain_is_the_unfactored_fold():
    """The plain version's tile factoring P = P1 * PB, ramp = ramp1 * RB
    against (P * srot) @ G2 * ramp * drot with P and ramp built whole in
    float64, on a block whose last tile is partial (nb = 400 = 6*64 +
    16), away from the stream's start."""
    chain, _, _ = build(COMB, [0.05] * len(COMB), COMB)
    st = chain.advance(chain.advance(chain.init_state()))
    crot, qrot = chain.block_rotations_factored(st)
    y = fold.fold(chain.P1, chain.G2, crot, qrot, chain.ramp1, chain.nb)
    W = RATE
    fr = np.asarray(COMB, np.int64) % W
    n = np.arange(chain.nb, dtype=np.int64)
    P = np.exp(2j * np.pi * (((fr[None] * ((n[:, None] * M) % W)) % W) / W))
    ramp = chain.cfg.carrier_ramp_np(chain.nb)
    srot = cplx.phase_rotation(st[0], W, 1.0).numpy()
    drot = cplx.phase_rotation(st[1], W, -1.0).numpy()
    ref = ((P * srot) @ chain.G2.numpy().astype(np.complex128)) * ramp * drot
    assert chain.nb % fold.FOLD_TILE != 0
    assert golden.snr_db(ref, y.numpy()) > 120.0


def test_fold_continues_from_jax_state():
    """A fold stream started in the JAX package continues in the port
    through convert.fold_state."""
    tx, ampls = [123_457, -345_677, 10_001], [0.5, 0.3, 0.2]
    chain, jkernel, _ = build(tx, ampls, tx)
    jst, _ = jkernel.multi_step(jkernel.init_state(), 2)
    st = convert.fold_state(jst, "cpu")
    assert st[0].dtype == st[1].dtype == torch.int64 and st[2] == 1.0
    out, states = run(chain, 2, st)
    jst, jy = jkernel.multi_step(jst, 2)
    assert golden.snr_db(jcplx.to_np(jy), out) > 85.0
    assert np.array_equal(states[-1][1].numpy(), np.asarray(jst[1]))
    ref = golden_loopback(tx, ampls, tx, 4)[2 * (L // M):]
    assert golden.snr_db(ref, out) > 90.0


def test_fold_on_any_block_length():
    """The port's tile needs no divisor of nb: nb = 2500 (a 50,000-sample
    block at M = 20) has no 8-aligned divisor, so the JAX kernel refuses
    it and JAX takes its XLA fold chain (ROADMAP Queue 3, divergence 5);
    the port's fold still matches the oracle."""
    Lb = 50_000
    tx = COMB[:8]
    kw = dict(rate=RATE, decim=M, pf_average=F, freqs=tuple(tx),
              phases=(0,) * len(tx))
    assert not TonesDirectFoldKernel(
        rate=RATE, tx_freqs=tuple(tx), tx_ampls=(0.1,) * 8,
        cfg=jddc.DirectDDCConfig(**kw), block_len=Lb).ok
    chain = fold.TonesDirectFold(RATE, tuple(tx), (0.1,) * 8,
                                 ddc.DirectDDCConfig(**kw), Lb, "cpu")
    _, y = chain.step(chain.init_state())
    x = golden.tone_block(tx, [0.1] * 8, RATE, 0, Lb)
    ref = golden.GoldenDirectDemodulator(tx, RATE, M, F)(x).T
    assert golden.snr_db(ref, y.numpy()) > 90.0


def test_fold_refuses_and_counts():
    """The fold wrapper checks its operands' shapes and counts no launch
    on the CPU."""
    chain, _, _ = build(COMB[:4], [0.2] * 4, COMB[:4])
    crot, qrot = chain.block_rotations_factored(chain.init_state())
    before = fold.fold.launches
    fold.fold(chain.P1, chain.G2, crot, qrot, chain.ramp1, chain.nb)
    assert fold.fold.launches == before
    with pytest.raises(ValueError, match="fold shapes"):
        fold.fold(chain.P1, chain.G2, crot[:-1], qrot, chain.ramp1,
                  chain.nb)
