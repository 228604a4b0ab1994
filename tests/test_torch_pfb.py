"""Parity of the PyTorch port's PFB ops, pre-sum and tone comb with the
JAX package (CPU backend) and the float64 oracles in gpu_sdr_tpu.golden.

Inputs come from numpy with a fixed seed and go through both packages.
Bars: 90 dB SNR for DSP chains (the repo's bar,
tests/test_ops_pfb_chirp.py:50-51); 1e-6 relative error for the
pre-sum, where both sides add the same float32 products in the same
order and differ only in fused vs separate rounding; exact equality for
integer math, windows, gathers and averages.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import pfb as jpfb
from gpu_sdr_tpu.ops import tonegen as jtone
from gpu_sdr_tpu.ops.pallas_pfb import pallas_presum
from gpu_sdr_tpu_torch.ops import pfb, tonegen
from gpu_sdr_tpu_torch.ops.presum import (pfb_frames_fused, presum,
                                          presum_plain)

torch.set_num_threads(2)

RATE = 1_000_000
AVG = 4
FRAMES = 128


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def rel_err(ref, test):
    ref, test = np.asarray(ref).ravel(), np.asarray(test).ravel()
    return np.linalg.norm(ref - test) / np.linalg.norm(ref)


@pytest.mark.parametrize("nfft", [1000, 200])
def test_window_matches_jax(nfft):
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    w = cfg.window("cpu")
    assert w.dtype == torch.float32 and w.shape == (nfft * AVG,)
    assert np.array_equal(w.numpy(), np.asarray(jcfg.window()))


def test_tone_bins_match_jax_and_golden():
    nfft = 1000
    freqs = [0, 1000, -1000, 250_000, -499_000, 123_456, 499_999]
    bins = pfb.tone_bins(freqs, RATE, nfft)
    assert np.array_equal(bins, jpfb.tone_bins(freqs, RATE, nfft))
    assert np.array_equal(bins, golden.tone_bins(freqs, RATE, nfft))
    assert list(bins[:3]) == [0, 1, nfft - 1]


@pytest.mark.parametrize("nfft", [1000, 200])
def test_pfb_frames_match_jax_and_golden(nfft):
    rng = np.random.default_rng(11)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    blocks = [crandn(rng, FRAMES * nfft) for _ in range(3)]
    window, spare = cfg.window("cpu"), pfb.pfb_spare_init(cfg, "cpu")
    jwin, jdft, jspare = jcfg.window(), jcfg.dft(), jpfb.pfb_spare_init(jcfg)
    outs, jouts = [], []
    for b in blocks:
        spare, fr = pfb.pfb_frames(cfg, window, spare, torch.from_numpy(b))
        jspare, jfr = jpfb.pfb_frames(jcfg, jwin, jdft, jspare,
                                      jcplx.from_np(b))
        outs.append(fr.numpy())
        jouts.append(jcplx.to_np(jfr))
    out, jout = np.concatenate(outs), np.concatenate(jouts)
    assert out.dtype == np.complex64 and out.shape == (3 * FRAMES, nfft)
    assert golden.snr_db(jout, out) > 90.0
    # zero-primed spare: frame t is golden frame t-(avg-1)
    ref = golden.pfb_frames(np.concatenate(blocks), nfft, AVG)
    n = len(out) - (AVG - 1)
    assert golden.snr_db(ref[:n], out[AVG - 1:]) > 90.0
    assert np.array_equal(spare.numpy(), blocks[-1][-(AVG - 1) * nfft:])


def test_select_and_average_match_jax():
    rng = np.random.default_rng(12)
    frames = crandn(rng, 12, 16)
    bins = np.asarray([3, 7, 15, 0], dtype=np.int64)
    sel = pfb.select_tones(torch.from_numpy(frames), torch.from_numpy(bins))
    jsel = jpfb.select_tones(jcplx.from_np(frames), bins.astype(np.int32))
    assert np.array_equal(sel.numpy(), jcplx.to_np(jsel))
    assert np.array_equal(sel.numpy(), golden.tone_select(frames, bins))
    avg = pfb.average_frames(torch.from_numpy(frames), 4)
    javg = jcplx.to_np(jpfb.average_frames(jcplx.from_np(frames), 4))
    assert avg.shape == (3, 16)
    np.testing.assert_allclose(avg.numpy(), javg, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(avg.numpy(),
                               golden.decimate_spectra(frames, 4),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("nfft", [1000, 200])
@pytest.mark.parametrize("carried", [False, True])
def test_presum_plain_matches_pallas(nfft, carried):
    """The plain pre-sum against the JAX package's Pallas kernel run in
    interpret mode, with a zero spare (stream start) and a carried one."""
    rng = np.random.default_rng(13)
    X = crandn(rng, FRAMES, nfft)
    spare = (crandn(rng, AVG - 1, nfft) if carried
             else np.zeros((AVG - 1, nfft), np.complex64))
    w2 = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE).window(
        "cpu").reshape(AVG, nfft)
    out = presum_plain(w2, torch.from_numpy(spare), torch.from_numpy(X))
    jout = pallas_presum(w2.numpy(), jcplx.from_np(spare), jcplx.from_np(X),
                         interpret=True)
    assert out.dtype == torch.complex64 and out.shape == (FRAMES, nfft)
    assert rel_err(jcplx.to_np(jout), out.numpy()) <= 1e-6
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(presum(w2, torch.from_numpy(spare),
                              torch.from_numpy(X)), out)


def test_pfb_frames_fused_matches_plain_stream():
    rng = np.random.default_rng(14)
    nfft = 200
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    window = cfg.window("cpu")
    s_a = s_b = pfb.pfb_spare_init(cfg, "cpu")
    for _ in range(3):
        x = torch.from_numpy(crandn(rng, FRAMES * nfft))
        s_a, fa = pfb.pfb_frames(cfg, window, s_a, x)
        s_b, fb = pfb_frames_fused(cfg, window, s_b, x)
        assert torch.equal(s_a, s_b)
        assert golden.snr_db(fa.numpy(), fb.numpy()) > 120.0


@pytest.mark.parametrize("bad", ["dtype", "spare_shape", "width"])
def test_presum_rejects_bad_operands(bad):
    nfft = 200
    w2 = torch.ones(AVG, nfft)
    spare = torch.zeros(AVG - 1, nfft, dtype=torch.complex64)
    X = torch.zeros(8, nfft, dtype=torch.complex64)
    if bad == "dtype":
        X = X.to(torch.complex128)
    elif bad == "spare_shape":
        spare = spare[:1]
    else:
        X = X[:, :100]
    with pytest.raises((TypeError, ValueError)):
        presum(w2, spare, X)


def test_comb_period_and_wavetable_match_jax():
    freqs = [k * 1000 for k in range(-8, 8)]
    ampls = [0.5 / (1 + i) for i in range(16)]
    assert tonegen.comb_period(freqs, RATE) == \
        jtone.comb_period(freqs, RATE) == 1000
    assert tonegen.comb_period([12_345], RATE) == 200_000
    blk = tonegen.tone_comb_wavetable_block(freqs, ampls, RATE, 4000)
    jblk = jcplx.to_np(jtone.tone_comb_wavetable_block(freqs, ampls, RATE,
                                                       4000))
    assert blk.dtype == np.complex64 and np.array_equal(blk, jblk)
    ref = golden.tone_block(freqs, ampls, RATE, 0, 4000)
    assert golden.snr_db(ref, blk) > 120.0


def test_tone_comb_block_matches_jax():
    """Aperiodic comb synthesis over 3 blocks, phase carried."""
    freqs = (12_345, -67_891, 300_001)
    ampls = (0.3, 0.3, 0.4)
    L = 10_000
    cfg = tonegen.ToneCombConfig(rate=RATE, freqs=freqs, ampls=ampls,
                                 block_len=L)
    jcfg = jtone.ToneCombConfig(rate=RATE, freqs=freqs, ampls=ampls,
                                block_len=L)
    P, Q = cfg.factors("cpu")
    jP, jQ = jcfg.factors()
    step, jstep = cfg.phase_step("cpu"), jcfg.phase_step()
    ph, jph = cfg.phase_init("cpu"), jcfg.phase_init()
    outs, jouts = [], []
    for _ in range(3):
        ph, x = tonegen.tone_comb_block(P, Q, step, RATE, ph)
        jph, jx = jtone.tone_comb_block(jP, jQ, jstep, RATE, jph)
        assert np.array_equal(ph.numpy(), np.asarray(jph))
        outs.append(x.numpy())
        jouts.append(jcplx.to_np(jx))
    out = np.concatenate(outs)
    assert golden.snr_db(np.concatenate(jouts), out) > 90.0
    ref = golden.tone_block(list(freqs), list(ampls), RATE, 0, 3 * L)
    assert golden.snr_db(ref, out) > 90.0
