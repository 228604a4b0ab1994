"""The port's last three ops against the JAX package's (ROADMAP Queue 1
item 8): the batched Welch PSD (gpu_sdr_tpu_torch/ops/spectral.py, on
torch.fft) against scipy.signal.welch and JAX's DFT-matmul version; the
streaming decimating FIR (ops/fir.streaming_fir) over two blocks
against JAX's and golden.GoldenFIR; the iFFT comb wavetable
(ops/tonegen.tone_comb_wavetable) bit for bit.  Modelled on
tests/test_spectral.py and tests/test_ops_ddc.py:85-106.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import fir as jfir
from gpu_sdr_tpu.ops import spectral as jspectral
from gpu_sdr_tpu.ops import tonegen as jtonegen
from gpu_sdr_tpu_torch import ops
from gpu_sdr_tpu_torch.ops import spectral

REL = 1e-4              # relative bar on linear power (tests/test_spectral.py)
FS = 12_500.0


def rel_err(a, b):
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-20)))


@pytest.mark.parametrize("nperseg", [256, 500, 1000])
def test_welch_matches_scipy_and_jax(nperseg):
    x = np.random.default_rng(9).standard_normal((4, 6000)).astype(
        np.float32)
    f_ref, p_ref = signal.welch(x, fs=FS, nperseg=nperseg,
                                detrend="linear", scaling="density")
    f, p = ops.batched_welch(x, FS, nperseg, device="cpu")
    fj, pj = jspectral.batched_welch(x, FS, nperseg)
    assert p.dtype == np.float32 and p.shape == p_ref.shape
    assert np.array_equal(f, f_ref)
    # divergence 29: JAX's axis comes out of jax.jit as float32
    assert f.dtype == np.float64 and fj.dtype == np.float32
    assert np.array_equal(f.astype(np.float32), fj)
    assert rel_err(p, p_ref) < REL
    assert rel_err(p, pj) < REL


def test_welch_peak_location():
    fs = 10_000.0
    t = np.arange(20_000) / fs
    x = np.sin(2 * np.pi * 1234.0 * t)[None, :].astype(np.float32)
    f, p = ops.batched_welch(x, fs, 2000, device="cpu")
    assert abs(f[np.argmax(p[0])] - 1234.0) < fs / 2000


@pytest.mark.parametrize("nperseg", [300, 301])
@pytest.mark.parametrize("shape", [(3001,), (3, 3001), (2, 3, 3001)])
def test_welch_psd_matches_jax_on_batched_rows(shape, nperseg):
    """welch_psd on any leading shape, with an even nperseg (Nyquist not
    doubled) and an odd one, against JAX's."""
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    f, p = spectral.welch_psd(torch.from_numpy(x), FS, nperseg)
    fj, pj = jspectral.welch_psd(jnp.asarray(x), FS, nperseg)
    assert f.dtype == np.float64 and np.array_equal(f, fj)
    assert p.shape == shape[:-1] + (nperseg // 2 + 1,)
    assert rel_err(p.numpy(), np.asarray(pj)) < REL


def test_welch_clamps_nperseg_with_a_warning():
    """nperseg > N: clamped to N with JAX's warning, and then scipy's
    one-segment estimate."""
    x = np.random.default_rng(6).standard_normal((2, 700)).astype(np.float32)
    with pytest.warns(UserWarning, match="nperseg=1000 > data length 700"):
        f, p = ops.batched_welch(x, FS, 1000, device="cpu")
    with pytest.warns(UserWarning):
        f_ref, p_ref = signal.welch(x, fs=FS, nperseg=1000, detrend="linear",
                                    scaling="density")
    with pytest.warns(UserWarning, match="nperseg=1000 > data length 700"):
        _, pj = jspectral.batched_welch(x, FS, 1000)
    assert len(f) == 351 and np.allclose(f, f_ref)
    assert rel_err(p, p_ref) < REL and rel_err(p, pj) < REL


def test_welch_frames_by_unfold():
    """The segments are a view of the rows (no gather): hann_periodic is
    scipy's periodic Hann, and the frames are the strided windows."""
    assert np.allclose(spectral.hann_periodic(64),
                       signal.get_window("hann", 64, fftbins=True))
    assert np.array_equal(spectral.hann_periodic(64),
                          jspectral.hann_periodic(64))
    x = torch.arange(20, dtype=torch.float32)
    seg = spectral._detrend_linear(x.unfold(-1, 8, 4))
    ref = signal.detrend(np.arange(20, dtype=np.float32)[
        np.arange(4)[:, None] * 4 + np.arange(8)], type="linear")
    assert seg.shape == (4, 8) and np.abs(seg.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("M, f", [(8, 5), (100, 4), (10, 1)])
def test_streaming_fir_matches_jax_and_golden(M, f):
    """Two blocks through streaming_fir (the history carried), >= 90 dB
    against JAX's streaming_fir and against golden.GoldenFIR."""
    rng = np.random.default_rng(M * 10 + f)
    taps = jfir.fir_taps_direct(M, f, dtype=np.float64)
    assert np.array_equal(ops.fir_taps_direct(M, f),
                          jfir.fir_taps_direct(M, f))
    L, C = 40 * M, 3
    blocks = [(rng.standard_normal((C, L)) +
               1j * rng.standard_normal((C, L))).astype(np.complex64)
              for _ in range(2)]
    golds = [golden.GoldenFIR(taps, M, f) for _ in range(C)]
    ref = np.concatenate([np.stack([g(b[c]) for c, g in enumerate(golds)])
                          for b in blocks], axis=1)
    tt = torch.from_numpy(taps.astype(np.float32))
    state = ops.fir_init_state(C, M, f, device="cpu")
    assert state.shape == (C, (f - 1) * M) and state.dtype == torch.complex64
    tj = jnp.asarray(taps.astype(np.float32))
    jstate = jfir.fir_init_state(C, M, f)
    outs, jouts = [], []
    for b in blocks:
        state, y = ops.streaming_fir(tt, state, torch.from_numpy(b))
        jstate, yj = jax.jit(lambda s, z: jfir.streaming_fir(tj, s, z))(
            jstate, jcplx.from_np(b))
        assert y.shape == (C, L // M) and y.dtype == torch.complex64
        outs.append(y.numpy())
        jouts.append(jcplx.to_np(yj))
    out, jout = np.concatenate(outs, axis=1), np.concatenate(jouts, axis=1)
    assert golden.snr_db(ref, out) >= 90.0
    assert golden.snr_db(jout.astype(np.complex128), out) >= 90.0
    assert np.array_equal(state.numpy(), blocks[1][:, L - (f - 1) * M:])


@pytest.mark.parametrize("freqs, ampls, rate, scale", [
    ([1, -3, 250], [0.5, 0.25, 0.125], 1000, 1.0),
    ([123_456, -7, 0, 499_999], [1.0, 0.5, 0.5, 2.0], 1_000_000, 0.3),
    ([5, 5], [0.1, 0.2], 16, 2.0),
])
def test_tone_comb_wavetable_is_jaxs(freqs, ampls, rate, scale):
    got = ops.tone_comb_wavetable(freqs, ampls, rate, scale)
    want = jtonegen.tone_comb_wavetable(freqs, ampls, rate, scale)
    assert got.dtype == want.dtype == np.complex64
    assert np.array_equal(got, want)
