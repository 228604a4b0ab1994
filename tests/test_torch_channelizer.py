"""Parity of the PyTorch port's fused channelizer with the JAX package's
Pallas kernel (channelizer_frames_t, run in interpret mode on the CPU)
and with the float64 oracle; and the conversion of JAX streaming state
into the port's.

Bar: 90 dB SNR (tests/test_ops_pfb_chirp.py:50-51) for spectra; exact
equality for carried raw samples.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import pfb as jpfb
from gpu_sdr_tpu.ops import tonegen as jtone
from gpu_sdr_tpu.ops.cplx import DFT
from gpu_sdr_tpu.ops.pallas_channelizer import (
    can_fuse_channelizer as jax_can_fuse, channelizer_frames_t,
    natural_frames_t, transpose_block)
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch.ops import pfb, tonegen
from gpu_sdr_tpu_torch.ops.channelizer import (
    best_split, can_fuse_channelizer, channelizer, channelizer_consts,
    channelizer_frames, channelizer_plain)

torch.set_num_threads(2)

RATE = 1_000_000
AVG = 4
FRAMES = 128


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _golden_stream(x, nfft):
    """Float64 PFB frames of a stream that starts with avg-1 zero frames
    (the zero-primed spare of both packages)."""
    z = np.concatenate([np.zeros((AVG - 1) * nfft, np.complex128),
                        np.asarray(x, np.complex128)])
    return golden.pfb_frames(z, nfft, AVG)


@pytest.mark.parametrize("nfft", [1000, 200])
def test_split_matches_jax(nfft):
    assert best_split(nfft) == DFT(nfft, two_stage=True).split


@pytest.mark.parametrize("nfft", [1000, 200])
@pytest.mark.parametrize("const", [False, True], ids=["stream", "const"])
def test_channelizer_matches_pallas_and_golden(nfft, const):
    """Two blocks: the first starts from the zero spare (stream start),
    the second from the spare the first carried."""
    rng = np.random.default_rng(21 + nfft)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    dft = DFT(nfft, two_stage=True)
    n1, n2 = dft.split
    consts = channelizer_consts(cfg, "cpu")
    spare = torch.zeros(AVG - 1, nfft, dtype=torch.complex64)
    jspare = transpose_block(jpfb.pfb_spare_init(jcfg), nfft, n1, n2)
    stream = []
    for blk in range(2):
        if const:
            frame = crandn(rng, nfft)
            x = torch.from_numpy(frame).reshape(1, nfft)
            jx = transpose_block(jcplx.from_np(frame), nfft, n1, n2)
            spare, fr = channelizer_frames(consts, spare, x, nframes=FRAMES)
            jspare, jfr = channelizer_frames_t(jcfg, jcfg.window(), dft,
                                               jspare, jx, interpret=True,
                                               nframes=FRAMES)
            stream.append(np.tile(frame, FRAMES))
        else:
            xs = crandn(rng, FRAMES * nfft)
            x = torch.from_numpy(xs).reshape(FRAMES, nfft)
            jx = transpose_block(jcplx.from_np(xs), nfft, n1, n2)
            spare, fr = channelizer_frames(consts, spare, x)
            jspare, jfr = channelizer_frames_t(jcfg, jcfg.window(), dft,
                                               jspare, jx, interpret=True)
            stream.append(xs)
        assert fr.dtype == torch.complex64 and fr.shape == (FRAMES, nfft)
        jnat = jcplx.to_np(natural_frames_t(jfr))
        assert golden.snr_db(jnat, fr.numpy()) > 90.0, blk
        assert np.array_equal(spare.numpy(), convert.channelizer_spare(
            jspare, "cpu").numpy()), blk
    ref = _golden_stream(np.concatenate(stream), nfft)[:2 * FRAMES]
    # frames of both blocks, the second one from the carried spare
    assert golden.snr_db(ref[FRAMES:], fr.numpy()) > 90.0


def test_channelizer_plain_is_the_dft_of_the_presum():
    """The two-stage algebra against numpy's FFT of the same pre-sum, in
    natural bin order, at a frame count no 8-aligned tile divides."""
    rng = np.random.default_rng(22)
    nfft, T = 1000, 37
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    w2, F1, G = channelizer_consts(cfg, "cpu")
    spare = crandn(rng, AVG - 1, nfft)
    x = crandn(rng, T, nfft)
    out = channelizer_plain(w2, F1, G, torch.from_numpy(spare),
                            torch.from_numpy(x))
    ext = np.concatenate([spare, x]).astype(np.complex128)
    w = w2.numpy().astype(np.float64)
    pre = sum(w[i] * ext[i:i + T] for i in range(AVG))
    assert golden.snr_db(np.fft.fft(pre, axis=-1), out.numpy()) > 90.0
    assert torch.equal(channelizer(w2, F1, G, torch.from_numpy(spare),
                                   torch.from_numpy(x)), out)


def test_const_frame_mode_computes_every_frame():
    """Const-frame mode is the block of T copies of the frame, frame by
    frame, including the startup frames that read the spare."""
    rng = np.random.default_rng(23)
    nfft, T = 200, 16
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    consts = channelizer_consts(cfg, "cpu")
    spare = torch.from_numpy(crandn(rng, AVG - 1, nfft))
    frame = torch.from_numpy(crandn(rng, 1, nfft))
    s1, a = channelizer_frames(consts, spare, frame, nframes=T)
    s2, b = channelizer_frames(consts, spare, frame.expand(T, nfft))
    assert a.shape == (T, nfft)
    assert torch.equal(s1, s2) and torch.equal(s1, frame.expand(3, nfft))
    assert golden.snr_db(b.numpy(), a.numpy()) > 120.0
    assert golden.snr_db(a[AVG:AVG + 1].numpy(), a[-1:].numpy()) > 120.0
    assert golden.snr_db(a[0].numpy(), a[-1].numpy()) < 60.0


def test_short_block_carries_old_spare():
    """Fewer frames than avg-1: the new spare keeps old spare rows."""
    nfft, T = 200, 2
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    consts = channelizer_consts(cfg, "cpu")
    spare = torch.arange(3 * nfft, dtype=torch.float32).reshape(
        3, nfft).to(torch.complex64)
    x = -torch.ones(T, nfft, dtype=torch.complex64)
    s, _ = channelizer_frames(consts, spare, x)
    assert torch.equal(s, torch.cat([spare, x])[T:])


@pytest.mark.parametrize("nframes", [128, 100, 6000])
def test_can_fuse_is_wider_than_jax(nframes):
    """The port's rule has no 8-aligned tiling condition; it accepts
    every block the JAX kernel accepts and some it refuses."""
    nfft = 1000
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    L = nframes * nfft
    assert can_fuse_channelizer(cfg, L)
    assert jax_can_fuse(jcfg, DFT(nfft, two_stage=True), L) == \
        (nframes != 100)
    assert not can_fuse_channelizer(cfg, L + 1)


def test_convert_channelizer_state_continues_jax_stream():
    """One block in JAX, its transposed spare converted, the next block
    in the port: equal to JAX's next block."""
    rng = np.random.default_rng(24)
    nfft = 1000
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    dft = DFT(nfft, two_stage=True)
    n1, n2 = dft.split
    b1, b2 = crandn(rng, FRAMES * nfft), crandn(rng, FRAMES * nfft)
    jspare = transpose_block(jpfb.pfb_spare_init(jcfg), nfft, n1, n2)
    jspare, _ = channelizer_frames_t(
        jcfg, jcfg.window(), dft, jspare,
        transpose_block(jcplx.from_np(b1), nfft, n1, n2), interpret=True)
    _, jfr2 = channelizer_frames_t(
        jcfg, jcfg.window(), dft, jspare,
        transpose_block(jcplx.from_np(b2), nfft, n1, n2), interpret=True)
    spare = convert.channelizer_spare(jspare, "cpu")
    assert spare.shape == (AVG - 1, nfft)
    assert np.array_equal(spare.numpy(),
                          b1[-(AVG - 1) * nfft:].reshape(AVG - 1, nfft))
    consts = (convert.window(jcfg.window(), "cpu").reshape(AVG, nfft),
              *channelizer_consts(cfg, "cpu")[1:])
    _, fr2 = channelizer_frames(consts, spare,
                                torch.from_numpy(b2).reshape(FRAMES, nfft))
    assert golden.snr_db(jcplx.to_np(natural_frames_t(jfr2)),
                         fr2.numpy()) > 90.0


def test_convert_host_spare_and_tone_phase_continue_jax_stream():
    rng = np.random.default_rng(25)
    nfft = 200
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    b1, b2 = crandn(rng, FRAMES * nfft), crandn(rng, FRAMES * nfft)
    jwin, jdft = jcfg.window(), jcfg.dft()
    jspare, _ = jpfb.pfb_frames(jcfg, jwin, jdft, jpfb.pfb_spare_init(jcfg),
                                jcplx.from_np(b1))
    _, jfr2 = jpfb.pfb_frames(jcfg, jwin, jdft, jspare, jcplx.from_np(b2))
    spare = convert.host_spare(jspare, AVG, nfft, "cpu")
    _, fr2 = pfb.pfb_frames(cfg, convert.window(jwin, "cpu"), spare,
                            torch.from_numpy(b2))
    assert golden.snr_db(jcplx.to_np(jfr2), fr2.numpy()) > 90.0
    with pytest.raises(ValueError):
        convert.host_spare(jspare, AVG, 2 * nfft, "cpu")

    freqs, ampls, L = (12_345, -67_891), (0.5, 0.5), 10_000
    jcc = jtone.ToneCombConfig(rate=RATE, freqs=freqs, ampls=ampls,
                               block_len=L)
    jP, jQ = jcc.factors()
    jph, _ = jtone.tone_comb_block(jP, jQ, jcc.phase_step(), RATE,
                                   jcc.phase_init())
    _, jx2 = jtone.tone_comb_block(jP, jQ, jcc.phase_step(), RATE, jph)
    cc = tonegen.ToneCombConfig(rate=RATE, freqs=freqs, ampls=ampls,
                                block_len=L)
    P, Q = cc.factors("cpu")
    ph = convert.tone_phase(jph, "cpu")
    assert ph.dtype == torch.int64
    _, x2 = tonegen.tone_comb_block(P, Q, cc.phase_step("cpu"), RATE, ph)
    assert golden.snr_db(jcplx.to_np(jx2), x2.numpy()) > 90.0
