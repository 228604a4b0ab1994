"""The device replay's three kernels, their plain versions on the CPU,
against the JAX package's Pallas kernels (interpret mode) and float64
oracles:

* #6 ``presum_at`` (gpu_sdr_tpu/ops/pallas_pfb.pallas_presum_at);
* #4 ``channelizer_at`` (pallas_channelizer.channelizer_frames_at, its
  transposed output brought to natural order by natural_frames_t);
* #18 ``lockin_at`` (pallas_lockin.pallas_chirp_lockin_at).

Each on block `idx` of a resident recording: the stream's first block
(zero halo), an interior block, the last one, and block 0 after the loop
seam (its halo the recording's last frames).  Bars: 90 dB SNR
(tests/test_ops_pfb_chirp.py:50-51); the carried stream position equal.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import chirp as jchirp
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import pfb as jpfb
from gpu_sdr_tpu.ops.cplx import C, DFT
from gpu_sdr_tpu.ops.pallas_channelizer import (
    channelizer_frames_at, natural_frames_t, transpose_block)
from gpu_sdr_tpu.ops.pallas_lockin import pallas_chirp_lockin_at
from gpu_sdr_tpu.ops.pallas_pfb import pallas_presum_at
from gpu_sdr_tpu_torch.ops import chirp, lockin, pfb
from gpu_sdr_tpu_torch.ops.channelizer import (channelizer_at,
                                               channelizer_at_plain,
                                               channelizer_consts)
from gpu_sdr_tpu_torch.ops.lockin_at import lockin_at
from gpu_sdr_tpu_torch.ops.presum import presum_at

torch.set_num_threads(2)

RATE, AVG, FRAMES, NBLK = 1_000_000, 4, 64, 4
# (block, valid): stream start, interior, last, block 0 after the seam
BLOCKS = [(0, 0), (2, 1), (3, 1), (0, 1)]
IDS = ["start", "interior", "last", "seam"]


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def golden_block(rec, nfft, idx, valid):
    """Float64 PFB frames of block idx: its avg-1 halo frames (the
    recording's frames before it, wrapped; zero if not valid), then its
    own frames."""
    frames = rec.reshape(-1, nfft).astype(np.complex128)
    base = idx * FRAMES
    halo = frames[np.arange(base - AVG + 1, base) % len(frames)]
    if not valid:
        halo = np.zeros_like(halo)
    x = np.concatenate([halo, frames[base:base + FRAMES]]).ravel()
    return golden.pfb_frames(x, nfft, AVG, window=pfb.PFBConfig(
        nfft=nfft, avg=AVG, rate=RATE).window("cpu").numpy())


@pytest.mark.parametrize("idx, valid", BLOCKS, ids=IDS)
def test_presum_at_matches_jax_and_golden(idx, valid):
    nfft = 1000
    rec = crandn(np.random.default_rng(40 + idx), NBLK * FRAMES * nfft)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    w2 = cfg.window("cpu").reshape(AVG, nfft)
    X = torch.from_numpy(rec).reshape(-1, nfft)
    ours = presum_at(w2, X, idx, valid, FRAMES)
    xc = jcplx.from_np(rec)
    jpre = pallas_presum_at(w2.numpy(), C(xc.re.reshape(-1, nfft),
                                          xc.im.reshape(-1, nfft)),
                            idx, valid, FRAMES, interpret=True)
    assert ours.shape == (FRAMES, nfft) and ours.dtype == torch.complex64
    assert golden.snr_db(jcplx.to_np(jpre), ours.numpy()) > 90.0
    ref = golden_block(rec, nfft, idx, valid)
    assert golden.snr_db(ref, np.fft.fft(ours.numpy(), axis=-1)) > 90.0


@pytest.mark.parametrize("nfft", [1000, 200])
@pytest.mark.parametrize("idx, valid", BLOCKS, ids=IDS)
def test_channelizer_at_matches_jax_and_golden(nfft, idx, valid):
    rec = crandn(np.random.default_rng(50 + idx), NBLK * FRAMES * nfft)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    dft = DFT(nfft, two_stage=True)
    X = torch.from_numpy(rec).reshape(-1, nfft)
    ours = channelizer_at(*channelizer_consts(cfg, "cpu"), X, idx, valid,
                          FRAMES)
    Xt = transpose_block(jcplx.from_np(rec), nfft, *dft.split)
    jfr = channelizer_frames_at(jcfg, jcfg.window(), dft, Xt, idx, valid,
                                nframes=FRAMES, interpret=True)
    assert ours.shape == (FRAMES, nfft) and ours.dtype == torch.complex64
    assert golden.snr_db(jcplx.to_np(natural_frames_t(jfr)),
                         ours.numpy()) > 90.0
    assert golden.snr_db(golden_block(rec, nfft, idx, valid),
                         ours.numpy()) > 90.0


def test_at_wrappers_check_operands_and_count_no_cpu_launch():
    cfg = pfb.PFBConfig(nfft=200, avg=AVG, rate=RATE)
    consts = channelizer_consts(cfg, "cpu")
    X = torch.zeros(NBLK * FRAMES, 200, dtype=torch.complex64)
    before = (channelizer_at.launches, presum_at.launches,
              lockin_at.launches)
    assert torch.equal(channelizer_at(*consts, X, 1, 1, FRAMES),
                       channelizer_at_plain(*consts, X, 1, 1, FRAMES))
    presum_at(consts[0], X, 1, 1, FRAMES)
    with pytest.raises(ValueError, match="outside the recording"):
        channelizer_at(*consts, X, NBLK, 1, FRAMES)
    with pytest.raises(ValueError, match="outside the recording"):
        presum_at(consts[0], X, NBLK, 1, FRAMES)
    with pytest.raises(TypeError):
        presum_at(consts[0], X.real.contiguous(), 0, 1, FRAMES)
    ccfg, _, _, _ = chirp_configs(False)
    prof = torch.from_numpy(lockin.lockin_profile(PPT))
    R = torch.zeros(2 * NSEG, PPT, dtype=torch.complex64)
    with pytest.raises(ValueError, match="outside the recording"):
        lockin_at(ccfg, prof, 0, R, 2, NSEG)
    lockin_at(ccfg, prof, 0, R, 1, NSEG)
    assert (channelizer_at.launches, presum_at.launches,
            lockin_at.launches) == before


# #18: the small chirp of the port's CHIRP tests, period 128,000
PPT, NSEG = 1000, 16
CHIRP_ARGS = (-300_000, 300_000, RATE, 128, 0.128)


def chirp_configs(down: bool):
    f0, f1, *rest = CHIRP_ARGS
    args = (f1, f0, *rest) if down else CHIRP_ARGS
    return (chirp.ChirpConfig.from_params(*args),
            jchirp.ChirpConfig.from_params(*args),
            golden.ChirpParameter(*args), args)


@pytest.mark.parametrize("down", [False, True], ids=["up", "down"])
@pytest.mark.parametrize("last, idx", [
    (0, 0),                     # stream start
    (37_000, 2),                # interior
    (128_000 - 3_500, 3),       # crosses the period seam inside the block
    (128_000 - 1, 1),           # the last position of the period
], ids=["start", "interior", "seam", "period_end"])
def test_lockin_at_matches_jax_and_golden(down, last, idx):
    cfg, jcfg, gcp, _ = chirp_configs(down)
    assert cfg.period == 128_000
    rec = crandn(np.random.default_rng(60 + idx), NBLK * NSEG, PPT)
    prof_np = lockin.lockin_profile(PPT)
    new, ours = lockin_at(cfg, torch.from_numpy(prof_np), last,
                          torch.from_numpy(rec), idx, NSEG)
    jnew, jy = pallas_chirp_lockin_at(
        jcfg, prof_np, np.uint32(last), jcplx.from_np(rec), idx, NSEG,
        interpret=True)
    assert new == int(jnew) == (last + NSEG * PPT) % cfg.period
    assert ours.shape == (NSEG,) and ours.dtype == torch.complex64
    assert golden.snr_db(jcplx.to_np(jy), ours.numpy()) > 90.0
    z = golden.chirp_demod(gcp, last, rec[idx * NSEG:(idx + 1) * NSEG]
                           .ravel())
    ref = z.reshape(NSEG, PPT) @ prof_np.astype(np.float64)
    assert golden.snr_db(ref, ours.numpy()) > 90.0


def test_lockin_at_on_the_chirp_is_unit():
    """Fed the chirp from the same position, every lock-in point is
    sum_k w[k] |c|^2 = 1."""
    cfg, _, _, _ = chirp_configs(False)
    last = cfg.period - 5_000
    _, c = chirp.chirp_block(cfg, last, NSEG * PPT, device="cpu")
    _, y = lockin_at(cfg, torch.from_numpy(lockin.lockin_profile(PPT)),
                     last, c.reshape(NSEG, PPT), 0, NSEG)
    np.testing.assert_allclose(y.numpy(), 1.0, atol=1e-5)
