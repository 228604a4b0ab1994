"""Parity of the port's two streamed-block kernels' plain versions (on the
CPU) with the JAX package's Pallas kernels in interpret mode and its XLA
routes, on inputs made from a numpy seed:

* #3, ops/channelizer.channelizer_frames_scrambled against
  gpu_sdr_tpu/ops/pallas_channelizer.channelizer_frames: spectra in the
  scrambled Cooley-Tukey order, at 90 dB SNR against JAX and the float64
  oracle; the carried spare bit-equal;
* #19, ops/lockin_at.fused_chirp_lockin against gpu_sdr_tpu/ops/
  pallas_lockin.pallas_chirp_lockin and the XLA route: every lock-in
  point within 1e-5, the new stream position equal, and the integer
  chirp phases of the block exactly equal (across the period seam and
  on a down-chirp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import chirp as jchirp
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import pfb as jpfb
from gpu_sdr_tpu.ops.cplx import DFT
from gpu_sdr_tpu.ops.lockin import lockin_profile
from gpu_sdr_tpu.ops.pallas_channelizer import (
    can_fuse_channelizer as jax_can_fuse, channelizer_frames as jax_frames)
from gpu_sdr_tpu.ops.pallas_lockin import fused_chirp_lockin as jax_lockin
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch.ops import channelizer, chirp, lockin_at, pfb
from gpu_sdr_tpu_torch.ops.channelizer import (
    best_split, can_fuse_channelizer, channelizer_frames_scrambled,
    channelizer_scrambled, scramble_index)
from gpu_sdr_tpu_torch.ops.presum import pfb_frames_fused

torch.set_num_threads(2)

RATE = 1_000_000
SNR_BAR, POINT_TOL = 90.0, 1e-5


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def golden_scrambled(stream, nfft, avg, n1, n2):
    """Float64 PFB frames of a stream after avg-1 zero frames, each
    spectrum's bins at their scrambled positions."""
    z = np.concatenate([np.zeros((avg - 1) * nfft, np.complex128),
                        np.asarray(stream, np.complex128)])
    nat = golden.pfb_frames(z, nfft, avg)
    out = np.empty_like(nat)
    out[:, scramble_index(np.arange(nfft), n1, n2)] = nat
    return out


def run_channelizer(nfft, avg, frames, seed, blocks=2):
    """`blocks` blocks through the port and through JAX from a zero
    spare: (port frames, JAX frames, the stream) per block, the spares
    compared after each."""
    rng = np.random.default_rng(seed)
    cfg = pfb.PFBConfig(nfft=nfft, avg=avg, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=avg, rate=RATE)
    dft = DFT(nfft, two_stage=True)
    assert best_split(nfft) == dft.split
    window = cfg.window("cpu")
    spare, jspare = pfb.pfb_spare_init(cfg, "cpu"), jpfb.pfb_spare_init(jcfg)
    out, jout, stream = [], [], []
    for _ in range(blocks):
        xs = crandn(rng, frames * nfft)
        spare, fr = channelizer_frames_scrambled(cfg, window, spare,
                                                 torch.from_numpy(xs))
        jspare, jfr = jax_frames(jcfg, jcfg.window(), dft, jspare,
                                 jcplx.from_np(xs), interpret=True)
        assert fr.dtype == torch.complex64 and fr.shape == (frames, nfft)
        assert np.array_equal(spare.numpy(), jcplx.to_np(jspare))
        out.append(fr.numpy())
        jout.append(jcplx.to_np(jfr))
        stream.append(xs)
    return out, jout, np.concatenate(stream), dft.split


@pytest.mark.parametrize("nfft,frames", [(1000, 40), (200, 48)])
def test_channelizer_scrambled_matches_pallas_and_golden(nfft, frames):
    """JAX's Pallas route (its gate passes, the spare is not empty), two
    blocks: the stream's start, then the carried spare."""
    avg = 4
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=avg, rate=RATE)
    assert jax_can_fuse(jcfg, DFT(nfft, two_stage=True), frames * nfft)
    before = channelizer_scrambled.launches
    out, jout, stream, (n1, n2) = run_channelizer(nfft, avg, frames,
                                                  31 + nfft)
    assert channelizer_scrambled.launches == before
    for a, b in zip(out, jout):
        assert golden.snr_db(b, a) > SNR_BAR
    ref = golden_scrambled(stream, nfft, avg, n1, n2)
    assert golden.snr_db(ref, np.concatenate(out)) > SNR_BAR


@pytest.mark.parametrize("nfft,avg,frames,port_kernel", [
    (1000, 1, 40, True),        # empty spare: JAX's XLA route
    (1000, 4, 100, True),       # no 8-aligned frame tile: JAX's XLA route
    (1018, 4, 16, False),       # split 2 x 509: the port's kernel refuses
], ids=["empty_spare", "untileable", "port_fallback"])
def test_channelizer_scrambled_fallback_order(nfft, avg, frames,
                                              port_kernel, monkeypatch):
    """Where either package leaves its kernel, the order stays scrambled:
    JAX re-orders its XLA frames, the port its pre-sum route's frames
    (ops/presum.pfb_frames_fused, kernel #2 on the card), and where the
    port's kernel takes a geometry JAX's refuses (ROADMAP Queue 3,
    divergence 20) both agree all the same."""
    cfg = pfb.PFBConfig(nfft=nfft, avg=avg, rate=RATE)
    assert can_fuse_channelizer(cfg, frames * nfft) == port_kernel
    routed = []
    monkeypatch.setattr(channelizer, "pfb_frames_fused",
                        lambda *a: routed.append(a) or
                        pfb_frames_fused(*a))
    out, jout, stream, (n1, n2) = run_channelizer(nfft, avg, frames,
                                                  41 + nfft + avg)
    assert len(routed) == (0 if port_kernel else 2)
    for a, b in zip(out, jout):
        assert golden.snr_db(b, a) > SNR_BAR
    ref = golden_scrambled(stream, nfft, avg, n1, n2)
    assert golden.snr_db(ref, np.concatenate(out)) > SNR_BAR


def test_channelizer_scrambled_continues_from_jax_spare():
    """One block in JAX, its flat spare through convert.host_spare, the
    next block in the port: equal to JAX's next block."""
    rng = np.random.default_rng(45)
    nfft, avg, frames = 1000, 4, 40
    cfg = pfb.PFBConfig(nfft=nfft, avg=avg, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=avg, rate=RATE)
    dft = DFT(nfft, two_stage=True)
    b1, b2 = crandn(rng, frames * nfft), crandn(rng, frames * nfft)
    jspare, _ = jax_frames(jcfg, jcfg.window(), dft,
                           jpfb.pfb_spare_init(jcfg), jcplx.from_np(b1),
                           interpret=True)
    jspare2, jfr = jax_frames(jcfg, jcfg.window(), dft, jspare,
                              jcplx.from_np(b2), interpret=True)
    spare = convert.host_spare(jspare, avg, nfft, "cpu")
    spare2, fr = channelizer_frames_scrambled(
        cfg, convert.window(jcfg.window(), "cpu"), spare,
        torch.from_numpy(b2))
    assert golden.snr_db(jcplx.to_np(jfr), fr.numpy()) > SNR_BAR
    assert np.array_equal(spare2.numpy(), jcplx.to_np(jspare2))


def test_scramble_index_matches_jax():
    for nfft in (1000, 200, 1018):
        n1, n2 = best_split(nfft)
        k = np.arange(nfft)
        assert np.array_equal(scramble_index(k, n1, n2),
                              DFT(nfft, two_stage=True).scramble_index(k))


def test_channelizer_scrambled_checks_operands():
    cfg = pfb.PFBConfig(nfft=200, avg=4, rate=RATE)
    with pytest.raises(ValueError, match="channelizer_frames_scrambled"):
        channelizer_frames_scrambled(cfg, cfg.window("cpu"),
                                     pfb.pfb_spare_init(cfg, "cpu"),
                                     torch.zeros(250, dtype=torch.complex64))


# (f_start, f_end, steps, chirp_t): the JAX test's up-chirp and a
# down-chirp, whose chirpness wraps past 2^31
CHIRPS = {"up": (-300_000, 300_000, 100, 0.02),
          "down": (300_000, -300_000, 100, 0.02)}


def chirp_configs(name):
    f0, f1, steps, t = CHIRPS[name]
    return (chirp.ChirpConfig.from_params(f0, f1, RATE, steps, t),
            jchirp.ChirpConfig.from_params(f0, f1, RATE, steps, t))


@pytest.mark.parametrize("start", ["zero", "seam"])
@pytest.mark.parametrize("name", list(CHIRPS))
def test_chirp_lockin_matches_pallas_and_xla(name, start):
    """Two blocks of 64 segments from position 0, or from 5000 samples
    before the period's end (the first block crosses the seam)."""
    cfg, jcfg = chirp_configs(name)
    if name == "down":
        assert cfg.chirpness & chirp.M32 >= 2 ** 31
    ppt, nseg = cfg.length, 64
    L = nseg * ppt
    last = 0 if start == "zero" else cfg.period - 5000
    rng = np.random.default_rng(51 + len(name) + len(start))
    prof_np = lockin_profile(ppt)
    prof = torch.from_numpy(prof_np)
    jlast = jnp.uint32(last)
    before = lockin_at.fused_chirp_lockin.launches
    for _ in range(2):
        # the block's integer phases, exactly
        n = np.arange(L, dtype=np.int64)
        idx = chirp.chirp_phase_index(cfg, last, torch.from_numpy(n))
        jidx = jchirp.chirp_phase_index(jcfg, jlast,
                                        jnp.asarray(n.astype(np.uint32)))
        assert np.array_equal(idx.numpy(), np.asarray(jidx).astype(np.int64))
        x = crandn(rng, L)
        new, y = lockin_at.fused_chirp_lockin(cfg, prof, last,
                                              torch.from_numpy(x))
        jnew, jy = jax_lockin(jcfg, jnp.asarray(prof_np), jlast,
                              jcplx.from_np(x), use_pallas=True,
                              interpret=True)
        xnew, xy = jax_lockin(jcfg, jnp.asarray(prof_np), jlast,
                              jcplx.from_np(x), use_pallas=False)
        assert y.shape == (nseg,) and y.dtype == torch.complex64
        assert new == int(jnew) == int(xnew)
        assert np.abs(y.numpy() - jcplx.to_np(jy)).max() <= POINT_TOL
        assert np.abs(y.numpy() - jcplx.to_np(xy)).max() <= POINT_TOL
        last, jlast = new, jnew
    assert lockin_at.fused_chirp_lockin.launches == before


def test_chirp_lockin_matches_golden():
    """Two blocks against the float64 chirp demodulator and lock-in."""
    cfg, _ = chirp_configs("up")
    ppt, nseg = cfg.length, 32
    L = nseg * ppt
    x = crandn(np.random.default_rng(53), 2 * L)
    prof = torch.from_numpy(lockin_profile(ppt))
    last, outs = 0, []
    for b in range(2):
        last, y = lockin_at.pallas_chirp_lockin(
            cfg, prof, last, torch.from_numpy(x[b * L:(b + 1) * L]))
        outs.append(y.numpy())
    cp = golden.ChirpParameter(*CHIRPS["up"][:2], RATE, *CHIRPS["up"][2:])
    ref = golden.GoldenVNADecimator(ppt)(golden.chirp_demod(cp, 0, x))
    assert golden.snr_db(ref, np.concatenate(outs)) > SNR_BAR


def test_chirp_lockin_continues_from_jax_position():
    """A lock-in stream started in JAX (a uint32 position) continues in
    the port through convert.chirp_state."""
    cfg, jcfg = chirp_configs("down")
    ppt, nseg = cfg.length, 16
    rng = np.random.default_rng(57)
    b1, b2 = crandn(rng, nseg * ppt), crandn(rng, nseg * ppt)
    prof_np = lockin_profile(ppt)
    jlast, _ = jax_lockin(jcfg, jnp.asarray(prof_np),
                          jnp.uint32(cfg.period - 1000), jcplx.from_np(b1),
                          use_pallas=True, interpret=True)
    jnew, jy = jax_lockin(jcfg, jnp.asarray(prof_np), jlast,
                          jcplx.from_np(b2), use_pallas=True, interpret=True)
    new, y = lockin_at.fused_chirp_lockin(cfg, torch.from_numpy(prof_np),
                                          convert.chirp_state(jlast),
                                          torch.from_numpy(b2))
    assert new == int(jnew)
    assert np.abs(y.numpy() - jcplx.to_np(jy)).max() <= POINT_TOL


def test_chirp_lockin_takes_any_segment_count():
    """JAX's kernel asserts nseg % 8 == 0; the port takes 20 segments
    (ROADMAP Queue 3, divergence 20) and matches JAX's XLA route."""
    cfg, jcfg = chirp_configs("up")
    ppt, nseg = cfg.length, 20
    x = crandn(np.random.default_rng(55), nseg * ppt)
    prof_np = lockin_profile(ppt)
    with pytest.raises(AssertionError):
        jax_lockin(jcfg, jnp.asarray(prof_np), jnp.uint32(7),
                   jcplx.from_np(x), use_pallas=True, interpret=True)
    new, y = lockin_at.fused_chirp_lockin(cfg, torch.from_numpy(prof_np), 7,
                                          torch.from_numpy(x))
    jnew, jy = jax_lockin(jcfg, jnp.asarray(prof_np), jnp.uint32(7),
                          jcplx.from_np(x))
    assert new == int(jnew)
    assert np.abs(y.numpy() - jcplx.to_np(jy)).max() <= POINT_TOL
    with pytest.raises(ValueError, match="whole segments"):
        lockin_at.fused_chirp_lockin(cfg, torch.from_numpy(prof_np), 0,
                                     torch.from_numpy(x[:-1]))
