"""The sharded layer's three kernels, their plain versions on the CPU,
against the JAX package's Pallas kernels (interpret mode) and float64
oracles, on one shard's operands of a (time=2) mesh:

* #5 ``channelizer_at_halo`` (gpu_sdr_tpu/ops/pallas_channelizer.
  channelizer_frames_at_halo, its transposed output brought to natural
  order by natural_frames_t);
* #10 ``ShardedReplayDDC.local`` (pallas_replay.ShardedReplayDDC.
  invoke_local);
* #15 ``chain`` (pallas_chain.TonesDirectChain.invoke).

Each at the stream's start, inside, and at the seam (the loop seam of a
recording, the block seam of the chain), on shard 0 and on shard 1,
whose history lies on shard 0.  Bars: 90 dB SNR against JAX and the
float64 oracles (tests/test_ops_pfb_chirp.py:50-51); the carried phases
equal.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import ddc as jddc
from gpu_sdr_tpu.ops import pfb as jpfb
from gpu_sdr_tpu.ops.cplx import C, DFT
from gpu_sdr_tpu.ops.pallas_chain import TonesDirectChain as JChain
from gpu_sdr_tpu.ops.pallas_channelizer import (
    _HALO_T, channelizer_frames_at_halo, natural_frames_t)
from gpu_sdr_tpu.ops.pallas_replay import (ShardedReplayDDC as JShardedRDDC,
                                           _HUNIT)
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch.ops import ddc, pfb
from gpu_sdr_tpu_torch.ops.chain import TonesDirectChain, chain, chain_plain
from gpu_sdr_tpu_torch.ops.channelizer import (
    channelizer_at_halo, channelizer_at_halo_plain, channelizer_consts)
from gpu_sdr_tpu_torch.ops.presum import shard_spans, staged_halos
from gpu_sdr_tpu_torch.ops.replay_ddc import ShardedReplayDDC

torch.set_num_threads(2)

RATE, T, NBLK = 1_000_000, 2, 4
# (block, valid, shard): the stream's start on both shards (valid is
# shard 0's alone), inside, the last block, block 0 after the loop seam
CASES = [(0, 0, 0), (0, 0, 1), (2, 1, 0), (3, 1, 1), (0, 1, 0), (0, 1, 1)]
IDS = ["start-0", "start-1", "inside-0", "last-1", "seam-0", "seam-1"]


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def snr(ref, got):
    return golden.snr_db(np.asarray(ref), np.asarray(got))


# ---- #5 -------------------------------------------------------------
NFFT, AVG, FTL = 1000, 4, 64            # 64 frames per shard per block


@pytest.fixture(scope="module")
def tones_recording():
    return crandn(np.random.default_rng(5), NBLK * T * FTL * NFFT)


def jax_halo_operands(rec, t, n1, n2):
    """Shard t's transposed span and staged halo units, laid out as
    gpu_sdr_tpu/parallel/sharded_replay._try_channelizer_replay does."""
    Tf = T * FTL
    fr = rec.reshape(NBLK, T, FTL, NFFT)
    g = fr[:, t].reshape(NBLK * FTL, n1, n2).transpose(1, 0, 2)
    allf = rec.reshape(NBLK * Tf, NFFT)
    h = np.stack([allf[np.arange(b * Tf + t * FTL - _HALO_T,
                                 b * Tf + t * FTL) % (NBLK * Tf)]
                  for b in range(NBLK)])
    hg = h.reshape(NBLK * _HALO_T, n1, n2).transpose(1, 0, 2)
    return (jcplx.from_np(np.ascontiguousarray(g)),
            jcplx.from_np(np.ascontiguousarray(hg)))


@pytest.mark.parametrize("idx, valid, t", CASES, ids=IDS)
def test_channelizer_at_halo_matches_jax_and_golden(tones_recording, idx,
                                                    valid, t):
    rec = tones_recording
    v = valid if t == 0 else 1          # only shard 0 owns the start
    cfg = pfb.PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    X = torch.from_numpy(rec).reshape(-1, NFFT)
    span = shard_spans(X, NBLK, T)[t]
    halo = staged_halos(X, NBLK, T, AVG - 1)[t]
    ours = channelizer_at_halo(*channelizer_consts(cfg, "cpu"), span, halo,
                               idx, v, FTL)
    assert ours.shape == (FTL, NFFT) and ours.dtype == torch.complex64
    jcfg = jpfb.PFBConfig(nfft=NFFT, avg=AVG, rate=RATE)
    dft = DFT(NFFT, two_stage=True)
    Xt, Hs = jax_halo_operands(rec, t, *dft.split)
    jfr = channelizer_frames_at_halo(jcfg, jcfg.window(), dft, Xt, Hs, idx,
                                     v, nframes=FTL, interpret=True)
    assert snr(jcplx.to_np(natural_frames_t(jfr)), ours.numpy()) > 90.0
    # float64: the block's frames in stream order after the avg-1 frames
    # before them (wrapped; zero at the stream's start)
    frames = rec.reshape(-1, NFFT).astype(np.complex128)
    base = idx * T * FTL + t * FTL
    h = frames[np.arange(base - AVG + 1, base) % len(frames)]
    x = np.concatenate([h if v else np.zeros_like(h),
                        frames[base:base + FTL]]).ravel()
    ref = golden.pfb_frames(x, NFFT, AVG,
                            window=cfg.window("cpu").numpy())
    assert snr(ref, ours.numpy()) > 90.0


def test_channelizer_at_halo_checks_operands_and_counts_no_cpu_launch():
    cfg = pfb.PFBConfig(nfft=200, avg=AVG, rate=RATE)
    consts = channelizer_consts(cfg, "cpu")
    X = torch.zeros(NBLK * FTL, 200, dtype=torch.complex64)
    Hs = torch.zeros(NBLK, AVG - 1, 200, dtype=torch.complex64)
    before = channelizer_at_halo.launches
    assert torch.equal(channelizer_at_halo(*consts, X, Hs, 1, 1, FTL),
                       channelizer_at_halo_plain(*consts, X, Hs, 1, 1, FTL))
    with pytest.raises(ValueError, match="channelizer_at_halo"):
        channelizer_at_halo(*consts, X, Hs, NBLK, 1, FTL)
    with pytest.raises(ValueError, match="channelizer_at_halo"):
        channelizer_at_halo(*consts, X, Hs[:2], 0, 1, FTL)
    assert channelizer_at_halo.launches == before


# ---- #10 ------------------------------------------------------------
M, F, L = 20, 4, 10_240                 # 512 rows a block, 256 per shard
FREQS = (100_003, -250_001, 31_250)


def direct_cfgs():
    kw = dict(rate=RATE, decim=M, pf_average=F, freqs=FREQS,
              phases=(0,) * len(FREQS))
    return ddc.DirectDDCConfig(**kw), jddc.DirectDDCConfig(**kw)


def golden_rows(rec, a0, n_rows, zero_history):
    """Float64 DIRECT rows from absolute sample a0 of a looped recording:
    mix-down at the absolute index, then the FIR over the f-1 rows before
    (zero at the stream's start)."""
    H = (F - 1) * M
    a = np.arange(a0 - H, a0 + n_rows * M, dtype=np.int64)
    x = rec[a % len(rec)].astype(np.complex128)
    if zero_history:
        x[:H] = 0
    h = golden.direct_fir_taps(M, F).astype(np.float64)
    out = np.empty((n_rows, len(FREQS)), np.complex128)
    for c, f in enumerate(FREQS):
        z = x * np.exp(-2j * np.pi * (((f % RATE) * (a % RATE)) % RATE) /
                       RATE)
        win = np.lib.stride_tricks.sliding_window_view(z, len(h))
        out[:, c] = win[::M][:n_rows] @ h
    return out


@pytest.mark.parametrize("idx, valid, t", CASES, ids=IDS)
def test_sharded_replay_ddc_matches_jax_and_golden(idx, valid, t):
    rec = crandn(np.random.default_rng(10), NBLK * L)
    cfg, jcfg = direct_cfgs()
    jrk = JShardedRDDC(jcfg, rec, L, T, blocks_per_exec=1, interpret=True)
    assert jrk.ok
    rk = ShardedReplayDDC(cfg, torch.from_numpy(rec), L, ["cpu"] * T)
    assert (rk.nbr, rk.nbr_t, rk.nblk) == (jrk.nbr, jrk.nbr_t, jrk.nblk)
    # the JAX state after `nabs` blocks (the seam: the whole recording)
    nabs = NBLK if (idx, valid) == (0, 1) else idx
    jst = jrk.init_state()
    for _ in range(nabs):
        jst = jrk._block_rots_and_advance(jst, 1)[3]
    if not valid:
        jst = (jst[0], jst[1], np.int32(0))
    st = convert.replay_state(jst, "cpu")
    assert st[0] == idx
    ours = rk.local(st, t)
    nt = rk.nbr_t
    assert ours.shape == (nt, len(FREQS)) and ours.dtype == torch.complex64
    idxs, val, drots, new = jrk._block_rots_and_advance(jst, 1)
    rep8 = C(np.repeat(np.asarray(drots.re), 8, 0),
             np.repeat(np.asarray(drots.im), 8, 0))
    Xl = jcplx.from_np(jrk.X_np[t * NBLK * nt:(t + 1) * NBLK * nt]
                       .astype(np.complex64))
    Hl = jcplx.from_np(jrk.H_np[t * NBLK * _HUNIT:(t + 1) * NBLK * _HUNIT])
    rampl = C(jrk._ramp.re[t * nt:(t + 1) * nt],
              jrk._ramp.im[t * nt:(t + 1) * nt])
    jy = jrk.invoke_local(idxs, val if t == 0 else np.ones(1, np.int32),
                          rep8, Xl, Hl, rampl)
    assert snr(jcplx.to_np(jy), ours.numpy()) > 90.0
    a0 = nabs * L + t * (L // T)
    ref = golden_rows(rec, a0, nt, zero_history=(a0 == 0 and not valid))
    assert snr(ref, ours.numpy()) > 90.0
    # the carried state advances as the JAX package's, phase exactly
    st2 = rk.step(st)[0]
    assert st2[0] == int(new[0]) and st2[2] == int(new[2])
    assert np.array_equal(st2[1].numpy(), np.asarray(new[1]))


def test_sharded_replay_ddc_plans_and_counts_no_cpu_launch():
    cfg, _ = direct_cfgs()
    assert ShardedReplayDDC.plan_tiles(cfg, NBLK * L, L, T) == (512, 256, 4)
    assert ShardedReplayDDC.plan_tiles(cfg, NBLK * L, L, 3) is None
    assert ShardedReplayDDC.plan_tiles(cfg, NBLK * L + 1, L, T) is None
    rk = ShardedReplayDDC(cfg, torch.zeros(NBLK * L, dtype=torch.complex64),
                          L, ["cpu"] * T)
    before = ShardedReplayDDC.launches
    st, ys = rk.step(rk.init_state())
    assert [y.shape for y in ys] == [(256, 3)] * T
    assert ShardedReplayDDC.launches == before


# ---- #15 ------------------------------------------------------------
CM, CL = 10, 40_000                     # 4000 rows a block, 2000 a shard
COMB = (12_345, -67_891, 300_001)
CAMPL = (0.4, 0.3, 0.2)


def chain_pair():
    kw = dict(rate=RATE, decim=CM, pf_average=F, freqs=COMB,
              phases=(0,) * len(COMB))
    ours = TonesDirectChain(RATE, COMB, CAMPL, ddc.DirectDDCConfig(**kw),
                            CL, time_shards=T)
    theirs = JChain(rate=RATE, tx_freqs=COMB, tx_ampls=CAMPL,
                    cfg=jddc.DirectDDCConfig(**kw), block_len=CL,
                    time_shards=T, interpret=True)
    assert ours.ok and theirs.ok
    return ours, theirs


@pytest.mark.parametrize("blk, t", [(0, 0), (0, 1), (1, 0), (1, 1), (3, 1)],
                         ids=["start-0", "start-1", "seam-0", "seam-1",
                              "inside-1"])
def test_chain_matches_jax_and_golden(blk, t):
    ours, theirs = chain_pair()
    nbt = ours.nb // T
    jst = theirs.init_state()
    for _ in range(blk):
        jst = theirs.block_rotations(jst, 1)[0]
    st = convert.fold_state(jst, "cpu")
    new, srot, hrot0, drot = ours.block_rotations(st)
    y = chain(ours.P[t * nbt:(t + 1) * nbt], ours.halo_rows(t * nbt),
              ours.G, ours.ramp[t * nbt:(t + 1) * nbt], srot,
              hrot0 if t == 0 else srot, drot)
    assert y.shape == (nbt, len(COMB)) and y.dtype == torch.complex64
    jnew, srots, hrots, drots = theirs.block_rotations(jst, 1)
    R = theirs.R
    lo, hi = t * (nbt // R) * 8, (t + 1) * (nbt // R) * 8
    jy = theirs.invoke(
        C(theirs._P.re[t * nbt:(t + 1) * nbt],
          theirs._P.im[t * nbt:(t + 1) * nbt]),
        C(theirs._lP.re[lo:hi], theirs._lP.im[lo:hi]), theirs._G,
        C(theirs._ramp.re[t * nbt:(t + 1) * nbt],
          theirs._ramp.im[t * nbt:(t + 1) * nbt]),
        srots, hrots if t == 0 else srots, drots, 1, interpret=True)
    assert snr(jcplx.to_np(jy), y.numpy()) > 90.0
    # float64: the comb from absolute sample a0 - (f-1)*M, zero before 0
    a0 = blk * CL + t * (CL // T)
    x = golden.tone_block(list(COMB), list(CAMPL), RATE, 0, a0 + nbt * CM)
    g = golden.GoldenDirectDemodulator(list(COMB), RATE, CM, F)
    ref = g(x)[:, a0 // CM:].T
    assert snr(ref, y.numpy()) > 90.0
    assert np.array_equal(new[0].numpy(), np.asarray(jnew[0]))
    assert np.array_equal(new[1].numpy(), np.asarray(jnew[1]))


def test_chain_checks_operands_and_counts_no_cpu_launch():
    ours, _ = chain_pair()
    nbt = ours.nb // T
    _, srot, hrot0, drot = ours.block_rotations(ours.init_state())
    args = [ours.P[:nbt], ours.halo_rows(0), ours.G, ours.ramp[:nbt], srot,
            hrot0, drot]
    before = chain.launches
    assert torch.equal(chain(*args), chain_plain(*args))
    assert not hrot0.abs().any()        # ahead of the stream: zero halo
    with pytest.raises(ValueError, match="chain shapes"):
        chain(*args[:1], ours.P[:F], *args[2:])
    with pytest.raises(TypeError):
        chain(args[0].real.contiguous(), *args[1:])
    assert chain.launches == before
    assert not TonesDirectChain(RATE, COMB, CAMPL, ours.cfg, CL,
                                time_shards=3).ok
