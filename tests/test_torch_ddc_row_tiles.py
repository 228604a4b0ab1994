"""The DDC kernel's row mode (csrc/ddc.cu ``ddc_row_kernel``: kernel #9,
and #7 and #10 at 8 channels or fewer) on the CPU: its plan and a
PyTorch emulation of its decomposition.

(a) The plan that ops/ddc.py mirrors (``row_plan``, ``smem_bytes``): its
constants are csrc/ddc.cu's, read from the source; a launch's shared
memory stays within the bound ``smem_bytes`` gives for every f in
1..4096 and C in 1..8, at M 1..300 and wide rows, and that bound keeps
two blocks an SM; a chunk's window and taps fit one stage; the staging
walks, stepped without a division, visit each staged sample once; the
lanes' halving shuffle tree leaves each lane the sum of the value the
epilogue reads there.

(b) The kernel's decomposition, emulated: row tiles of R rows, tap
passes of J rows and column chunks, each chunk's window staged as the
kernel stages it (one column chunk: the span of ext from an even
sample, in pairs; more: a piece a row) through the three row sources
read flat (a streamed block after its history; a recording block read
in place, wrapped at the loop seam, zero history when ``valid`` is 0; a
shard's span after its staged halo), its taps zero past the pass's tap
rows and the channels; each warp's lanes take tasks (an arm, kArmR tap
rows) in the kernel's order, sliding the taps over the RR rows' window
samples and summing per lane in complex64 (FP32); then the shuffle
tree, the epilogue, every output element written once.  Held at 90 dB
SNR against the port's plain versions (``direct_ddc_fir``,
``ReplayDDCT.block_plain``, ``ShardedReplayDDC.local_plain``) and the
JAX package's ``ddc_fused``, ``ReplayDDCT`` and ``ShardedReplayDDC`` (the
Pallas kernels in interpret mode where they take the geometry, else the
package's plain route), at M 100, 10, 7 and 1 and wide rows (column
chunks), f 1, 4, 40 and over a pass, C 1, 3 and 8, each with a tail
tile.  The kernel itself runs only on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from test_torch_ddc_tiles import (Ext, advanced_phase, configs, crandn,
                                  jax_plain, snr, source_constants, walk)

from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import ddc as jddc
from gpu_sdr_tpu.ops.cplx import C as JC
from gpu_sdr_tpu.ops.pallas_ddc import ddc_fused as jddc_fused
from gpu_sdr_tpu.ops.pallas_replay import ReplayDDCT as JReplayDDCT
from gpu_sdr_tpu.ops.pallas_replay import ShardedReplayDDC as JShardedRDDC
from gpu_sdr_tpu.ops.pallas_replay import _HUNIT
from gpu_sdr_tpu_torch.ops import ddc
from gpu_sdr_tpu_torch.ops.cplx import phase_rotation
from gpu_sdr_tpu_torch.ops.replay_ddc import ReplayDDCT, ShardedReplayDDC

torch.set_num_threads(2)

H100_SMEM = 232_448             # bytes a block may use with the opt-in
SM_SMEM = 233_472               # an SM's shared memory, 1 KB a block reserved
F_MAX = 4096
SNR_BAR = 90.0
RATE = 1_000_000
LANES = 32
WIDE_M = (301, 500, 1000, 4099, 100_000)   # column chunks at every C


def test_row_tiles_mirror_the_source():
    d, t = source_constants(), ddc.DDC_TILES[True]
    assert (t["warps"], t["rows_warp"], t["acc"], t["arm"], t["stage"],
            t["stages"]) == \
        (d["kWarpsR"], d["kRowsWarp"], d["kAccR"], d["kArmR"], d["kStageR"],
         d["kStagesR"]) == (8, 8, 16, 4, 7104, 2)
    assert d["kThreadsR"] == 256
    assert ddc.ROW_MODE_MAX_CHANNELS == d["kMaxRowChannels"] == 8
    # config 1 (M 100, f 4, C 1): the whole span of a 64-row tile in one
    # stage, 4 blocks an SM; a deep FIR at decimation 10: 320 tap rows a
    # pass, two stages, two blocks an SM
    assert ddc.row_plan(100, 4, 1) == dict(
        CP=1, R=64, P=100, nmc=1, J=4, npass=1, nchunk=1, woff=6700,
        stage=7100, smem=56_800)
    assert ddc.row_plan(10, 800, 1) == dict(
        CP=1, R=64, P=10, nmc=1, J=320, npass=3, nchunk=3, woff=3830,
        stage=7030, smem=112_480)
    assert ddc.row_plan(100, 4, 8)["R"] == 16


@pytest.mark.parametrize("C", range(1, 9))
def test_row_plan_fits_for_every_f(C):
    """The bound is the same for every f, within a block's opt-in limit
    and two blocks an SM; every launch (M 1..300 and wide rows; f 1..40,
    passes' edges, 4096) stays within it, its chunk within a stage, its
    tap rows a multiple of kArmR covering f, its column chunks M."""
    t = ddc.DDC_TILES[True]
    bound = ddc.smem_bytes(1, True, C)
    assert {ddc.smem_bytes(f, True, C) for f in range(1, F_MAX + 1)} == \
        {bound} == {t["stages"] * t["stage"] * 8}
    assert bound <= H100_SMEM and 2 * (bound + 1024) <= SM_SMEM
    fs = sorted(set(range(1, 41)) | {319, 320, 321, 471, 472, 473, 800,
                                     2000, F_MAX})
    for M in list(range(1, 301)) + list(WIDE_M):
        for f in fs:
            p = ddc.row_plan(M, f, C)
            assert p["CP"] >= C and p["CP"] // 2 < C
            rr = p["R"] // t["warps"]             # rows a warp
            assert p["R"] == t["warps"] * rr and p["R"] % 2 == 0
            assert rr == t["rows_warp"] if p["CP"] <= 2 else \
                rr * p["CP"] == t["acc"]
            assert (p["nmc"] - 1) * p["P"] < M <= p["nmc"] * p["P"]
            assert p["J"] % t["arm"] == 0 and p["J"] >= t["arm"]
            assert (p["npass"] - 1) * p["J"] < f <= p["npass"] * p["J"]
            assert p["woff"] >= (p["R"] + p["J"] - 1) * p["P"]
            assert p["woff"] % 2 == 0 and p["stage"] % 2 == 0
            assert p["woff"] + p["CP"] * p["J"] * p["P"] <= p["stage"] <= \
                t["stage"]
            assert p["smem"] <= bound
            assert p["smem"] == (2 if p["nchunk"] > 1 else 1) * \
                p["stage"] * 8


@pytest.mark.parametrize("M, f, C", [(101, 4, 1), (7, 40, 3), (300, 4, 2),
                                     (4099, 9, 8)])
def test_row_staging_walks_cover_once(M, f, C):
    """The piece-mode window (rows by the chunk's columns) and the taps
    (tap rows by columns x CP channels), each thread's share stepped
    without a division, visit each staged sample once."""
    p = ddc.row_plan(M, f, C)
    threads = ddc.DDC_TILES[True]["warps"] * LANES
    for jr, mc in {(min(p["J"], -(-f // 4) * 4), p["P"]),
                   (4, M - (p["nmc"] - 1) * p["P"])}:
        for per_row, total in ((mc, (p["R"] + jr - 1) * mc),
                               (mc * p["CP"], jr * mc * p["CP"])):
            seen = [rj for tid in range(threads)
                    for rj in walk(tid, threads, per_row, total)]
            assert sorted(seen) == [divmod(q, per_row) for q in range(total)]


def reduce_lanes(v):
    """The kernel's halving shuffle tree over a warp's lanes: v (32, N)
    float32, each lane's values; returns each lane's v[0] after it."""
    v = [list(row) for row in v]
    n = len(v[0])
    for o in (16, 8, 4, 2, 1):
        out = []
        for lane in range(LANES):
            up, mine, peer = lane & o, v[lane], v[lane ^ o]
            if n > 1:
                h = n // 2
                # the partner sends the half this lane keeps
                out.append([(mine[k + h] if up else mine[k]) +
                            (peer[k + h] if up else peer[k])
                            for k in range(h)])
            else:
                out.append([mine[0] + peer[0]])
        v, n = out, max(1, n // 2)
    return np.array([row[0] for row in v])


@pytest.mark.parametrize("n", [16, 32])
def test_shuffle_tree_leaves_each_lane_its_value(n):
    """Lane l ends with the whole sum of value l (N = 32) or l >> 1 (N =
    16): the epilogue reads re and im of output q on lanes 2q and 2q + 1
    (N = 32) or 4q and 4q + 2 (N = 16)."""
    rng = np.random.default_rng(n)
    v = rng.integers(-1000, 1000, (LANES, n)).astype(np.float32)
    got = reduce_lanes(v)
    s = 0 if n == 32 else 1
    assert np.array_equal(got, v.sum(0)[np.arange(LANES) >> s])


# ---- (b) the emulation ----------------------------------------------

def lane_sums(v):
    """The tree's sums in float32 as every lane holds them (a butterfly:
    each level adds lane l ^ O's value to lane l's, the halving tree's
    sums for the values a lane keeps)."""
    lanes = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def emulate(ext, M, nb, f, hmod, ramp, phase, W):
    """The row-mode kernel's result, tile by tile, chunk by chunk, task
    by task: (nb, C) complex64, every element written once."""
    A = ddc.DDC_TILES[True]["arm"]
    K, C = hmod.shape
    p = ddc.row_plan(M, f, C)
    CP, R, P, J = p["CP"], p["R"], p["P"], p["J"]
    nw = ddc.DDC_TILES[True]["warps"]
    RR = R // nw                        # rows a warp
    r0 = np.arange(nw) * RR
    rot = phase_rotation(torch.from_numpy(phase), W, -1.0).numpy()
    out = np.full((nb, C), np.nan, np.complex64)
    lanes, ii = np.arange(LANES), np.arange(RR)
    for n0 in range(0, nb, R):
        acc = np.zeros((nw, LANES, RR, CP), np.complex64)
        for ch in range(p["nchunk"]):
            pss, mch = divmod(ch, p["nmc"])
            j0 = pss * J
            jc = min(J, f - j0)
            jr = -(-jc // A) * A
            m0 = mch * P
            mc = min(P, M - m0)
            rows = R + jr - 1
            e0 = (n0 + j0) * M + m0
            buf = np.full(p["stage"], np.nan, np.complex64)
            if p["nmc"] == 1:               # the span, in pairs
                assert e0 % 2 == 0
                n2 = 2 * ((rows * M + 1) // 2)
                # the fast path: all in the body, its even samples aligned
                fast = ((ext.body - ext.H) % 2 == 0 and e0 >= ext.H and
                        e0 + n2 <= ext.end)
                buf[:n2] = (ext.body_at if fast else ext.at)(
                    e0 + np.arange(n2))
            else:                           # a piece a row
                u, col = np.divmod(np.arange(rows * mc), mc)
                buf[u * P + col] = ext.at(e0 + u * M + col)
            assert 2 * ((rows * P + 1) // 2) <= p["woff"]
            jj, v = np.divmod(np.arange(jr * mc * CP), mc * CP)
            col, c = np.divmod(v, CP)
            k = (j0 + jj) * M + m0 + col
            live = (jj < jc) & (c < C)
            buf[p["woff"] + c * J * P + jj * P + col] = np.where(
                live, hmod[np.minimum(k, K - 1), np.minimum(c, C - 1)], 0)
            nt = jr // A * mc
            for t0 in range(0, nt, LANES):  # a round of the lanes' tasks
                t = t0 + lanes
                on = t < nt
                jb, m = np.divmod(np.where(on, t, 0), mc)
                for a in range(A):
                    wrow = r0[:, None, None] + (jb * A)[None, :, None] + \
                        ii[None, None, :] + a               # (nw, 32, RR)
                    x = buf[wrow * P + m[None, :, None]]
                    h = buf[p["woff"] + np.arange(CP)[None, :] * J * P +
                            ((jb * A + a) * P + m)[:, None]]   # (32, CP)
                    acc += np.where(on[None, :, None, None],
                                    x[..., None] * h[None, :, None, :], 0)
        s = lane_sums(acc)                  # (nw, RR, CP)
        n = n0 + r0[:, None] + ii[None, :]
        live = n < nb
        blk = out[n[live]][:, :C]
        assert np.isnan(blk).all()                      # written once
        out[n[live]] = (s[live][:, :C] * ramp[n[live]]) * rot[None, :]
    assert not np.isnan(out).any()
    return out


def taps_ramp(cfg, nb):
    return (cfg.modulated_taps_np().astype(np.complex64),
            cfg.carrier_ramp_np(nb).astype(np.complex64))


# (M, f, C, rows): config 1's geometry and its tail tile; f 40 at M 100
# runs 10 passes of 4 tap rows; f 330 at M 10 two passes (320 + 10);
# M 101, 300 and 4099 run column chunks (pieces); M 1 f 1 the mix-down
STREAMED = [(100, 4, 1, 200), (100, 40, 3, 130), (100, 1, 8, 150),
            (10, 4, 8, 203), (10, 40, 1, 197), (10, 330, 1, 100),
            (7, 4, 3, 200), (7, 40, 8, 197), (1, 4, 1, 300), (1, 1, 3, 250),
            (101, 4, 1, 150), (300, 4, 2, 70), (4099, 2, 8, 20)]


@pytest.mark.parametrize("M, f, C, nb", STREAMED,
                         ids=[f"M{m}-f{f}-C{c}-nb{n}"
                              for m, f, c, n in STREAMED])
def test_emulation_streamed_block(M, f, C, nb):
    """(a) a streamed block after a carried history (#7 at C <= 8)."""
    cfg, jcfg = configs(M, f, C)
    rng = np.random.default_rng(M * 1000 + f + C)
    x, hist = crandn(rng, nb * M), crandn(rng, (f - 1) * M)
    phase = advanced_phase(cfg, nb * M, 3).numpy()
    hmod, ramp = taps_ramp(cfg, nb)
    got = emulate(Ext(x, hist, nb, 0, nb, f - 1, M, 1), M, nb, f, hmod, ramp,
                  phase, RATE)
    plain = ddc.direct_ddc_fir(
        cfg.modulated_taps("cpu"), cfg.carrier_ramp(nb, "cpu"),
        ddc.ddc_carrier_step(cfg, nb * M, "cpu"), RATE, M, f,
        torch.from_numpy(phase), torch.from_numpy(hist),
        torch.from_numpy(x))[2].numpy()
    assert snr(plain, got) > SNR_BAR
    jy = jddc_fused(jcfg.modulated_taps(), jcfg.carrier_ramp(nb),
                    jddc.ddc_carrier_step(jcfg, nb * M), RATE, M, f,
                    np.asarray(phase, np.int32), jcplx.from_np(hist),
                    jcplx.from_np(x), interpret=True)[2]
    assert snr(jcplx.to_np(jy), got) > SNR_BAR


# (M, f, C, rows a block, blocks, block, valid): config 1's geometry at
# the stream's start, inside and block 0 after the seam (the JAX
# transposed kernel takes these); f 330's 329 history rows exceed its
# 128-column lead and wrap a 20-row recording many times (the plain
# route)
RECORDED = [(100, 4, 1, 200, 3, 0, 0), (100, 4, 1, 200, 3, 1, 1),
            (100, 4, 1, 200, 3, 0, 1), (10, 40, 3, 200, 3, 2, 1),
            (10, 40, 3, 200, 3, 0, 1), (7, 40, 8, 200, 3, 0, 0),
            (1, 4, 1, 200, 2, 1, 1), (10, 330, 1, 20, 1, 0, 1),
            (101, 4, 2, 200, 2, 0, 1)]


@pytest.mark.parametrize("M, f, C, nbr, nblk, idx, valid", RECORDED,
                         ids=[f"M{c[0]}-f{c[1]}-C{c[2]}-nbr{c[3]}-{c[5]}-"
                              f"{c[6]}" for c in RECORDED])
def test_emulation_recording_block(M, f, C, nbr, nblk, idx, valid):
    """(b) a block of a resident recording read in place (#9)."""
    cfg, jcfg = configs(M, f, C)
    L = nbr * M
    rec = crandn(np.random.default_rng(nbr + f + C), nblk * L)
    rk = ReplayDDCT(cfg, rec, L, "cpu")
    nabs = nblk if (idx, valid) == (0, 1) else idx
    phase = advanced_phase(cfg, L, nabs)
    st = (idx, phase, valid)
    hmod, ramp = taps_ramp(cfg, nbr)
    got = emulate(Ext(rec, None, nblk * nbr, idx * nbr, nbr, f - 1, M,
                      valid), M, nbr, f, hmod, ramp, phase.numpy(), RATE)
    assert snr(rk.block_plain(st).numpy(), got) > SNR_BAR
    jrk = JReplayDDCT(jcfg, rec, L, blocks_per_exec=1, interpret=True)
    assert jrk.ok == (f - 1 <= 128)
    if jrk.ok:
        jy = jrk.multi_step((np.int32(idx), phase.numpy().astype(np.int32),
                             np.int32(valid)))[1]
        jy = jcplx.to_np(jy)
    else:
        H = (f - 1) * M
        hist = rec[np.arange(idx * L - H, idx * L) % len(rec)] if valid \
            else np.zeros(H, np.complex64)
        jy = jax_plain(jcfg, nbr, phase.numpy(), hist,
                       rec[idx * L:(idx + 1) * L])
    assert snr(jy, got) > SNR_BAR


T = 2
# (M, f, C, rows a block): the JAX kernel takes f 4; f 40 the plain
# route.  256 rows a shard: four 64-row tiles (C 1), eight 32-row (C 3),
# sixteen 16-row (C 8); 152 a shard: four 32-row and a tail (C 3)
SHARDED = [(10, 4, 1, 512), (7, 40, 8, 512), (100, 4, 3, 304)]
# (block, valid, shard): the stream's start on both shards, inside, the
# last block, block 0 after the loop seam
SHARD_CASES = [(0, 0, 0), (0, 0, 1), (2, 1, 1), (0, 1, 0)]


@pytest.mark.parametrize("M, f, C, nbr", SHARDED,
                         ids=[f"M{m}-f{f}-C{c}" for m, f, c, _ in SHARDED])
@pytest.mark.parametrize("idx, valid, t", SHARD_CASES,
                         ids=["start-0", "start-1", "last-1", "seam-0"])
def test_emulation_staged_halo(M, f, C, nbr, idx, valid, t):
    """(c) a time shard's span after its staged halo (#10 at C <= 8)."""
    nblk = 3
    cfg, jcfg = configs(M, f, C)
    L = nbr * M
    rec = crandn(np.random.default_rng(7 * f + M + C), nblk * L)
    rk = ShardedReplayDDC(cfg, torch.from_numpy(rec), L, ["cpu"] * T)
    nt = rk.nbr_t
    nabs = nblk if (idx, valid) == (0, 1) else idx
    phase = advanced_phase(cfg, L, nabs)
    st = (idx, phase, valid)
    v = valid if t == 0 else 1
    span = rk.X[t].reshape(-1).numpy()
    halo = rk.H[t][idx].reshape(-1).numpy()
    hmod, ramp = taps_ramp(cfg, nbr)
    got = emulate(Ext(span, halo, rk.X[t].shape[0], idx * nt, nt, f - 1, M,
                      v), M, nt, f, hmod, ramp[t * nt:(t + 1) * nt],
                  phase.numpy(), RATE)
    assert snr(rk.local_plain(st, t).numpy(), got) > SNR_BAR
    jrk = JShardedRDDC(jcfg, rec, L, T, blocks_per_exec=1, interpret=True)
    assert jrk.ok == (f - 1 <= _HUNIT)
    if jrk.ok:
        jst = (np.int32(idx), phase.numpy().astype(np.int32), np.int32(valid))
        idxs, val, drots, _ = jrk._block_rots_and_advance(jst, 1)
        rep8 = JC(np.repeat(np.asarray(drots.re), 8, 0),
                  np.repeat(np.asarray(drots.im), 8, 0))
        Xl = jcplx.from_np(jrk.X_np[t * nblk * nt:(t + 1) * nblk * nt]
                           .astype(np.complex64))
        Hl = jcplx.from_np(jrk.H_np[t * nblk * _HUNIT:
                                    (t + 1) * nblk * _HUNIT])
        rampl = JC(jrk._ramp.re[t * nt:(t + 1) * nt],
                   jrk._ramp.im[t * nt:(t + 1) * nt])
        jy = jcplx.to_np(jrk.invoke_local(
            idxs, val if t == 0 else np.ones(1, np.int32), rep8, Xl, Hl,
            rampl))
    else:
        H, a0 = (f - 1) * M, idx * L + t * (L // T)
        hist = rec[np.arange(a0 - H, a0) % len(rec)] if v \
            else np.zeros(H, np.complex64)
        jramp = jcfg.carrier_ramp(nbr)
        y = jddc.direct_ddc_fir(
            jcfg.modulated_taps(), JC(jramp.re[t * nt:(t + 1) * nt],
                                      jramp.im[t * nt:(t + 1) * nt]),
            jddc.ddc_carrier_step(jcfg, L), RATE, M, f,
            phase.numpy().astype(np.int32), jcplx.from_np(hist),
            jcplx.from_np(rec[a0:a0 + nt * M]))[2]
        jy = jcplx.to_np(y)
    assert snr(jy, got) > SNR_BAR
