"""The DDC kernel's channel mode (csrc/ddc.cu, kernels #7, #8 and #10) on
the CPU: its plan and a PyTorch emulation of its tiling.

(a) The plan that ops/ddc.py mirrors (``channel_plan``, ``smem_bytes``):
its constants are csrc/ddc.cu's, read from the source; it fits the
H100's 232,448 bytes a block, and two blocks an SM, for every f in
1..4096 at C in {9, 100, 128, 129, 1000}, whatever f; at most one
channel group idles; the staging walks, stepped without a division,
visit each staged pair once, and the threads' register tiles cover the
block's rows and channels once.

(b) The kernel's decomposition, emulated: row tiles, channel tiles and
k-chunks of the window ext[n*M + k], each chunk's window staged as the
kernel stages it (the span where M <= chunk, else a piece a row, pairs
of samples from an even ext index) through the three row sources read
flat (csrc/ddc.cu ``Ext``: a streamed block after its history; a
recording block read in place, wrapped at the loop seam, zero history
when ``valid`` is 0; a shard's span after its staged halo), the taps
zero past f*M and past the tile's channels, accumulated chunk by chunk
in complex64 (FP32), then the epilogue.  Every output element is written
once.  Held at 90 dB SNR against the port's plain versions
(``direct_ddc_fir``, ``ReplayDDC.block_plain``,
``ShardedReplayDDC.local_plain``) and against the JAX package's
``ddc_fused``, ``ReplayDDC`` and ``ShardedReplayDDC`` (the Pallas kernels
in interpret mode where they take the geometry, else the package's plain
route, ``direct_ddc_fir``), at M 100, 10 and 7, f 4 and 40, each with a
tail tile.  The kernel itself runs only on the card (chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import ddc as jddc
from gpu_sdr_tpu.ops.cplx import C as JC
from gpu_sdr_tpu.ops.pallas_ddc import ddc_fused as jddc_fused
from gpu_sdr_tpu.ops.pallas_replay import ReplayDDC as JReplayDDC
from gpu_sdr_tpu.ops.pallas_replay import ShardedReplayDDC as JShardedRDDC
from gpu_sdr_tpu.ops.pallas_replay import _HUNIT
from gpu_sdr_tpu_torch.ops import ddc
from gpu_sdr_tpu_torch.ops.cplx import phase_rotation
from gpu_sdr_tpu_torch.ops.replay_ddc import ReplayDDC, ShardedReplayDDC

torch.set_num_threads(2)

H100_SMEM = 232_448             # bytes a block may use with the opt-in
SM_SMEM = 233_472               # an SM's shared memory, 1 KB a block reserved
F_MAX = 4096
PLAN_CS = (9, 100, 128, 129, 1000)
SNR_BAR = 90.0
RATE = 1_000_000


def source_constants():
    """csrc/ddc.cu's integer ``constexpr int`` constants whose value is a
    product of literals and earlier such constants."""
    text = (Path(ddc.__file__).parent.parent / "csrc" / "ddc.cu").read_text()
    consts = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([\w\s*]+);", text):
        consts[key] = int(np.prod([int(consts.get(t.strip(), t))
                                   for t in expr.split("*")]))
    return consts


def walk(tid, nthr, per_row, total):
    """The kernel's staging walk of thread `tid`: pairs tid, tid + nthr,
    ... below `total`, as (row, pair) stepped without a division."""
    r, j = divmod(tid, per_row)
    dr, dj = divmod(nthr, per_row)
    out, q = [], tid
    while q < total:
        out.append((r, j))
        r, j = r + dr, j + dj
        if j >= per_row:
            j, r = j - per_row, r + 1
        q += nthr
    return out


def thread_tile(tid, p):
    """Thread tid's (rows, local channels): rows rg + i*RG, channel
    pairs cg and cg + CG (csrc/ddc.cu ddc_channel_kernel)."""
    cg, rg = tid % p["CG"], tid // p["CG"]
    rows = [rg + i * p["RG"] for i in range(ddc.DDC_TILES[False]["rows"])]
    chans = [2 * (cg + (j >> 1) * p["CG"]) + (j & 1) for j in range(4)]
    return rows, chans


def test_channel_tiles_mirror_the_source():
    d, t = source_constants(), ddc.DDC_TILES[False]
    assert (t["rows"], t["channels"], t["chunk"], t["pitch"], t["stages"],
            t["max_channels"], t["max_threads"], t["max_row_groups"]) == \
        (d["kTM"], d["kTN"], d["kKC"], d["kKP"], d["kStages"],
         d["kChanTile"], d["kThreadsC"], d["kRowGroupsMax"]) == \
        (8, 4, 32, 34, 2, 128, 256, 16)
    assert ddc.SMEM_MAX == d["kSmemMax"] == H100_SMEM
    assert t["pitch"] == t["chunk"] + 2 and t["chunk"] % 8 == 0
    assert ddc.channel_plan(100) == dict(ntile=1, Ct=100, CG=25, RG=10,
                                         BM=80, threads=250, smem=94_720)


@pytest.mark.parametrize("C", PLAN_CS)
def test_channel_plan_fits_for_every_f(C):
    """The same bytes for every f (the k-loop takes any depth), within a
    block's opt-in limit and two blocks an SM; the channel tiles cover
    C; at most one channel group of a tile idles (none at C = 100)."""
    p = ddc.channel_plan(C)
    sizes = {ddc.smem_bytes(f, False, C) for f in range(1, F_MAX + 1)}
    assert sizes == {p["smem"]}
    assert p["smem"] <= H100_SMEM and 2 * (p["smem"] + 1024) <= SM_SMEM
    assert p["threads"] == p["CG"] * p["RG"] <= 256
    assert p["BM"] == 8 * p["RG"] and 4 * p["CG"] >= p["Ct"] <= 128
    assert (p["ntile"] - 1) * p["Ct"] < C <= p["ntile"] * p["Ct"]
    for tile in range(p["ntile"]):
        live = min(p["Ct"], C - tile * p["Ct"])
        idle = sum(all(c >= live for c in thread_tile(cg, p)[1])
                   for cg in range(p["CG"]))
        assert idle <= (0 if C == 100 else 1)


@pytest.mark.parametrize("C", PLAN_CS)
def test_staging_walks_and_register_tiles_cover_once(C):
    p = ddc.channel_plan(C)
    t = ddc.DDC_TILES[False]
    pairs = t["pitch"] // 2
    for per_row, total in ((pairs, p["BM"] * pairs),          # window
                           (2 * p["CG"], t["chunk"] * 2 * p["CG"])):  # taps
        seen = [rj for tid in range(p["threads"])
                for rj in walk(tid, p["threads"], per_row, total)]
        assert sorted(seen) == [divmod(q, per_row) for q in range(total)]
    cells = [(r, c) for tid in range(p["threads"])
             for rows, chans in [thread_tile(tid, p)]
             for r in rows for c in chans]
    assert sorted(cells) == [(r, c) for r in range(p["BM"])
                             for c in range(4 * p["CG"])]


# ---- (b) the emulation ----------------------------------------------

class Ext:
    """csrc/ddc.cu's Ext: the block's extended samples read flat from
    one of rows.cuh's three sources; zero where a sample stands for zero
    (history at the stream's start, past the block)."""

    def __init__(self, x, hist, x_rows, base, nb, lead, M, valid):
        self.x, self.hist, self.valid = x, hist, valid
        self.H, self.end = lead * M, (nb + lead) * M
        self.body = base * M
        self.w0, self.X = base * M - self.H, x_rows * M

    def body_at(self, e):
        """The kernel's fast path: samples e, all in the block's body."""
        return self.x[self.body + np.asarray(e, np.int64) - self.H]

    def at(self, e):
        e = np.asarray(e, np.int64)
        live = (e < self.end) & ((e >= self.H) | bool(self.valid))
        out = np.zeros(e.shape, np.complex64)
        body = live & (e >= self.H)
        out[body] = self.x[self.body + e[body] - self.H]
        hist = live & (e < self.H)
        if self.hist is not None:
            out[hist] = self.hist[e[hist]]
        else:
            w = self.w0 + e[hist]
            w = np.where(w < 0, w + self.X, w)
            out[hist] = self.x[np.mod(w, self.X)]
        return out


def emulate(ext, M, nb, hmod, ramp, phase, W):
    """The channel-mode kernel's result, tile by tile and chunk by chunk:
    (nb, C) complex64, every element written once."""
    t = ddc.DDC_TILES[False]
    KC, KP, rpairs = t["chunk"], t["pitch"], t["pitch"] // 2
    K, C = hmod.shape
    p = ddc.channel_plan(C)
    BM, tw = p["BM"], 4 * p["CG"]
    rot = phase_rotation(torch.from_numpy(phase), W, -1.0).numpy()
    out = np.full((nb, C), np.nan, np.complex64)
    span = M <= KC
    r = np.arange(BM)
    for n0 in range(0, nb, BM):
        s0 = n0 * M
        assert BM % 2 == 0
        if span:                        # BM is even: so is s0 + k0
            rowoff = r * M
            wpairs = ((BM - 1) * M + KC + 1) // 2
        else:
            rowoff = r * KP + (((n0 + r) * M) & 1)
            wpairs = BM * rpairs
        assert 2 * wpairs <= BM * KP
        wext = 2 * wpairs if span else (BM - 1) * M + KP
        for c0 in range(0, C, p["Ct"]):
            cend = min(C, c0 + p["Ct"])
            acc = np.zeros((BM, tw), np.complex64)
            for k0 in range(0, K, KC):
                # the kernel's fast path: the window inside the body,
                # read there without the per-sample test (the recording
                # 16-byte aligned, so its even samples are where the
                # body's offset from ext sample 0 is even)
                fast = ((ext.body - ext.H) % 2 == 0 and s0 + k0 >= ext.H
                        and s0 + k0 + wext <= ext.end)
                at = ext.body_at if fast else ext.at
                buf = np.full(BM * KP, np.nan, np.complex64)
                if span:
                    e = s0 + k0 + np.arange(2 * wpairs)
                    buf[:2 * wpairs] = at(e)
                else:
                    rr, jj = np.divmod(np.arange(wpairs), rpairs)
                    e = (((n0 + rr) * M + k0) & ~1) + 2 * jj
                    for d in (0, 1):
                        buf[rr * KP + 2 * jj + d] = at(e + d)
                k = k0 + np.arange(KC)[:, None]
                c = c0 + np.arange(tw)[None, :]
                taps = np.where((k < K) & (c < cend),
                                hmod[np.minimum(k, K - 1),
                                     np.minimum(c, C - 1)], 0)
                kc = min(KC, (K - k0 + 7) & ~7)
                A = buf[rowoff[:, None] + np.arange(kc)[None, :]]
                acc += A @ taps[:kc].astype(np.complex64)
            rows = min(BM, nb - n0)
            cn = cend - c0
            blk = out[n0:n0 + rows, c0:cend]
            assert np.isnan(blk).all()                  # written once
            out[n0:n0 + rows, c0:cend] = (
                acc[:rows, :cn] * ramp[n0:n0 + rows, c0:cend] *
                rot[None, c0:cend])
    assert not np.isnan(out).any()
    return out


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def configs(M, f, C):
    freqs = tuple(int(v) for v in np.linspace(-0.45 * RATE, 0.43 * RATE, C))
    kw = dict(rate=RATE, decim=M, pf_average=f, freqs=freqs,
              phases=(0,) * C)
    return ddc.DirectDDCConfig(**kw), jddc.DirectDDCConfig(**kw)


def snr(ref, got):
    return golden.snr_db(np.asarray(ref), np.asarray(got))


def jax_plain(jcfg, nb, phase, hist, x):
    """The JAX package's plain route of one block: direct_ddc_fir."""
    M, f = jcfg.M, jcfg.f
    y = jddc.direct_ddc_fir(
        jcfg.modulated_taps(), jcfg.carrier_ramp(nb),
        jddc.ddc_carrier_step(jcfg, nb * M), jcfg.rate, M, f,
        np.asarray(phase, np.int32), jcplx.from_np(hist),
        jcplx.from_np(x))[2]
    return jcplx.to_np(y)


def advanced_phase(cfg, L, n):
    """The carried phase after n blocks of L samples, int64 (C,)."""
    ph = ddc.ddc_carrier_init(cfg, "cpu")
    step = ddc.ddc_carrier_step(cfg, L, "cpu")
    for _ in range(n):
        ph = (ph + step) % cfg.rate
    return ph


# (M, f, C, rows): M 37, odd and over a chunk, stages a piece a row from
# an odd sample every other row
STREAMED = [(100, 4, 100, 200), (100, 40, 100, 200), (10, 4, 100, 200),
            (10, 40, 100, 197), (7, 4, 100, 200), (7, 40, 100, 197),
            (37, 4, 100, 200), (37, 40, 129, 197), (10, 4, 129, 200),
            (100, 4, 9, 203)]


@pytest.mark.parametrize("M, f, C, nb", STREAMED,
                         ids=[f"M{m}-f{f}-C{c}-nb{n}"
                              for m, f, c, n in STREAMED])
def test_emulation_streamed_block(M, f, C, nb):
    """(a) a streamed block after a carried history (#7)."""
    cfg, jcfg = configs(M, f, C)
    rng = np.random.default_rng(M * 1000 + f + C)
    x, hist = crandn(rng, nb * M), crandn(rng, (f - 1) * M)
    phase = advanced_phase(cfg, nb * M, 3).numpy()
    hmod = cfg.modulated_taps_np().astype(np.complex64)
    ramp = cfg.carrier_ramp_np(nb).astype(np.complex64)
    got = emulate(Ext(x, hist, nb, 0, nb, f - 1, M, 1), M, nb, hmod, ramp,
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


# (M, f, rows a block, blocks, block, valid): the JAX kernel takes the
# first geometry, at the stream's start, inside and block 0 after the
# seam; the second's f - 1 = 39 exceeds its 8-row halo (the plain
# route); the third's one 20-row block is shorter than its 39-row
# history, which wraps twice
RECORDED = [(100, 4, 200, 3, 0, 0), (100, 4, 200, 3, 1, 1),
            (100, 4, 200, 3, 0, 1), (7, 40, 200, 3, 0, 0),
            (7, 40, 200, 3, 2, 1), (7, 40, 200, 3, 0, 1),
            (37, 40, 200, 3, 0, 1), (7, 40, 20, 1, 0, 1)]


@pytest.mark.parametrize("M, f, nbr, nblk, idx, valid", RECORDED,
                         ids=[f"M{c[0]}-f{c[1]}-nbr{c[2]}-{c[4]}-{c[5]}"
                              for c in RECORDED])
def test_emulation_recording_block(M, f, nbr, nblk, idx, valid):
    """(b) a block of a resident recording read in place (#8)."""
    cfg, jcfg = configs(M, f, 100)
    L = nbr * M
    rec = crandn(np.random.default_rng(nbr + f), nblk * L)
    rk = ReplayDDC(cfg, rec, L, "cpu")
    nabs = nblk if (idx, valid) == (0, 1) else idx
    phase = advanced_phase(cfg, L, nabs)
    st = (idx, phase, valid)
    got = emulate(Ext(rec, None, nblk * nbr, idx * nbr, nbr, f - 1, M,
                      valid), M, nbr, cfg.modulated_taps_np().astype(
                          np.complex64),
                  cfg.carrier_ramp_np(nbr).astype(np.complex64),
                  phase.numpy(), RATE)
    assert snr(rk.block_plain(st).numpy(), got) > SNR_BAR
    jrk = JReplayDDC(jcfg, rec, L, blocks_per_exec=1, interpret=True)
    assert jrk.ok == (f - 1 <= _HUNIT)
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
# (M, f, rows a block): the JAX kernel takes f 4; f 40 the plain route.  256 rows a shard: three 80-row tiles and a 16-row tail.
SHARDED = [(10, 4, 512), (7, 40, 512), (37, 4, 512)]
# (block, valid, shard): the stream's start on both shards, inside, the
# last block, block 0 after the loop seam
SHARD_CASES = [(0, 0, 0), (0, 0, 1), (2, 1, 1), (0, 1, 0)]


@pytest.mark.parametrize("M, f, nbr", SHARDED,
                         ids=[f"M{m}-f{f}" for m, f, _ in SHARDED])
@pytest.mark.parametrize("idx, valid, t", SHARD_CASES,
                         ids=["start-0", "start-1", "last-1", "seam-0"])
def test_emulation_staged_halo(M, f, nbr, idx, valid, t):
    """(c) a time shard's span after its staged halo (#10)."""
    nblk = 3
    cfg, jcfg = configs(M, f, 100)
    L = nbr * M
    rec = crandn(np.random.default_rng(7 * f + M), nblk * L)
    rk = ShardedReplayDDC(cfg, torch.from_numpy(rec), L, ["cpu"] * T)
    nt = rk.nbr_t
    nabs = nblk if (idx, valid) == (0, 1) else idx
    phase = advanced_phase(cfg, L, nabs)
    st = (idx, phase, valid)
    v = valid if t == 0 else 1
    span = rk.X[t].reshape(-1).numpy()
    halo = rk.H[t][idx].reshape(-1).numpy()
    got = emulate(Ext(span, halo, rk.X[t].shape[0], idx * nt, nt, f - 1, M,
                      v), M, nt, cfg.modulated_taps_np().astype(
                          np.complex64),
                  cfg.carrier_ramp_np(nbr)[t * nt:(t + 1) * nt].astype(
                      np.complex64), phase.numpy(), RATE)
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
        ramp = jcfg.carrier_ramp(nbr)
        y = jddc.direct_ddc_fir(
            jcfg.modulated_taps(), JC(ramp.re[t * nt:(t + 1) * nt],
                                      ramp.im[t * nt:(t + 1) * nt]),
            jddc.ddc_carrier_step(jcfg, L), RATE, M, f,
            phase.numpy().astype(np.int32), jcplx.from_np(hist),
            jcplx.from_np(rec[a0:a0 + nt * M]))[2]
        jy = jcplx.to_np(y)
    assert snr(jy, got) > SNR_BAR
