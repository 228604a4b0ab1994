"""Chirp mode of the lock-in kernel (csrc/lockin.cu: kernel #18
``lockin_at`` and #19 ``fused_chirp_lockin``) on the CPU: its launch plan
and a PyTorch emulation of its walk.

(a) The plan that ops/lockin_at.py mirrors (``chirp_plan``): its
constants are csrc/lockin.cu's, read from the source; for nseg 1..40,
ppt 1..64, 1000, 20,000 and 20,001 and both bodies (16-byte column
vectors of two samples where ppt is even and the pointers aligned, else
8-byte ones of one), the grid of one block a segment covers every
(segment, column) exactly once.  Each of bench/lockin_variants.py's
text edits finds its anchor in the source exactly once, and its SASS
fast-path count walks a made-up loop as the kernel's fast path runs.

(b) The kernel's walk, emulated thread by thread: each segment's first
position reduced mod period once, each thread's start settled
onto its step, the phase advanced as a uint32 recurrence (G = F*stride a
stride, F between the two samples of a 16-byte vector), and the step
boundaries and the period's seam resolved by the settling walk where a
position reaches the step's end.  Its integer phases equal
``ops/chirp.chirp_phase_index`` bit for bit.

(c) The lock-in points the emulation forms from them: the oscillator
(csrc/lockin.cu's MUFU __sincosf, emulated by the float32 sin / cos of
the same th, whose error against MUFU's the card's checks bound), its
loads at the body's width and alignment, each thread's FP32 sum in its
order, the shuffle tree and the warps; held to 1e-6 relative against
``lockin_at_plain`` / ``fused_chirp_lockin_plain`` and the JAX package's
``pallas_chirp_lockin_at`` / ``pallas_chirp_lockin`` in interpret mode
(nseg a multiple of 8).

The emulation fails under a step boundary taken two samples late (one
late stays exact), the seam not wrapped, a dropped warp and the 16-byte
body taken on odd ppt.
The kernel itself runs only on the card (chip_smoke.py).
"""

import re
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_sdr_tpu.ops import chirp as jchirp
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops.pallas_lockin import (pallas_chirp_lockin,
                                           pallas_chirp_lockin_at)
from gpu_sdr_tpu_torch.bench.chain_variants import variant_source
from gpu_sdr_tpu_torch.bench.lockin_variants import EDITS, fast_path
from gpu_sdr_tpu_torch.ops import chirp as C
from gpu_sdr_tpu_torch.ops import lockin_at as L
from gpu_sdr_tpu_torch.ops.lockin import lockin_profile

torch.set_num_threads(2)

REL = 1e-6
M32 = 0xFFFFFFFF
PLAN_NSEG = range(1, 41)
PLAN_PPT = list(range(1, 65)) + [1000, 20_000, 20_001]

# config 2 (period 100,000,000, length 20,000), its reversed sweep (a
# down-chirp, chirpness past 2^31), the port's small test chirp (period
# 128,000, length 1000), a period of 2100 (shorter than a segment of
# 5000) and steps of 7 samples (shorter than a stride, period 35)
CFG2 = C.ChirpConfig.from_params(-40_000_000, 40_000_000, 100_000_000, 5000,
                                 1.0)
DOWN2 = C.ChirpConfig.from_params(40_000_000, -40_000_000, 100_000_000, 5000,
                                  1.0)
SMALL = C.ChirpConfig.from_params(-300_000, 300_000, 1_000_000, 128, 0.128)
SHORT = C.ChirpConfig(num_steps=3, length=700, chirpness=123_456_789,
                      f0=-987_654)
STEP7 = C.ChirpConfig(num_steps=5, length=7, chirpness=3_000_000_001,
                      f0=77_777_777)
CFGS = {"cfg2": CFG2, "down2": DOWN2, "small": SMALL, "short": SHORT,
        "step7": STEP7}


SOURCE = Path(L.__file__).parent.parent / "csrc" / "lockin.cu"


def source_constants():
    """csrc/lockin.cu's integer ``constexpr int`` constants."""
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", SOURCE.read_text())}


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def rel_err(ref, test):
    ref, test = np.asarray(ref).ravel(), np.asarray(test).ravel()
    return np.linalg.norm(ref - test) / np.linalg.norm(ref)


# ---- (a) the plan ---------------------------------------------------

def test_plan_mirrors_the_source():
    d, t = source_constants(), L.CHIRP_TILES
    assert (t["threads"], t["unroll"]) == \
        (d["kChirpThreads"], d["kChirpUnroll"]) == (256, 4)
    # the oscillator: MUFU, chosen on the card
    assert "__sincosf(th, &s, &c);" in SOURCE.read_text()
    # the main path's shapes: #18 at 300 x 20,000, #19 at 200 x 20,000
    assert L.chirp_plan(300, 20_000, True) == dict(vec=2, threads=256,
                                                   blocks=300)
    assert L.chirp_plan(200, 20_000, True) == dict(vec=2, threads=256,
                                                   blocks=200)
    # odd ppt or a row one sample in: the 8-byte body
    assert L.chirp_plan(300, 19_999, True)["vec"] == 1
    assert L.chirp_plan(300, 20_000, False)["vec"] == 1
    assert L.pointers_aligned(1 << 20, 1 << 21)
    assert not L.pointers_aligned((1 << 20) + 8, 1 << 21)
    assert not L.pointers_aligned(1 << 20, (1 << 21) + 4)


@pytest.mark.parametrize("aligned", [True, False], ids=["16B", "8B"])
@pytest.mark.parametrize("nseg", PLAN_NSEG)
def test_plan_covers_every_column_once(nseg, aligned):
    """Every (segment, column) once, for ppt 1..64, 1000, 20,000 and
    20,001: block b is segment b, its threads take the row's column
    vectors j, j + threads, ..., each of vec samples; the 16-byte body
    only where asked for and ppt is even."""
    for ppt in PLAN_PPT:
        p = L.chirp_plan(nseg, ppt, aligned)
        vec, T = p["vec"], p["threads"]
        assert vec == (2 if aligned and ppt % 2 == 0 else 1)
        assert T == L.CHIRP_TILES["threads"] and p["blocks"] == nseg
        hits = np.zeros((nseg, ppt + 1), dtype=np.int64)
        cols = ppt // vec
        for s in range(p["blocks"]):
            j = np.arange(T)[:, None] + T * np.arange(-(-cols // T))[None, :]
            j = j[j < cols]
            k = (j[:, None] * vec + np.arange(vec)).ravel()
            np.add.at(hits[s], np.minimum(k, ppt), 1)
        assert (hits[:, :ppt] == 1).all() and (hits[:, ppt] == 0).all(), \
            (nseg, ppt, aligned)


@pytest.mark.parametrize("name", list(EDITS))
def test_bench_variant_edits_the_source(name):
    """bench/lockin_variants.py's variant `name`: each of its text edits
    finds its anchor in csrc/lockin.cu exactly once, and every variant
    but the kernel itself changes the source."""
    text = SOURCE.read_text()
    assert (variant_source(text, EDITS[name]) == text) == (name == "kernel")


def test_sass_fast_path_of_a_loop():
    """bench/lockin_variants.py fast_path on a made-up loop: the walk's
    forward ``@!P BRA`` past its settling code taken, the column guard's
    ``@P BRA`` not, an unconditional BRA taken; a backward branch met on
    the way raises."""
    code = [(0x00, "IADD3 R1, R1, 0x1, RZ"),
            (0x10, "ISETP.GE.U32.AND P0, PT, R1, R2, PT"),
            (0x20, "@!P0 BRA 0x50"),
            (0x30, "IADD3 R1, R1, -R2, RZ"),
            (0x40, "@P1 BRA 0x30"),
            (0x50, "ISETP.GE.AND P2, PT, R3, R4, PT"),
            (0x60, "@P2 BRA 0x80"),
            (0x70, "FFMA R5, R6, R7, R5"),
            (0x80, "BRA 0x90"),
            (0x90, "@!P3 BRA 0x0")]
    assert fast_path(code, 0x00, 0x90) == (
        8, {"BRA": 4, "ISETP": 2, "IADD3": 1, "FFMA": 1})
    with pytest.raises(ValueError):
        fast_path(code[:2] + [(0x20, "@!P0 BRA 0x0")] + code[3:], 0x00, 0x90)


# ---- (b) the walk ---------------------------------------------------

class Faults(NamedTuple):
    late: int = 0             # a step's end taken `late` samples late
    no_wrap: bool = False     # the seam not wrapped
    drop_warp: bool = False   # the last warp left out of the block's sum
    vec: int = 0              # the body forced (0: the plan's)


def u32(v):
    return np.asarray(v, dtype=np.uint64) & np.uint64(M32)


def phase_at(cfg, eff, fi):
    """csrc/lockin.cu phase_at, uint32 arithmetic in uint64 masked."""
    c, f0, ln = (np.uint64(cfg.chirpness & M32), np.uint64(cfg.f0 & M32),
                 np.uint64(cfg.length))
    one = np.uint64(1)
    q = u32((fi >> one) * (fi + one) + (fi & one) * ((fi + one) >> one))
    return u32(u32(eff * u32(f0 + u32(fi * c))) + (np.uint64(1 << 32) -
                                                   u32(c * u32(ln * q))))


def settle(cfg, eff, fi, nb, f: Faults):
    """csrc/lockin.cu settle on arrays: a step a boundary, the seam
    wrapping eff to step 0."""
    period, ln = np.uint64(cfg.period), np.uint64(cfg.length)
    while True:
        m = eff >= nb + np.uint64(f.late)
        if not m.any():
            return
        seam = m & (nb == period) & (not f.no_wrap)
        step = m & ~seam
        eff[seam] -= period
        fi[seam] = 0
        nb[seam] = ln
        fi[step] += np.uint64(1)
        nb[step] += ln


def walk_phases(cfg, last, nseg, ppt, vec, f: Faults = Faults()):
    """The integer phases (int64, (nseg * ppt,)) of the kernel's walk on
    the body `vec` (csrc/lockin.cu sdr_lockin_chirp_phases: the plan for
    aligned pointers where vec is 2), segment by segment, thread by
    thread, from stream position `last`."""
    plan = L.chirp_plan(nseg, ppt, vec == 2)
    plan = dict(plan, vec=f.vec or plan["vec"])
    out = np.full(nseg * ppt, -1, dtype=np.int64)
    for s in range(nseg):
        for _, j, a, bb in thread_walk(cfg, last, s, ppt, plan, f):
            out[s * ppt + j * plan["vec"]] = a
            if plan["vec"] == 2:
                out[s * ppt + j * plan["vec"] + 1] = bb
    return out


def thread_walk(cfg, last, s, ppt, plan, f: Faults):
    """For each stride of segment s's block of threads: (lanes, columns
    j, phases a, phases b) of the threads whose column lies in the row's
    ppt // vec, the phases as int32 values; every thread's walk steps
    each stride, as the kernel's does."""
    vec, T = plan["vec"], plan["threads"]
    stride = np.uint64(T * vec)
    period, ln = cfg.period, cfg.length
    c, f0 = np.uint64(cfg.chirpness & M32), np.uint64(cfg.f0 & M32)
    hi = ppt // vec
    e0 = last % period + s * ppt % period
    if e0 >= period:
        e0 -= period
    fi0 = e0 // ln
    t = np.arange(T, dtype=np.uint64)
    eff = np.uint64(e0) + t * np.uint64(vec)
    fi = np.full(T, fi0, dtype=np.uint64)
    nb = np.full(T, (fi0 + 1) * ln, dtype=np.uint64)
    settle(cfg, eff, fi, nb, f)
    F = u32(f0 + u32(fi * c))
    G = u32(F * stride)
    ia = phase_at(cfg, eff, fi)
    for j0 in range(0, hi, T):
        a = ia.copy()
        b = np.zeros(T, dtype=np.uint64)
        if vec == 2:
            fast = eff + np.uint64(1) < nb + np.uint64(f.late)
            b[fast] = u32(ia[fast] + F[fast])
            e, fb, n = eff + np.uint64(1), fi.copy(), nb.copy()
            settle(cfg, e, fb, n, f)
            b[~fast] = phase_at(cfg, e, fb)[~fast]
        j = j0 + np.arange(T)
        live = j < hi
        yield (np.arange(T)[live], j[live], as_int32(a[live]),
               as_int32(b[live]))
        eff += stride
        ia = u32(ia + G)
        moved = eff >= nb + np.uint64(f.late)
        if moved.any():
            settle(cfg, eff, fi, nb, f)
            F = np.where(moved, u32(f0 + u32(fi * c)), F)
            G = u32(F * stride)
            ia = np.where(moved, phase_at(cfg, eff, fi), ia)


def as_int32(v):
    v = v.astype(np.int64)
    return np.where(v >= 2 ** 31, v - 2 ** 32, v)


def oracle(cfg, last, n):
    return C.chirp_phase_index(cfg, last, torch.arange(
        n, dtype=torch.int64)).numpy()


# (config, position, nseg, ppt): config 2 from the stream's start, at
# 12,345 (no step boundary on a segment's edge), just before the seam
# (it falls inside a segment); ppt = length, < length (4096), > length
# (the small chirp at 2048 and 5000), odd ppt (20,001 and 4095: the
# 8-byte body); a down-chirp across the seam; a period (2100) shorter
# than a segment; steps of 7 samples, shorter than a stride
WALKS = [("cfg2", 0, 8, 20_000), ("cfg2", 12_345, 8, 20_000),
         ("cfg2", CFG2.period - 7_000, 8, 20_000),
         ("cfg2", CFG2.period - 1, 3, 20_000),
         ("cfg2", 12_345, 16, 4096), ("cfg2", 12_345, 6, 20_001),
         ("down2", DOWN2.period - 7_000, 8, 20_000),
         ("small", SMALL.period - 5_000, 16, 2048),
         ("small", 12_345, 8, 5_000), ("small", 3, 16, 4095),
         ("short", 1_500, 8, 5_000), ("short", 2_099, 16, 1024),
         ("step7", 30, 8, 1_000), ("step7", 0, 4, 3_001)]
WALK_IDS = [f"{c}-at{p}-{n}x{k}" for c, p, n, k in WALKS]


@pytest.mark.parametrize("name, last, nseg, ppt", WALKS, ids=WALK_IDS)
def test_walk_gives_the_exact_phases(name, last, nseg, ppt):
    """Both bodies' walks against chirp_phase_index, bit for bit."""
    cfg = CFGS[name]
    ref = oracle(cfg, last, nseg * ppt)
    for vec in (2, 1) if ppt % 2 == 0 else (1,):
        assert np.array_equal(walk_phases(cfg, last, nseg, ppt, vec),
                              ref), vec


# ---- (c) the lock-in points -----------------------------------------

class Mem(NamedTuple):
    """A device allocation: a flat tensor and its first byte's address."""
    data: torch.Tensor
    addr: int


def mem(t: torch.Tensor) -> Mem:
    return Mem(t.reshape(-1), t.data_ptr())


def access(m: Mem, first, vec: int):
    """The elements a vector access at element indices `first` reads:
    checked aligned (vec elements' bytes) and inside the allocation, as
    the card would fault."""
    first = torch.as_tensor(first, dtype=torch.int64)
    idx = first[:, None] + torch.arange(vec)
    size = m.data.element_size()
    if vec == 2:
        assert ((m.addr + first * size) % (2 * size) == 0).all(), \
            "misaligned vector access"
    assert idx.numel() == 0 or int(idx.max()) < m.data.numel(), \
        "access past the allocation"
    return idx


def fma(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def osc(idx):
    """csrc/lockin.cu osc: (sin th, -cos th) at th = pi * idx / 2^31 for
    int32 phases idx (int64 array), float32."""
    th = torch.from_numpy(idx).float() * C.INV_2_31_5 * C.PI_F32
    return torch.sin(th), -torch.cos(th)


def tree(v):
    """Lane 0 of csrc/lockin.cu warp_sum over the last axis (32 lanes):
    v[l] += v[l + off] for off 16, 8, 4, 2, 1, in float32."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def emulate(cfg, w, last, x: Mem, row0, nseg, ppt, f: Faults = Faults()):
    """The kernel's lock-in points (nseg,) complex64 for rows
    [row0, row0 + nseg) of the (rows, ppt) recording at x, from stream
    position `last`: segment by segment, each thread's columns in turn,
    then the shuffle tree and the warps."""
    wm = mem(w)
    plan = L.chirp_plan(nseg, ppt, L.pointers_aligned(
        x.addr + row0 * ppt * 8, wm.addr))
    vec = f.vec or plan["vec"]
    plan = dict(plan, vec=vec)
    T = plan["threads"]
    y = torch.zeros(nseg, dtype=torch.complex64)
    for s in range(nseg):
        re = torch.zeros(T, dtype=torch.float32)
        im = torch.zeros(T, dtype=torch.float32)
        row = (row0 + s) * ppt
        for lane, j, a, bb in thread_walk(cfg, last, s, ppt, plan, f):
            lane = torch.from_numpy(lane)
            xs = x.data[access(x, row + torch.from_numpy(j) * vec, vec)]
            ws = wm.data[access(wm, torch.from_numpy(j) * vec, vec)]
            for v, ph in enumerate((a, bb)[:vec]):
                cr, ci = osc(ph)
                xr, xi = xs[:, v].real, xs[:, v].imag
                zr = fma(cr, xr, ci * xi)
                zi = fma(cr, xi, -(ci * xr))
                re[lane] = fma(ws[:, v], zr, re[lane])
                im[lane] = fma(ws[:, v], zi, im[lane])
        warps_re = tree(re.reshape(-1, 32))
        warps_im = tree(im.reshape(-1, 32))
        if f.drop_warp:
            warps_re, warps_im = warps_re[:-1], warps_im[:-1]
        pad = torch.zeros(32 - len(warps_re))
        y[s] = torch.complex(tree(torch.cat([warps_re, pad])),
                             tree(torch.cat([warps_im, pad])))
    return y


def recording(rng, rows, ppt, offset=0):
    """A (rows, ppt) recording `offset` samples into its allocation."""
    flat = torch.from_numpy(crandn(rng, rows * ppt + offset))
    return flat[offset:].view(rows, ppt)


# (config, position, nseg, ppt, block, offset): the walk's cases that the
# JAX kernels take (nseg a multiple of 8) as #18 blocks of a 3-block
# recording, and a view one sample in (the 8-byte body)
POINTS = [("small", 0, 8, 1000, 1, 0), ("small", 12_345, 16, 2048, 2, 0),
          ("small", SMALL.period - 5_000, 16, 2048, 0, 0),
          ("small", 3, 8, 4095, 1, 0), ("cfg2", 12_345, 16, 4096, 1, 0),
          ("cfg2", CFG2.period - 7_000, 8, 20_000, 0, 0),
          ("down2", DOWN2.period - 7_000, 8, 20_000, 2, 0),
          ("short", 1_500, 8, 5_000, 1, 0), ("step7", 30, 8, 1_000, 0, 0),
          ("small", 777, 8, 2048, 1, 1)]
POINT_IDS = [f"{c}-at{p}-{n}x{k}-b{b}-o{o}" for c, p, n, k, b, o in POINTS]


def jax_config(cfg):
    return jchirp.ChirpConfig(num_steps=cfg.num_steps, length=cfg.length,
                              chirpness=cfg.chirpness, f0=cfg.f0)


@pytest.mark.parametrize("name, last, nseg, ppt, idx, offset", POINTS,
                         ids=POINT_IDS)
def test_lockin_at_points(name, last, nseg, ppt, idx, offset):
    """#18: block `idx` of a recording, against the plain version and
    JAX's pallas_chirp_lockin_at in interpret mode."""
    cfg = CFGS[name]
    rng = np.random.default_rng(nseg + ppt + idx + offset)
    X = recording(rng, 3 * nseg, ppt, offset)
    w = torch.from_numpy(lockin_profile(ppt))
    got = emulate(cfg, w, last, Mem(X.reshape(-1), X.data_ptr()),
                  idx * nseg, nseg, ppt)
    plain = L.lockin_at_plain(cfg, w, last, X, idx, nseg)
    assert rel_err(plain.numpy(), got.numpy()) <= REL
    _, jy = pallas_chirp_lockin_at(
        jax_config(cfg), w.numpy(), np.uint32(last),
        jcplx.from_np(X.numpy()), idx, nseg, interpret=True)
    assert rel_err(jcplx.to_np(jy), got.numpy()) <= REL


@pytest.mark.parametrize("name, last, nseg, ppt", [
    ("small", SMALL.period - 5_000, 16, 2048), ("down2", 12_345, 8, 4096),
    ("short", 2_099, 8, 1024)], ids=["small-seam", "down2", "short"])
def test_fused_chirp_lockin_points(name, last, nseg, ppt):
    """#19: a streamed block (the same kernel at row 0), against the
    plain version and JAX's pallas_chirp_lockin in interpret mode; fed
    the chirp itself, every point within 1e-5 of 1."""
    cfg = CFGS[name]
    rng = np.random.default_rng(ppt + nseg)
    x = torch.from_numpy(crandn(rng, nseg * ppt))
    w = torch.from_numpy(lockin_profile(ppt))
    got = emulate(cfg, w, last, mem(x), 0, nseg, ppt)
    _, plain = L.fused_chirp_lockin_plain(cfg, w, last, x)
    assert rel_err(plain.numpy(), got.numpy()) <= REL
    _, jy = pallas_chirp_lockin(jax_config(cfg), jnp.asarray(w.numpy()),
                                jnp.uint32(last), jcplx.from_np(x.numpy()),
                                interpret=True)
    assert rel_err(jcplx.to_np(jy), got.numpy()) <= REL
    c = C.chirp_block(cfg, last, nseg * ppt, device="cpu")[1]
    assert float((emulate(cfg, w, last, mem(c), 0, nseg, ppt) - 1).abs()
                 .max()) <= 1e-5


# ---- the emulation's faults -----------------------------------------

@pytest.mark.parametrize("late", [1, 2])
def test_walk_fails_a_late_step_boundary(late):
    """A step's end taken late, config 2 from 12,345 (a step boundary
    inside every segment, no seam).  One sample late the phases stay
    exact: the quadratic phase is continuous at a step's end (both
    steps' formulas give the same idx at nb, c*(nb - length*(fi+1)) = 0
    apart), so the walk may take either step there.  Two samples late
    the sample after the end takes the old step's F and fails."""
    ref = oracle(CFG2, 12_345, 4 * 20_000)
    for vec in (2, 1):
        got = walk_phases(CFG2, 12_345, 4, 20_000, vec, Faults(late=late))
        assert np.array_equal(got, ref) == (late == 1)


def test_walk_fails_an_unwrapped_seam():
    """The seam not wrapped: a block across the period's end."""
    last = CFG2.period - 7_000
    ref = oracle(CFG2, last, 4 * 20_000)
    for vec in (2, 1):
        assert not np.array_equal(walk_phases(
            CFG2, last, 4, 20_000, vec, Faults(no_wrap=True)), ref)


def fails(fn, ref) -> bool:
    """Whether an emulation with a fault injected raises or misses the
    bar against `ref`."""
    try:
        got = fn()
    except AssertionError:
        return True
    return rel_err(ref.numpy(), got.numpy()) > REL


def test_emulation_fails_a_dropped_warp():
    """The block's last warp left out of its sum (ppt 2048: every warp
    holds columns)."""
    rng = np.random.default_rng(11)
    X = recording(rng, 16, 2048)
    w = torch.from_numpy(lockin_profile(2048))
    assert fails(lambda: emulate(SMALL, w, 99, mem(X), 0, 16, 2048,
                                 Faults(drop_warp=True)),
                 L.lockin_at_plain(SMALL, w, 99, X, 0, 16))


@pytest.mark.parametrize("ppt", [4095, 1001, 1])
def test_emulation_fails_the_wide_body_on_odd_ppt(ppt):
    """The 16-byte body forced on an odd ppt: its odd rows start
    misaligned, and a row's last sample is never read."""
    rng = np.random.default_rng(ppt)
    X = recording(rng, 8, ppt)
    w = torch.from_numpy(lockin_profile(ppt))
    assert L.chirp_plan(8, ppt, True)["vec"] == 1
    assert fails(lambda: emulate(SMALL, w, 5, mem(X), 0, 8, ppt,
                                 Faults(vec=2)),
                 L.lockin_at_plain(SMALL, w, 5, X, 0, 8))
