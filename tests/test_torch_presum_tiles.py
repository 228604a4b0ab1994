"""The pre-sum kernel (csrc/presum.cu: kernel #2 ``presum`` and #6
``presum_at``) on the CPU: its launch plan and a PyTorch emulation of
its tile walk.

(a) The plan that ops/presum.py mirrors (``presum_plan``): its constants
are csrc/presum.cu's, read from the source; for T 1..70, nfft 1..64,
999, 1000, 1001 and 1018, avg 1..12 and both bodies (16-byte columns of
two bins where nfft is even and the pointers aligned, else 8-byte
columns of one), its grid of (tiles, strips) blocks covers every output
(t, b) exactly once, and avg picks the register ring (avg <= 8) or the
generic body.

(b) The kernel's walk, emulated: per tile and strip, each thread's
column loads its avg taps once; the ring body loads the tile's avg - 1
halo rows, then kInFlight rows a step, and sums the ring; the generic
body loads avg rows an output.  Every extended row is resolved through
rows.cuh's ``row_ptr`` rule (a spare then a block; a recording read in
place, wrapped at the loop seam, zero when ``valid`` is 0, a recording
shorter than its halo), every load, tap and store at the body's width
and alignment, every output written once, each sum formed in the
kernel's order in float32 FMA.  Held to 1e-6 relative against the
port's ``presum_plain`` / ``presum_at_plain`` and the JAX package's
``pallas_presum`` / ``pallas_presum_at`` in interpret mode where they
take the geometry (T a multiple of 8, avg - 1 <= 8; the recording's
frames too, avg >= 2).  The emulation fails under a halo started one
row late, a dropped tail tile and the 16-byte body taken on odd nfft.
The kernel itself runs only on the card (chip_smoke.py).
"""

import re
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops.cplx import C as JC
from gpu_sdr_tpu.ops.pallas_pfb import pallas_presum, pallas_presum_at
from gpu_sdr_tpu_torch.ops import presum as P
from gpu_sdr_tpu_torch.ops.pfb import PFBConfig

torch.set_num_threads(2)

RATE = 1_000_000
REL = 1e-6
PLAN_T = range(1, 71)
PLAN_NFFT = list(range(1, 65)) + [999, 1000, 1001, 1018]
PLAN_AVG = range(1, 13)


def source_constants():
    """csrc/presum.cu's integer ``constexpr int`` constants."""
    text = (Path(P.__file__).parent.parent / "csrc" / "presum.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def rel_err(ref, test):
    ref, test = np.asarray(ref).ravel(), np.asarray(test).ravel()
    return np.linalg.norm(ref - test) / np.linalg.norm(ref)


def window(nfft, avg):
    return PFBConfig(nfft=nfft, avg=avg, rate=RATE).window("cpu").reshape(
        avg, nfft)


# ---- (a) the plan ---------------------------------------------------

def test_plan_mirrors_the_source():
    d, t = source_constants(), P.PRESUM_TILES
    assert (t["rows"], t["threads"], t["in_flight"], t["ring_max"]) == \
        (d["kRows"], d["kThreads"], d["kInFlight"], d["kMaxRingAvg"]) == \
        (32, 256, 2, 8)
    # the main path's shapes: #2 at 6000 x 1000, #6 at NOISE's 5893 x 1018
    assert P.presum_plan(6000, 1000, 4, True) == dict(
        vec=2, threads=256, strips=2, rows=32, tiles=188, ring=4)
    assert P.presum_plan(5893, 1018, 4, True) == dict(
        vec=2, threads=256, strips=2, rows=32, tiles=185, ring=4)
    assert P.presum_plan(997, 1001, 16, True) == dict(
        vec=1, threads=256, strips=4, rows=32, tiles=32, ring=0)
    assert P.presum_plan(1, 10, 1, False) == dict(
        vec=1, threads=32, strips=1, rows=32, tiles=1, ring=1)
    # a view one sample into a recording takes the 8-byte body
    assert P.pointers_aligned(1 << 20, 0, 1 << 21, 1 << 22)
    assert not P.pointers_aligned((1 << 20) + 8, 0, 1 << 21, 1 << 22)
    assert not P.pointers_aligned(1 << 20, 0, 1 << 21, (1 << 22) + 4)


def grid_counts(plan, T, nfft):
    """How often the plan's grid writes each output row and each bin (a
    thread past the columns returns; a tile's rows stop at T); the grid
    is a product of tiles and strips, so (t, b) is written rows[t] *
    bins[b] times.  Bins at or past nfft are counted in bins[nfft]."""
    vec, R = plan["vec"], plan["rows"]
    c = np.arange(plan["strips"] * plan["threads"])
    c = c[c < nfft // vec]
    b = (c[:, None] * vec + np.arange(vec)).ravel()
    t = (np.arange(plan["tiles"])[:, None] * R + np.arange(R)).ravel()
    t = t[t < T]
    return (np.bincount(t, minlength=T),
            np.bincount(np.minimum(b, nfft), minlength=nfft + 1))


@pytest.mark.parametrize("aligned", [True, False], ids=["16B", "8B"])
@pytest.mark.parametrize("avg", PLAN_AVG)
def test_plan_covers_every_output_once(avg, aligned):
    """Every (t, b) once, for T 1..70 and nfft 1..64, 999, 1000, 1001,
    1018; the 16-byte body only where asked for and nfft is even; whole
    warps, at most kThreads a block; avg picks the body."""
    t = P.PRESUM_TILES
    for nfft in PLAN_NFFT:
        for T in PLAN_T:
            p = P.presum_plan(T, nfft, avg, aligned)
            assert p["vec"] == (2 if aligned and nfft % 2 == 0 else 1)
            assert p["threads"] % 32 == 0 and p["threads"] <= t["threads"]
            assert p["ring"] == (avg if avg <= t["ring_max"] else 0)
            rows, bins = grid_counts(p, T, nfft)
            assert (rows == 1).all() and (bins[:nfft] == 1).all() and \
                bins[nfft] == 0, (T, nfft, avg, aligned)


# ---- (b) the emulation ----------------------------------------------

class Mem(NamedTuple):
    """A device allocation: a flat tensor and its first byte's address."""
    data: torch.Tensor
    addr: int


def mem(t: torch.Tensor) -> Mem:
    return Mem(t.reshape(-1), t.data_ptr())


class Rows(NamedTuple):
    """rows.cuh ``Rows``: (a) a streamed block after its history, (b) a
    recording's block read in place."""
    x: Mem
    hist: Optional[Mem]
    x_rows: int
    base: int
    nb: int
    lead: int
    M: int
    valid: int


def row_ptr(rows: Rows, g: int):
    """rows.cuh ``row_ptr``: extended row g's (allocation, first element),
    or None where it stands for zeros."""
    if g >= rows.nb + rows.lead:
        return None                                   # past the block
    r = g - rows.lead
    if r >= 0:
        return rows.x, (rows.base + r) * rows.M
    if not rows.valid:
        return None
    if rows.hist is not None:
        return rows.hist, g * rows.M
    w = rows.base + r
    if w < 0:                       # wrapped at the loop seam (C's % then
        w = w % rows.x_rows         # + x_rows: Python's % is that)
    return rows.x, w * rows.M


def access(m: Mem, first: torch.Tensor, vec: int):
    """The elements a column access at element indices `first` reads or
    writes at the body's width: checked aligned (16 bytes for two
    complex64, 8 for two float32) and inside the allocation, as the card
    would fault."""
    idx = first[:, None] + torch.arange(vec)
    nbytes = m.data.element_size()
    if vec == 2:
        assert ((m.addr + first * nbytes) % (2 * nbytes) == 0).all(), \
            "misaligned vector access"
    assert idx.numel() == 0 or int(idx.max()) < m.data.numel(), \
        "access past the allocation"
    return idx


def fma(w, v, acc):
    """acc + w * v per component, rounded once to float32 (FFMA; the
    float32 product is exact in float64)."""
    return (w.double() * v.to(torch.complex128) +
            acc.to(torch.complex128)).to(torch.complex64)


def emulate(rows: Rows, w2: torch.Tensor, vec=None, halo_late=0,
            drop_tail=False):
    """The kernel's result, tile by tile, strip by strip, step by step:
    (T, nfft) complex64, every element written once.  Faults: `vec`
    forces the body, `halo_late` starts each tile's halo rows that many
    rows late, `drop_tail` launches only the whole tiles."""
    avg, nfft = w2.shape
    T = rows.nb
    out = Mem(torch.full((T * nfft,), float("nan"), dtype=torch.complex64),
              1 << 30)
    w = mem(w2)
    plan = P.presum_plan(T, nfft, avg, P.pointers_aligned(
        rows.x.addr, rows.hist.addr if rows.hist else 0, out.addr, w.addr))
    vec = vec or plan["vec"]
    R, F = plan["rows"], P.PRESUM_TILES["in_flight"]
    cols = nfft // vec
    tiles = T // R if drop_tail else plan["tiles"]
    for tile in range(tiles):
        t0 = tile * R
        nt = min(R, T - t0)
        for strip in range(plan["strips"]):
            c = strip * plan["threads"] + torch.arange(plan["threads"])
            c = c[c < cols]                         # the rest return

            def load(j):
                """Tile row j of ext at the thread's column: (n, vec)."""
                if j < avg - 1:
                    j += halo_late
                src = row_ptr(rows, t0 + j)
                if src is None:
                    return torch.zeros((len(c), vec), dtype=torch.complex64)
                m, off = src
                return m.data[access(m, off + c * vec, vec)]

            def tap(i):
                return w.data[access(w, i * nfft + c * vec, vec)]

            def store(t, acc):
                idx = access(out, (t0 + t) * nfft + c * vec, vec)
                assert torch.isnan(out.data[idx]).all(), "written twice"
                out.data[idx] = acc

            zero = torch.zeros((len(c), vec), dtype=torch.complex64)
            if plan["ring"]:
                wr = [tap(i) for i in range(avg)]
                v = [load(i) for i in range(avg - 1)]
                for t in range(0, nt, F):
                    v += [load(t + k + avg - 1) if t + k < nt else zero
                          for k in range(F)]
                    for k in range(F):
                        acc = zero
                        for i in range(avg):
                            acc = fma(wr[i], v[k + i], acc)
                        if t + k < nt:
                            store(t + k, acc)
                    v = v[F:]
            else:
                for t in range(nt):
                    acc = zero
                    for i in range(avg):
                        acc = fma(tap(i), load(t + i), acc)
                    store(t, acc)
    got = out.data.reshape(T, nfft)
    assert not torch.isnan(got).any(), "an output never written"
    return got


def streamed(rng, T, nfft, avg, offset=0):
    """A block and its spare; the block `offset` samples into its
    allocation (a view one sample in takes the 8-byte body)."""
    w2 = window(nfft, avg)
    spare = torch.from_numpy(crandn(rng, avg - 1, nfft))
    flat = torch.from_numpy(crandn(rng, T * nfft + offset))
    X = flat[offset:].view(T, nfft)
    return w2, spare, X, Rows(Mem(X.reshape(-1), X.data_ptr()), mem(spare),
                              T, 0, T, avg - 1, nfft, 1)


def jax_takes(T, avg):
    """Whether JAX's Pallas pre-sum takes the geometry (8-aligned tiles,
    a halo of at most 8 rows)."""
    return T % 8 == 0 and avg - 1 <= 8


# (T, nfft, avg, offset): nfft 1000 at avg 4 with a tail tile (72 = 2 x 32
# + 8) and the NOISE nfft; nfft 1001 and a view one sample in (the 8-byte
# body); avg 1, 2, 8 on the ring, 9 and 12 on the generic body; T < avg-1
STREAMED = [(72, 1000, 4, 0), (64, 1018, 4, 0), (72, 1001, 4, 0),
            (40, 1000, 4, 1), (40, 62, 1, 0), (48, 63, 2, 0),
            (70, 100, 8, 0), (72, 64, 9, 0), (33, 50, 12, 0),
            (3, 1000, 8, 0), (5, 1001, 16, 0), (1, 20, 4, 0)]


@pytest.mark.parametrize("T, nfft, avg, offset", STREAMED,
                         ids=[f"T{t}-n{n}-a{a}-o{o}"
                              for t, n, a, o in STREAMED])
def test_emulation_streamed_block(T, nfft, avg, offset):
    """(a) a streamed block after its carried spare (#2)."""
    rng = np.random.default_rng(T * 7 + nfft + avg)
    w2, spare, X, rows = streamed(rng, T, nfft, avg, offset)
    got = emulate(rows, w2)
    assert P.presum_plan(T, nfft, avg, P.pointers_aligned(
        X.data_ptr(), spare.data_ptr(), 0, w2.data_ptr()))["vec"] == \
        (2 if nfft % 2 == 0 and offset == 0 else 1)
    plain = P.presum_plain(w2, spare, X)
    assert rel_err(plain.numpy(), got.numpy()) <= REL
    if jax_takes(T, avg):
        jout = pallas_presum(w2.numpy(), jcplx.from_np(spare.numpy()),
                             jcplx.from_np(X.numpy()), interpret=True)
        assert rel_err(jcplx.to_np(jout), got.numpy()) <= REL


def recording(rng, frames, nfft, avg, offset=0):
    w2 = window(nfft, avg)
    flat = torch.from_numpy(crandn(rng, frames * nfft + offset))
    X = flat[offset:].view(frames, nfft)
    return w2, X


# (frames a block, blocks, nfft, avg, block, valid, offset): the stream's
# start, inside, the last block and block 0 after the loop seam at nfft
# 1000 (a tail tile at 40 frames); NOISE's nfft 1018; the 8-byte body at
# nfft 1001 and one sample in; the generic body (avg 9, 12); T < avg - 1
# at the stream's start and after the seam; recordings shorter than the
# halo: 4 frames, block 1 of one frame (a halo that wraps in part), 2
# frames (a halo that wraps more than once), avg 4 and 8
RECORDED = [(40, 4, 1000, 4, 0, 0, 0), (40, 4, 1000, 4, 2, 1, 0),
            (40, 4, 1000, 4, 3, 1, 0), (40, 4, 1000, 4, 0, 1, 0),
            (64, 3, 1018, 4, 0, 1, 0), (72, 3, 1001, 4, 1, 1, 0),
            (40, 3, 100, 4, 0, 1, 1), (40, 3, 64, 9, 0, 1, 0),
            (35, 3, 30, 12, 1, 1, 0), (3, 4, 1000, 8, 0, 0, 0),
            (3, 4, 1000, 8, 0, 1, 0), (1, 4, 200, 4, 1, 1, 0),
            (1, 2, 200, 4, 1, 1, 0), (1, 2, 201, 8, 1, 1, 0),
            (1, 4, 40, 8, 0, 1, 0)]


@pytest.mark.parametrize("T, nblk, nfft, avg, idx, valid, offset", RECORDED,
                         ids=[f"T{c[0]}x{c[1]}-n{c[2]}-a{c[3]}-b{c[4]}-v"
                              f"{c[5]}-o{c[6]}" for c in RECORDED])
def test_emulation_recording_block(T, nblk, nfft, avg, idx, valid, offset):
    """(b) a block of a resident recording read in place (#6)."""
    rng = np.random.default_rng(T + nblk * 13 + nfft + avg + idx)
    w2, X = recording(rng, nblk * T, nfft, avg, offset)
    rows = Rows(Mem(X.reshape(-1), X.data_ptr()), None, nblk * T, idx * T, T,
                avg - 1, nfft, valid)
    got = emulate(rows, w2)
    plain = P.presum_at_plain(w2, X, idx, valid, T)
    assert rel_err(plain.numpy(), got.numpy()) <= REL
    if jax_takes(T, avg) and avg > 1:
        xc = jcplx.from_np(X.numpy())
        jout = pallas_presum_at(w2.numpy(), JC(xc.re, xc.im), idx, valid, T,
                                interpret=True)
        assert rel_err(jcplx.to_np(jout), got.numpy()) <= REL


def fails(fn, ref) -> bool:
    """Whether an emulation with a fault injected raises or misses the
    bar against `ref`."""
    try:
        got = fn()
    except AssertionError:
        return True
    return rel_err(ref.numpy(), got.numpy()) > REL


# (T, nfft, avg): the ring at avg 4 and 8, the generic body at avg 9
FAULTS = [(72, 1000, 4), (40, 64, 8), (70, 30, 9)]


@pytest.mark.parametrize("T, nfft, avg", FAULTS,
                         ids=[f"T{t}-n{n}-a{a}" for t, n, a in FAULTS])
def test_emulation_fails_a_late_halo(T, nfft, avg):
    """A halo started one row late, on a streamed block and after the
    loop seam."""
    rng = np.random.default_rng(3 * T + avg)
    w2, spare, X, rows = streamed(rng, T, nfft, avg)
    assert fails(lambda: emulate(rows, w2, halo_late=1),
                 P.presum_plain(w2, spare, X))
    w2, R = recording(rng, 3 * T, nfft, avg)
    rows = Rows(mem(R), None, 3 * T, 0, T, avg - 1, nfft, 1)
    assert fails(lambda: emulate(rows, w2, halo_late=1),
                 P.presum_at_plain(w2, R, 0, 1, T))


@pytest.mark.parametrize("T, nfft, avg", FAULTS,
                         ids=[f"T{t}-n{n}-a{a}" for t, n, a in FAULTS])
def test_emulation_fails_a_dropped_tail_tile(T, nfft, avg):
    """Only the whole tiles launched: the tail's rows are never written."""
    assert T % P.PRESUM_TILES["rows"]
    rng = np.random.default_rng(5 * T + avg)
    w2, spare, X, rows = streamed(rng, T, nfft, avg)
    assert fails(lambda: emulate(rows, w2, drop_tail=True),
                 P.presum_plain(w2, spare, X))


@pytest.mark.parametrize("nfft", [1001, 63, 1])
def test_emulation_fails_the_wide_body_on_odd_nfft(nfft):
    """The 16-byte body forced on an odd nfft: its rows after the first
    are misaligned, and a row's last bin is never written."""
    rng = np.random.default_rng(nfft)
    w2, spare, X, rows = streamed(rng, 40, nfft, 4)
    assert P.presum_plan(40, nfft, 4, True)["vec"] == 1
    assert fails(lambda: emulate(rows, w2, vec=2),
                 P.presum_plain(w2, spare, X))
