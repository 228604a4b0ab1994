"""The TF32 split of the port's tensor-core kernels (csrc/tc.cuh: the
fold #11-#14 and the chain #15), rehearsed on the CPU.

``ops/cplx.tf32_round`` emulates the card's ``cvt.rna.tf32.f32`` bit for
bit (round to nearest, ties away from zero, the low 13 mantissa bits
cleared); ``tf32_split`` forms big + small as the kernels do, and
``tf32_cmatmul`` their complex product (the real embedding, float32
sums).  At config 3's widths (Ct = Cp = 100) one TF32 pass stays under
the 90 dB bar against the float64 oracle, and the three-pass split
(small*big + big*small + big*big) clears it, for the fold and for the
chain at f 4 and at a deep f: that is why the kernels take three passes.
The oracle is the same function in float64 on the same complex64
operands, so it measures the product's rounding alone.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu_torch.ops import cplx, ddc
from gpu_sdr_tpu_torch.ops.chain import TonesDirectChain
from gpu_sdr_tpu_torch.ops.fold import TonesDirectFold, fold_plain

torch.set_num_threads(2)

BAR_DB = 90.0
RATE = 100_000_000
CONFIG3 = [int(f) for f in np.linspace(-45e6, 45e6, 100)]   # Ct = Cp = 100
AMPL = (0.01,) * len(CONFIG3)


def bits(x: float) -> int:
    return int(np.array([x], np.float32).view(np.uint32)[0])


def from_bits(u: int) -> float:
    return float(np.array([u], np.uint32).view(np.float32)[0])


# (input bits, cvt.rna.tf32.f32's bits): below, at and above the tie,
# ties away from zero for both signs, a carry into the exponent
@pytest.mark.parametrize("u,want", [
    (0x3F800000, 0x3F800000),       # 1.0, exact
    (0x3F800FFF, 0x3F800000),       # under the tie: down
    (0x3F801000, 0x3F802000),       # 1 + 2^-11, the tie: away from zero
    (0x3F803000, 0x3F804000),       # 1 + 3*2^-11, the tie: away
    (0x3F801001, 0x3F802000),       # over the tie: up
    (0xBF801000, 0xBF802000),       # -(1 + 2^-11): away from zero
    (0x3FFFF000, 0x40000000),       # 2 - 2^-11: the carry reaches 2.0
    (0x00000000, 0x00000000),       # +0
    (0x80000000, 0x80000000),       # -0
    (0x7F7FFFFF, 0x7F800000),       # the largest float32: past TF32's
], ids=lambda v: f"{v:#010x}")
def test_round_matches_cvt_rna_bits(u, want):
    got = cplx.tf32_round(torch.tensor([from_bits(u)], dtype=torch.float32))
    assert bits(got.item()) == want


def test_split_keeps_22_bits():
    """big + small within 2^-22 of x relative, big and small both TF32
    (low 13 bits clear), small no larger than half big's last place."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(100_000) *
                          10.0 ** rng.uniform(-6, 6, 100_000)).astype(
                              np.float32))
    big, small = cplx.tf32_split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((big.double() + small.double() - x.double()).abs() /
           x.double().abs()).max().item()
    assert rel <= 2.0 ** -22
    assert ((small.double().abs() <= big.double().abs() * 2.0 ** -11)).all()


def emulated_fold(fo, crot, qrot, passes):
    """The fold's kernel arithmetic (#11) with the product emulated:
    A = P1 * crot tile by tile, the split product, then ramp and qrot."""
    tiles = crot.shape[0]
    A = (fo.P1[None] * crot[:, None, :]).reshape(-1, fo.Ct)
    y = cplx.tf32_cmatmul(A, fo.G2, passes).reshape(tiles, -1, fo.Cp)
    return (y * fo.ramp1[None] * qrot[:, None, :]).reshape(-1, fo.Cp)


@pytest.mark.parametrize("passes", [1, 3])
def test_fold_split_at_config3(passes):
    """Config 3's fold (M 100, pf_average 4) on 4 tiles of 64 rows of a
    block away from the stream's start: real P1, crot and G2 from
    TonesDirectFold; one pass < 90 dB, three >= 90 dB, against the
    float64 fold of the same operands."""
    cfg = ddc.DirectDDCConfig(RATE, 100, 4, tuple(CONFIG3), (0,) * 100)
    fo = TonesDirectFold(RATE, tuple(CONFIG3), AMPL, cfg, 4 * 64 * 100, "cpu")
    crot, qrot = fo.block_rotations_factored(fo.advance(fo.init_state()))
    c128 = [t.to(torch.complex128) for t in (fo.P1, fo.G2, crot, qrot,
                                             fo.ramp1)]
    ref = fold_plain(*c128, fo.nb).numpy()
    snr = golden.snr_db(ref, emulated_fold(fo, crot, qrot, passes).numpy())
    assert (snr >= BAR_DB) == (passes == 3), snr
    # the float32 plain version, the kernels' yardstick, is >= 120 dB
    assert golden.snr_db(ref, fold_plain(fo.P1, fo.G2, crot, qrot, fo.ramp1,
                                         fo.nb).numpy()) >= 120.0


@pytest.mark.parametrize("decim,f,block,rows,passes", [
    (100, 4, 40_000, 200, 1),         # config 3, f 4: the g_chain path
    (100, 4, 40_000, 200, 3),
    (10, 400, 8_000, 64, 1),          # a deep FIR, a tile of rows
    (10, 400, 8_000, 64, 3),
], ids=["f4-1pass", "f4-3pass", "f400-1pass", "f400-3pass"])
def test_chain_split(decim, f, block, rows, passes):
    """The chain's K = f * Ct product over the extended rows E (halo,
    then P, each rotated), G from TonesDirectChain at config 3's tones
    and channels: one pass < 90 dB, three >= 90 dB against float64."""
    cfg = ddc.DirectDDCConfig(RATE, decim, f, tuple(CONFIG3), (0,) * 100)
    ch = TonesDirectChain(RATE, tuple(CONFIG3), AMPL, cfg, block)
    assert ch.ok
    _, srot, hrot, _ = ch.block_rotations(
        ch.block_rotations(ch.init_state())[0])
    E = torch.cat([ch.halo_rows(0) * hrot, ch.P * srot])
    E64, G64 = E.to(torch.complex128), ch.G.to(torch.complex128)
    ref = sum(E64[j:j + rows] @ G64[j] for j in range(f)).numpy()
    y = sum(cplx.tf32_cmatmul(E[j:j + rows], ch.G[j], passes)
            for j in range(f))
    snr = golden.snr_db(ref, y.numpy())
    assert (snr >= BAR_DB) == (passes == 3), snr


def test_cmatmul_is_the_complex_product():
    """The real embedding times an interleaved row is the complex
    product: with operands already TF32 (small parts 0) every pass count
    gives the float32 complex matmul to its rounding."""
    rng = np.random.default_rng(3)
    a = cplx.tf32_round(torch.from_numpy(rng.standard_normal((32, 24))
                                         .astype(np.float32)))
    b = cplx.tf32_round(torch.from_numpy(rng.standard_normal((12, 20))
                                         .astype(np.float32)))
    a = torch.view_as_complex(a.reshape(32, 12, 2).contiguous())
    b = torch.view_as_complex(b.reshape(12, 10, 2).contiguous())
    ref = (a.to(torch.complex128) @ b.to(torch.complex128)).numpy()
    for passes in (1, 3):
        assert golden.snr_db(ref, cplx.tf32_cmatmul(a, b, passes)
                             .numpy()) > 130.0
    with pytest.raises(ValueError):
        cplx.tf32_cmatmul(a, b, 2)
