"""The channelizer kernel's FFT plan (csrc/channelizer.cu), on the CPU.

The kernel computes each frame's DFT as mixed-radix Stockham passes over
a radix plan and a twiddle table that ops/channelizer.py builds
(``fft_radices``, ``fft_table``) and hands it.  Here the plan and the
table run through ``stockham``, a plain PyTorch emulation of the
kernel's passes (the same index math, in float32), held against numpy's
float64 FFT at 120 dB SNR for every nfft the repo uses, two with a
prime pass, and three more that take the other radices; and, where the
JAX package's Pallas channelizer takes the geometry, the pre-sum then
the emulated passes against that kernel (interpret mode) at 90 dB
(tests/test_ops_pfb_chirp.py:50-51).
The shared-memory plan mirrors the source's constants, and the gate
(``can_fuse_channelizer``) admits exactly the geometries of the port's
earlier two-stage kernel, its rule written out here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import pfb as jpfb
from gpu_sdr_tpu.ops.cplx import DFT
from gpu_sdr_tpu.ops.pallas_channelizer import (
    can_fuse_channelizer as jax_can_fuse, channelizer_frames_t,
    natural_frames_t, transpose_block)
from gpu_sdr_tpu_torch.ops import channelizer as ch
from gpu_sdr_tpu_torch.ops import pfb
from gpu_sdr_tpu_torch.ops.presum import presum_plain

torch.set_num_threads(2)

RATE, AVG, FRAMES = 1_000_000, 4, 16
FFT_BAR, JAX_BAR = 120.0, 90.0
NFFTS = [64, 200, 500, 1000, 4096, 127, 1016, 960, 1024, 21]
JAX_NFFTS = [64, 200, 1000, 1016, 960, 1024]     # 2 <= n1 <= 16
H100_SM_SMEM = 233_472          # an SM's shared memory, 228 KB
SMEM_RESERVED = 1024            # the runtime's share of each block


def crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def stockham(a: torch.Tensor, radices, table: np.ndarray) -> torch.Tensor:
    """The kernel's passes over frames a (F, n) complex64: pass p of
    radix R reads butterfly j's inputs a[j + r nb] (nb = n / R), twiddles
    input r by table[off + (r-1) ns + m] (m = j % ns), takes their
    DFT over R's roots table[off + ns (R-1) + (r k mod R)], and writes
    output k to b[(j - m) R + m + k ns]."""
    F, n = a.shape
    tw = torch.from_numpy(table)
    ns, off = 1, 0
    for R in radices:
        nb = n // R
        j = torch.arange(nb)
        m = j % ns
        r = torch.arange(R)[:, None]
        v = a[:, j[None, :] + r * nb]                             # (F, R, nb)
        v[:, 1:] = v[:, 1:] * tw[off + (r[1:] - 1) * ns + m]
        roots = tw[off + ns * (R - 1) + (r * r.T) % R]            # (k, q)
        y = torch.einsum("kq,fqj->fkj", roots, v)
        b = torch.empty_like(a)
        b[:, ((j - m) * R + m + r * ns).reshape(-1)] = y.reshape(F, -1)
        a, off, ns = b, off + ns * (R - 1) + R, ns * R
    return a


def source_constants():
    """The ``constexpr int`` literals of csrc/channelizer.cu."""
    text = (Path(ch.__file__).parent.parent / "csrc" /
            "channelizer.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


@pytest.mark.parametrize("nfft", NFFTS)
def test_fft_plan_matches_numpy(nfft):
    """The plan's radices multiply to nfft, each a butterfly radix of
    the kernel or a prime factor they leave; through the emulated
    passes it is the float64 FFT to 120 dB."""
    radices = ch.fft_radices(nfft)
    assert int(np.prod(radices)) == nfft
    assert all(r in ch.FFT_RADICES or
               (r > 7 and all(r % d for d in range(2, r)))
               for r in radices)
    x = crandn(np.random.default_rng(nfft), 3, nfft)
    got = stockham(torch.from_numpy(x), radices, ch.fft_table(radices))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert golden.snr_db(ref, got.numpy()) >= FFT_BAR


@pytest.mark.parametrize("nfft", JAX_NFFTS)
def test_presum_and_fft_plan_match_pallas(nfft):
    """One block from the zero spare: the port's plain pre-sum, then the
    emulated passes, against the JAX package's Pallas channelizer
    (interpret mode), natural order; and against the float64 oracle."""
    rng = np.random.default_rng(61 + nfft)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    dft = DFT(nfft, two_stage=True)
    n1, n2 = dft.split
    assert jax_can_fuse(jcfg, dft, FRAMES * nfft)
    xs = crandn(rng, FRAMES * nfft)
    _, jfr = channelizer_frames_t(
        jcfg, jcfg.window(), dft,
        transpose_block(jpfb.pfb_spare_init(jcfg), nfft, n1, n2),
        transpose_block(jcplx.from_np(xs), nfft, n1, n2), interpret=True)
    pre = presum_plain(cfg.window("cpu").reshape(AVG, nfft),
                       torch.zeros(AVG - 1, nfft, dtype=torch.complex64),
                       torch.from_numpy(xs).reshape(FRAMES, nfft))
    radices = ch.fft_radices(nfft)
    got = stockham(pre, radices, ch.fft_table(radices)).numpy()
    assert golden.snr_db(jcplx.to_np(natural_frames_t(jfr)), got) > JAX_BAR
    z = np.concatenate([np.zeros((AVG - 1) * nfft, np.complex128), xs])
    assert golden.snr_db(golden.pfb_frames(z, nfft, AVG), got) > JAX_BAR


@pytest.mark.parametrize("nfft", [127, 500, 4096])
def test_pallas_refuses_where_only_the_port_runs(nfft):
    """The JAX kernel's 2 <= n1 <= 16 rule refuses these sizes; the
    port's gate admits them (ROADMAP Queue 3, divergence 10)."""
    jcfg = jpfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
    assert not jax_can_fuse(jcfg, DFT(nfft, two_stage=True), FRAMES * nfft)
    assert ch.can_fuse_channelizer(cfg, FRAMES * nfft)


def test_fft_table_layout():
    """Each pass's twiddles, then its roots, built in float64 and stored
    complex64: the first pass's twiddles exactly 1, every entry on the
    unit circle, at the offsets the kernel's make_plan computes."""
    radices = ch.fft_radices(1000)
    assert radices == (10, 10, 10)
    strides = np.cumprod((1,) + radices[:-1])
    assert ch.fft_table(radices).dtype == np.complex64
    table = ch.fft_table(radices).astype(np.complex128)
    assert len(table) == sum(ns * (R - 1) + R
                             for ns, R in zip(strides, radices))
    assert np.all(table[:radices[0] - 1] == 1)
    eps = 2e-7                  # complex64 rounding of each part
    assert np.abs(np.abs(table) - 1).max() < eps
    off = 0
    for ns, R in zip(strides, radices):
        m, r = ns - 1, R - 1
        assert abs(table[off + (r - 1) * ns + m] -
                   np.exp(-2j * np.pi * r * m / (ns * R))) < eps
        assert abs(table[off + ns * (R - 1) + 1] -
                   np.exp(-2j * np.pi / R)) < eps
        off += ns * (R - 1) + R


def test_smem_plan_mirrors_the_source():
    """The Python plan's constants are the CUDA source's; a tile's two
    buffers fit three blocks an SM up to nfft 4608, one block's shared
    memory up to 14,528, and beyond it the kernel keeps them in device
    memory (0 bytes)."""
    c = source_constants()
    assert (c["FT_MAX"], c["SMEM_TILE"], c["SMEM_MAX"]) == \
        (ch.FRAME_TILE, ch.SMEM_TILE, ch.SMEM_LIMIT)
    sizes = {n: ch.smem_bytes(n) for n in range(1, 20_001)}
    assert all(3 * (b + SMEM_RESERVED) <= H100_SM_SMEM
               for n, b in sizes.items() if n <= 4608)
    assert all(0 < b <= ch.SMEM_LIMIT for n, b in sizes.items()
               if n <= 14_528)
    assert all(b == 0 for n, b in sizes.items() if n > 14_528)
    assert ch.tile_frames(1000) == 4 and ch.smem_bytes(1000) == 64_000


def pr7_rule(nfft, block_len):
    """The port's two-stage kernel's gate: G_k1 (n2 x n2 complex) and a
    32-frame z tile (32 x n2) inside one block's 227 KB, whole frames."""
    _, n2 = ch.best_split(nfft)
    return ((n2 * n2 + 32 * n2) * 8 <= 232_448 and
            block_len % nfft == 0 and block_len >= nfft)


@pytest.mark.parametrize("frames", [1, 7, 6000])
def test_can_fuse_admits_the_two_stage_geometries(frames):
    """For nfft 2..5000 and whole-frame blocks (and one sample short of
    them), the gate admits exactly what the two-stage kernel's did:
    every nfft whose split's n2 is at most 155 (nfft 1018, split 2 x
    509, stays refused)."""
    for nfft in range(2, 5001):
        cfg = pfb.PFBConfig(nfft=nfft, avg=AVG, rate=RATE)
        for L in (frames * nfft, frames * nfft - 1):
            assert ch.can_fuse_channelizer(cfg, L) == pr7_rule(nfft, L), \
                (nfft, L)
        assert pr7_rule(nfft, nfft) == (ch.best_split(nfft)[1] <= 155)
    assert not ch.can_fuse_channelizer(
        pfb.PFBConfig(nfft=1018, avg=AVG, rate=RATE), frames * 1018)
