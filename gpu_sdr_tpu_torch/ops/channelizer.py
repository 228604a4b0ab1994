"""Fused PFB channelizer: the CUDA kernel (csrc/channelizer.cu) in its
streamed, recording and staged-halo modes, and their plain PyTorch
versions.

Port of gpu_sdr_tpu/ops/pallas_channelizer.py (channelizer_frames_t,
channelizer_frames_at and channelizer_frames_at_halo): the windowed
pre-sum over avg-1 halo frames, then the frame's DFT.  The plain
versions keep the JAX package's algebra, a two-stage n1 x n2 DFT with
the twiddle folded into per-k1 stage-2 constants (``channelizer_consts``:
window, F1, G); the kernel computes the same function as a mixed-radix
Stockham FFT in shared memory, its plan (``fft_radices``) and twiddle
table (``fft_table``) built here in float64 once per (nfft, device).
``channelizer`` takes a streamed block and its carried spare;
``channelizer_at`` reads block `idx` of a resident (total_frames, nfft)
recording in place, its halo the avg-1 frames before it, wrapped at the
loop seam and zero on the stream's first block (``valid`` 0);
``channelizer_at_halo`` reads block `idx` of one time shard's span of a
recording, its halo frames staged per block at upload (the sharded
replay, parallel/sharded_replay.py).  The output is (T, nfft) in natural
bin order, so tone selection is ops/pfb.select_tones (a plain
``index_select``) where the JAX package needed select_tones_t; the TPU
layout artifacts (transposed (n1, T, n2) blocks and the recording
transposed at upload, 8-frame halo units, bf16 hi/lo constants, the bt %
8 tiling rule, the DFT as a matmul) have no counterpart here.

``channelizer_frames_scrambled`` is the port of the JAX package's
``channelizer_frames`` (kernel #3): a streamed block in the JAX layout
(flat spare and block), its spectra in the scrambled Cooley-Tukey order
frames[t, k1*n2 + k2] (bin k at ``scramble_index(k)``), stored so by the
kernel itself (``channelizer_scrambled``).  No engine path takes it, as
in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import build
from .pfb import PFBConfig
from .presum import pfb_frames_fused, presum_plain, recording_halo

FRAME_TILE = 32                     # frames of a block at most (csrc FT_MAX)
SMEM_TILE = 73_728                  # a multi-frame tile's two buffers (csrc)
SMEM_LIMIT = 232_448                # bytes of shared memory a block may use
SCRATCH_BLOCKS = 264                # blocks of an nfft too large for it
FFT_RADICES = (16, 10, 8, 6, 5, 4, 3, 7, 2)    # its register butterflies


def best_split(n: int) -> Tuple[int, int]:
    """The Cooley-Tukey split (n1, n2) the JAX package's two-stage DFT
    picks (gpu_sdr_tpu/ops/cplx._best_split): n1 a multiple of 8 with
    64 <= n2 <= 160 when one exists (the smallest n1 + n2), else the
    most balanced divisor pair.  (8, 125) for nfft = 1000."""
    aligned = [(d, n // d) for d in range(8, n + 1, 8)
               if n % d == 0 and 64 <= n // d <= 160]
    if aligned:
        return min(aligned, key=lambda p: p[0] + p[1])
    best = (1, n)
    for d in range(1, int(np.sqrt(n)) + 1):
        if n % d == 0:
            best = (d, n // d)
    return best


def tile_frames(nfft: int) -> int:
    """Frames of one kernel block (csrc tile_frames): its two (frames,
    nfft) complex buffers within SMEM_TILE; at least one, at most
    FRAME_TILE."""
    return max(1, min(FRAME_TILE, SMEM_TILE // (16 * nfft)))


def smem_bytes(nfft: int) -> int:
    """Shared memory of one kernel block (csrc sdr_channelizer_smem_bytes):
    the tile's two buffers, or 0 where one frame's two buffers exceed
    SMEM_LIMIT (nfft > 14,528) and the kernel keeps them in device memory
    (``SCRATCH_BLOCKS`` pairs, the blocks looping over the frames)."""
    b = 16 * tile_frames(nfft) * nfft
    return b if b <= SMEM_LIMIT else 0


def can_fuse_channelizer(cfg: PFBConfig, block_len: int) -> bool:
    """Whether the engine's paths take the channelizer kernel for this
    geometry: whole frames per block, and the rule of the port's first,
    two-stage kernel, G_k1 (n2 x n2) and a 32-frame z tile inside one
    block's shared memory (n2 <= 155).  The FFT kernel takes any nfft;
    the rule is kept so that every engine path keeps its route (NOISE at
    nfft 1018, split 2 x 509, stays on the pre-sum route).  The JAX kernel
    also needs 2 <= n1 <= 16, avg >= 2 and an 8-aligned frame tile
    dividing the block; the port's masks its last tile and reads no halo
    when avg = 1, so it takes more geometries than the JAX one."""
    _, n2 = best_split(cfg.nfft)
    return ((n2 * n2 + 32 * n2) * 8 <= SMEM_LIMIT and
            block_len % cfg.nfft == 0 and block_len >= cfg.nfft)


def fft_radices(nfft: int) -> Tuple[int, ...]:
    """The kernel's radix plan for nfft, one Stockham pass each: as many
    of each register butterfly as divide it, largest first (16, 10, 8,
    6, 5, 4, 3, 7, 2), then each prime factor left (a direct-DFT pass).
    (10, 10, 10) for 1000, (16, 16, 16) for 4096."""
    out, n = [], nfft
    for r in FFT_RADICES:
        while n % r == 0:
            out.append(r)
            n //= r
    p = 11
    while n > 1:
        if n % p == 0:
            out.append(p)
            n //= p
        else:
            p += 2
    return tuple(out)


def fft_table(radices) -> np.ndarray:
    """The kernel's twiddle table for `radices`, built in float64 and
    stored complex64: for pass p, with ns the product of the radices
    before it and R its own, exp(-2 pi i r m / (ns R)) at [(r - 1) ns +
    m] for 1 <= r < R and m < ns, then R's roots exp(-2 pi i j / R), j <
    R (csrc Plan)."""
    parts, ns = [], 1
    for R in radices:
        r = np.arange(1, R, dtype=np.float64)[:, None]
        m = np.arange(ns, dtype=np.float64)[None, :]
        parts += [np.exp(-2j * np.pi * r * m / (ns * R)).ravel(),
                  np.exp(-2j * np.pi * np.arange(R) / R)]
        ns *= R
    return np.concatenate(parts or [np.zeros(0)]).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _fft_consts(nfft: int, device: torch.device):
    """(radices, the table on `device`, the radices as a C int array) of
    nfft, built once."""
    radices = fft_radices(nfft)
    return (radices, torch.from_numpy(fft_table(radices)).to(device),
            (ctypes.c_int * max(1, len(radices)))(*radices))


def stage1_matrix(n1: int, device) -> torch.Tensor:
    """F1[a, k1] = exp(-2 pi i a k1 / n1), complex64 (n1, n1)."""
    a = np.arange(n1, dtype=np.float64)
    f1 = np.exp(-2j * np.pi * np.outer(a, a) / n1)
    return torch.from_numpy(f1.astype(np.complex64)).to(device)


def stage2_consts(n: int, n1: int, n2: int, device) -> torch.Tensor:
    """G[k1, b, k2] = exp(-2 pi i b k1 / n) * exp(-2 pi i b k2 / n2),
    built in float64 on the host and stored complex64 (n1, n2, n2)."""
    b = np.arange(n2, dtype=np.float64)
    k1 = np.arange(n1, dtype=np.float64)
    f2 = np.exp(-2j * np.pi * np.outer(b, b) / n2)           # (b, k2)
    tw = np.exp(-2j * np.pi * np.outer(k1, b) / n)           # (k1, b)
    g = tw[:, :, None] * f2[None, :, :]                      # (k1, b, k2)
    return torch.from_numpy(g.astype(np.complex64)).to(device)


def channelizer_consts(cfg: PFBConfig, device):
    """(window2d (avg, nfft) float32, F1, G) for one configuration."""
    n1, n2 = best_split(cfg.nfft)
    return (cfg.window(device).reshape(cfg.avg, cfg.nfft),
            stage1_matrix(n1, device),
            stage2_consts(cfg.nfft, n1, n2, device))


def channelizer_plain(window2d: torch.Tensor, F1: torch.Tensor,
                      G: torch.Tensor, spare: torch.Tensor, x: torch.Tensor,
                      nframes: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch channelizer, the same algebra as the kernel.

    spare (avg-1, nfft); x (T, nfft), or (1, nfft) with `nframes` for
    const-frame mode.  Returns (T, nfft) complex64, natural bin order."""
    n1, n2 = G.shape[0], G.shape[1]
    if nframes is not None:
        x = x.expand(int(nframes), x.shape[1])
    T = x.shape[0]
    pre = presum_plain(window2d, spare, x).reshape(T, n1, n2)
    z = torch.einsum("tab,ak->tkb", pre, F1)                 # stage 1
    y = torch.einsum("tkb,kbc->tkc", z, G)                   # stage 2
    return y.transpose(1, 2).reshape(T, n1 * n2)             # k1 + n1*k2


def _check(window2d, F1, G, spare, x, nframes):
    avg, nfft = window2d.shape
    n1, n2 = G.shape[0], G.shape[1]
    if any(t.dtype != torch.complex64 for t in (F1, G, spare, x)) or \
            window2d.dtype != torch.float32:
        raise TypeError("channelizer wants complex64 F1/G/spare/x and a "
                        "float32 window")
    if n1 * n2 != nfft or tuple(G.shape) != (n1, n2, n2) or \
            tuple(F1.shape) != (n1, n1) or \
            tuple(spare.shape) != (avg - 1, nfft) or \
            x.ndim != 2 or x.shape[1] != nfft:
        raise ValueError(
            f"channelizer shapes: window {tuple(window2d.shape)}, F1 "
            f"{tuple(F1.shape)}, G {tuple(G.shape)}, spare "
            f"{tuple(spare.shape)}, x {tuple(x.shape)}")
    if nframes is not None and x.shape[0] != 1:
        raise ValueError("const-frame mode takes one (1, nfft) frame")
    if len({t.device for t in (window2d, F1, G, spare, x)}) != 1:
        raise ValueError("channelizer operands on different devices")


@functools.cache
def _library():
    """The kernel library, its frame tile checked once against
    FRAME_TILE, on which tile_frames and smem_bytes rest."""
    lib = build.load()
    if lib.sdr_channelizer_frame_tile() != FRAME_TILE:
        raise RuntimeError("csrc/channelizer.cu FT_MAX differs from "
                           "FRAME_TILE")
    return lib


def _launch(entry: str, srcs, window2d, G, T: int, *tail):
    """Launch the C entry `entry` of csrc/channelizer.cu on CUDA operands:
    its row sources `srcs` (data pointers), the window, nfft's FFT plan,
    a (T, nfft) output and, where smem_bytes(nfft) is 0, the device
    buffers of up to SCRATCH_BLOCKS blocks; then `tail`."""
    dev = window2d.device
    n1, n2 = G.shape[0], G.shape[1]
    nfft = n1 * n2
    radices, table, c_radices = _fft_consts(nfft, dev)
    out = torch.empty((T, nfft), dtype=torch.complex64, device=dev)
    scratch, nscratch = None, 0
    if smem_bytes(nfft) == 0:
        nscratch = min(T, SCRATCH_BLOCKS)
        scratch = torch.empty((nscratch, 2, nfft), dtype=torch.complex64,
                              device=dev)
    _library()
    build.launch(entry, dev, *srcs, window2d.data_ptr(), table.data_ptr(),
                 c_radices, len(radices), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), nscratch,
                 *tail)
    return out


def channelizer(window2d: torch.Tensor, F1: torch.Tensor, G: torch.Tensor,
                spare: torch.Tensor, x: torch.Tensor,
                nframes: Optional[int] = None) -> torch.Tensor:
    """The channelizer: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Counts its kernel launches in
    ``channelizer.launches``.

    Const-frame mode (x one frame, `nframes` given) still computes every
    frame; only the block read is saved."""
    _check(window2d, F1, G, spare, x, nframes)
    if x.device.type == "cpu":
        return channelizer_plain(window2d, F1, G, spare, x, nframes)
    T = int(nframes) if nframes is not None else x.shape[0]
    out = _launch_streamed("sdr_channelizer", window2d, G, spare, x, T,
                           int(nframes is not None))
    if T:
        channelizer.launches += 1
    return out


channelizer.launches = 0


def _launch_streamed(entry: str, window2d, G, spare, x, T: int, *flags):
    """Launch the C entry `entry` of csrc/channelizer.cu's stream source
    (#1, or #3's scrambled store) on CUDA operands: (T, nfft) spectra,
    no launch when T is 0."""
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    if not T:
        return torch.empty((0, x.shape[1]), dtype=torch.complex64,
                           device=x.device)
    x, spare, window2d = (t.contiguous() for t in (x, spare, window2d))
    return _launch(entry, (x.data_ptr(), spare.data_ptr()), window2d, G, T,
                   T, G.shape[0], G.shape[1], window2d.shape[0], *flags)


def channelizer_at_plain(window2d: torch.Tensor, F1: torch.Tensor,
                         G: torch.Tensor, X: torch.Tensor, idx: int,
                         valid: int, nframes: int) -> torch.Tensor:
    """Plain PyTorch channelizer of block `idx` (nframes frames) of a
    recording X (total_frames, nfft): (nframes, nfft) complex64."""
    base = idx * nframes
    halo = recording_halo(X, base, window2d.shape[0] - 1, valid)
    return channelizer_plain(window2d, F1, G, halo, X[base:base + nframes])


def channelizer_at(window2d: torch.Tensor, F1: torch.Tensor, G: torch.Tensor,
                   X: torch.Tensor, idx: int, valid: int,
                   nframes: int) -> torch.Tensor:
    """The channelizer of block `idx` of a resident recording X
    (total_frames, nfft), blocks of `nframes` frames: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  Counts its kernel
    launches in ``channelizer_at.launches``."""
    avg, nfft = window2d.shape
    if nframes <= 0 or idx < 0 or X.ndim != 2 or \
            (idx + 1) * nframes > X.shape[0]:
        raise ValueError(f"channelizer_at: block {idx} of {nframes} frames "
                         f"outside the recording {tuple(X.shape)}")
    _check(window2d, F1, G, X.new_empty((avg - 1, nfft)), X, None)
    if X.device.type == "cpu":
        return channelizer_at_plain(window2d, F1, G, X, idx, valid, nframes)
    if X.device.type != "cuda":
        raise ValueError(f"channelizer_at: unsupported device {X.device}")
    X, window2d = X.contiguous(), window2d.contiguous()
    out = _launch("sdr_channelizer_at", (X.data_ptr(),), window2d, G,
                  nframes, X.shape[0], idx * nframes, nframes, G.shape[0],
                  G.shape[1], avg, int(bool(valid)))
    channelizer_at.launches += 1
    return out


channelizer_at.launches = 0


def can_channelizer_at_halo(cfg: PFBConfig, nframes: int,
                            total_frames: int) -> bool:
    """Whether channelizer_at_halo takes a shard's geometry: the
    channelizer's own gate on blocks of `nframes` frames, whole blocks
    in the shard's `total_frames`.  The JAX gate's 8-frame halo units,
    its bt tiling and 2 <= n1 <= 16 have no counterpart."""
    return (nframes > 0 and total_frames % nframes == 0 and
            can_fuse_channelizer(cfg, nframes * cfg.nfft))


def channelizer_at_halo_plain(window2d: torch.Tensor, F1: torch.Tensor,
                              G: torch.Tensor, X: torch.Tensor,
                              Hs: torch.Tensor, idx: int, valid: int,
                              nframes: int) -> torch.Tensor:
    """Plain PyTorch channelizer of block `idx` of one time shard's span
    X (nblk*nframes, nfft) after its staged halo Hs[idx] (avg-1, nfft),
    zero unless `valid`: (nframes, nfft) complex64."""
    halo = Hs[idx] if valid else torch.zeros_like(Hs[idx])
    return channelizer_plain(window2d, F1, G, halo,
                             X[idx * nframes:(idx + 1) * nframes])


def channelizer_at_halo(window2d: torch.Tensor, F1: torch.Tensor,
                        G: torch.Tensor, X: torch.Tensor, Hs: torch.Tensor,
                        idx: int, valid: int, nframes: int) -> torch.Tensor:
    """The channelizer of block `idx` of one time shard's span of a
    resident recording, X (nblk*nframes, nfft), its avg-1 halo frames
    the staged Hs (nblk, avg-1, nfft)'s row idx, zero unless `valid`
    (kernel #5, gpu_sdr_tpu/ops/pallas_channelizer.
    channelizer_frames_at_halo): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Counts its kernel launches in
    ``channelizer_at_halo.launches``."""
    avg, nfft = window2d.shape
    if nframes <= 0 or idx < 0 or X.ndim != 2 or \
            (idx + 1) * nframes > X.shape[0] or \
            tuple(Hs.shape) != (X.shape[0] // nframes, avg - 1, nfft):
        raise ValueError(f"channelizer_at_halo: block {idx} of {nframes} "
                         f"frames, span {tuple(X.shape)}, staged halo "
                         f"{tuple(Hs.shape)}")
    _check(window2d, F1, G, Hs[0], X, None)
    if X.device.type == "cpu":
        return channelizer_at_halo_plain(window2d, F1, G, X, Hs, idx, valid,
                                         nframes)
    if X.device.type != "cuda":
        raise ValueError(f"channelizer_at_halo: unsupported device "
                         f"{X.device}")
    X, Hs, window2d = (t.contiguous() for t in (X, Hs, window2d))
    out = _launch("sdr_channelizer_at_halo", (X.data_ptr(), Hs.data_ptr()),
                  window2d, G, nframes, X.shape[0], idx, nframes, G.shape[0],
                  G.shape[1], avg, int(bool(valid)))
    channelizer_at_halo.launches += 1
    return out


channelizer_at_halo.launches = 0


def channelizer_frames(consts, spare: torch.Tensor, x: torch.Tensor,
                       nframes: Optional[int] = None):
    """One block through the channelizer: (new_spare, frames).

    consts: channelizer_consts(cfg, device); spare: (avg-1, nfft) carried
    frames; x: (T, nfft) block, or its one (1, nfft) frame with
    `nframes` (const-frame mode, where the new spare is that frame
    repeated, as in the JAX kernel)."""
    frames = channelizer(*consts, spare, x, nframes)
    lead, T = spare.shape[0], frames.shape[0]
    if lead == 0:
        return spare, frames
    body = x if nframes is None else x.expand(T, x.shape[1])
    tail = body[T - lead:] if T >= lead else torch.cat([spare, body])[T:]
    return tail.contiguous(), frames


def scramble_index(bins, n1: int, n2: int) -> np.ndarray:
    """The position of each bin k in the scrambled order (k % n1)*n2 +
    k // n1 (gpu_sdr_tpu/ops/cplx.DFT.scramble_index), int64."""
    b = np.asarray(bins, dtype=np.int64)
    return (b % n1) * n2 + b // n1


def scrambled(frames: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """(T, nfft) spectra in natural order -> scrambled order: position
    k1*n2 + k2 holds bin k1 + n1*k2."""
    T = frames.shape[0]
    return frames.reshape(T, n2, n1).transpose(1, 2).reshape(T, n1 * n2)


def channelizer_scrambled_plain(window2d: torch.Tensor, F1: torch.Tensor,
                                G: torch.Tensor, spare: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel #3: the channelizer's plain version, then
    the permutation to the scrambled order.  (T, nfft) complex64."""
    return scrambled(channelizer_plain(window2d, F1, G, spare, x),
                     G.shape[0], G.shape[1])


def channelizer_scrambled(window2d: torch.Tensor, F1: torch.Tensor,
                          G: torch.Tensor, spare: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """The channelizer of a streamed block x (T, nfft) after its spare
    (avg-1, nfft), spectra in the scrambled order (kernel #3,
    gpu_sdr_tpu/ops/pallas_channelizer.channelizer_frames): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  Counts
    its kernel launches in ``channelizer_scrambled.launches``."""
    _check(window2d, F1, G, spare, x, None)
    if x.device.type == "cpu":
        return channelizer_scrambled_plain(window2d, F1, G, spare, x)
    out = _launch_streamed("sdr_channelizer_scrambled", window2d, G,
                           spare, x, x.shape[0])
    if x.shape[0]:
        channelizer_scrambled.launches += 1
    return out


channelizer_scrambled.launches = 0


@functools.lru_cache(maxsize=8)
def _dft_consts(nfft: int, device: torch.device):
    """(F1, G) of nfft's split on `device`, built once."""
    n1, n2 = best_split(nfft)
    return stage1_matrix(n1, device), stage2_consts(nfft, n1, n2, device)


def channelizer_frames_scrambled(cfg: PFBConfig, window: torch.Tensor,
                                 spare: torch.Tensor, x: torch.Tensor):
    """One streamed block through the channelizer, in the JAX package's
    layout and bin order (gpu_sdr_tpu/ops/pallas_channelizer.
    channelizer_frames, without its `dft`: the split is best_split's,
    the JAX package's two-stage one): (new_spare, frames).

    window (nfft*avg,) float32; spare ((avg-1)*nfft,) carried samples; x
    (L,), L % nfft == 0.  frames (L//nfft, nfft) complex64 in the
    scrambled order, bin k at scramble_index(k); new_spare the last
    (avg-1)*nfft samples of spare ++ x.  Where the kernel takes the
    geometry (can_fuse_channelizer) it runs kernel #3; elsewhere, as the
    JAX package falls back to its XLA route, the engine's host-fed PFB
    route (ops/presum.pfb_frames_fused: the pre-sum kernel #2, then
    torch.fft) put in the same order.  On CPU tensors both are their
    plain versions."""
    nfft, avg = cfg.nfft, cfg.avg
    L = x.shape[0]
    if L % nfft or tuple(spare.shape) != ((avg - 1) * nfft,) or \
            tuple(window.shape) != (avg * nfft,):
        raise ValueError(f"channelizer_frames_scrambled: block {L}, spare "
                         f"{tuple(spare.shape)}, window "
                         f"{tuple(window.shape)} for nfft {nfft}, avg {avg}")
    n1, n2 = best_split(nfft)
    if can_fuse_channelizer(cfg, L):
        F1, G = _dft_consts(nfft, x.device)
        frames = channelizer_scrambled(
            window.reshape(avg, nfft), F1, G, spare.reshape(avg - 1, nfft),
            x.reshape(L // nfft, nfft))
    else:
        frames = scrambled(pfb_frames_fused(cfg, window, spare, x)[1], n1,
                           n2)
    H = spare.shape[0]
    new_spare = x[L - H:] if H <= L else torch.cat([spare, x])[L:]
    return new_spare, frames
