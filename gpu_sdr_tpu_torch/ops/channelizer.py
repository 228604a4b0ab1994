"""Fused PFB channelizer: the CUDA kernel (csrc/channelizer.cu) in its
streamed, recording and staged-halo modes, and their plain PyTorch
versions.

Port of gpu_sdr_tpu/ops/pallas_channelizer.py (channelizer_frames_t,
channelizer_frames_at and channelizer_frames_at_halo): the windowed
pre-sum over avg-1 halo frames,
then a two-stage n1 x n2 DFT with the twiddle folded into per-k1
stage-2 constants.  ``channelizer`` takes a streamed block and its
carried spare; ``channelizer_at`` reads block `idx` of a resident
(total_frames, nfft) recording in place, its halo the avg-1 frames
before it, wrapped at the loop seam and zero on the stream's first
block (``valid`` 0); ``channelizer_at_halo`` reads block `idx` of one
time shard's span of a recording, its halo frames staged per block at
upload (the sharded replay, parallel/sharded_replay.py).  The output is
(T, nfft) in natural bin order, so
tone selection is ops/pfb.select_tones (a plain ``index_select``) where
the JAX package needed select_tones_t; the TPU layout artifacts
(transposed (n1, T, n2) blocks and the recording transposed at upload,
8-frame halo units, bf16 hi/lo constants, the bt % 8 tiling rule) have
no counterpart here.

``channelizer_frames_scrambled`` is the port of the JAX package's
``channelizer_frames`` (kernel #3): a streamed block in the JAX layout
(flat spare and block), its spectra in the scrambled Cooley-Tukey order
frames[t, k1*n2 + k2] (bin k at ``scramble_index(k)``), stored so by the
kernel itself (``channelizer_scrambled``).  No engine path takes it, as
in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import build
from .pfb import PFBConfig
from .presum import pfb_frames_fused, presum_plain, recording_halo

FRAME_TILE = 32                     # frames per CUDA block (csrc FT)
SMEM_LIMIT = 232_448                # bytes of shared memory a block may use


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


def smem_bytes(n2: int) -> int:
    """Shared memory of one channelizer block: G_k1 plus the z tile."""
    return (n2 * n2 + FRAME_TILE * n2) * 8


def can_fuse_channelizer(cfg: PFBConfig, block_len: int) -> bool:
    """Whether the channelizer kernel takes this geometry: G_k1 and the
    z tile inside one block's shared memory, and whole frames per block.
    The JAX kernel also needs 2 <= n1 <= 16, avg >= 2 and an 8-aligned
    frame tile dividing the block; the CUDA kernel masks its last tile,
    loops over n1 and reads no halo when avg = 1, so it takes more
    geometries than the JAX one."""
    _, n2 = best_split(cfg.nfft)
    return (smem_bytes(n2) <= SMEM_LIMIT and
            block_len % cfg.nfft == 0 and block_len >= cfg.nfft)


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
    FRAME_TILE, on which smem_bytes and can_fuse_channelizer rest."""
    lib = build.load()
    if lib.sdr_channelizer_frame_tile() != FRAME_TILE:
        raise RuntimeError("csrc/channelizer.cu FT differs from FRAME_TILE")
    return lib


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
    out = _launch_streamed("sdr_channelizer", window2d, F1, G, spare, x, T,
                           int(nframes is not None))
    if T:
        channelizer.launches += 1
    return out


channelizer.launches = 0


def _launch_streamed(entry: str, window2d, F1, G, spare, x, T: int, *flags):
    """Launch the C entry `entry` of csrc/channelizer.cu's stream source
    (#1, or #3's scrambled store) on CUDA operands: (T, nfft) spectra,
    no launch when T is 0."""
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    n1, n2 = G.shape[0], G.shape[1]
    avg, nfft = window2d.shape
    if smem_bytes(n2) > SMEM_LIMIT:
        raise ValueError(f"{entry}: split ({n1}, {n2}) does not fit one "
                         "block's shared memory")
    x, spare, window2d, F1, G = (t.contiguous() for t in
                                 (x, spare, window2d, F1, G))
    out = torch.empty((T, nfft), dtype=torch.complex64, device=x.device)
    if T:
        _library()
        build.launch(entry, x.device, x.data_ptr(), spare.data_ptr(),
                     window2d.data_ptr(), F1.data_ptr(), G.data_ptr(),
                     out.data_ptr(), T, n1, n2, avg, *flags)
    return out


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
    n1, n2 = G.shape[0], G.shape[1]
    if smem_bytes(n2) > SMEM_LIMIT:
        raise ValueError(f"channelizer_at: split ({n1}, {n2}) does not fit "
                         "one block's shared memory")
    X, window2d, F1, G = (t.contiguous() for t in (X, window2d, F1, G))
    out = torch.empty((nframes, nfft), dtype=torch.complex64,
                      device=X.device)
    _library()
    build.launch("sdr_channelizer_at", X.device, X.data_ptr(),
                 window2d.data_ptr(), F1.data_ptr(), G.data_ptr(),
                 out.data_ptr(), X.shape[0], idx * nframes, nframes, n1, n2,
                 avg, int(bool(valid)))
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
    n1, n2 = G.shape[0], G.shape[1]
    if smem_bytes(n2) > SMEM_LIMIT:
        raise ValueError(f"channelizer_at_halo: split ({n1}, {n2}) does not "
                         "fit one block's shared memory")
    X, Hs, window2d, F1, G = (t.contiguous() for t in
                              (X, Hs, window2d, F1, G))
    out = torch.empty((nframes, nfft), dtype=torch.complex64,
                      device=X.device)
    _library()
    build.launch("sdr_channelizer_at_halo", X.device, X.data_ptr(),
                 Hs.data_ptr(), window2d.data_ptr(), F1.data_ptr(),
                 G.data_ptr(), out.data_ptr(), X.shape[0], idx, nframes, n1,
                 n2, avg, int(bool(valid)))
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
    out = _launch_streamed("sdr_channelizer_scrambled", window2d, F1, G,
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
