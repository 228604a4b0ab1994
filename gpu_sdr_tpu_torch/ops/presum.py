"""PFB windowed pre-sum: the CUDA kernel (csrc/presum.cu) in its two
addressing modes and their plain PyTorch versions.

Port of gpu_sdr_tpu/ops/pallas_pfb.py (pallas_presum, pfb_frames_fused,
pallas_presum_at):

    pre[t, b] = sum_{i<avg} W[i, b] * ext[t+i, b],  ext = concat(halo, X)

computed without materializing ext.  ``presum`` takes a streamed block
and its carried spare as the halo; ``presum_at`` reads block `idx` of a
resident (total_frames, nfft) recording in place, its halo the avg-1
recording frames before it, wrapped at the loop seam and zero on the
stream's first block (``valid`` 0).  The DFT after it stays torch
(``torch.fft.fft``), as the JAX package left it to XLA.

The kernel streams rows: a block owns a strip of columns and a tile of
``rows`` output rows, a thread one column (two complex bins, 16 bytes,
where nfft is even and the pointers aligned; else one) and a register
ring of the last avg rows down its tile (``presum_plan`` mirrors its
launch plan).
"""

from __future__ import annotations

import torch

from ..kernels import build
from .pfb import PFBConfig


# csrc/presum.cu's constants: output rows a tile, threads a block, rows
# whose loads a thread issues at once, the largest avg of the register
# ring (above it the generic body)
PRESUM_TILES = dict(rows=32, threads=256, in_flight=2, ring_max=8)


def presum_plan(T: int, nfft: int, avg: int, aligned: bool) -> dict:
    """The pre-sum kernel's launch plan (csrc/presum.cu make_plan): vec,
    complex bins a thread's column (2, the 16-byte body, where nfft is
    even and the pointers aligned, ``pointers_aligned``; else 1);
    threads a block (a strip of columns, whole warps); strips; rows a
    tile; tiles; ring, the avg of the register ring (0: the generic
    body).  The grid is (tiles, strips)."""
    t = PRESUM_TILES
    vec = 2 if aligned and nfft % 2 == 0 else 1
    cols = nfft // vec
    threads = min(t["threads"], -(-cols // 32) * 32)
    return dict(vec=vec, threads=threads, strips=-(-cols // threads),
                rows=t["rows"], tiles=-(-T // t["rows"]),
                ring=avg if avg <= t["ring_max"] else 0)


def pointers_aligned(x: int, hist: int, out: int, w: int) -> bool:
    """Whether the 16-byte body may run (csrc/presum.cu launch): the
    rows' addresses (block or recording, history, output) 16-byte and
    the window's 8-byte aligned.  A view of a recording may start on an
    odd sample."""
    return x % 16 == 0 and hist % 16 == 0 and out % 16 == 0 and w % 8 == 0


def recording_halo(X: torch.Tensor, base: int, lead: int,
                   valid: int) -> torch.Tensor:
    """The `lead` rows of a recording X (rows, M) before row `base`,
    wrapped mod the recording (the loop seam), zeroed unless `valid`
    (the stream's first block): (lead, M)."""
    if not valid:
        return X.new_zeros((lead,) + tuple(X.shape[1:]))
    rows = torch.arange(base - lead, base, device=X.device) % X.shape[0]
    return X.index_select(0, rows)


def recording_rows(X: torch.Tensor, idx: int, nbr: int, lead: int,
                   valid: int) -> torch.Tensor:
    """The extended rows (nbr + lead, M) of block `idx` of a recording X
    (nblk*nbr, M): its recording_halo, then its nbr rows."""
    base = idx * nbr
    body = X[base:base + nbr]
    if lead == 0:
        return body
    return torch.cat([recording_halo(X, base, lead, valid), body])


def shard_spans(X: torch.Tensor, nblk: int, T: int) -> list:
    """A recording X (nblk*T*span, M) of rows in stream order, laid out
    per time shard: shard t's span of every block, block after block,
    (nblk*span, M) each, the JAX package's shard-major layout
    (pallas_replay.ShardedReplayDDC, sharded_replay._try_channelizer_
    replay)."""
    M = X.shape[1]
    g = X.reshape(nblk, T, -1, M)
    return [g[:, t].reshape(-1, M) for t in range(T)]


def staged_halos(X: torch.Tensor, nblk: int, T: int,
                 lead: int) -> list:
    """The `lead` rows before each time shard's span of each block, in
    stream order, wrapped mod the recording (the loop seam), staged per
    shard as (nblk, lead, M): the rows a shard's first output needs that
    lie on the previous shard or in the previous block."""
    rows, M = X.shape
    span = rows // (nblk * T)
    p = torch.arange(nblk * T, device=X.device).reshape(nblk, T) * span
    out = []
    for t in range(T):
        idx = (p[:, t, None] - lead +
               torch.arange(lead, device=X.device)[None, :]) % rows
        out.append(X[idx.reshape(-1)].reshape(nblk, lead, M))
    return out


def presum_plain(window2d: torch.Tensor, spare: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pre-sum.  window2d (avg, nfft) float32; spare
    (avg-1, nfft) and X (T, nfft) complex64 -> (T, nfft) complex64."""
    avg = window2d.shape[0]
    T = X.shape[0]
    ext = torch.cat([spare, X]) if spare.shape[0] else X
    pre = ext[0:T] * window2d[0]
    for i in range(1, avg):
        pre = pre + ext[i:i + T] * window2d[i]
    return pre


def _check(window2d, spare, X):
    avg, nfft = window2d.shape
    if X.dtype != torch.complex64 or spare.dtype != torch.complex64 or \
            window2d.dtype != torch.float32:
        raise TypeError("presum wants complex64 X/spare, float32 window")
    if X.ndim != 2 or X.shape[1] != nfft or \
            tuple(spare.shape) != (avg - 1, nfft):
        raise ValueError(f"presum shapes: window {tuple(window2d.shape)}, "
                         f"spare {tuple(spare.shape)}, X {tuple(X.shape)}")
    if not (X.device == spare.device == window2d.device):
        raise ValueError("presum operands on different devices")


def presum(window2d: torch.Tensor, spare: torch.Tensor,
           X: torch.Tensor) -> torch.Tensor:
    """The pre-sum: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Counts its kernel launches in ``presum.launches``."""
    _check(window2d, spare, X)
    if X.device.type == "cpu":
        return presum_plain(window2d, spare, X)
    if X.device.type != "cuda":
        raise ValueError(f"presum: unsupported device {X.device}")
    X, spare, window2d = (X.contiguous(), spare.contiguous(),
                          window2d.contiguous())
    out = torch.empty_like(X)
    if X.shape[0] == 0:
        return out
    build.launch("sdr_presum", X.device, X.data_ptr(), spare.data_ptr(),
                 window2d.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1],
                 window2d.shape[0])
    presum.launches += 1
    return out


presum.launches = 0


def presum_at_plain(window2d: torch.Tensor, X: torch.Tensor, idx: int,
                    valid: int, frames: int) -> torch.Tensor:
    """Plain PyTorch pre-sum of block `idx` (frames rows) of a recording
    X (total_frames, nfft) -> (frames, nfft) complex64."""
    base = idx * frames
    halo = recording_halo(X, base, window2d.shape[0] - 1, valid)
    return presum_plain(window2d, halo, X[base:base + frames])


def presum_at(window2d: torch.Tensor, X: torch.Tensor, idx: int, valid: int,
              frames: int) -> torch.Tensor:
    """The pre-sum of block `idx` of a resident recording X (total_frames,
    nfft), blocks of `frames` frames: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Counts its kernel launches in
    ``presum_at.launches``."""
    avg, nfft = window2d.shape
    if X.dtype != torch.complex64 or window2d.dtype != torch.float32:
        raise TypeError("presum_at wants a complex64 recording and a "
                        "float32 window")
    if X.ndim != 2 or X.shape[1] != nfft or frames <= 0 or idx < 0 or \
            (idx + 1) * frames > X.shape[0]:
        raise ValueError(f"presum_at: block {idx} of {frames} frames "
                         f"outside the recording {tuple(X.shape)} (nfft "
                         f"{nfft})")
    if X.device != window2d.device:
        raise ValueError("presum_at operands on different devices")
    if X.device.type == "cpu":
        return presum_at_plain(window2d, X, idx, valid, frames)
    if X.device.type != "cuda":
        raise ValueError(f"presum_at: unsupported device {X.device}")
    X, window2d = X.contiguous(), window2d.contiguous()
    out = torch.empty((frames, nfft), dtype=torch.complex64, device=X.device)
    build.launch("sdr_presum_at", X.device, X.data_ptr(), window2d.data_ptr(),
                 out.data_ptr(), X.shape[0], idx * frames, frames, nfft, avg,
                 int(bool(valid)))
    presum_at.launches += 1
    return out


presum_at.launches = 0


def pfb_frames_fused(cfg: PFBConfig, window: torch.Tensor,
                     spare: torch.Tensor, x: torch.Tensor):
    """ops/pfb.pfb_frames with the pre-sum kernel: (new_spare, frames).

    spare: ((avg-1)*nfft,) carried samples; x: (L,) block."""
    nfft, avg = cfg.nfft, cfg.avg
    L = x.shape[0]
    H = (avg - 1) * nfft
    X = x.reshape(L // nfft, nfft)
    pre = presum(window.reshape(avg, nfft), spare.reshape(avg - 1, nfft), X)
    frames = torch.fft.fft(pre, dim=-1)
    new_spare = x[L - H:] if H <= L else torch.cat([spare, x])[L:]
    return new_spare, frames
