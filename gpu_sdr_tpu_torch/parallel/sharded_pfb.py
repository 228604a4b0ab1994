"""Sharded PFB channelizer over a (time, channels) mesh (port of
gpu_sdr_tpu/parallel/sharded_pfb.py).

* 'time': the block splits into contiguous segments; each shard needs
  the (avg-1)*nfft samples before its segment, the PFB's overlap-save
  halo, which rides the time ring exactly as in ShardedDDC;
* 'channels': the DFT matrix splits by columns, so each channel shard
  computes nfft/Kc of the bins of every frame; the windowed pre-sum
  (kernel #2, ops/presum.presum) is computed by each channel shard of a
  time shard (it is the memory-bound part), the (ft, nfft) x
  (nfft, nfft/Kc) product is split.

With `bins` set, tone selection is owner-local: each channel shard owns
nfft/Kc contiguous bins, selects the tones whose bin it owns (the others
masked to zero), and one psum over the channel axis (Mesh.psum_row)
joins them, so no
sharded gather is needed.  The DFT columns are built in float64 and
multiplied in float32 (no TF32, config.configure_precision).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cplx import from_np
from ..ops.pfb import PFBConfig
from ..ops.presum import presum
from .mesh import Mesh, Sharded, shard_input


def dft_columns(nfft: int, c0: int, c1: int) -> np.ndarray:
    """F[n, k] = exp(-2j*pi*n*k/nfft) for bins k in [c0, c1), float64
    (nfft, c1 - c0), from exact integer phases n*k mod nfft."""
    n = np.arange(nfft, dtype=np.int64)
    k = np.arange(c0, c1, dtype=np.int64)
    return np.exp(-2j * np.pi * ((np.outer(n, k) % nfft) / nfft))


class ShardedPFB:
    """Channel+time sharded PFB for one mesh.

    State: the carry grid [t][c] of (H,) complex64 halo samples, "the
    tail I received last block", as ShardedDDC's.  ``step`` returns the
    frames (L/nfft, nfft) sharded over (time, channels), or, with
    `bins`, the selected (L/nfft, n_tones) frames sharded over time."""

    def __init__(self, cfg: PFBConfig, mesh: Mesh, block_len: int,
                 bins: Optional[Tuple[int, ...]] = None):
        self.cfg, self.mesh, self.block_len = cfg, mesh, int(block_len)
        self.bins = bins
        nfft, avg = cfg.nfft, cfg.avg
        T, Kc, L = mesh.T, mesh.Kc, self.block_len
        if L % (T * nfft) or nfft % Kc:
            raise ValueError(f"sharded PFB: block {L} must split over {T} "
                             f"time shards in whole frames of {nfft}, and "
                             f"nfft over {Kc} channel shards")
        self.T, self.Kc = T, Kc
        self.Lt = L // T
        self.frames_t = self.Lt // nfft
        self.H = (avg - 1) * nfft
        nloc = nfft // Kc
        w2 = cfg.window(torch.device("cpu")).reshape(avg, nfft)
        self._w2 = mesh.grid(lambda t, c, d: w2.to(d))
        self._F = mesh.grid(lambda t, c, d: from_np(
            dft_columns(nfft, c * nloc, (c + 1) * nloc), d))
        if bins is not None:
            b = np.asarray(bins, dtype=np.int64)
            owners, local = b // nloc, b % nloc

            def sel(t, c, d):
                mask = torch.from_numpy((owners == c).astype(np.float32))
                return (torch.from_numpy(local).to(d), mask.to(d))

            self._sel = mesh.grid(sel)

    def init_state(self):
        H = self.H
        return self.mesh.grid(lambda t, c, d: torch.zeros(
            H, dtype=torch.complex64, device=d))

    def frames(self, carry, xs):
        """(carry', per-shard (ft, nfft/Kc) frames grid) of one block
        given as a per-shard grid (None for other processes' shards)."""
        mesh, H, nfft = self.mesh, self.H, self.cfg.nfft
        avg, ft = self.cfg.avg, self.frames_t
        out = [[None] * self.Kc for _ in range(self.T)]
        new_carry = [[None] * self.Kc for _ in range(self.T)]
        for c in range(self.Kc):
            recv = mesh.ring(c, [None if xs[t][c] is None
                                 else xs[t][c][self.Lt - H:]
                                 for t in range(self.T)]) if H else \
                [carry[t][c] for t in range(self.T)]
            for t in range(self.T):
                if xs[t][c] is None:
                    continue
                new_carry[t][c] = recv[t]
                halo = carry[t][c] if t == 0 else recv[t]
                pre = presum(self._w2[t][c], halo.reshape(avg - 1, nfft),
                             xs[t][c].reshape(ft, nfft))
                out[t][c] = pre @ self._F[t][c]
        return new_carry, out

    def step(self, carry, x):
        """One block: x (L,) on the mesh's first device, or its grid.
        Returns (carry', Sharded frames or selected tones)."""
        mesh = self.mesh
        carry, fr = self.frames(carry, shard_input(mesh, x))
        if self.bins is None:
            return carry, Sharded(fr, mesh)
        sel = []
        for t in range(self.T):
            parts = []
            for c in range(self.Kc):
                if fr[t][c] is None:
                    parts.append(None)
                    continue
                local, mask = self._sel[t][c]
                parts.append(torch.index_select(fr[t][c], 1, local) *
                             mask[None, :])
            sel.append([mesh.psum_row(t, parts)])
        return carry, Sharded(sel, mesh)
