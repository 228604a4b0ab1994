"""Sharded DDC+FIR (DIRECT) over a (time, channels) mesh (port of
gpu_sdr_tpu/parallel/sharded.py).

* the block x (L,) splits over 'time': shard t holds the Lt = L/T
  samples [t*Lt, (t+1)*Lt);
* the modulated taps Hmod (f*M, C) split over 'channels' (column
  slices), and so do the carrier phases;
* the output (nb, C) splits over both (rows over time, columns over
  channels).

Each shard runs the DDC kernel #7 (ops/ddc.ddc_fused) on its segment.
Its FIR needs the H = (f-1)*M samples before the segment, the
overlap-save halo, which rides one step around the time ring
(Mesh.ring): shard t > 0 takes the tail of shard t-1 of the same
block, shard 0 the tail of the last shard of the previous block, which
is what last block's ring delivered to it; so each shard's carry is
"the tail I received last block".

Carrier phases stay exact: the global block's integer phase is carried
per channel shard, and shard t's rows are the global rows t*nbt + n, so
its carrier ramp is the global ramp's rows (built in float64 from
integer phases), where the JAX package multiplies a local ramp by a
per-shard rotation; the two agree to float32 rounding.
"""

from __future__ import annotations

import torch

from ..ops import ddc as ddc_ops
from ..ops.ddc import DirectDDCConfig
from .mesh import Mesh, Sharded, shard_input


class ShardedDDC:
    """Channel+time sharded DDC+FIR for one mesh.

    State: (phase grid [t][c] int64 (C/Kc,), carry grid [t][c] (H,)
    complex64), every part on its shard's device; the phases are
    replicated over the time axis, as the JAX package's P('channels').

        sd = ShardedDDC(cfg, mesh, block_len)
        state = sd.init_state()
        state, y = sd.step(state, x)        # y: Sharded (nb, C)
    """

    def __init__(self, cfg: DirectDDCConfig, mesh: Mesh, block_len: int):
        self.cfg, self.mesh, self.block_len = cfg, mesh, int(block_len)
        T, Kc = mesh.T, mesh.Kc
        M, f, Cn = cfg.M, cfg.f, cfg.n_channels
        L = self.block_len
        if L % (T * M) or Cn % Kc:
            raise ValueError(f"sharded DDC: block {L} must split over "
                             f"{T} time shards of whole rows of {M}, "
                             f"{Cn} channels over {Kc} channel shards")
        self.T, self.Kc = T, Kc
        self.Lt = L // T
        self.nbt = self.Lt // M
        self.H = (f - 1) * M
        if self.H > self.Lt:
            raise ValueError("sharded DDC: the halo must fit in one time "
                             "shard")
        Cl = Cn // Kc
        self.Cl = Cl
        hmod = cfg.modulated_taps(torch.device("cpu"))
        ramp = cfg.carrier_ramp(L // M, torch.device("cpu"))
        step = ddc_ops.ddc_carrier_step(cfg, L, torch.device("cpu"))
        cs = [slice(c * Cl, (c + 1) * Cl) for c in range(Kc)]
        nbt = self.nbt
        self._hmod = mesh.grid(lambda t, c, d: hmod[:, cs[c]].to(d))
        self._ramp = mesh.grid(lambda t, c, d: ramp[t * nbt:(t + 1) * nbt,
                                                    cs[c]].to(d))
        self._step = mesh.grid(lambda t, c, d: step[cs[c]].to(d))
        self._cs = cs

    def init_state(self):
        ph0 = ddc_ops.ddc_carrier_init(self.cfg, torch.device("cpu"))
        H = self.H
        return (self.mesh.grid(lambda t, c, d: ph0[self._cs[c]].to(d)),
                self.mesh.grid(lambda t, c, d: torch.zeros(
                    H, dtype=torch.complex64, device=d)))

    def step(self, state, x):
        """One block: x (L,) on the mesh's first device, or its grid of
        per-shard segments.  Returns (state', Sharded y (nb, C)); the
        shards of other processes are None."""
        phase, carry = state
        cfg, mesh, H, T = self.cfg, self.mesh, self.H, self.T
        xs = shard_input(mesh, x)
        new_phase = [[None] * self.Kc for _ in range(T)]
        new_carry = [[None] * self.Kc for _ in range(T)]
        ys = [[None] * self.Kc for _ in range(T)]
        for c in range(self.Kc):
            recv = mesh.ring(c, [None if xs[t][c] is None
                                 else xs[t][c][self.Lt - H:]
                                 for t in range(T)]) if H else \
                [carry[t][c] for t in range(T)]
            for t in range(T):
                if xs[t][c] is None:
                    continue
                new_carry[t][c] = recv[t]
                halo = carry[t][c] if t == 0 else recv[t]
                ph, _, y = ddc_ops.ddc_fused(
                    self._hmod[t][c], self._ramp[t][c], self._step[t][c],
                    cfg.rate, cfg.M, cfg.f, phase[t][c], halo, xs[t][c])
                new_phase[t][c] = ph
                ys[t][c] = y
        return (new_phase, new_carry), Sharded(ys, mesh)
