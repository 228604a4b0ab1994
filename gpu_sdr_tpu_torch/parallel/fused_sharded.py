"""Fused loopback chains over a (time, channels) mesh (port of
gpu_sdr_tpu/parallel/fused_sharded.py).

The mesh form of engine/fused.py: TX synthesis and demodulation stay on
the devices, one block per step, each shard's work on its own device.
Three chains, each with the JAX package's sub-paths, tried in its order:

* ``ShardedFusedLoopback`` (TONES -> TONES): ``channelizer_wavetable``,
  a bin-quantized comb on a time-only mesh through the channelizer
  kernel #1 per shard (the comb is one-frame periodic, so every halo
  frame is the comb frame: no collective), else ``pfb_scan``, the TX
  comb per shard and the ShardedPFB step (kernel #2, the halo ring,
  the owner-local select and psum);
* ``ShardedFusedVNA`` (CHIRP -> CHIRP): ``chirp_table``, one period of
  the chirp as a table on each shard's device and the lock-in kernel
  #16 per shard at block o*T + t of segments, else ``chirp_lockin``,
  the chirp synthesised and mixed per shard;
* ``ShardedFusedDirect`` (TONES -> DIRECT): ``fold_kernel``, the fold
  kernel #11 per shard on the shard's rows (ops/fold.TonesDirectFold
  with a row offset and a channel slice), else ``g_chain``, the G-fused
  kernel #15 per shard (ops/chain).  The port's fold takes every
  decimating geometry, so run_measurement never reaches g_chain; it is
  reached with ``use_fold=False``, the JAX class's own field.

No chain needs a collective per block but ``pfb_scan``'s (the halo
ring and the psum).  The JAX package's K blocks per execution, its lane
padding of the channel axis (``pad_lanes``), its Pallas switch and TF32
gate have no counterpart (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chirp as chirp_ops
from ..ops import cplx
from ..ops import ddc as ddc_ops
from ..ops import tonegen as tone_ops
from ..ops.cplx import advance_phase, phase_rotation
from ..ops.chain import TonesDirectChain, chain
from ..ops.channelizer import (can_fuse_channelizer, channelizer,
                               channelizer_consts)
from ..ops.ddc import DirectDDCConfig
from ..ops.fold import TonesDirectFold, fold
from ..ops.lockin import lockin_decimate, lockin_profile
from ..ops.lockin_table import lockin_self
from ..ops.pfb import PFBConfig, select_tones, tone_bins
from ..params import AntennaParams, WaveType
from .mesh import Mesh, Sharded
from .sharded_pfb import ShardedPFB


def plan_sharded_channelizer_loopback(tx, rx, mesh: Mesh,
                                      block_len: int) -> bool:
    """The gate of ShardedFusedLoopback's channelizer_wavetable: a time-
    only mesh, a bin-quantized comb (period dividing nfft), no burst, no
    frame averaging, whole frames per shard that the channelizer takes."""
    if mesh.Kc != 1:
        return False                   # DFT columns stay device-local
    nfft = int(rx.fft_tones)
    if nfft <= 0 or int(rx.decim) > 1 or tx.burst_on > 0:
        return False
    if block_len % (mesh.T * nfft):
        return False
    freqs = tuple(int(f) for f in tx.freq)
    if not freqs or not rx.freq:
        return False
    if nfft % tone_ops.comb_period(freqs, int(tx.rate)):
        return False                   # comb not one-frame-periodic
    cfg = PFBConfig(nfft=nfft, avg=int(rx.pf_average), rate=int(rx.rate))
    return can_fuse_channelizer(cfg, block_len // mesh.T)


def _run(chain_obj, sinks, usrp_number, front_end, n_blocks):
    """The generic acquisition loop of a sharded chain: n_blocks steps,
    each a Sharded block gathered by the pipeline's fetch."""
    from ..engine.pipeline import run_chunked
    nb = int(n_blocks) if n_blocks else 1
    return run_chunked(chain_obj.step, chain_obj.init_state, nb,
                       chain_obj.block_len, chain_obj.n_tones,
                       chain_obj.T * chain_obj.ft * nb,
                       chain_obj.mesh.first, sinks,
                       usrp_number=usrp_number, front_end=front_end)


class ShardedFusedLoopback:
    """The sharded TONES -> TONES (PFB) loopback, one block per step.

        sf = ShardedFusedLoopback(tx, rx, mesh, block_len=L)
        state = sf.init_state()
        state, ys = sf.step(state)      # Sharded (L//nfft, n_tones)
    """

    def __init__(self, tx: AntennaParams, rx: AntennaParams, mesh: Mesh,
                 block_len: int = 1_000_000):
        assert tx.wave_type and tx.wave_type[0] == WaveType.TONES
        assert rx.wave_type and rx.wave_type[0] == WaveType.TONES
        self.tx, self.rx, self.mesh = tx, rx, mesh
        self.block_len = L = int(block_len)
        rate, nfft = int(rx.rate), int(rx.fft_tones)
        avg = int(rx.pf_average)
        self.cfg = PFBConfig(nfft=nfft, avg=avg, rate=rate)
        self.T, self.Kc = mesh.T, mesh.Kc
        if L % (self.T * nfft) or nfft % self.Kc:
            raise ValueError("sharded loopback: the block must split over "
                             "time shards in whole frames, nfft over the "
                             "channel shards")
        self.Lt = L // self.T
        self.ft = self.Lt // nfft
        self.H = (avg - 1) * nfft
        if self.H > self.Lt:
            raise ValueError("sharded loopback: the halo must fit in one "
                             "time shard")
        self.bins = tuple(int(b) for b in tone_bins(rx.freq, rate, nfft))
        self.n_tones = len(self.bins)
        freqs = tuple(int(f) for f in tx.freq)
        ampls = tuple(float(a) for a in (tx.ampl or [1.0] * len(freqs)))
        period = tone_ops.comb_period(freqs, rate)
        self._const_tx = L % period == 0 and period <= (1 << 22)
        if plan_sharded_channelizer_loopback(tx, rx, mesh, L):
            self.path = "channelizer_wavetable"
            self._build_channelizer(freqs, ampls)
        else:
            self.path = "pfb_scan"
            self._build_pfb(freqs, ampls)

    def _build_pfb(self, freqs, ampls):
        mesh, L, Lt = self.mesh, self.block_len, self.Lt
        rate = self.cfg.rate
        self._pfb = ShardedPFB(self.cfg, mesh, L, bins=self.bins)
        if self._const_tx:
            x = tone_ops.tone_comb_wavetable_block(freqs, ampls, rate, L)
            self._x = mesh.grid(lambda t, c, d: cplx.from_np(
                x[t * Lt:(t + 1) * Lt], d))
            return
        # an aperiodic comb per shard: the factors of an Lt-sample block,
        # shard t's phase starting at f*(t*Lt) mod W, advancing per
        # global block by f*L mod W
        cfgt = tone_ops.ToneCombConfig(rate=rate, freqs=freqs, ampls=ampls,
                                       block_len=Lt)
        P, Q = cfgt.factors(torch.device("cpu"))
        fr = np.asarray(freqs, dtype=np.int64)
        self._PQ = mesh.grid(lambda t, c, d: (P.to(d), Q.to(d)))
        self._tx_step = mesh.grid(lambda t, c, d: torch.from_numpy(
            (fr * L) % rate).to(d))
        self._tx_phase0 = [torch.from_numpy((fr * ((t * Lt) % rate)) % rate)
                           for t in range(self.T)]

    def _build_channelizer(self, freqs, ampls):
        """The channelizer kernel per time shard in const-frame mode: a
        one-frame-periodic comb makes every halo frame the comb frame, so
        only the stream's very first frames (shard 0, block 0) differ,
        their halo zero, as the pfb_scan path's zero-primed carry."""
        cfg, mesh = self.cfg, self.mesh
        frame = tone_ops.tone_comb_wavetable_block(freqs, ampls, cfg.rate,
                                                   cfg.nfft)
        self._frame = [cplx.from_np(frame, mesh.device(t, 0)).reshape(
            1, cfg.nfft) for t in range(self.T)]
        self._consts = [channelizer_consts(cfg, mesh.device(t, 0))
                        for t in range(self.T)]
        self._bins_t = [torch.as_tensor(self.bins, device=mesh.device(t, 0))
                        for t in range(self.T)]

    def init_state(self):
        if self.path == "channelizer_wavetable":
            return 0                              # started flag
        halo = self._pfb.init_state()
        if self._const_tx:
            return (halo,)
        phase = self.mesh.grid(lambda t, c, d: self._tx_phase0[t].to(d))
        return (phase, halo)

    def step(self, state):
        """One block: (state', Sharded (L//nfft, n_tones))."""
        if self.path == "channelizer_wavetable":
            lead = self.cfg.avg - 1
            ys = []
            for t in range(self.T):
                fr = self._frame[t]
                spare = fr.expand(lead, fr.shape[1])
                if t == 0 and not state:
                    spare = torch.zeros_like(spare)
                y = channelizer(*self._consts[t], spare.contiguous(), fr,
                                nframes=self.ft)
                ys.append([select_tones(y, self._bins_t[t])])
            return 1, Sharded(ys)
        if self._const_tx:
            (halo,) = state
            halo, ys = self._pfb.step(halo, self._x)
            return (halo,), ys
        phase, halo = state
        W = self.cfg.rate
        xs, phase2 = [], []
        for t in range(self.T):
            xs.append([])
            phase2.append([])
            for c in range(self.Kc):
                P, Q = self._PQ[t][c]
                ph, x = tone_ops.tone_comb_block(P, Q, self._tx_step[t][c],
                                                 W, phase[t][c])
                xs[t].append(x)
                phase2[t].append(ph)
        halo, ys = self._pfb.step(halo, xs)
        return (phase2, halo), ys

    def run(self, sinks=(), usrp_number: int = 0, front_end: str = "A",
            n_blocks: int | None = None):
        """Stream n_blocks blocks into the sinks."""
        return _run(self, sinks, usrp_number, front_end, n_blocks)


def plan_sharded_chirp_table(tx, rx, mesh: Mesh, block_len: int) -> bool:
    """The gate of ShardedFusedVNA's chirp_table: no burst, a lock-in
    receiver whose chirp is the TX chirp, whole segments per shard, and
    a one-period table that fits (ops/chirp.chirp_table_fits).  The JAX
    gate's Pallas switch and 8-segment rule have no counterpart."""
    if tx is None or tx.burst_on > 0 or int(rx.decim) < 1:
        return False
    for attr in ("freq", "chirp_f", "chirp_t", "swipe_s"):
        a, b = getattr(tx, attr), getattr(rx, attr)
        if not a or not b or a[0] != b[0]:
            return False
    cfg = chirp_ops.chirp_config(rx)
    ppt = cfg.length * int(rx.decim)
    return bool(block_len % (mesh.T * ppt) == 0 and
                chirp_ops.chirp_table_fits(cfg, block_len, ppt))


class ShardedFusedVNA:
    """The sharded CHIRP -> CHIRP (VNA) loopback, one block per step: no
    halo (the lock-in segments are shard-local), shard t's segments
    start at sample t*Lt of the block."""

    def __init__(self, tx: AntennaParams, rx: AntennaParams, mesh: Mesh,
                 block_len: int = 1_000_000):
        assert tx.wave_type and tx.wave_type[0] == WaveType.CHIRP
        assert rx.wave_type and rx.wave_type[0] == WaveType.CHIRP
        self.tx, self.rx, self.mesh = tx, rx, mesh
        self.block_len = L = int(block_len)
        self.cfg = chirp_ops.chirp_config(rx)
        decim = int(rx.decim)
        if decim <= 0:
            raise ValueError("sharded fused VNA needs the lock-in "
                             "(decim >= 1)")
        self.ppt = self.cfg.length * decim
        self.T = mesh.T
        if L % (self.T * self.ppt):
            raise ValueError("sharded fused VNA: the block must split into "
                             "whole lock-in segments per time shard")
        self.Lt = L // self.T
        self.nseg_t = self.ft = self.Lt // self.ppt
        self.scale = float(tx.ampl[0]) if tx.ampl else 1.0
        self.n_tones = 1
        devs = [mesh.device(t, 0) for t in range(self.T)]
        if plan_sharded_chirp_table(tx, rx, mesh, L):
            self.path = "chirp_table"
            # the amplitude divides back out through the profile, as in
            # the single-device chain (engine/fused._ChirpWavetableChain)
            prof = torch.from_numpy(lockin_profile(self.ppt) /
                                    (self.scale if self.scale else 1.0))
            tables = {}
            for d in devs:
                if d not in tables:
                    tables[d] = chirp_ops.chirp_period_table(
                        self.cfg, L, self.ppt, scale=self.scale, device=d)
            self._table = [tables[d] for d in devs]
            self._nblk = self.cfg.period // L
        else:
            self.path = "chirp_lockin"
            prof = torch.from_numpy(lockin_profile(self.ppt))
        self._profile = [prof.to(d) for d in devs]

    def init_state(self):
        """chirp_table: the period block, an int (the JAX state's uint32
        accumulator beside it is never read, and is not ported);
        chirp_lockin: the stream position, an int."""
        return 0

    def step(self, state):
        """One block: (state', Sharded (L//ppt, 1))."""
        cfg, L, T = self.cfg, self.block_len, self.T
        ys = []
        if self.path == "chirp_table":
            o = state
            for t in range(T):
                y = lockin_self(self._profile[t], self._table[t], o * T + t,
                                self.nseg_t)
                ys.append([y[:, None]])
            return (o + 1) % self._nblk, Sharded(ys)
        last = state
        for t in range(T):
            base = chirp_ops.advance(cfg, last, t * self.Lt)
            _, x = chirp_ops.chirp_block(cfg, base, self.Lt,
                                         scale=self.scale,
                                         device=self._profile[t].device)
            _, z = chirp_ops.chirp_demod_block(cfg, base, x)
            ys.append([lockin_decimate(self._profile[t], z)[:, None]])
        return chirp_ops.advance(cfg, last, L), Sharded(ys)

    def run(self, sinks=(), usrp_number: int = 0, front_end: str = "A",
            n_blocks: int | None = None):
        return _run(self, sinks, usrp_number, front_end, n_blocks)


class ShardedFusedDirect:
    """The sharded TONES -> DIRECT loopback: no collective.  P and ramp
    rows split over 'time', G (or G2) and ramp columns over 'channels'.
    State: the chain's (synthesis phases, DDC phases, prev_valid) on the
    mesh's first device; each shard takes its rotations from it."""

    def __init__(self, tx: AntennaParams, rx: AntennaParams, mesh: Mesh,
                 block_len: int = 1_000_000, use_fold: bool = True):
        assert tx.wave_type and tx.wave_type[0] == WaveType.TONES
        assert rx.wave_type and rx.wave_type[0] == WaveType.DIRECT
        self.tx, self.rx, self.mesh = tx, rx, mesh
        self.block_len = L = int(block_len)
        self.T, self.Kc = mesh.T, mesh.Kc
        freqs = tuple(int(f) for f in tx.freq)
        ampls = tuple(float(a) for a in (tx.ampl or [1.0] * len(freqs)))
        rx_freqs = tuple(int(f) for f in rx.freq)
        rate = int(tx.rate)
        dcfg = DirectDDCConfig(rate=int(rx.rate), decim=int(rx.decim),
                               pf_average=int(rx.pf_average),
                               freqs=rx_freqs, phases=(0,) * len(rx_freqs))
        self.n_tones = len(rx_freqs)
        M = dcfg.M
        nb = L // M if dcfg.decim > 0 and L % M == 0 else 0
        self.ok = bool(nb and freqs and nb % self.T == 0 and
                       len(rx_freqs) % self.Kc == 0)
        self.use_fold = use_fold
        if self.ok and not use_fold:
            self.chain = TonesDirectChain(rate, freqs, ampls, dcfg, L,
                                          time_shards=self.T)
            self.ok = self.chain.ok
        if not self.ok:
            return
        self.nb, self.ft = nb, nb // self.T
        Cl = len(rx_freqs) // self.Kc
        cs = [slice(c * Cl, (c + 1) * Cl) for c in range(self.Kc)]
        nbt = self.ft
        if use_fold:
            self.path = "fold_kernel"
            # the fold of shard (t, c): its rows from t*nbt, its channels
            self._folds = mesh.grid(lambda t, c, d: TonesDirectFold(
                rate, freqs, ampls, DirectDDCConfig(
                    rate=dcfg.rate, decim=dcfg.decim,
                    pf_average=dcfg.pf_average, freqs=rx_freqs[cs[c]],
                    phases=(0,) * Cl), L, d, rows=(t * nbt, nbt)))
            # the whole block's stream state, as TonesDirectFold's
            fr = np.asarray(freqs, dtype=np.int64) % rate
            self._state0 = (
                torch.from_numpy((fr * -((dcfg.f - 1) * M)) % rate),
                ddc_ops.ddc_carrier_init(dcfg, torch.device("cpu")), 0.0)
            self._steps = (torch.from_numpy((fr * L) % rate).to(mesh.first),
                           ddc_ops.ddc_carrier_step(dcfg, L, mesh.first))
        else:
            self.path = "g_chain"
            ch = self.chain
            self._P = mesh.grid(lambda t, c, d: ch.P[t * nbt:(t + 1) * nbt]
                                .to(d))
            self._hP = mesh.grid(lambda t, c, d: ch.halo_rows(t * nbt).to(d))
            self._G = mesh.grid(lambda t, c, d: ch.G[:, :, cs[c]].to(d))
            self._ramp = mesh.grid(lambda t, c, d: ch.ramp[
                t * nbt:(t + 1) * nbt, cs[c]].to(d))
            self._state0 = ch.init_state(mesh.first)
        self._cs = cs

    def init_state(self):
        sph, dph, pv = self._state0
        return (sph.to(self.mesh.first).clone(),
                dph.to(self.mesh.first).clone(), pv)

    def step(self, state):
        """One block: (state', Sharded (nb, C))."""
        mesh, cs = self.mesh, self._cs
        sph, dph, pv = state
        ys = [[None] * self.Kc for _ in range(self.T)]
        if self.path == "fold_kernel":
            W = self._folds[0][0].rate
            # the block's rotations once, each shard's tile rows from them
            srot = phase_rotation(sph, W, 1.0)
            drot = phase_rotation(dph, W, -1.0)
            for t in range(self.T):
                for c in range(self.Kc):
                    d = mesh.device(t, c)
                    fo = self._folds[t][c]
                    crot, qrot = fo.tile_rotations(srot.to(d),
                                                   drot[cs[c]].to(d))
                    y = fold(fo.P1, fo.G2, crot, qrot, fo.ramp1, fo.nb)
                    # the stream's first rows: shard 0's, first block only
                    ys[t][c] = fo.startup_correction(
                        (sph.to(d), dph[cs[c]].to(d), pv), y)
            return (advance_phase(sph, self._steps[0], W),
                    advance_phase(dph, self._steps[1], W), 1.0), Sharded(ys)
        new, srot, hrot0, drot = self.chain.block_rotations(state)
        for t in range(self.T):
            for c in range(self.Kc):
                d = mesh.device(t, c)
                hrot = hrot0 if t == 0 else srot
                ys[t][c] = chain(self._P[t][c], self._hP[t][c],
                                 self._G[t][c], self._ramp[t][c],
                                 srot.to(d), hrot.to(d), drot[cs[c]].to(d))
        return new, Sharded(ys)

    def run(self, sinks=(), usrp_number: int = 0, front_end: str = "A",
            n_blocks: int | None = None):
        return _run(self, sinks, usrp_number, front_end, n_blocks)


def can_fuse_sharded(tx, rx: AntennaParams, mesh: Mesh) -> bool:
    """Whether the (tx, rx, mesh) triple maps onto a sharded fused chain:
    TONES -> TONES without frame averaging, bins splitting over the
    channel axis; CHIRP -> CHIRP into a lock-in; TONES -> DIRECT into a
    decimating receiver with pf_average >= 2, no burst, tones splitting
    over the channel axis.  The JAX gate's Pallas switch and TF32 gate
    on TONES -> DIRECT have no counterpart."""
    if tx is None or not tx.wave_type or not rx.wave_type:
        return False
    pair = (tx.wave_type[0], rx.wave_type[0])
    if pair == (WaveType.TONES, WaveType.TONES):
        nfft = int(rx.fft_tones)
        return int(rx.decim) <= 1 and nfft > 0 and nfft % mesh.Kc == 0
    if pair == (WaveType.CHIRP, WaveType.CHIRP):
        return int(rx.decim) >= 1 and len(rx.freq) == 1
    if pair == (WaveType.TONES, WaveType.DIRECT):
        return (int(rx.decim) > 0 and int(rx.pf_average) >= 2 and
                tx.burst_on <= 0 and len(rx.freq) > 0 and
                len(rx.freq) % mesh.Kc == 0)
    return False


def make_sharded_fused(tx: AntennaParams, rx: AntennaParams, mesh: Mesh,
                       block_len: int):
    """The sharded fused chain of a fusable (tx, rx) pair, or None where
    the geometry does not tile (the caller takes the host pipeline)."""
    if rx.wave_type[0] == WaveType.CHIRP:
        return ShardedFusedVNA(tx, rx, mesh, block_len=block_len)
    if rx.wave_type[0] == WaveType.DIRECT:
        sf = ShardedFusedDirect(tx, rx, mesh, block_len=block_len)
        return sf if sf.ok else None
    return ShardedFusedLoopback(tx, rx, mesh, block_len=block_len)


def plan_sharded_block(rx: AntennaParams, mesh: Mesh):
    """(block_len, n_blocks) of a sharded fused acquisition: the
    planner's block rounded up to split over the time shards in whole
    output strides, and for the PFB to cover the halo in each shard."""
    from ..engine.planner import mode_stride, plan_blocks
    plan = plan_blocks(rx)
    T = mesh.T
    q = T * mode_stride(rx)
    L = -(-plan.block_len // q) * q
    if rx.wave_type and rx.wave_type[0] == WaveType.TONES:
        L = max(L, T * (int(rx.pf_average) - 1) * int(rx.fft_tones))
        L = -(-L // q) * q
    total = int(rx.samples) if int(rx.samples) > 0 else L
    return L, max(1, -(-total // L))
