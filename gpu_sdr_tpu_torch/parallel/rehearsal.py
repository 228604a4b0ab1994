"""The sharded layer across processes, rehearsed (the port's counterpart
of tools/multihost_rehearsal.py and of __graft_entry__.dryrun_multichip's
sub-paths).

Started once a rank, each rank naming its own devices:

    python -m gpu_sdr_tpu_torch.parallel.rehearsal --init \\
        tcp://127.0.0.1:PORT --world 2 --rank R --mesh 2x4 \\
        --devices cpu*4 --backend gloo --size small --out DIR

``--world 1`` (no ``--init``) runs the same phases on a one-process mesh
of the named devices, the reference a multi-process run is held against
bit for bit.  Every rank's sinks receive the global stream (the gather
of parallel/mesh.Mesh.gather).  One JSON line a phase goes to standard
output; each rank's gathered outputs go to ``DIR/rank<R>.npz`` (with
``--size full``, each packet's CRC-32 and every 97th row instead of the
whole stream), and its phase reports to ``DIR/rank<R>.json``.

``--size small`` (the CPU tests) runs the JAX rehearsal's six phases at
its shapes and the dry run's sub-paths:

1. ``fused_direct``: ShardedFusedDirect (fold_kernel, #11);
2. ``config5``: BASELINE config 5 in lock-step through
   ``run_measurement(mesh=)`` with the shared-tone alignment test;
3. ``families``: ShardedPFB's TONES select (#2, psum) and NOISE at decim
   4, ShardedChirpLockin;
4. ``mixed``: a DIRECT + CHIRP receiver, each rank handed the whole host
   block and sharding out its own part;
5. ``replay``: ShardedDeviceReplay (scan);
6. ``ingest``: PerHostIngest, each rank fed its own span over 127.0.0.1,
   then the last rank's producer gone after 1.5 blocks;

and ``segmented`` (ShardedSegmentedReplay), ``channelizer_replay`` (#5),
``channelizer_loopback`` (#1), ``chirp_table`` (#16),
``replay_kernel`` (#10) and ``g_chain`` (#15), the time-only sub-paths on
a (devices, 1) mesh.

``--size full`` (the card) runs the chip cases at full width, each
rank's meshes (n, 1) and (1, n) of every rank's devices:
``config3_fused`` (#11), ``tones_fused`` (config 4, #1),
``config3_hostfed`` ((1, n): channel shards across ranks, #7),
``replays`` (config 3 #10, TONES #5), ``config5`` (dual lock-step, #1)
and ``ingest`` (#7, with the abort).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import threading
import time
import zlib

import numpy as np
import torch

from ..engine.sinks import Sink
from .mesh import Mesh, Sharded, make_mesh

RATE = 1_000_000
DECIM, PFA = 10, 4
# 8 tones so every mesh channel width in {1, 2, 4, 8} divides the set
FREQS8 = [12_345, -67_891, 300_001, -111_111, 45_007, -250_013, 150_151,
          -321_001]
AMPLS8 = [0.4, 0.3, 0.2, 0.1, 0.15, 0.12, 0.1, 0.08]
L1, N1 = 80_000, 4                  # phase 1: blocks of 80,000, 4 blocks
ROWS = slice(0, None, 97)           # the rows a full-size run keeps
SEND_TIMEOUT = 30.0        # the ingest's waits: under the group's timeout


def tone_block(freqs, ampls, start: int, length: int,
               rate: int = RATE) -> np.ndarray:
    """A tone comb from exact integer phases, complex64."""
    n = np.arange(start, start + length, dtype=np.int64)
    x = np.zeros(length, dtype=np.complex128)
    for f, a in zip(freqs, ampls):
        x += a * np.exp(2j * np.pi * ((int(f) * n) % rate) / rate)
    return x.astype(np.complex64)


def noise(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _params(P=None):
    """The parameter module: the port's, or one named by the caller (the
    tests build the JAX package's parameters from the same functions)."""
    if P is not None:
        return P
    from .. import params
    return params


# -- the inputs of the small phases, shared with the tests --------------
def direct_pair(freqs=FREQS8, ampls=AMPLS8, block=L1, n_blocks=N1,
                decim=DECIM, P=None):
    """A TX comb into a DIRECT receiver at the same frequencies."""
    P = _params(P)
    tx = P.AntennaParams(mode=P.AntMode.TX, rate=RATE, buffer_len=block,
                         samples=n_blocks * block, freq=list(freqs),
                         ampl=list(ampls),
                         wave_type=[P.WaveType.TONES] * len(freqs))
    rx = P.AntennaParams(mode=P.AntMode.RX, rate=RATE, buffer_len=block,
                         samples=n_blocks * block, freq=list(freqs),
                         decim=decim, pf_average=PFA,
                         wave_type=[P.WaveType.DIRECT] * len(freqs))
    return tx, rx


CONFIG5_TONES, CONFIG5_DECIM, CONFIG5_DF = 16, 100, 1_000


def config5_small(P=None):
    """The JAX rehearsal's config-5 shape: 16 tones a front end, each TX
    tone `CONFIG5_DF` off its RX carrier, decim 100, 4 blocks."""
    P = _params(P)
    dfreqs = [int(f) for f in np.linspace(-400_000, 400_000,
                                          CONFIG5_TONES)]
    cmd = P.UsrpParams()
    n = CONFIG5_TONES
    for fe in ("A", "B"):
        setattr(cmd, f"{fe}_TXRX", P.AntennaParams(
            mode=P.AntMode.TX, rate=RATE, buffer_len=L1, samples=4 * L1,
            freq=[f + CONFIG5_DF for f in dfreqs], ampl=[1.0 / n] * n,
            wave_type=[P.WaveType.TONES] * n, delay=1.0))
        setattr(cmd, f"{fe}_RX2", P.AntennaParams(
            mode=P.AntMode.RX, rate=RATE, buffer_len=L1, samples=4 * L1,
            decim=CONFIG5_DECIM, pf_average=PFA, freq=dfreqs,
            wave_type=[P.WaveType.DIRECT] * n, delay=1.0))
    return cmd


def config5_alignment(a: np.ndarray, b: np.ndarray) -> dict:
    """The JAX rehearsal's shared-tone test: both front ends' outputs
    rotate at the offset; after the FIR's warm-up their amplitudes agree
    and their phases are flat and equal."""
    n = CONFIG5_TONES
    out_rate = RATE / CONFIG5_DECIM
    k = np.arange(len(a))
    rot = np.exp(2j * np.pi * CONFIG5_DF * k / out_rate)[:, None]
    ra, rb = a[8:] / rot[8:], b[8:] / rot[8:]
    amp_ok = bool(np.allclose(np.abs(ra), np.abs(rb), atol=1e-4) and
                  np.allclose(np.abs(ra), 1.0 / n, atol=5e-3))
    ptp = float(np.ptp(np.angle(ra), axis=0).max())
    pd = float(np.abs(np.angle(ra * np.conj(rb))).max())
    return {"config5_ptp": ptp, "config5_pd": pd,
            "config5_aligned": bool(amp_ok and ptp < 1e-2 and pd < 1e-3)}


PFB_NFFT, PFB_AVG, PFB_BINS, PFB_DEC = 64, 4, (5, 17, 40), 4


def pfb_small(T: int):
    """Phase 3's PFB block (whole frames a shard, >= 8 a shard) and its
    two random blocks."""
    Lp = PFB_NFFT * 32 * max(1, T // 2)
    return Lp, [noise(7 + i, Lp) for i in range(2)]


CHIRP_LC = 80_000


def chirp_small():
    """Phase 3's chirp: -300 to +300 kHz in 1000 steps over 0.1 s at 1
    Msps (100 samples a step, decim 1), and its two random blocks."""
    from ..ops.chirp import ChirpConfig
    cfg = ChirpConfig.from_params(-300_000, 300_000, RATE, 1000, 0.1)
    return cfg, [noise(17 + i, CHIRP_LC) for i in range(2)]


MIXED_FREQS, MIXED_AMPLS = [100_000, -200_000], [0.4, 0.25]


def mixed_small(P=None):
    """Phase 4: two DIRECT tones and a CHIRP sweep on one receiver at
    decim 100; its two blocks (the comb plus the sweep)."""
    from ..ops import chirp as chirp_ops
    P = _params(P)
    rx = P.AntennaParams(
        mode=P.AntMode.RX, rate=RATE, buffer_len=100_000, samples=200_000,
        decim=100, pf_average=PFA, freq=MIXED_FREQS + [-300_000],
        wave_type=[P.WaveType.DIRECT] * 2 + [P.WaveType.CHIRP],
        chirp_f=[0, 0, 300_000], chirp_t=[0.0, 0.0, 0.1],
        swipe_s=[0, 0, 1000])
    cfg = chirp_ops.ChirpConfig.from_params(-300_000, 300_000, RATE, 1000,
                                            0.1)
    return rx, cfg


def mixed_input(cfg, B: int) -> np.ndarray:
    from ..ops import chirp as chirp_ops
    _, c = chirp_ops.chirp_block(cfg, 0, 2 * B, device=torch.device("cpu"))
    return (tone_block(MIXED_FREQS, MIXED_AMPLS, 0, 2 * B) +
            c.numpy()).astype(np.complex64)


def replay_small(P=None):
    """Phase 5: 4 blocks of 100,000 of the 8-tone comb, decim 100."""
    _, rx = direct_pair(block=100_000, n_blocks=4, decim=100, P=P)
    return rx, tone_block(FREQS8, AMPLS8, 0, 400_000)


def ingest_rx(n_blocks: int, P=None):
    _, rx = direct_pair(block=100_000, n_blocks=n_blocks, decim=100, P=P)
    return rx


def time_mesh_len(n_devices: int) -> int:
    """The sub-paths' block: 16 frames of 1000 a time shard."""
    return 16_000 * n_devices


def seg_small(P=None):
    _, rx = direct_pair(block=L1, n_blocks=8, P=P)
    return rx, noise(1, 8 * L1)


def chan_replay_small(n: int, P=None):
    P = _params(P)
    L = time_mesh_len(n)
    rx = P.AntennaParams(mode=P.AntMode.RX, rate=RATE, buffer_len=L,
                         samples=4 * L, fft_tones=1000, pf_average=4,
                         wave_type=[P.WaveType.NOISE])
    return rx, noise(2, 2 * L)


CHAN_FREQS, CHAN_AMPLS = [50_000, -200_000, 333_000], [0.4, 0.3, 0.2]


def chan_loopback_small(n: int, P=None):
    P = _params(P)
    L = time_mesh_len(n)
    kw = dict(rate=RATE, buffer_len=L, samples=4 * L, freq=CHAN_FREQS,
              wave_type=[P.WaveType.TONES] * 3, delay=1.0)
    return (P.AntennaParams(mode=P.AntMode.TX, ampl=CHAN_AMPLS, **kw),
            P.AntennaParams(mode=P.AntMode.RX, fft_tones=1000,
                            pf_average=4, **kw))


def chirp_table_small(n: int, P=None):
    P = _params(P)
    L = time_mesh_len(n)
    kw = dict(rate=RATE, buffer_len=L, samples=4 * L, freq=[-300_000],
              chirp_f=[300_000], chirp_t=[L / RATE], swipe_s=[L // 1000],
              delay=1.0)
    return (P.AntennaParams(mode=P.AntMode.TX, ampl=[0.7],
                            wave_type=[P.WaveType.CHIRP], **kw),
            P.AntennaParams(mode=P.AntMode.RX, decim=1,
                            wave_type=[P.WaveType.CHIRP], **kw))


def replay_kernel_small(n: int, P=None):
    L = time_mesh_len(n)
    _, rx = direct_pair(block=L, n_blocks=4, P=P)
    return rx, noise(3, 2 * L)


# -- running ------------------------------------------------------------
@dataclasses.dataclass
class Context:
    devices: list                  # this rank's own devices
    shape: tuple                   # the main mesh's (T, Kc)
    size: str
    world: int
    rank: int
    abort_rank: int
    meshes: dict = dataclasses.field(default_factory=dict)
    outputs: dict = dataclasses.field(default_factory=dict)

    def mesh(self, shape) -> Mesh:
        """The mesh of `shape` over every rank's devices, built once (by
        every rank, in one order: make_mesh is collective)."""
        shape = tuple(shape)
        if shape not in self.meshes:
            self.meshes[shape] = make_mesh(shape, devices=self.devices)
        return self.meshes[shape]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    def keep(self, name: str, y: np.ndarray) -> None:
        self.outputs[name] = np.asarray(y)


class KeepSink(Sink):
    """Every packet, by front end; kept whole (the small runs) or, after
    the stream, as each packet's CRC-32 and every 97th row (the
    full-size runs, whose streams run to gigabytes: the digest is taken
    outside the streaming window).  The window runs from the sinks'
    start (set-up done) to their end, for the rates."""

    def __init__(self, full: bool):
        self.full = full
        self.packets = {}
        self.n_packets = 0
        self.t_start = self.t_end = None

    def on_start(self, n_channels, expected_rows) -> None:
        if self.t_start is None:            # the first front end's start
            self.t_start = time.perf_counter()

    def on_end(self) -> None:
        self.t_end = time.perf_counter()

    def on_packet(self, meta, data) -> None:
        # a copy: the fetch's pinned buffer goes back to its allocator,
        # as a sink that drops packets lets it (a kept pinned buffer
        # makes every block allocate a new one)
        self.n_packets += 1
        self.packets.setdefault(meta.front_end_code, []).append(
            np.array(data))

    def store(self, ctx: Context, name: str) -> None:
        for fe, pkts in sorted(self.packets.items()):
            key = name if len(self.packets) == 1 else f"{name}_{fe}"
            keep_packets(ctx, key, pkts)
        self.packets = {}


def keep_packets(ctx: Context, key: str, pkts) -> None:
    """A stream's packets into the outputs: whole, or (full size) their
    CRC-32s and every 97th row."""
    if ctx.size == "full":
        ctx.keep(key + "_crc", np.asarray(
            [zlib.crc32(np.ascontiguousarray(p).tobytes()) for p in pkts],
            np.uint32))
        ctx.keep(key + "_rows", np.concatenate([p[ROWS] for p in pkts]))
    else:
        ctx.keep(key, np.concatenate([np.asarray(p) for p in pkts]))


def _np(y) -> np.ndarray:
    if isinstance(y, Sharded):
        y = y.gather("cpu")
    return y.detach().cpu().numpy()


def _counters():
    """The wrappers of the kernels this layer runs, by their name in the
    smoke's kernels line: each counts its launches in ``launches``."""
    from ..ops.chain import chain
    from ..ops.channelizer import channelizer, channelizer_at_halo
    from ..ops.ddc import ddc_fused
    from ..ops.fold import fold
    from ..ops.lockin_table import lockin_self
    from ..ops.presum import presum
    from ..ops.replay_ddc import ShardedReplayDDC
    return {"channelizer": channelizer, "presum": presum,
            "channelizer_at_halo": channelizer_at_halo, "ddc": ddc_fused,
            "replay_ddc_sharded": ShardedReplayDDC, "fold": fold,
            "chain": chain, "lockin_self": lockin_self}


def _steps(chain, n: int, ctx: Context, name: str) -> None:
    state = chain.init_state()
    outs = []
    for _ in range(n):
        state, y = chain.step(state)
        outs.append(_np(y))
    ctx.keep(name, np.concatenate(outs))


# -- the small phases ---------------------------------------------------
def phase_fused_direct(ctx: Context) -> dict:
    from .fused_sharded import ShardedFusedDirect
    tx, rx = direct_pair()
    sf = ShardedFusedDirect(tx, rx, ctx.mesh(ctx.shape), block_len=L1)
    assert sf.ok and sf.path == "fold_kernel", sf.path
    _steps(sf, N1, ctx, "fused_direct")
    return {"path": sf.path}


def phase_config5(ctx: Context) -> dict:
    from .. import measure
    sink = KeepSink(full=False)
    measure.run_measurement(config5_small(), None, extra_sinks=[sink],
                            mesh=ctx.mesh(ctx.shape))
    lockstep = set(sink.packets) == {"A_RX2", "B_RX2"}
    sink.store(ctx, "config5")
    rep = {"config5_lockstep": lockstep,
           "dispatch": [list(v) for v in measure.last_dispatch()]}
    if lockstep:
        rep.update(config5_alignment(ctx.outputs["config5_A_RX2"],
                                     ctx.outputs["config5_B_RX2"]))
    rep["phase_ok"] = bool(lockstep and rep.get("config5_aligned"))
    return rep


def phase_families(ctx: Context) -> dict:
    from ..ops import pfb as pfb_ops
    from ..ops.pfb import PFBConfig
    from .sharded_chirp import ShardedChirpLockin
    from .sharded_pfb import ShardedPFB
    mesh = ctx.mesh(ctx.shape)
    Lp, xs = pfb_small(mesh.T)
    pcfg = PFBConfig(nfft=PFB_NFFT, avg=PFB_AVG, rate=RATE)
    for name, sp, post in (
            ("tones", ShardedPFB(pcfg, mesh, Lp, bins=PFB_BINS), None),
            ("noise_decim", ShardedPFB(pcfg, mesh, Lp),
             lambda f: pfb_ops.average_frames(f, PFB_DEC))):
        carry, outs = sp.init_state(), []
        for b in xs:
            carry, y = sp.step(carry, torch.from_numpy(b))
            outs.append(_np(y if post is None else y.map(post)))
        ctx.keep(name, np.concatenate(outs))
    cfg, xc = chirp_small()
    sc = ShardedChirpLockin(cfg, mesh, CHIRP_LC, cfg.length)
    last, outs = sc.init_state(), []
    for b in xc:
        last, y = sc.step(last, torch.from_numpy(b))
        outs.append(_np(y))
    ctx.keep("chirp", np.concatenate(outs))
    return {}


def phase_mixed(ctx: Context) -> dict:
    from ..engine import make_demodulator
    rx, cfg = mixed_small()
    dm = make_demodulator(rx, mesh=ctx.mesh(ctx.shape))
    B = dm.plan.block_len
    xm = mixed_input(cfg, B)
    st, od, oc = dm.init_state(), [], []
    for b in range(2):
        # every rank holds the whole host block; the step shards out its
        # own part (JAX's device_put with a NamedSharding)
        st, (yd, yc) = dm.step(st, torch.from_numpy(xm[b * B:(b + 1) * B]))
        od.append(_np(yd))
        oc.append(_np(yc))
    ctx.keep("mixed_direct", np.concatenate(od))
    ctx.keep("mixed_chirp", np.concatenate(oc))
    return {}


def phase_replay(ctx: Context) -> dict:
    from .sharded_replay import ShardedDeviceReplay
    rx, rec = replay_small()
    sr = ShardedDeviceReplay(rx, rec, ctx.mesh(ctx.shape), loop=False)
    sink = KeepSink(full=False)
    sr.run([sink])
    sink.store(ctx, "replay")
    return {"path": sr.path}


def _produce(port: int, payload: np.ndarray) -> None:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=SEND_TIMEOUT) as s:
        s.sendall(payload.tobytes())


def _ingest_run(ctx: Context, mesh, rx, rec, n_blocks: int, short: bool,
                name: str) -> dict:
    """One per-host ingest run: this rank's producer sends its span of
    every block (or, if `short`, 1.5 blocks of it and hangs up)."""
    from ..engine import make_demodulator
    from .host_ingest import PerHostIngest, host_stream_for
    dm = make_demodulator(rx, mesh=mesh)
    L = dm.plan.block_len
    with PerHostIngest(mesh, L, timeout=SEND_TIMEOUT) as ing:
        payload = host_stream_for(rec, ing, n_blocks)
        if short:
            payload = payload[:ing.local_len + ing.local_len // 2]
        th = threading.Thread(target=_produce, args=(ing.port, payload),
                              daemon=True)
        th.start()
        st, outs, errs = dm.init_state(), [], []
        g0, s0 = mesh.gathers, mesh.gather_seconds
        t0 = time.perf_counter()
        for grid, e in ing.device_blocks(L, n_blocks):
            st, y = dm.step(st, grid)
            outs.append(_np(y))
            errs.append(e)
        seconds = time.perf_counter() - t0
        gathers = mesh.gathers - g0
        th.join(timeout=SEND_TIMEOUT)
        if th.is_alive():
            raise RuntimeError("the ingest producer did not finish")
        rep = {f"{name}_blocks": len(outs),
               f"{name}_aborted": bool(ing.aborted),
               f"{name}_shortfall": int(ing.shortfall_blocks),
               f"{name}_errors": errs,
               f"{name}_local_len": int(ing.local_len),
               f"{name}_seconds": seconds,
               f"{name}_gather_s_per_block":
                   ((mesh.gather_seconds - s0) / gathers
                    if gathers else None)}
    keep_packets(ctx, name, outs)
    return rep


def phase_ingest(ctx: Context) -> dict:
    mesh = ctx.mesh(ctx.shape)
    rx = ingest_rx(3)
    rec = tone_block(FREQS8, AMPLS8, 0, 300_000)
    rep = _ingest_run(ctx, mesh, rx, rec, 3, False, "ingest")
    rx4 = ingest_rx(4)
    rep.update(_ingest_run(ctx, mesh, rx4, noise(5, 400_000), 4,
                           ctx.rank == ctx.abort_rank, "ingest_abort"))
    rep["phase_ok"] = bool(
        not rep["ingest_aborted"] and rep["ingest_blocks"] == 3 and
        rep["ingest_abort_aborted"] and rep["ingest_abort_blocks"] == 2 and
        rep["ingest_abort_shortfall"] == 2)
    return rep


def phase_segmented(ctx: Context) -> dict:
    from .sharded_replay import ShardedSegmentedReplay
    rx, rec = seg_small()
    sr = ShardedSegmentedReplay(rx, rec, ctx.mesh(ctx.shape), loop=False,
                                segment_bytes=2 * L1 * 8)
    sink = KeepSink(full=False)
    sr.run([sink])
    sink.store(ctx, "segmented")
    return {"segments": -(-8 // sr.seg_blocks)}


def phase_channelizer_replay(ctx: Context) -> dict:
    from .sharded_replay import ShardedDeviceReplay
    rx, rec = chan_replay_small(ctx.n_devices)
    sr = ShardedDeviceReplay(rx, rec, ctx.mesh((ctx.n_devices, 1)),
                             loop=True)
    assert sr.path == "channelizer_at", sr.path
    sink = KeepSink(full=False)
    sr.run([sink])
    sink.store(ctx, "channelizer_replay")
    return {"path": sr.path}


def phase_channelizer_loopback(ctx: Context) -> dict:
    from .fused_sharded import ShardedFusedLoopback
    tx, rx = chan_loopback_small(ctx.n_devices)
    sf = ShardedFusedLoopback(tx, rx, ctx.mesh((ctx.n_devices, 1)),
                              block_len=time_mesh_len(ctx.n_devices))
    assert sf.path == "channelizer_wavetable", sf.path
    _steps(sf, 4, ctx, "channelizer_loopback")
    return {"path": sf.path}


def phase_chirp_table(ctx: Context) -> dict:
    from .fused_sharded import ShardedFusedVNA
    tx, rx = chirp_table_small(ctx.n_devices)
    v = ShardedFusedVNA(tx, rx, ctx.mesh((ctx.n_devices, 1)),
                        block_len=time_mesh_len(ctx.n_devices))
    assert v.path == "chirp_table", v.path
    _steps(v, 4, ctx, "chirp_table")
    return {"path": v.path}


def phase_replay_kernel(ctx: Context) -> dict:
    from .sharded_replay import ShardedDeviceReplay
    rx, rec = replay_kernel_small(ctx.n_devices)
    sr = ShardedDeviceReplay(rx, rec, ctx.mesh((ctx.n_devices, 1)),
                             loop=True)
    assert sr.path == "replay_kernel", sr.path
    sink = KeepSink(full=False)
    sr.run([sink])
    sink.store(ctx, "replay_kernel")
    return {"path": sr.path}


def phase_g_chain(ctx: Context) -> dict:
    from .fused_sharded import ShardedFusedDirect
    tx, rx = direct_pair()
    sf = ShardedFusedDirect(tx, rx, ctx.mesh(ctx.shape), block_len=L1,
                            use_fold=False)
    assert sf.ok and sf.path == "g_chain", getattr(sf, "path", None)
    _steps(sf, N1, ctx, "g_chain")
    return {"path": sf.path}


SMALL = {"fused_direct": phase_fused_direct, "config5": phase_config5,
         "families": phase_families, "mixed": phase_mixed,
         "replay": phase_replay, "ingest": phase_ingest,
         "segmented": phase_segmented,
         "channelizer_replay": phase_channelizer_replay,
         "channelizer_loopback": phase_channelizer_loopback,
         "chirp_table": phase_chirp_table,
         "replay_kernel": phase_replay_kernel, "g_chain": phase_g_chain}


# -- the full-size phases (the card) -------------------------------------
FULL_BLOCKS, FULL_INGEST_BLOCKS, FULL_REC_BLOCKS = 10, 6, 4


def _streamed(ctx: Context, name: str, run, mesh, block_len: int,
              n_blocks: int, front_ends: int = 1) -> dict:
    """run(sinks) streams n_blocks blocks a front end into the sinks; the
    rates of this rank and of the mesh over the sinks' streaming window,
    and the gather's seconds a block, from this run."""
    sink = KeepSink(full=ctx.size == "full")
    g0, s0 = mesh.gathers, mesh.gather_seconds
    run([sink])
    sink.store(ctx, name)
    elapsed = sink.t_end - sink.t_start
    samples = front_ends * n_blocks * block_len
    gathers = mesh.gathers - g0
    return {"packets": sink.n_packets, "blocks": n_blocks,
            "msps_total": samples / elapsed / 1e6,
            "msps_rank": samples / elapsed / 1e6 / ctx.world,
            "gather_s_per_block": ((mesh.gather_seconds - s0) / gathers
                                   if gathers else None),
            "streaming_s": elapsed}


def full_direct():
    from ..probe import CONFIG3, direct_params
    return lambda n: direct_params(CONFIG3, 0.01, n)


def phase_full_config3_fused(ctx: Context) -> dict:
    from ..probe import D_BLOCK
    from .fused_sharded import ShardedFusedDirect
    p = full_direct()(FULL_BLOCKS)
    mesh = ctx.mesh((ctx.n_devices, 1))
    sf = ShardedFusedDirect(p.A_TXRX, p.A_RX2, mesh, block_len=D_BLOCK)
    assert sf.ok and sf.path == "fold_kernel", sf.path
    rep = _streamed(ctx, "config3_fused",
                    lambda s: sf.run(s, n_blocks=FULL_BLOCKS), mesh,
                    D_BLOCK, FULL_BLOCKS)
    rep["path"] = sf.path
    return rep


def phase_full_tones_fused(ctx: Context) -> dict:
    from ..probe import BLOCK, loopback_params
    from .fused_sharded import ShardedFusedLoopback
    p = loopback_params(FULL_BLOCKS)
    mesh = ctx.mesh((ctx.n_devices, 1))
    sf = ShardedFusedLoopback(p.A_TXRX, p.A_RX2, mesh, block_len=BLOCK)
    assert sf.path == "channelizer_wavetable", sf.path
    rep = _streamed(ctx, "tones_fused",
                    lambda s: sf.run(s, n_blocks=FULL_BLOCKS), mesh, BLOCK,
                    FULL_BLOCKS)
    rep["path"] = sf.path
    return rep


def phase_full_config3_hostfed(ctx: Context) -> dict:
    from .. import measure
    from ..engine.channel import IdealChannel
    from ..probe import D_BLOCK
    p = full_direct()(FULL_BLOCKS)
    mesh = ctx.mesh((1, ctx.n_devices))
    rep = _streamed(ctx, "config3_hostfed",
                    lambda s: measure.run_measurement(
                        p, channel=IdealChannel(), mesh=mesh,
                        extra_sinks=s), mesh, D_BLOCK, FULL_BLOCKS)
    rep["dispatch"] = [list(v) for v in measure.last_dispatch()]
    return rep


def phase_full_replays(ctx: Context) -> dict:
    from ..probe import (BLOCK, D_BLOCK, loopback_params, receiver_only,
                         tx_recording)
    from .sharded_replay import ShardedDeviceReplay
    mesh = ctx.mesh((ctx.n_devices, 1))
    rep = {}
    for name, params, block, path in (
            ("config3_replay", full_direct(), D_BLOCK, "replay_kernel"),
            ("tones_replay", loopback_params, BLOCK, "channelizer_at")):
        rec = tx_recording(params, FULL_REC_BLOCKS, block, ctx.devices[0])
        rx = receiver_only(params(FULL_BLOCKS)).A_RX2
        sr = ShardedDeviceReplay(rx, rec, mesh, loop=True)
        assert sr.path == path, (name, sr.path)
        del rec
        r = _streamed(ctx, name, sr.run, mesh, block, FULL_BLOCKS)
        rep.update({f"{name}_{k}": v for k, v in r.items()})
        rep[f"{name}_path"] = sr.path
    return rep


def phase_full_config5(ctx: Context) -> dict:
    from .. import measure
    from ..probe import BLOCK, config5_params
    mesh = ctx.mesh((ctx.n_devices, 1))
    rep = _streamed(ctx, "config5",
                    lambda s: measure.run_measurement(
                        config5_params(FULL_BLOCKS), mesh=mesh,
                        extra_sinks=s), mesh, BLOCK, FULL_BLOCKS, 2)
    rep["dispatch"] = [list(v) for v in measure.last_dispatch()]
    return rep


def phase_full_ingest(ctx: Context) -> dict:
    from ..probe import D_BLOCK, receiver_only, tx_recording
    mesh = ctx.mesh((ctx.n_devices, 1))
    n = FULL_INGEST_BLOCKS
    rec = tx_recording(full_direct(), n, D_BLOCK, ctx.devices[0])
    rx = receiver_only(full_direct()(n)).A_RX2
    rep = _ingest_run(ctx, mesh, rx, rec, n, False, "ingest")
    rep["ingest_msps_total"] = n * D_BLOCK / rep["ingest_seconds"] / 1e6
    rep["ingest_msps_rank"] = rep["ingest_msps_total"] / ctx.world
    rx4 = receiver_only(full_direct()(4)).A_RX2
    rep.update(_ingest_run(ctx, mesh, rx4, rec[:4 * D_BLOCK], 4,
                           ctx.rank == ctx.abort_rank, "ingest_abort"))
    rep["phase_ok"] = bool(
        not rep["ingest_aborted"] and rep["ingest_blocks"] == n and
        rep["ingest_abort_aborted"] and rep["ingest_abort_blocks"] == 2 and
        rep["ingest_abort_shortfall"] == 2)
    return rep


FULL = {"config3_fused": phase_full_config3_fused,
        "tones_fused": phase_full_tones_fused,
        "config3_hostfed": phase_full_config3_hostfed,
        "replays": phase_full_replays, "config5": phase_full_config5,
        "ingest": phase_full_ingest}


def run(devices, shape, size: str = "small", phases=None,
        abort_rank=None, emit=None):
    """Run the phases on this rank (or one process): (reports, outputs).
    `devices` are this rank's own; under a process group the meshes span
    every rank's.  Each report holds the phase's launches of this
    slice's kernels, counted from 0 just before it, its seconds and its
    outputs' shapes; a phase that fails raises."""
    from .mesh import distributed_world
    world = distributed_world()
    rank = 0
    if world > 1:
        import torch.distributed as dist
        rank = dist.get_rank()
    table = SMALL if size == "small" else FULL
    names = list(table) if not phases else list(phases)
    ctx = Context(devices=list(devices), shape=tuple(shape), size=size,
                  world=world, rank=rank,
                  abort_rank=world - 1 if abort_rank is None
                  else int(abort_rank))
    counters = _counters()
    reports = []
    for name in names:
        before = set(ctx.outputs)
        for w in counters.values():
            w.launches = 0
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = table[name](ctx)
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in counters.items()
                    if w.launches}
        outs = {k: list(ctx.outputs[k].shape)
                for k in sorted(set(ctx.outputs) - before)}
        finite = all(np.isfinite(ctx.outputs[k]).all() for k in outs
                     if np.iscomplexobj(ctx.outputs[k]))
        rep = {"phase": name, "rank": rank, "world": world,
               "mesh": "x".join(map(str, shape)), "launches": launches,
               "wall_s": wall, "outputs": outs, "finite": bool(finite),
               **rep}
        if torch.cuda.is_available() and any(
                torch.device(d).type == "cuda" for d in devices):
            rep["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
        rep["ok"] = bool(finite and rep.get("phase_ok", True))
        reports.append(rep)
        if emit is not None:
            emit(rep)
    return reports, ctx.outputs


def parse_devices(spec: str):
    """'cpu*4' -> ['cpu'] * 4; 'cuda:0,cuda:1' -> both; '' -> None."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, k = part.partition("*")
        out += [name] * (int(k) if k else 1)
    return out or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The sharded layer across processes: one rank.")
    ap.add_argument("--init", default=None,
                    help="the process group's address, e.g. "
                         "tcp://127.0.0.1:29500 (omit for --world 1)")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--mesh", default="2x4", help="time x channels")
    ap.add_argument("--devices", default="",
                    help="this rank's devices: 'cpu*4', 'cuda:0', ... "
                         "(default: every visible card)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--size", default="small", choices=("small", "full"))
    ap.add_argument("--phases", default="",
                    help="comma-separated phase names (default: all)")
    ap.add_argument("--abort_rank", type=int, default=None,
                    help="the rank whose ingest producer stops after 1.5 "
                         "blocks in the abort run (default: the last)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a collective may wait (over the "
                         "ingest's 30)")
    ap.add_argument("--out", default=None, help="directory of the .npz")
    args = ap.parse_args(argv)
    T, Kc = (int(v) for v in args.mesh.lower().split("x"))
    devices = parse_devices(args.devices)
    if devices is None:
        if not torch.cuda.is_available():
            raise SystemExit("rehearsal: no card; name the devices")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    dev0 = torch.device(devices[0])
    if dev0.type == "cuda":
        torch.cuda.set_device(dev0)
    if args.world > 1:
        from .distributed import initialize_distributed
        initialize_distributed(args.init, args.world, args.rank,
                               backend=args.backend, timeout_s=args.timeout)
    try:
        def emit(rep):
            print(json.dumps(rep), flush=True)
        phases = [p for p in args.phases.split(",") if p] or None
        reports, outputs = run(devices, (T, Kc), args.size, phases,
                               args.abort_rank, emit)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                     **outputs)
            with open(os.path.join(args.out, f"rank{args.rank}.json"),
                      "w") as f:
                json.dump(reports, f)
    finally:
        if args.world > 1:
            from .distributed import shutdown
            shutdown()
    return 0 if all(r["ok"] for r in reports) else 1


if __name__ == "__main__":
    raise SystemExit(main())
