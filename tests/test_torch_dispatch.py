"""The port's dispatch table cannot drift from its code: engine/dispatch.
plan_dispatch must predict, for a battery reaching every (path, sub-path)
the module declares, exactly the path run_measurement(device="cpu")
takes (measure.LAST_DISPATCH), modelled on tests/test_dispatch_table.py.
The JAX package's plan_dispatch (Pallas on) on the same battery differs
from the port's exactly on a pinned list of cases, each tagged with the
ROADMAP Queue 3 entry it comes from, so a new drift fails.  No module
of engine/ or parallel/ imports measure, which carries the plan out
from above them.
"""

import ast
import collections
import pathlib

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu.engine import dispatch as jdispatch
from gpu_sdr_tpu.engine import replay as jreplay
from gpu_sdr_tpu.engine.sources import ArraySource as JArraySource
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.engine import dispatch
from gpu_sdr_tpu_torch.engine import replay as treplay
from gpu_sdr_tpu_torch.engine.channel import IdealChannel
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource
from gpu_sdr_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

RATE = 1_000_000
FOLD = {"A": [12_345, -67_891, 300_001], "B": [23_456, -45_678, 210_001]}
COMB16 = [k * 10_000 for k in range(-8, 8)]          # period 100, 16 tones
CHIRP = dict(freq=[-300_000], chirp_f=[300_000], swipe_s=[64])


def _tones_direct(P, p, fe, freqs, burst=False, block=100_000):
    n = len(freqs)
    tx = P.AntennaParams(mode=P.AntMode.TX, rate=RATE, buffer_len=block,
                         samples=2 * block, freq=list(freqs),
                         ampl=[0.5 / n] * n, wave_type=[P.WaveType.TONES] * n)
    if burst:
        tx.burst_on, tx.burst_off = 0.03, 0.02
    setattr(p, f"{fe}_TXRX", tx)
    setattr(p, f"{fe}_RX2", P.AntennaParams(
        mode=P.AntMode.RX, rate=RATE, buffer_len=block, samples=2 * block,
        decim=100, pf_average=4, freq=list(freqs),
        wave_type=[P.WaveType.DIRECT] * n))


def _tones(P, p, fe, freqs):
    kw = dict(rate=RATE, buffer_len=128_000, freq=list(freqs),
              wave_type=[P.WaveType.TONES] * len(freqs))
    setattr(p, f"{fe}_TXRX", P.AntennaParams(
        mode=P.AntMode.TX, ampl=[0.25] * len(freqs), **kw))
    setattr(p, f"{fe}_RX2", P.AntennaParams(
        mode=P.AntMode.RX, fft_tones=1000, pf_average=4, samples=256_000,
        **kw))


def _chirp(P, p, fe, chirp_t):
    kw = dict(rate=RATE, buffer_len=64_000, samples=256_000,
              chirp_t=[chirp_t], wave_type=[P.WaveType.CHIRP], **CHIRP)
    setattr(p, f"{fe}_TXRX", P.AntennaParams(mode=P.AntMode.TX, ampl=[0.7],
                                             **kw))
    setattr(p, f"{fe}_RX2", P.AntennaParams(mode=P.AntMode.RX, decim=1,
                                            **kw))


# a loopback of each kind on front end `fe` (B's tones differ from A's)
LOOPBACKS = {
    "replay_kernel_t": lambda P, p, fe: _tones_direct(
        P, p, fe, [100_000 if fe == "A" else -70_000]),
    "replay_kernel": lambda P, p, fe: _tones_direct(P, p, fe, COMB16),
    "fold_kernel": lambda P, p, fe: _tones_direct(P, p, fe, FOLD[fe]),
    "generic_scan": lambda P, p, fe: _tones_direct(P, p, fe, FOLD[fe],
                                                   burst=True),
    "chirp_wavetable": lambda P, p, fe: _chirp(P, p, fe, 0.128),
    "chirp_lockin": lambda P, p, fe: _chirp(P, p, fe, 0.1),  # 100k period
    "channelizer_wavetable": lambda P, p, fe: _tones(
        P, p, fe, [50_000, -200_000] if fe == "A" else [120_000, -30_000]),
}


def loopback(kind, fes="AB", edit=None):
    def build(P):
        p = P.UsrpParams()
        for fe in fes:
            LOOPBACKS[kind](P, p, fe)
        if edit is not None:
            edit(P, p)
        return p
    return build


def receiver(kind):
    """One RX antenna fed from a recording (tests/test_torch_device_
    replay.py's geometries)."""
    def build(P):
        def rx(block, **kw):
            return P.AntennaParams(mode=P.AntMode.RX, rate=RATE,
                                   buffer_len=block, samples=2 * block, **kw)
        W = P.WaveType
        p = P.UsrpParams()
        p.A_RX2 = {
            "direct2": lambda: rx(50_000, decim=10, pf_average=4,
                                  freq=[100_000, -250_000],
                                  wave_type=[W.DIRECT] * 2),
            "direct10": lambda: rx(50_000, decim=10, pf_average=4,
                                   freq=COMB16[:10],
                                   wave_type=[W.DIRECT] * 10),
            "tones": lambda: rx(128_000, fft_tones=1000, pf_average=4,
                                freq=[50_000, -200_000],
                                wave_type=[W.TONES] * 2),
            "noise1009": lambda: rx(64 * 1009, fft_tones=1009, pf_average=4,
                                    freq=[0], wave_type=[W.NOISE]),
            "chirp64k": lambda: rx(64_000, decim=1, chirp_t=[0.128],
                                   wave_type=[W.CHIRP], **CHIRP),
            "chirp96k": lambda: rx(96_000, decim=1, chirp_t=[0.128],
                                   wave_type=[W.CHIRP], **CHIRP),
            "nodsp": lambda: rx(50_000, wave_type=[W.NODSP]),
        }[kind]()
        return p
    return build


def _unmatched(P, p):
    p.B_RX2.buffer_len = 50_000


def _mixed(P, p):
    p.A_RX2.wave_type = [P.WaveType.DIRECT, P.WaveType.CHIRP]
    p.A_RX2.freq = [100_000, 0]
    p.A_RX2.chirp_f, p.A_RX2.chirp_t = [0, 200_000], [0.0, 0.1]
    p.A_RX2.swipe_s = [0, 1000]


def _no_tx(P, p):
    p.A_TXRX = P.AntennaParams()
    p.B_TXRX = P.AntennaParams()


Case = collections.namedtuple(
    "Case", "build source mesh channel segmented expect")
D, DS = "dual_fused", "dual_sharded_fused"
F, SF = "fused_loopback", "sharded_fused"
DR, SR = "device_replay", "sharded_replay"


def both(path, sub):
    return [("A_RX2", path, sub), ("B_RX2", path, sub)]


def case(build, expect, source=None, mesh=None, channel=False,
         segmented=False):
    return Case(build, source, mesh, channel, segmented, expect)


BATTERY = {
    # lock-step front ends, every FusedLoopback sub-path
    **{f"dual_{k}": case(loopback(k), both(D, k)) for k in (
        "replay_kernel_t", "replay_kernel", "fold_kernel", "generic_scan",
        "chirp_wavetable", "channelizer_wavetable")},
    "dual_chirp_lockin_period": case(loopback("chirp_lockin"),
                                     both(D, "generic_scan")),
    # lock-step sharded chains, every sub-path
    "dual_sharded_channelizer": case(loopback("channelizer_wavetable"),
                                     both(DS, "channelizer_wavetable"),
                                     mesh=(2, 1)),
    "dual_sharded_pfb_scan": case(loopback("channelizer_wavetable"),
                                  both(DS, "pfb_scan"), mesh=(1, 2)),
    "dual_sharded_fold": case(loopback("fold_kernel"),
                              both(DS, "fold_kernel"), mesh=(2, 1)),
    "dual_sharded_chirp_table": case(loopback("chirp_wavetable"),
                                     both(DS, "chirp_table"), mesh=(2, 1)),
    "dual_sharded_chirp_lockin": case(loopback("chirp_lockin"),
                                      both(DS, "chirp_lockin"), mesh=(2, 1)),
    # the sequential path: plan_dual refuses, each RX in turn
    "sequential_unmatched": case(
        loopback("replay_kernel_t", edit=_unmatched),
        [("A_RX2", F, "replay_kernel_t"), ("B_RX2", F, "replay_kernel_t")]),
    "sequential_channel": case(loopback("fold_kernel"),
                               both("host_pipeline", None), channel=True),
    "sequential_no_tx": case(loopback("fold_kernel", edit=_no_tx),
                             both("host_pipeline", None)),
    "sequential_mesh_untileable": case(loopback("fold_kernel"),
                                       both("host_pipeline", None),
                                       mesh=(1, 2)),
    # one front end: fused_loopback, every sub-path
    **{f"fused_{k}": case(loopback(k, "A"), [("A_RX2", F, k)]) for k in (
        "replay_kernel_t", "replay_kernel", "fold_kernel", "generic_scan",
        "chirp_wavetable", "channelizer_wavetable")},
    # sharded_fused, every sub-path
    "sharded_channelizer": case(loopback("channelizer_wavetable", "A"),
                                [("A_RX2", SF, "channelizer_wavetable")],
                                mesh=(2, 1)),
    "sharded_pfb_scan": case(loopback("channelizer_wavetable", "A"),
                             [("A_RX2", SF, "pfb_scan")], mesh=(1, 2)),
    "sharded_fold": case(loopback("fold_kernel", "A"),
                         [("A_RX2", SF, "fold_kernel")], mesh=(2, 1)),
    "sharded_chirp_table": case(loopback("chirp_wavetable", "A"),
                                [("A_RX2", SF, "chirp_table")], mesh=(2, 1)),
    "sharded_chirp_lockin": case(loopback("chirp_lockin", "A"),
                                 [("A_RX2", SF, "chirp_lockin")],
                                 mesh=(2, 1)),
    # recordings: device_replay, every sub-path, and segmented_replay
    "replay_kernel_t": case(receiver("direct2"),
                            [("A_RX2", DR, "replay_kernel_t")],
                            source=(50_000, True)),
    "replay_kernel": case(receiver("direct10"),
                          [("A_RX2", DR, "replay_kernel")],
                          source=(50_000, True)),
    "replay_channelizer_at": case(receiver("tones"),
                                  [("A_RX2", DR, "channelizer_at")],
                                  source=(256_000, True)),
    "replay_pfb_at": case(receiver("noise1009"), [("A_RX2", DR, "pfb_at")],
                          source=(64 * 1009, True)),
    "replay_chirp_table": case(receiver("chirp64k"),
                               [("A_RX2", DR, "chirp_table")],
                               source=(128_000, True)),
    "replay_chirp_at": case(receiver("chirp96k"),
                            [("A_RX2", DR, "chirp_at")],
                            source=(192_000, True)),
    "replay_scan": case(receiver("direct2"), [("A_RX2", DR, "scan")],
                        source=(60_000, False)),
    "segmented_replay": case(receiver("direct2"),
                             [("A_RX2", "segmented_replay", None)],
                             source=(100_000, False), segmented=True),
    # recordings under a mesh
    "sharded_replay_kernel": case(receiver("direct2"),
                                  [("A_RX2", SR, "replay_kernel")],
                                  source=(100_000, True), mesh=(2, 1)),
    "sharded_replay_channelizer_at": case(receiver("tones"),
                                          [("A_RX2", SR, "channelizer_at")],
                                          source=(256_000, True),
                                          mesh=(2, 1)),
    "sharded_replay_scan": case(receiver("direct2"),
                                [("A_RX2", SR, "scan")],
                                source=(60_000, False), mesh=(2, 1)),
    "sharded_segmented_replay": case(
        receiver("direct2"), [("A_RX2", "sharded_segmented_replay", None)],
        source=(100_000, False), mesh=(2, 1), segmented=True),
    # mixed wave types: the mixed host pipeline, whatever else applies
    "host_mixed": case(loopback("fold_kernel", "A", edit=_mixed),
                       [("A_RX2", "host_pipeline_mixed", None)]),
    "host_mixed_mesh": case(loopback("fold_kernel", "A", edit=_mixed),
                            [("A_RX2", "host_pipeline_mixed", None)],
                            mesh=(2, 1)),
    "host_mixed_recording": case(
        loopback("fold_kernel", "A", edit=lambda P, p: (_mixed(P, p),
                                                        _no_tx(P, p))),
        [("A_RX2", "host_pipeline_mixed", None)], source=(100_000, True)),
    # NODSP: the raw stream, replayed (scan) or host-fed
    "nodsp_replay": case(receiver("nodsp"), [("A_RX2", DR, "scan")],
                         source=(100_000, True)),
    "nodsp_host": case(receiver("nodsp"),
                       [("A_RX2", "host_pipeline", None)]),
    # the host pipeline
    "host_white_noise": case(receiver("direct2"),
                             [("A_RX2", "host_pipeline", None)]),
    "host_partial_loop": case(receiver("direct2"),
                              [("A_RX2", "host_pipeline", None)],
                              source=(75_000, True)),
}


def recording(n, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


def inputs(c, P, Source, mesh_fn, monkeypatch, replay_mod):
    """(params, source, mesh) of case `c` for one package."""
    src = None
    if c.source is not None:
        n, loop = c.source
        src = Source(recording(n))
        src.loop = loop
    if c.segmented:
        monkeypatch.setattr(replay_mod, "DEVICE_REPLAY_MAX_BYTES",
                            40_000 * 8)
    mesh = mesh_fn(c.mesh) if c.mesh else None
    return c.build(P), src, mesh


def port_mesh(shape):
    return make_mesh(shape, devices=["cpu"] * 8)


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_plan_matches_actual(monkeypatch, name):
    c = BATTERY[name]
    params, src, mesh = inputs(c, tparams, ArraySource, port_mesh,
                               monkeypatch, treplay)
    plan = dispatch.plan_dispatch(params, source=src,
                                  channel=IdealChannel() if c.channel
                                  else None, mesh=mesh)
    measure.run_measurement(params, source=src, mesh=mesh,
                            channel=IdealChannel() if c.channel else None,
                            extra_sinks=[MemorySink()], device="cpu")
    actual = list(measure.last_dispatch())
    assert [d.key() for d in plan] == actual
    assert actual == c.expect
    assert all(d.reason for d in plan)


def test_battery_reaches_every_declared_path():
    reached = {(p, s) for c in BATTERY.values() for _n, p, s in c.expect}
    assert reached == dispatch.declared()
    assert "fold_chain" not in {s for _p, s in dispatch.declared()}
    assert "g_chain" not in {s for _p, s in dispatch.declared()}


def test_mixed_is_planned_and_raises():
    """Mixed wave types: planned and run as the JAX package's
    host_pipeline_mixed, group 0's packets to the extra sinks; a second
    chirp on the antenna is planned the same and raises when run, as in
    JAX (the reference demodulates one chirp)."""
    params = loopback("fold_kernel", "A", edit=_mixed)(tparams)
    plan = dispatch.plan_dispatch(params)
    assert [d.key() for d in plan] == [("A_RX2", dispatch.HOST_MIXED, None)]
    assert plan[0].key() == jdispatch.plan_dispatch(
        loopback("fold_kernel", "A", edit=_mixed)(jparams))[0].key()
    sink = MemorySink()
    measure.run_measurement(params, extra_sinks=[sink], device="cpu")
    assert list(measure.last_dispatch()) == [d.key() for d in plan]
    assert sink.data.shape == (2_000, 1)        # the DIRECT group's rows

    def two_chirps(P, p):
        _mixed(P, p)
        p.A_RX2.wave_type.append(P.WaveType.CHIRP)
        p.A_RX2.freq.append(-100_000)
        p.A_RX2.chirp_f.append(100_000)
        p.A_RX2.chirp_t.append(0.1)
        p.A_RX2.swipe_s.append(1000)
    params = loopback("fold_kernel", "A", edit=two_chirps)(tparams)
    assert [d.key() for d in dispatch.plan_dispatch(params)] == \
        [("A_RX2", dispatch.HOST_MIXED, None)]
    with pytest.raises(NotImplementedError, match="matches reference"):
        measure.run_measurement(params, extra_sinks=[MemorySink()],
                                device="cpu")


# Where the JAX plan (Pallas on, lane padding off) differs from the
# port's, and the ROADMAP Queue 3 entry each difference comes from.
JAX_DIFFERS = {
    # 4 (replay geometry): the port's replay takes a one-tone periodic
    # comb at 50,000-sample blocks; JAX's tile refuses it
    "sequential_unmatched": ("Queue 3 #4", [
        ("A_RX2", F, "replay_kernel_t"), ("B_RX2", F, "generic_scan")]),
    # 16 (sharded gates): the port's fold and replay kernel tile any
    # shard's rows; JAX needs a row tile per shard
    "sharded_fold": ("Queue 3 #16", [("A_RX2", SF, "g_chain")]),
    "sharded_replay_kernel": ("Queue 3 #16", [("A_RX2", SR, "scan")]),
    # 23 (the dual sub-path under a mesh): JAX's plan leaves it None
    **{f"dual_sharded_{k}": ("Queue 3 #23", both(DS, None)) for k in (
        "channelizer", "pfb_scan", "fold", "chirp_table", "chirp_lockin")},
}


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_jax_plan_differs_only_where_pinned(monkeypatch, name):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    monkeypatch.setenv("GPU_SDR_TPU_PAD_LANES", "0")
    c = BATTERY[name]
    params, src, mesh = inputs(
        c, jparams, JArraySource,
        lambda s: jmake_mesh(s, ("time", "channels")), monkeypatch, jreplay)
    jplan = [d.key() for d in jdispatch.plan_dispatch(
        params, source=src, mesh=mesh,
        channel=object() if c.channel else None)]
    if name in JAX_DIFFERS:
        assert jplan != c.expect
        assert jplan == JAX_DIFFERS[name][1]
    else:
        assert jplan == c.expect


# ---------------------------------------------------------------------
# the arrows: measure sits above engine/ and parallel/

PKG = pathlib.Path(measure.__file__).parent
# entry points run with ``python -m`` that drive run_measurement from
# above it; no module of the package imports them
ENTRY_POINTS = {"gpu_sdr_tpu_torch.parallel.rehearsal"}


def _module(path):
    return ".".join(path.relative_to(PKG.parent).with_suffix("").parts)


def _imported(path) -> set:
    """Every module `path` imports, at its top or inside a function,
    relative imports resolved, ``from a import b`` counted as a and
    a.b."""
    parts = _module(path).split(".")[:-1]
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = parts[:len(parts) - node.level + 1] if node.level else []
            src = ".".join(base + ([node.module] if node.module else []))
            out |= {src} | {f"{src}.{a.name}" for a in node.names}
    return out


def test_engine_and_parallel_import_nothing_of_measure():
    every = sorted(PKG.rglob("*.py"))
    below = [p for p in every if p.parent.name in ("engine", "parallel")]
    assert len(below) > 20
    up = {_module(p) for p in below
          if "gpu_sdr_tpu_torch.measure" in _imported(p)}
    assert up <= ENTRY_POINTS, up
    for entry in ENTRY_POINTS:
        path = PKG.parent.joinpath(*entry.split(".")).with_suffix(".py")
        assert 'if __name__ == "__main__":' in path.read_text()
        assert not [p for p in every if entry in _imported(p)]
