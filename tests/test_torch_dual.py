"""The port's dual front ends (gpu_sdr_tpu_torch/engine/dual.py) against
the JAX package's (gpu_sdr_tpu/engine/dual.py) on the CPU, at
tests/test_dual.py's DIRECT geometry (1 MHz, 400,000 samples, decim
100), a two-front-end TONES readout (nfft 1000, two bins, 128,000-sample
blocks, tests/test_dispatch_table.py:86-103), a three-tone fold and a
chirp loopback: plan_dual, DualFused bit for bit against the port's
single chains and at 90 dB against JAX's DualFused and the float64
oracle, the shared timebase, DualShardedFused on a (2, 1) CPU mesh, the
packets a shared sink sees, the sequential path, and a JAX DualFused
state carried into the port (convert.dual_state).  The JAX side runs
its Pallas kernels in interpret mode (GPU_SDR_TPU_PALLAS=1) with no lane
padding.
"""

import logging

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu.engine import dual as jdual
from gpu_sdr_tpu.engine.channel import IdealChannel as JIdealChannel
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu_torch import convert, measure, spans
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.engine import dual
from gpu_sdr_tpu_torch.engine.channel import IdealChannel
from gpu_sdr_tpu_torch.engine.fused import FusedLoopback
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

RATE = 1_000_000
NFFT = 1000
# tests/test_dual.py's frontends, and a three-tone aperiodic comb each
DIRECT = {"A": [100_000], "B": [-70_000]}
FOLD = {"A": [12_345, -67_891, 300_001], "B": [23_456, -45_678, 210_001]}
# two bins each, B's at half A's amplitude
TONES = {"A": ([50_000, -200_000], [0.5, 0.25]),
         "B": ([120_000, -30_000], [0.25, 0.125])}
CHIRP = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
             swipe_s=[64])


def direct_dual(P, freqs=DIRECT, rx_freqs=None, samples=400_000, **rx_kw):
    p = P.UsrpParams()
    for fe, fs in freqs.items():
        n = len(fs)
        setattr(p, f"{fe}_TXRX", P.AntennaParams(
            mode=P.AntMode.TX, rate=RATE, buffer_len=100_000,
            samples=samples, freq=list(fs), ampl=[0.5 / n] * n,
            wave_type=[P.WaveType.TONES] * n))
        rf = list(rx_freqs[fe] if rx_freqs else fs)
        setattr(p, f"{fe}_RX2", P.AntennaParams(
            mode=P.AntMode.RX, rate=RATE, buffer_len=100_000,
            samples=samples, decim=100, pf_average=4, freq=rf,
            wave_type=[P.WaveType.DIRECT] * len(rf), **rx_kw))
    return p


def tones_dual(P, blocks=2, block=128_000):
    p = P.UsrpParams()
    for fe, (fs, amps) in TONES.items():
        setattr(p, f"{fe}_TXRX", P.AntennaParams(
            mode=P.AntMode.TX, rate=RATE, buffer_len=block, freq=list(fs),
            ampl=list(amps), wave_type=[P.WaveType.TONES] * 2))
        setattr(p, f"{fe}_RX2", P.AntennaParams(
            mode=P.AntMode.RX, rate=RATE, fft_tones=NFFT, pf_average=4,
            buffer_len=block, samples=blocks * block, freq=list(fs),
            wave_type=[P.WaveType.TONES] * 2))
    return p


def chirp_dual(P):
    p = P.UsrpParams()
    kw = dict(rate=RATE, buffer_len=64_000, samples=256_000,
              wave_type=[P.WaveType.CHIRP], **CHIRP)
    for fe, amp in (("A", 0.7), ("B", 0.35)):
        setattr(p, f"{fe}_TXRX", P.AntennaParams(mode=P.AntMode.TX,
                                                 ampl=[amp], **kw))
        setattr(p, f"{fe}_RX2", P.AntennaParams(mode=P.AntMode.RX, decim=1,
                                                **kw))
    return p


GEOMETRIES = {
    "replay_kernel_t": direct_dual,
    "fold_kernel": lambda P: direct_dual(P, FOLD),
    "channelizer_wavetable": tones_dual,
    "chirp_wavetable": chirp_dual,
}


@pytest.fixture(autouse=True)
def pallas(monkeypatch):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    monkeypatch.setenv("GPU_SDR_TPU_PAD_LANES", "0")


def golden_stream(geometry, fe):
    """The float64 oracle of one front end's acquisition."""
    if geometry == "channelizer_wavetable":
        fs, amps = TONES[fe]
        x = golden.tone_block(fs, amps, RATE, 0, 256_000)
        x = np.concatenate([np.zeros(3 * NFFT), x])
        frames = golden.pfb_frames(x, NFFT, 4)
        return golden.tone_select(frames, golden.tone_bins(fs, RATE, NFFT))
    fs = (DIRECT if geometry == "replay_kernel_t" else FOLD)[fe]
    x = golden.tone_block(fs, [0.5 / len(fs)] * len(fs), RATE, 0, 400_000)
    g = golden.GoldenDirectDemodulator(fs, RATE, 100, 4)
    return np.concatenate([g(x[k * 100_000:(k + 1) * 100_000])
                           for k in range(4)], axis=1).T


class Captured(logging.Handler):
    """Warnings of the two packages' dual loggers, read at the loggers
    themselves (a logger that another test configured may not
    propagate to pytest's capture)."""

    NAMES = ("gpu_sdr_tpu.dual", "gpu_sdr_tpu_torch.dual")

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        for n in self.NAMES:
            logging.getLogger(n).addHandler(self)
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            logging.getLogger(n).removeHandler(self)


# ---------------------------------------------------------------------
# plan_dual


def _one_rx(P):
    p = direct_dual(P)
    p.B_RX2 = P.AntennaParams()
    return p


def _mixed(P):
    p = direct_dual(P)
    p.B_RX2.wave_type = [P.WaveType.DIRECT, P.WaveType.CHIRP]
    p.B_RX2.freq = [-70_000, 0]
    return p


def _no_tx(P):
    p = direct_dual(P)
    p.A_TXRX = P.AntennaParams()
    p.B_TXRX = P.AntennaParams()
    return p


def _unmatched(P):
    p = direct_dual(P)
    p.B_RX2.buffer_len = 50_000
    return p


@pytest.mark.parametrize("case, build, warns", [
    ("direct", direct_dual, False),
    ("tones", tones_dual, False),
    ("chirp", chirp_dual, False),
    ("one_rx", _one_rx, False),
    ("mixed", _mixed, True),
    ("no_tx", _no_tx, True),
    ("unmatched", _unmatched, True),
], ids=lambda v: v if isinstance(v, str) else "")
def test_plan_dual_matches_jax(case, build, warns):
    with Captured() as caplog:
        jpairs = jdual.plan_dual(build(jparams))
        pairs = dual.plan_dual(build(tparams))
    if jpairs is None:
        assert pairs is None
    else:
        assert [(n, tx.freq, rx.freq) for n, tx, rx in pairs] == \
            [(n, tx.freq, rx.freq) for n, tx, rx in jpairs]
    assert (case in ("direct", "tones", "chirp")) == (pairs is not None)
    logs = {r.name: r.getMessage() for r in caplog.records
            if "SEQUENTIALLY" in r.message}
    assert sorted(logs) == (["gpu_sdr_tpu.dual", "gpu_sdr_tpu_torch.dual"]
                            if warns else [])
    if warns:
        assert logs["gpu_sdr_tpu_torch.dual"] == logs["gpu_sdr_tpu.dual"]


def test_plan_dual_under_mesh_matches_jax():
    jpairs = jdual.plan_dual(tones_dual(jparams),
                             mesh=jmake_mesh((2, 1), ("time", "channels")))
    pairs = dual.plan_dual(tones_dual(tparams),
                           mesh=make_mesh((2, 1), devices=["cpu"] * 2))
    assert [n for n, _, _ in pairs] == [n for n, _, _ in jpairs] == \
        ["A_RX2", "B_RX2"]


# ---------------------------------------------------------------------
# DualFused


def run_jax_dual(p):
    pairs = jdual.plan_dual(p)
    sinks = [JMemorySink(), JMemorySink()]
    jdual.DualFused(pairs).run([[s] for s in sinks])
    return [s.data for s in sinks]


@pytest.mark.parametrize("geometry", ["replay_kernel_t", "fold_kernel",
                                      "channelizer_wavetable"])
def test_dual_fused_matches_single_chains_jax_and_golden(geometry):
    build = GEOMETRIES[geometry]
    pairs = dual.plan_dual(build(tparams))
    d = dual.DualFused(pairs, device="cpu")
    assert [ch.path for ch in d.chains] == [geometry] * 2
    sinks = [MemorySink(), MemorySink()]
    res = d.run([[s] for s in sinks])
    assert len(res) == 2 and res[0].elapsed_s == res[1].elapsed_s
    jdata = run_jax_dual(build(jparams))
    for (name, tx, rx), sink, jd in zip(pairs, sinks, jdata):
        ref = MemorySink()
        FusedLoopback(tx, rx, device="cpu").run([ref], front_end=name[0])
        np.testing.assert_array_equal(ref.data, sink.data)
        assert sink.data.shape == jd.shape
        assert golden.snr_db(jd, sink.data) > 90.0
        assert golden.snr_db(golden_stream(geometry, name[0]),
                             sink.data) > 90.0


def test_dual_chirp_matches_single_chains_and_jax():
    pairs = dual.plan_dual(chirp_dual(tparams))
    sinks = [MemorySink(), MemorySink()]
    dual.DualFused(pairs, device="cpu").run([[s] for s in sinks])
    jdata = run_jax_dual(chirp_dual(jparams))
    for (name, tx, rx), sink, jd in zip(pairs, sinks, jdata):
        ref = MemorySink()
        FusedLoopback(tx, rx, device="cpu").run([ref], front_end=name[0])
        np.testing.assert_array_equal(ref.data, sink.data)
        assert golden.snr_db(jd, sink.data) > 90.0
        np.testing.assert_allclose(np.abs(sink.data), tx.ampl[0], rtol=1e-5)


def test_dual_runs_the_pipelines_loop_with_its_spans():
    """DualFused streams through the pipeline's one loop: sdr.loop.block
    and sdr.loop.step once a block, sdr.drain.wait and sdr.drain.sinks
    once a block a front end (an output each, as a mixed antenna's
    groups), one block in flight behind the next, and the packets those
    of a run with the recorder off."""
    pairs = dual.plan_dual(direct_dual(tparams))
    off = [MemorySink(), MemorySink()]
    dual.DualFused(pairs, device="cpu").run([[s] for s in off])
    on = [MemorySink(), MemorySink()]
    with spans.recording() as rec:
        res = dual.DualFused(pairs, device="cpu").run([[s] for s in on])
    n = res[0].n_blocks
    assert n == 4
    t = rec.table()
    for name, per_block in (("sdr.loop.block", 1), ("sdr.loop.step", 1),
                            ("sdr.fetch.start", 1), ("sdr.inflight", 1),
                            ("sdr.drain.wait", 2), ("sdr.drain.sinks", 2)):
        blocks = sorted(t[t["name"] == rec.name_id(name)]["block"])
        assert blocks == sorted(list(range(n)) * per_block), name
    assert rec.record()["counters"]["inflight_max"] == 2
    for a, b in zip(on, off):
        assert a.metas == b.metas
        for x, y in zip(a.packets, b.packets):
            np.testing.assert_array_equal(x, y)


def test_dual_shared_timebase_phase_alignment():
    """Both front ends demodulate their tone 1 kHz off-carrier: the
    residual rotations start from the same t=0, so packet k of A and B
    covers the same sample indices (tests/test_dual.py:55-79)."""
    df = 1_000
    p = direct_dual(tparams, {"A": [100_000], "B": [-200_000]},
                    rx_freqs={"A": [100_000 - df], "B": [-200_000 - df]})
    sa, sb = MemorySink(), MemorySink()
    dual.DualFused(dual.plan_dual(p), device="cpu").run([[sa], [sb]])
    a, b = sa.data[:, 0], sb.data[:, 0]
    k = np.arange(len(a))
    expected = np.exp(2j * np.pi * df * k / (RATE / 100))
    pa = np.angle(a[16:] / expected[16:])
    pb = np.angle(b[16:] / expected[16:])
    assert np.ptp(pa) < 1e-3, "A rotation is not the closed form"
    assert np.ptp(pb) < 1e-3, "B rotation is not the closed form"
    assert abs(np.angle(np.exp(1j * (pa.mean() - pb.mean())))) < 1e-3, \
        "A/B timebases differ"


@pytest.mark.parametrize("geometry, sub", [
    ("replay_kernel_t", "fold_kernel"),
    ("channelizer_wavetable", "channelizer_wavetable"),
    ("chirp_wavetable", "chirp_table"),
])
def test_dual_sharded_fused_matches_unsharded(geometry, sub):
    build = GEOMETRIES[geometry]
    mesh = make_mesh((2, 1), devices=["cpu"] * 2)
    pairs = dual.plan_dual(build(tparams), mesh=mesh)
    ds = dual.DualShardedFused(pairs, mesh)
    assert ds.ok and [ch.path for ch in ds.chains] == [sub] * 2
    sinks = [MemorySink(), MemorySink()]
    res = ds.run([[s] for s in sinks])
    assert [r.n_blocks for r in res] == [ds.n_blocks] * 2
    refs = [MemorySink(), MemorySink()]
    dual.DualFused(dual.plan_dual(build(tparams)), device="cpu").run(
        [[s] for s in refs])
    for sink, ref in zip(sinks, refs):
        assert sink.data.shape == ref.data.shape
        assert golden.snr_db(ref.data, sink.data) > 90.0


def test_dual_sharded_fused_refuses_unmatched_mesh_plans():
    """Front ends whose sharded block plans differ: .ok is False (the
    caller streams them in turn), as JAX's DualShardedFused."""
    p = tones_dual(tparams)
    p.B_RX2.buffer_len = p.B_TXRX.buffer_len = 64_000
    mesh = make_mesh((2, 1), devices=["cpu"] * 2)
    pairs = [(n, p.antenna(n[0] + "_TXRX"), p.antenna(n))
             for n in ("A_RX2", "B_RX2")]
    assert not dual.DualShardedFused(pairs, mesh).ok


# ---------------------------------------------------------------------
# run_measurement: the packets a shared sink sees, sequential paths


class Recorder:
    """A sink recording every call, for JAX's sink protocol and the
    port's alike."""

    def __init__(self):
        self.calls = []
        self.data = {}

    def on_start(self, n_channels, expected_rows):
        self.calls.append(("start", n_channels, expected_rows))

    def on_packet(self, meta, data):
        self.calls.append(("packet", meta.front_end_code,
                           meta.packet_number, data.shape))
        self.data.setdefault(meta.front_end_code, []).append(
            np.asarray(data))

    def on_end(self):
        self.calls.append(("end",))

    def stream(self, code):
        return np.concatenate(self.data[code])


def run_both(build, jkw=None, kw=None, mesh_shape=None):
    jr, tr = Recorder(), Recorder()
    jkw, kw = dict(jkw or {}), dict(kw or {})
    if mesh_shape:
        jkw["mesh"] = jmake_mesh(mesh_shape, ("time", "channels"))
        kw["mesh"] = make_mesh(mesh_shape, devices=["cpu"] * 8)
    else:
        kw["device"] = "cpu"
    jmeasure.run_measurement(build(jparams), extra_sinks=[jr], **jkw)
    measure.run_measurement(build(tparams), extra_sinks=[tr], **kw)
    return jmeasure.last_dispatch(), measure.last_dispatch(), jr, tr


def held_against_jax(jr, tr, jr1):
    """The port's calls against JAX run_measurement's (`jr`) and JAX's
    lock-step loop at one block an execution (`jr1`).  JAX drains K
    blocks of A, then K of B, per execution (K = blocks_per_exec, 8 in
    run_measurement); the port runs one block a step, so its packets
    interleave A0, B0, A1, B1, ... as JAX's do at K = 1 (ROADMAP Queue
    3).  Each front end's own packets and the start and end calls are
    the same at any K."""
    def only(calls, code):
        return [c for c in calls if c[0] != "packet" or c[1] == code]
    for code in ("A_RX2", "B_RX2"):
        assert only(tr.calls, code) == only(jr.calls, code)
        assert golden.snr_db(jr.stream(code), tr.stream(code)) > 90.0
    assert tr.calls == jr1.calls
    assert [c[1:3] for c in tr.calls if c[0] == "packet"][:4] == \
        [("A_RX2", 0), ("B_RX2", 0), ("A_RX2", 1), ("B_RX2", 1)]
    assert [c[0] for c in tr.calls].count("start") == 2
    assert [c[0] for c in tr.calls].count("end") == 2


@pytest.mark.parametrize("geometry", ["replay_kernel_t",
                                      "channelizer_wavetable"])
def test_shared_sink_sees_jax_sequence(geometry):
    """One sink shared by both front ends: on_start twice, packets coded
    with the full antenna name, on_end twice."""
    jdisp, disp, jr, tr = run_both(GEOMETRIES[geometry])
    assert disp == jdisp == (("A_RX2", "dual_fused", geometry),
                             ("B_RX2", "dual_fused", geometry))
    jr1 = Recorder()
    jdual.DualFused(jdual.plan_dual(GEOMETRIES[geometry](jparams)),
                    blocks_per_exec=1).run([[jr1], [jr1]])
    held_against_jax(jr, tr, jr1)


def test_shared_sink_under_mesh_sees_jax_sequence():
    """Under a (2, 1) mesh: the same calls as JAX's DualShardedFused; the
    port records each chain's sub-path where JAX's plan leaves None."""
    jdisp, disp, jr, tr = run_both(tones_dual, mesh_shape=(2, 1))
    assert [d[:2] for d in disp] == [d[:2] for d in jdisp] == \
        [("A_RX2", "dual_sharded_fused"), ("B_RX2", "dual_sharded_fused")]
    assert [d[2] for d in disp] == ["channelizer_wavetable"] * 2
    jr1 = Recorder()
    jmesh = jmake_mesh((2, 1), ("time", "channels"))
    jdual.DualShardedFused(jdual.plan_dual(tones_dual(jparams), mesh=jmesh),
                           jmesh, blocks_per_exec=1).run([[jr1], [jr1]])
    held_against_jax(jr, tr, jr1)


@pytest.mark.parametrize("case", ["unmatched", "channel"])
def test_sequential_paths_match_jax(case):
    """Front ends with unmatched block plans stream one after the other
    with plan_dual's warning; through a channel model the dual branch is
    not tried.  Packets are coded with the front end's letter."""
    if case == "unmatched":
        build, want, jkw, kw = _unmatched, "fused_loopback", {}, {}
    else:
        build, want = direct_dual, "host_pipeline"
        jkw, kw = dict(channel=JIdealChannel()), dict(channel=IdealChannel())
    with Captured() as caplog:
        jdisp, disp, jr, tr = run_both(build, jkw, kw)
    assert [d[:2] for d in disp] == [d[:2] for d in jdisp] == \
        [("A_RX2", want), ("B_RX2", want)]
    warned = [r for r in caplog.records if r.name == "gpu_sdr_tpu_torch.dual"]
    assert len(warned) == (case == "unmatched")
    assert tr.calls == jr.calls
    assert sorted(tr.data) == ["A", "B"]
    for code in ("A", "B"):
        assert golden.snr_db(jr.stream(code), tr.stream(code)) > 90.0


# ---------------------------------------------------------------------
# a JAX DualFused state carried into the port


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_jax_dual_state_resumes_in_port(geometry):
    """JAX's DualFused (one block an execution) stops after one; its
    state list goes through convert.dual_state and the port's DualFused
    continues, within 90 dB of JAX's continuation."""
    build = GEOMETRIES[geometry]
    jd = jdual.DualFused(jdual.plan_dual(build(jparams)), blocks_per_exec=1)
    jst = [ch._init_states() for ch in jd.chains]
    jst, _ = jd._multi_all(jst)
    jst2, jys = jd._multi_all(jst)
    _, jys3 = jd._multi_all(jst2)
    d = dual.DualFused(dual.plan_dual(build(tparams)), device="cpu")
    assert [ch.path for ch in d.chains] == [geometry] * 2
    st = convert.dual_state(jst, d)
    outs = []
    for _ in range(2):
        st, ys = d.step(st)
        outs.append([y.numpy() for y in ys])
    for i in range(2):
        for k, jy in enumerate((jys, jys3)):
            ref = jcplx.to_np(jy[i]).reshape(outs[k][i].shape)
            assert golden.snr_db(ref, outs[k][i]) > 90.0, (i, k)


def test_generic_scan_state_resumes_in_port():
    """A burst-gated comb takes generic_scan on both sides: the
    generator's (phase, burst offset) and the demodulator's state carry
    over through convert.fused_state."""
    def build(P):
        p = direct_dual(P, FOLD)
        for fe in "AB":
            tx = p.antenna(f"{fe}_TXRX")
            tx.burst_on, tx.burst_off = 0.03, 0.02
        return p
    jd = jdual.DualFused(jdual.plan_dual(build(jparams)), blocks_per_exec=1)
    jst = jd._multi_all([ch._init_states() for ch in jd.chains])[0]
    _, jys = jd._multi_all(jst)
    d = dual.DualFused(dual.plan_dual(build(tparams)), device="cpu")
    assert [ch.path for ch in d.chains] == ["generic_scan"] * 2
    _, ys = d.step(convert.dual_state(jst, d))
    for jy, y in zip(jys, ys):
        ref = jcplx.to_np(jy).reshape(y.shape)
        assert golden.snr_db(ref, y.numpy()) > 90.0
