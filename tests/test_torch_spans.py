"""The port's span recorder (spans.py) on the CPU: off, no site reaches
the profiler and a run's record holds no spans; on, every per-block
span counts one a packet, a block's spans come in the loop's order,
each child lies inside its parent, and a profiler's Chrome trace holds
the spans around the operations they time."""

import json
import os

import numpy as np
import pytest
import torch

from gpu_sdr_tpu_torch import measure, spans
from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine.replay import SegmentedDeviceReplay
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource, Source
from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams, UsrpParams,
                                      WaveType)

torch.set_num_threads(2)

BLK = 50_000
PACKETS = 6
HOST_BLOCK_SPANS = ("sdr.feed.source", "sdr.feed.stage", "sdr.feed.put_wait",
                    "sdr.loop.get_wait", "sdr.loop.block", "sdr.loop.step",
                    "sdr.fetch.start", "sdr.inflight", "sdr.drain.wait",
                    "sdr.drain.sinks")
REPLAY_BLOCK_SPANS = ("sdr.loop.block", "sdr.loop.step", "sdr.fetch.start",
                      "sdr.inflight", "sdr.drain.wait", "sdr.drain.sinks")
ONCE = ("sdr.setup.plan", "sdr.setup.build", "sdr.setup.state",
        "sdr.setup.sync", "sdr.stream")


def _rx(blocks=PACKETS):
    return AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=BLK,
                         samples=blocks * BLK, decim=10, pf_average=4,
                         freq=[100_000, -250_000],
                         wave_type=[WaveType.DIRECT] * 2)


def _params(blocks=PACKETS):
    p = UsrpParams()
    p.A_RX2 = _rx(blocks)
    return p


REC = (np.random.default_rng(5).standard_normal((4, BLK)) + 0.5j).astype(
    np.complex64)


class _HostBlocks(Source):
    """A host source (not a recording): the host-fed pipeline's path."""

    def blocks(self, block_len, n_blocks):
        for k in range(n_blocks):
            yield REC[k % len(REC)]


class _Looped(ArraySource):
    """A looped recording: the device replay's path."""

    loop = True


def _replay():
    return _Looped(REC.reshape(-1))


def _raise(*a, **kw):
    raise AssertionError("record_function reached with the recorder off")


def test_off_reaches_no_profiler(monkeypatch):
    """Off, a run never opens record_function, the host-fed pipeline,
    a device replay and a segmented replay all run to their end, and
    the record has the stream's seconds but no spans or counters."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    sink = MemorySink()
    run_pipeline(make_demodulator(_rx(), "cpu"), _HostBlocks(), [sink])
    assert sink.data.shape[0] == PACKETS * BLK // 10
    for source, path in ((_replay(), "device_replay"),
                         (_HostBlocks(), "host_pipeline")):
        sink = MemorySink()
        measure.run_measurement(_params(), source=source, extra_sinks=[sink],
                                device="cpu")
        run = measure.RUNS[-1]
        assert measure.last_dispatch()[0][1] == path
        assert sink.data.shape[0] == PACKETS * BLK // 10
        assert "spans" not in run and "counters" not in run
        assert run["seconds"] > run["stream_seconds"] > 0
    sr = SegmentedDeviceReplay(_rx(), REC.reshape(-1), loop=True,
                               segment_bytes=2 * BLK * 8, device="cpu")
    sink = MemorySink()
    assert sr.run([sink]).n_blocks == PACKETS


def _rows(rec, name):
    t = rec.table()
    return t[t["name"] == rec.name_id(name)]


def _by_block(rec, name):
    rows = _rows(rec, name)
    assert sorted(rows["block"]) == list(range(PACKETS)), name
    return {int(r["block"]): r for r in rows}


@pytest.mark.parametrize("source, names", [
    (_HostBlocks, HOST_BLOCK_SPANS), (_replay, REPLAY_BLOCK_SPANS)],
    ids=["host_fed", "replay"])
def test_on_a_span_a_packet_in_the_loop_order(source, names):
    with spans.recording() as rec:
        sink = MemorySink()
        measure.run_measurement(_params(), source=source(),
                                extra_sinks=[sink], device="cpu")
    run = measure.RUNS[-1]
    summary = run["spans"]
    for name in names:
        assert summary[name]["count"] == PACKETS, name
        assert summary[name]["p50_seconds"] <= summary[name]["p99_seconds"]
    for name in ONCE:
        assert summary[name]["count"] == 1, name
    assert summary["sdr.stream"]["seconds"] == \
        pytest.approx(run["stream_seconds"])
    assert run["counters"]["device_segments"] == 0
    assert run["counters"]["pinned_allocs"] == 0
    if source is _HostBlocks:
        # depth 2 then one where the feed keeps ahead, one where it is
        # starved (test_torch_pipeline_drain pins both ends)
        assert 1 <= run["counters"]["inflight_max"] <= 3
        assert run["counters"].get("drains_starved", 0) <= PACKETS
        assert 1 <= run["counters"]["feed_queue_max"] <= 2
    # block k: staged, handed over, stepped, its copy started, held,
    # waited for, then given to the sinks
    chain = [n for n in ("sdr.feed.stage", "sdr.loop.get_wait",
                         "sdr.loop.step", "sdr.fetch.start", "sdr.inflight",
                         "sdr.drain.wait", "sdr.drain.sinks") if n in names]
    rows = [_by_block(rec, n) for n in chain]
    for k in range(PACKETS):
        if "sdr.feed.stage" in chain:
            assert rows[0][k]["end"] <= rows[1][k]["end"]
            rest = rows[1:]
        else:
            rest = rows
        for a, b in zip(rest, rest[1:]):
            assert a[k]["end"] <= b[k]["start"], k
    assert rec.threads[0] == "MainThread"
    assert ("host-feed" in rec.threads) == (source is _HostBlocks)


def test_children_lie_inside_their_parents():
    with spans.recording() as rec:
        measure.run_measurement(_params(), source=_HostBlocks(),
                                extra_sinks=[MemorySink()], device="cpu")
    t = rec.table()
    by_seq = {int(r["seq"]): r for r in t}
    assert len(by_seq) == len(t)
    children = 0
    for r in t:
        assert r["self"] >= 0 and r["end"] >= r["start"]
        if r["parent"] < 0:
            continue
        p = by_seq[int(r["parent"])]
        assert p["start"] <= r["start"] and r["end"] <= p["end"]
        assert p["thread"] == r["thread"]
        children += 1
    assert children >= 5 * PACKETS
    step = _rows(rec, "sdr.loop.step")
    blocks = {int(r["seq"]): r for r in _rows(rec, "sdr.loop.block")}
    assert all(int(blocks[int(r["parent"])]["block"]) == r["block"]
               for r in step)
    summary = rec.summary()
    for v in summary.values():
        assert 0 <= v["self_seconds"] <= v["seconds"] + 1e-9
    loop = summary["sdr.loop.block"]
    inside = sum(summary[n]["seconds"] for n in (
        "sdr.loop.step", "sdr.fetch.start")) + sum(
        (r["end"] - r["start"]) / 1e9 for n in ("sdr.drain.wait",
                                              "sdr.drain.sinks")
        for r in _rows(rec, n) if r["parent"] in blocks)
    assert loop["self_seconds"] == pytest.approx(loop["seconds"] - inside,
                                                 abs=1e-6)


def test_the_ring_folds_into_bounded_aggregates():
    """A ring far smaller than the spans: counts and totals exact,
    percentiles within a bin (1.1%), the rows kept the newest."""
    rec = spans.Recorder(ring=16)
    rec.reset(blocks=True)
    durs = np.arange(1, 1001) * 1000            # 1 us .. 1 ms
    for k, d in enumerate(durs):
        rec.interval("sdr.inflight", k, 10 ** 9, 10 ** 9 + int(d))
    s = rec.summary()["sdr.inflight"]
    assert s["count"] == 1000
    assert s["seconds"] == pytest.approx(durs.sum() / 1e9)
    assert s["p50_seconds"] == pytest.approx(500e-6, rel=0.011)
    assert s["p99_seconds"] == pytest.approx(990e-6, rel=0.011)
    assert list(rec.table()["block"]) == list(range(984, 1000))


def test_spans_land_in_the_profilers_trace(monkeypatch, tmp_path):
    """Under GPU_SDR_TPU_PROFILE the call records its spans, and the
    Chrome trace holds them as user annotations on the operations'
    clock: the k-th sdr.loop.step encloses block k's operations."""
    monkeypatch.setenv("GPU_SDR_TPU_PROFILE", str(tmp_path))
    measure.run_measurement(_params(), source=_replay(),
                            extra_sinks=[MemorySink()], device="cpu")
    assert measure.RUNS[-1]["spans"]["sdr.loop.step"]["count"] == PACKETS
    assert spans.RECORDER.anchor is not None
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
               for f in fs if f.endswith(".json")]
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if "dur" in e]
    sdr = [e for e in events if e["name"].startswith("sdr.")]
    assert sdr and all(e["cat"] == "user_annotation" for e in sdr)
    assert {"sdr.setup.build", "sdr.stream", "sdr.loop.block",
            "sdr.drain.wait"} <= {e["name"] for e in sdr}
    steps = sorted((e for e in sdr if e["name"] == "sdr.loop.step"),
                   key=lambda e: e["ts"])
    assert len(steps) == PACKETS
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    for k, s in enumerate(steps):
        inside = [e for e in ops if e["tid"] == s["tid"] and
                  s["ts"] <= e["ts"] and
                  e["ts"] + e["dur"] <= s["ts"] + s["dur"]]
        assert inside, f"block {k}'s step encloses no operation"
        if k + 1 < PACKETS:
            assert s["ts"] + s["dur"] <= steps[k + 1]["ts"]
