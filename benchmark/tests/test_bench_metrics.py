"""The metrics: p99 over every block, msps as all the work over all the
time, and the readers of the trace."""

import types

import numpy as np
import pytest

import harness
import stats


def _run(**kw):
    base = dict(cfg=None, mix=None, seconds=1.0, setup_s=3.0, window_s=2.0,
                packets=1000, samples=10 ** 9, latencies=None,
                measure_run={"seconds": 2.5, "stream_seconds": 2.0},
                trace=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_p99_is_the_nearest_rank_over_every_value():
    v = np.arange(1, 2001, dtype=float)          # 2000 blocks
    assert stats.p99(v) == 1980.0                # 20 lie above it
    rng = np.random.default_rng(1)
    assert stats.p99(rng.permutation(v)) == 1980.0
    assert stats.p99([5.0]) == 5.0 and stats.p99([]) == 0.0


def test_latency_counts_a_lost_block_to_the_window_end():
    due = np.array([0.0, 0.01, 0.02, 0.03])
    lat = stats.latencies(np.array([0.021, 0.031]), due, 0.5)
    assert lat.tolist() == pytest.approx([0.021, 0.021, 0.48, 0.47])


def test_block_latency_reader():
    r = harness.metric_reader("block_latency_p99_ms")
    lat = np.full(2000, 0.021)
    lat[:20] = 0.5
    assert r.read(_run(latencies=lat)) == pytest.approx(21.0)
    lat[20] = 0.4                                # 21 above: p99 moves
    assert r.read(_run(latencies=lat)) == pytest.approx(400.0)
    assert r.read(_run()) is None


def test_block_latency_p50_reader():
    r = harness.metric_reader("block_latency_p50_ms")
    lat = np.full(2000, 0.021)
    lat[:1000] = 0.5                             # half above: it holds
    assert r.read(_run(latencies=lat)) == pytest.approx(21.0)
    lat[1000] = 0.5                              # more than half: it moves
    assert r.read(_run(latencies=lat)) == pytest.approx(500.0)
    assert r.read(_run()) is None
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_msps_is_all_the_work_over_all_the_time():
    r = harness.metric_reader("msps")
    assert r.read(_run(samples=3 * 10 ** 9, window_s=2.0)) == 1500.0


def test_setup_readers():
    assert harness.metric_reader("setup_s").read(_run()) == 3.0
    assert harness.metric_reader("measure_setup_s").read(_run()) == 0.5


def _trace():
    return dict(window_s=2.0, busy_s=0.5, packets=1000,
                op_s={"Memcpy HtoD (Pinned -> Device)": 0.2,
                      "Memcpy DtoH (Device -> Pinned)": 0.15,
                      "ddc_channel_kernel": 0.1, "lockin_kernel": 0.01},
                launches={"Memcpy HtoD (Pinned -> Device)": 1000,
                          "Memcpy DtoH (Device -> Pinned)": 1000,
                          "ddc_channel_kernel": 1000, "lockin_kernel": 1000})


def test_trace_readers():
    rx = {"buffer_len": 1_000_000, "decim": 100, "pf_average": 4,
          "freq": list(range(100)), "rate": 100_000_000}
    t = _run(trace=_trace(), cfg={"rx": rx})
    rd = harness.metric_reader
    assert rd("h2d_ms_per_block").read(t) == pytest.approx(0.2)
    assert rd("d2h_ms_per_block").read(t) == pytest.approx(0.15)
    assert rd("device_idle_pct").read(t) == pytest.approx(75.0)
    assert rd("device_ms_per_block.realtime").read(t) == pytest.approx(0.5)
    # #7 a call: 3.212 GFLOP at 67 TFLOP/s over 0.1 ms
    assert rd("ddc_roofline_pct").read(t) == pytest.approx(
        100 * 3.212e9 / 67e12 / 1e-4)
    chirp = {"buffer_len": 1_000_000, "decim": 1, "rate": 100_000_000,
             "chirp_t": [1.0], "swipe_s": [5000]}
    assert rd("lockin_roofline_pct").read(_run(
        trace=_trace(), cfg={"rx": chirp})) == pytest.approx(
            100 * 16_080_400 / 3.35e12 / 1e-5)


def test_a_reader_with_nothing_to_read_returns_nothing():
    t = _run(trace=dict(window_s=1.0, busy_s=0.1, op_s={}, launches={},
                        packets=10),
             cfg={"rx": {}})
    for name in ("h2d_ms_per_block", "d2h_ms_per_block",
                 "ddc_roofline_pct", "lockin_roofline_pct"):
        assert harness.metric_reader(name).read(t) is None
        assert harness.metric_reader(name).read(_run()) is None


def test_the_sink_keeps_what_the_control_compares():
    """A window's sink keeps its first packet, its last and KEEP drawn
    from the seed: the packets control.py computes for the same seed."""
    from gpu_sdr_tpu_torch.engine.sinks import PacketMeta
    for seed, n in ((3, 5), (2 ** 31 + 1, 400)):
        sink = harness.WindowSink(seed)
        sink.on_start(1, n)
        for k in range(n):
            sink.on_packet(PacketMeta(packet_number=k), np.full(1, k))
        sink.on_end()
        kept = sink.kept()
        assert sorted(kept) == harness.kept_packets(seed, n)
        assert all(int(v[0]) == k for k, v in kept.items())
        assert len(kept) == min(n, harness.KEEP + 2)
