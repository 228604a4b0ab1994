"""The trace reader on a small chrome trace."""

import json

import pytest

import trace_reader


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}


EVENTS = [
    _ev("bench.window", "user_annotation", 100.0, 1000.0),
    _ev("bench.window", "gpu_user_annotation", 150.0, 900.0),
    # a kernel straddling the window's start is clipped
    _ev("void (anonymous namespace)::ddc_channel_kernel(Ext, int)",
        "kernel", 50.0, 100.0),
    _ev("void (anonymous namespace)::ddc_channel_kernel(Ext, int)",
        "kernel", 300.0, 100.0),
    _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 350.0, 100.0),
    _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 700.0, 50.0),
    _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 2000.0, 50.0),
    _ev("aten::copy_", "cpu_op", 460.0, 200.0),
    _ev("cudaEventSynchronize", "cuda_runtime", 760.0, 330.0),
]


def test_breakdown_of_the_window():
    b = trace_reader.breakdown(EVENTS)
    assert b["window_s"] == pytest.approx(1e-3)
    # busy: [100, 150] + [300, 450] + [700, 750]
    assert b["busy_s"] == pytest.approx(250e-6)
    assert b["op_s"]["ddc_channel_kernel"] == pytest.approx(150e-6)
    assert b["launches"] == {"ddc_channel_kernel": 2,
                             "Memcpy HtoD (Pinned -> Device)": 1,
                             "Memcpy DtoH (Device -> Pinned)": 1}
    assert trace_reader.op_seconds(b, "ddc_") == (pytest.approx(150e-6), 2)
    assert b["device_ops"][0] == ["ddc_channel_kernel",
                                  pytest.approx(150e-6)]
    # gaps: [750, 1100] the sync, [450, 700] the copy, [150, 300] none
    assert b["idle_gaps"] == [["cudaEventSynchronize", pytest.approx(350e-6)],
                              ["aten::copy_", pytest.approx(250e-6)],
                              ["nothing traced", pytest.approx(150e-6)]]


def test_a_trace_without_its_window_or_device_work_raises(tmp_path):
    with pytest.raises(RuntimeError):
        trace_reader.breakdown(EVENTS[2:])
    with pytest.raises(RuntimeError):
        trace_reader.breakdown(EVENTS[:2] + EVENTS[-2:])
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    assert len(trace_reader.read_events(str(p))) == len(EVENTS)
