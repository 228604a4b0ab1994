"""The readers of the program's spans and counters: each reads the
record of a real window call on the CPU (a small run of its cell with
the program's recorder on), and nothing from a record without spans,
as a traced run of a program without the recorder gives."""

import types

import pytest

import harness
from conftest import SMALL

import gpu_sdr_tpu_torch.measure as measure
from gpu_sdr_tpu_torch import spans

SPEC = harness.load_spec()
READERS = {
    "direct100.realtime": ["inflight_hold_ms", "allocs_per_kblock"],
    "direct100.replay": ["host_loop_ms_per_block", "step_ms_per_block",
                         "fetch_wait_ms_per_block"],
}


def _record(workload):
    """The window call's measure.RUNS record of a small CPU run of
    `workload`, the recorder on."""
    mix = {"rate_msps": 10} if workload.endswith("realtime") else None
    with spans.recording():
        out = harness.run(workload, 2 ** 31 + 5, 0.4, False, device="cpu",
                          need_card=False, cfg_over=SMALL["direct100"],
                          mix_over=mix)
    assert out["correct"], out["checks"]
    return measure.RUNS[-1]


def _ctx(record):
    return types.SimpleNamespace(measure_run=record, trace=None)


@pytest.mark.parametrize("workload", sorted(READERS))
def test_the_readers_read_a_real_record(workload):
    rec = _record(workload)
    s, c = rec["spans"], rec["counters"]
    got = {n: harness.metric_reader(n).read(_ctx(rec))
           for n in READERS[workload]}
    want = {
        "inflight_hold_ms": 1e3 * s["sdr.inflight"]["p50_seconds"],
        "allocs_per_kblock": 0.0,       # no caching allocator off a card
        "host_loop_ms_per_block": 1e3 * s["sdr.loop.block"]["p50_seconds"],
        "step_ms_per_block": 1e3 * s["sdr.loop.step"]["p50_seconds"],
        "fetch_wait_ms_per_block": 1e3 * s["sdr.drain.wait"]["seconds"] /
        s["sdr.drain.wait"]["count"],
    }
    for name, v in got.items():
        assert v == pytest.approx(want[name]) and v >= 0, name
    assert c["device_segments"] == c["pinned_allocs"] == 0
    with_allocs = {**rec, "counters": {**c, "device_segments": 3,
                                       "pinned_allocs": 2}}
    blocks = s["sdr.loop.block"]["count"]
    assert harness.metric_reader("allocs_per_kblock").read(
        _ctx(with_allocs)) == pytest.approx(5e3 / blocks)
    bare = {k: v for k, v in rec.items() if k not in ("spans", "counters")}
    for name in READERS[workload]:
        assert harness.metric_reader(name).read(_ctx(bare)) is None, name


def test_a_reader_is_per_layer_in_its_cells_only():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    for cell, names in READERS.items():
        for name in names:
            m = per_layer[name]
            assert m["workloads"] == [cell]
            assert m["source"] in ("program_span", "program_counter")
            assert name not in {e["name"] for e in SPEC["end_to_end"]}
