"""The reader of the share of packets a CUDA graph replay issued,
``graph_block_share``: 100 times the program's ``graph_blocks`` counter
over its ``sdr.inflight`` count on a synthetic record; nothing from a
record without spans (the recorder off) or without the counter (a
program without the graphs); 0 from a real window call on the CPU,
where no graph is captured."""

import types

import pytest

import harness
from conftest import SMALL

import gpu_sdr_tpu_torch.measure as measure
from gpu_sdr_tpu_torch import spans

NAME = "graph_block_share"
SPEC = harness.load_spec()


def _read(record):
    return harness.metric_reader(NAME).read(
        types.SimpleNamespace(measure_run=record, trace=None))


def _record(blocks, packets):
    return {"seconds": 1.0,
            "spans": {"sdr.inflight": {"count": packets, "seconds": 0.1},
                      "sdr.loop.block": {"count": -(-packets // 8)}},
            "counters": {"graph_blocks": blocks, "launches": {}}}


@pytest.mark.parametrize("blocks, packets", [(0, 10), (9984, 10000),
                                             (40, 53), (8, 8)])
def test_the_share_of_a_synthetic_record(blocks, packets):
    assert _read(_record(blocks, packets)) == \
        pytest.approx(100.0 * blocks / packets)


def test_nothing_without_spans_or_the_counter():
    rec = _record(40, 53)
    assert _read({k: v for k, v in rec.items()
                  if k not in ("spans", "counters")}) is None
    assert _read({**rec, "counters": {"launches": {}}}) is None
    assert _read({**rec, "spans": {}}) is None


def test_a_cpu_window_call_reads_0():
    with spans.recording():
        out = harness.run("direct100.replay", 2 ** 31 + 28, 0.4, False,
                          device="cpu", need_card=False,
                          cfg_over=SMALL["direct100"])
    assert out["correct"], out["checks"]
    assert _read(measure.RUNS[-1]) == 0.0


def test_the_entry():
    (m,) = [m for m in SPEC["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("%", "higher", "program_counter", "drain",
                                "msps", ["direct100.replay",
                                         "tones1000.replay"])
    assert SPEC["per_layer"][-1] is m
