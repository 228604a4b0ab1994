"""BENCHMARK.json against the files the harness finds by name, and the
rules of its contract that a file can be checked against."""

import json
import os
import re

import pytest

import harness

ROOT = os.path.dirname(harness.BENCH_DIR)
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_are_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith(
        "benchmark/configs/")
    cfg = harness.load_config(entry)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["limits"]["rel_err"] is not None
    assert {"assumed", "rx", "kind", "recording_blocks", "dispatch"} <= \
        set(cfg)
    mod = harness.reference_module(cfg)
    assert callable(mod.make_recording) and hasattr(mod, "Reference")
    assert any(c["config"] == entry["name"] for c in SPEC["workloads"])
    assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cells_are_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    _, entry = harness.find_cell(SPEC, cell["name"])
    cfg = harness.load_config(entry)
    mix = harness.load_mix(cell["traffic"])
    assert mix["path"] in cfg["dispatch"]
    assert mix["recording"] in cfg["recording_blocks"]
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell["name"],
                                                   "end_to_end")}
    layer = harness.cell_metrics(SPEC, cell["name"], "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


def test_pairs_and_names_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    assert len(set(CELLS)) == len(CELLS)


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_are_found_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(harness.metric_reader(m["name"]).read)
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_setup_s_is_everywhere():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    assert [m["name"] for m in harness.cell_metrics(SPEC, "direct100.replay",
                                                    "end_to_end")] == \
        ["msps", "setup_s"]
    assert [m["name"] for m in harness.cell_metrics(
        SPEC, "direct100.realtime", "end_to_end")] == \
        ["block_latency_p50_ms", "setup_s"]


def test_a_layer_has_one_name():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    assert set(by_layer) == {"entry", "kernels", "fetch", "drain", "device"}


def test_mixes_are_data():
    mixes = os.listdir(os.path.join(harness.BENCH_DIR, "mixes"))
    assert all(n.endswith(".json") for n in mixes)
    for c in SPEC["workloads"]:
        assert f"{c['traffic']}.json" in mixes
        json.loads(open(os.path.join(harness.BENCH_DIR, "mixes",
                                     f"{c['traffic']}.json")).read())
