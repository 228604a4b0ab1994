"""Nothing the harness imports is JAX or the JAX package (top-level
names compared whole), and a run without a card or without the program
prints no result."""

import os
import shutil
import subprocess
import sys

import harness

ROOT = os.path.dirname(harness.BENCH_DIR)

PROBE = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import harness, control, roofline, stats, trace_reader, traffic
spec = harness.load_spec()
for e in spec["configs"]:
    harness.reference_module(harness.load_config(e))
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.metric_reader(m["name"])
import gpu_sdr_tpu_torch.measure
print(sorted({m.split(".")[0] for m in sys.modules}))
print(harness.forbidden_modules())
"""


def test_the_harness_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(harness.BENCH_DIR), ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "'gpu_sdr_tpu_torch'" in tops
    for name in harness.FORBIDDEN:
        assert f"'{name}'" not in tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpu_sdr_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert "gpu_sdr_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gpu_sdr_tpu.engine", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    found = harness.forbidden_modules()
    assert "gpu_sdr_tpu.engine" in found and "jax.numpy" in found
    assert "jaxlike.sub" not in found


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "direct100.replay", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
