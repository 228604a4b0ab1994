"""The operation and byte counts of the kernels a cell runs, at its
1M-sample blocks."""

import json
import os

import pytest

import roofline

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rx(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        return json.load(fh)["rx"]


def test_ddc_counts_at_1m():
    """#7 and #8: 10,000 rows x 100 channels x 400 taps; a quarter of
    the chip smoke's 12.85 GFLOP at 4M-sample blocks."""
    n_bytes, flops = roofline.ddc_counts(_rx("direct100"))
    assert flops == 10_000 * 100 * (8 * 400 + 12) == 3_212_000_000
    assert n_bytes == 8 * (1_000_000 + 300 + 400 * 100 + 2 * 10_000 * 100) \
        + 800
    assert roofline.bound_s(n_bytes, flops) == pytest.approx(
        flops / 67e12)                          # bound by its operations
    assert roofline.bound_s(n_bytes, flops) * 1e3 == pytest.approx(
        0.0479, abs=1e-4)


def test_lockin_counts_at_1m():
    """#17: 50 segments of 20,000 samples, the block and its table
    rows; a quarter of the chip smoke's 64.1 MB at 4M-sample blocks."""
    rx = _rx("vna_chirp")
    assert roofline.chirp_ppt(rx) == 20_000
    n_bytes, flops = roofline.lockin_table_counts(rx)
    assert n_bytes == 16_000_000 + 80_000 + 400
    assert flops == 10_000_000
    assert roofline.bound_s(n_bytes, flops) == pytest.approx(
        n_bytes / 3.35e12)                      # bound by its bytes
