"""The benchmark's own tests: `python3 -m pytest benchmark/tests` from
the root of a checkout.  The tests marked ``chip`` need a CUDA card and
skip without one; on the card, `python3 -m pytest benchmark/tests -m
chip` runs them."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

# the small configurations the CPU tests run the harness at
SMALL = {
    "direct100": {"rx": {"buffer_len": 50_000,
                         "freq": [-30_000_000, -3_000_000, 1_000_000,
                                  2_500_000, 4_000_000, 9_000_000,
                                  12_000_000, 20_000_000, 44_090_909]},
                  "recording_blocks": {"host": 4, "device": 4}},
    "vna_chirp": {"rx": {"buffer_len": 100_000, "chirp_t": [0.01],
                         "swipe_s": [50]},
                  "recording_blocks": {"host": 10, "device": 10}},
}


# cells built and proven correct whose rates spread too widely on the
# card's host to hold a bound: not in BENCHMARK.json, kept for later
UNLISTED = {
    "configs": [{"name": "vna_chirp", "reduced": [], "source": "",
                 "file": "benchmark/configs/vna_chirp.json", "why": ""}],
    "workloads": [
        {"name": "direct100.stream", "config": "direct100",
         "traffic": "stream", "chips": 1, "why": ""},
        {"name": "vna_chirp.stream", "config": "vna_chirp",
         "traffic": "stream", "chips": 1, "why": ""}],
}


def full_spec():
    """BENCHMARK.json with the unlisted cells."""
    import harness
    spec = harness.load_spec()
    return {**spec, **{k: spec[k] + v for k, v in UNLISTED.items()}}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test on a machine without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
