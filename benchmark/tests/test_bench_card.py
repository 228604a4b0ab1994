"""On the card: each cell's control comes out not correct at the cell's
own size, and a short run of each cell comes out correct.

    python3 -m pytest benchmark/tests -m chip
"""

import pytest

import control
import harness

SPEC = harness.load_spec()
CONTROL_CELLS = ["direct100.replay"]
SEEDS = [5, 2 ** 31 + 3, 987_654_321]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CONTROL_CELLS)
def test_the_control_is_not_correct(card, workload):
    _, entry = harness.find_cell(SPEC, workload)
    limit = harness.load_config(entry)["limits"]["rel_err"]
    for seed, r in control.readings(workload, SEEDS, 20_000):
        assert r["bad_packets"] == 0
        assert r["rel_err"] > 3 * limit, (seed, r)


@pytest.mark.chip
@pytest.mark.parametrize("workload", [c["name"] for c in SPEC["workloads"]])
def test_a_short_run_is_correct(card, workload):
    out = harness.run(workload, 2 ** 31 + 77, 2.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["failed"] == 0
