"""The whole run on the CPU at a small size, the look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, not correct, once for each fault a cell can have."""

import dataclasses

import pytest
import torch

import harness
from conftest import SMALL, full_spec

import gpu_sdr_tpu_torch.measure as measure
from gpu_sdr_tpu_torch.engine.replay import DeviceReplay

CELLS = ["direct100.stream", "direct100.realtime", "vna_chirp.stream",
         "direct100.replay"]


def _run(workload):
    cfg = SMALL[workload.split(".")[0]]
    mix = {"rate_msps": 10} if workload.endswith("realtime") else None
    return harness.run(workload, 2 ** 32 + 17, 0.4, False, device="cpu",
                       need_card=False, cfg_over=cfg, mix_over=mix,
                       spec=full_spec())


def _state_unchanged(step):
    def broken(state, *x):
        return state, step(state, *x)[1]
    return broken


def _half_left_out(step):
    """Half the block left out, the mean taken over the rest."""
    def broken(state, x):
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return step(state, 2 * x)
    return broken


def _half_rows_left_out(step):
    """A replay's half of the rows left out, the rest doubled."""
    def broken(state):
        state, y = step(state)
        y = 2 * y
        y[y.shape[0] // 2:] = 0
        return state, y
    return broken


def _answer_altered(step):
    def broken(state, *x):
        state, y = step(state, *x)
        y = y.clone()
        y[0, 0] = -y[0, 0]
        return state, y
    return broken


HOST_FAULTS = {"state_unchanged": _state_unchanged,
               "half_left_out": _half_left_out,
               "answer_altered": _answer_altered}
REPLAY_FAULTS = {"state_unchanged": _state_unchanged,
                 "half_left_out": _half_rows_left_out,
                 "answer_altered": _answer_altered}


def _plant(monkeypatch, workload, fault):
    if workload.endswith("replay"):
        step = DeviceReplay.step
        broken = REPLAY_FAULTS[fault]
        monkeypatch.setattr(DeviceReplay, "step",
                            lambda self, s: broken(
                                lambda st: step(self, st))(s))
        return
    make = measure.make_demodulator

    def wrapped(*a, **kw):
        d = make(*a, **kw)
        return dataclasses.replace(d, step=HOST_FAULTS[fault](d.step))
    monkeypatch.setattr(measure, "make_demodulator", wrapped)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 3
    assert list(out["checks"]) == ["rel_err", "missing_packets",
                                   "misordered_packets", "bad_packets",
                                   "packet_errors", "dispatch_mismatch"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["rel_err"]["value"] < \
        out["checks"]["rel_err"]["limit"] / 5


@pytest.mark.parametrize("fault", list(HOST_FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    _plant(monkeypatch, workload, fault)
    out = _run(workload)
    assert not out["correct"]
    assert out["checks"]["rel_err"]["value"] > \
        10 * out["checks"]["rel_err"]["limit"]


def test_the_check_runs_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoCard):
        harness.check_card(1)
