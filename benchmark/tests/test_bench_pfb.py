"""The PFB configuration (``tones1000``): its plain reference against a
direct float64 sum, the kernels' counts at the cells' shapes, its cells
and metrics found by name, the program's PFB spans in a real window
call's record, and on the card the float16 control and a short run of
each cell."""

import json
import math
import os
import types

import numpy as np
import pytest
import torch

import control
import harness
import pfb_roofline
from configs import pfb

import gpu_sdr_tpu_torch.measure as measure
from gpu_sdr_tpu_torch import spans

SPEC = harness.load_spec()
# the host path's cell, built and correct, whose p50 spreads too widely
# on the card's host to hold its bound: not in BENCHMARK.json
REALTIME = {"name": "tones1000.realtime", "config": "tones1000",
            "traffic": "realtime", "chips": 1, "why": ""}
WITH_REALTIME = {**SPEC, "workloads": SPEC["workloads"] + [REALTIME]}
CELLS = ["tones1000.replay", "tones1000.realtime"]
# 46 frames of 1111: the planner's smallest block (its floor is 5e4)
SMALL = {"rx": {"buffer_len": 51_106},
         "recording_blocks": {"host": 3, "device": 3}}
SEEDS = [7, 2 ** 31 + 11, 987_654_323]
RNG = np.random.default_rng(24)


def _rx():
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "tones1000.json")) as fh:
        return json.load(fh)["rx"]


def _cfg_small():
    return {"rx": {"rate": 1000, "buffer_len": 60, "fft_tones": 12,
                   "pf_average": 3, "decim": 0,
                   "freq": [-417, -240, 40, 120, 333]},
            "input": {"tone_amplitude": [0.5, 1.0], "noise_rms": 0.1}}


def test_the_window_is_the_windowed_sinc():
    w = pfb.pfb_window(1111, 4)
    assert w.shape == (4444,) and abs(w.sum() - 1.0) < 1e-12
    n, fc, i = 4444, 1 / 2222, 1234
    k = np.arange(n) - (n - 1) // 2
    sinc = np.array([2 * fc if j == 0 else
                     2 * fc * math.sin(2 * math.pi * fc * j) /
                     (2 * math.pi * fc * j) for j in k])
    ham = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    assert w[i] == pytest.approx(sinc[i] * ham[i] / (sinc * ham).sum(),
                                 rel=1e-12)


def test_tone_bins_are_the_reference_mapping():
    """The last axis point within a bin's width of the tone (of the two
    around it, the upper), shifted by nfft//2: one tone a bin here."""
    rx = _cfg_small()["rx"]
    assert pfb.tone_bins(rx["freq"], 1000, 12).tolist() == [7, 10, 1, 2, 4]
    assert pfb.tone_bins([600], 1000, 12).tolist() == [0]   # outside


@pytest.mark.parametrize("k", [0, 1, 4, 5])
def test_pfb_reference_is_the_float64_sum(k):
    cfg = _cfg_small()
    rx = cfg["rx"]
    L, N, avg = rx["buffer_len"], rx["fft_tones"], rx["pf_average"]
    rec = (RNG.standard_normal(3 * L) +
           1j * RNG.standard_normal(3 * L)).astype(np.complex64)
    y = pfb.Reference(cfg, rec, torch.device("cpu")).output(k).numpy()
    w = pfb.pfb_window(N, avg)
    stream = np.concatenate([rec] * (k // 3 + 2)).astype(np.complex128)
    bins = pfb.tone_bins(rx["freq"], rx["rate"], N)

    def x(a):                           # the looped stream, zero before 0
        return stream[a] if a >= 0 else 0.0
    want = np.zeros((L // N, len(bins)), np.complex128)
    for t in range(L // N):
        for c, b in enumerate(bins):
            for s in range(N):
                pre = sum(w[i * N + s] * x(k * L + (t + i - avg + 1) * N + s)
                          for i in range(avg))
                want[t, c] += pre * np.exp(-2j * np.pi * s * b / N)
    assert np.max(np.abs(y - want)) < 1e-12 * np.max(np.abs(want))


def test_pfb_recording_is_the_seeded_comb():
    cfg = _cfg_small()
    cfg["input"]["noise_rms"] = 0.0
    a = pfb.make_recording(cfg, 2 ** 33 + 5, 2, "cpu").numpy()
    assert np.array_equal(a, pfb.make_recording(cfg, 2 ** 33 + 5, 2,
                                                "cpu").numpy())
    n = np.arange(120)
    basis = np.exp(2j * np.pi * np.outer(n, cfg["rx"]["freq"]) / 1000)
    coef, *_ = np.linalg.lstsq(basis, a.astype(np.complex128), rcond=None)
    assert np.linalg.norm(basis @ coef - a) < 1e-5 * np.linalg.norm(a)
    assert np.all((np.abs(coef) > 0.5 - 1e-5) & (np.abs(coef) < 1 + 1e-5))


def test_pfb_counts_at_the_cells_shapes():
    """#2 and #4 at 900 frames of 1111, avg 4: the block, its 3333-sample
    halo, the 4444-tap window and the (900, 1111) output, 16.04 MB;
    16 operations a sample, and 5 N log2 N a frame for #4.  Both bound
    by their bytes, 4.79 us a call."""
    rx = _rx()
    n_bytes = 8 * (999_900 + 3333) + 4 * 4444 + 8 * 900 * 1111
    assert pfb_roofline.presum_counts(rx) == (n_bytes, 16 * 999_900)
    nb, flops = pfb_roofline.channelizer_counts(rx)
    assert nb == n_bytes == 16_042_840
    assert flops == pytest.approx(16 * 999_900 +
                                  5 * 1111 * math.log2(1111) * 900)
    for counts in (pfb_roofline.presum_counts(rx), (nb, flops)):
        assert pfb_roofline.bound_s(*counts) == pytest.approx(
            n_bytes / 3.35e12)
    assert pfb_roofline.bound_s(nb, flops) * 1e6 == pytest.approx(4.789,
                                                                  abs=1e-3)


def _trace():
    ops = {"Memcpy HtoD (Pinned -> Device)": 0.2,
           "Memcpy DtoH (Device -> Pinned)": 0.15,
           "channelizer_kernel": 0.02, "presum_ring": 0.01,
           "prime_fft_factor": 0.03, "regular_fft_factor": 0.01,
           "indexSelectLargeIndex": 0.004}
    return dict(window_s=2.0, busy_s=0.5, packets=1000, op_s=ops,
                launches={k: 1000 for k in ops})


def test_the_pfb_trace_readers():
    t = types.SimpleNamespace(trace=_trace(), cfg={"rx": _rx()},
                              measure_run={})
    rd = harness.metric_reader
    bound = 16_042_840 / 3.35e12
    assert rd("channelizer_roofline_pct").read(t) == pytest.approx(
        100 * bound / 2e-5)
    empty = types.SimpleNamespace(
        trace=dict(window_s=1.0, busy_s=0.1, op_s={}, launches={},
                   packets=10), cfg={"rx": {}}, measure_run={})
    assert rd("channelizer_roofline_pct").read(empty) is None
    assert rd("channelizer_roofline_pct").read(types.SimpleNamespace(
        trace=None, cfg={"rx": {}}, measure_run={})) is None


def test_the_new_cells_and_metrics_are_found_by_name():
    for cell in CELLS:
        c, entry = harness.find_cell(WITH_REALTIME, cell)
        assert entry["name"] == "tones1000" and c["chips"] == 1
        cfg = harness.load_config(entry)
        assert harness.reference_module(cfg).Reference is not None
        mix = harness.load_mix(c["traffic"])
        assert cfg["dispatch"][mix["path"]] == (
            "channelizer_at" if cell.endswith("replay") else None)
    assert "tones1000.realtime" not in {c["name"] for c in SPEC["workloads"]}
    assert [m["name"] for m in harness.cell_metrics(
        SPEC, "tones1000.replay", "end_to_end")] == ["msps", "setup_s"]
    layer = {m["name"]: m for m in harness.cell_metrics(
        SPEC, "tones1000.replay", "per_layer")}
    assert set(layer) == {"channelizer_roofline_pct", "d2h_ms_per_block",
                          "device_idle_pct"}
    c = layer["channelizer_roofline_pct"]
    assert (c["layer"], c["moves"], c["workloads"]) == (
        "kernels", "msps", ["tones1000.replay"])


@pytest.mark.parametrize("workload", CELLS)
def test_the_pfb_spans_in_a_window_call(workload):
    """A small CPU run of each cell, the recorder on: the window call's
    record holds the path's ``sdr.pfb.*`` spans, one a block, inside
    ``sdr.loop.step``, and the ``fft_plans`` counter at 0; with the
    recorder off it holds neither."""
    mix = {"rate_msps": 10} if workload.endswith("realtime") else None
    with spans.recording():
        out = harness.run(workload, 2 ** 31 + 24, 0.4, False, device="cpu",
                          need_card=False, cfg_over=SMALL, mix_over=mix,
                          spec=WITH_REALTIME)
    assert out["correct"], out["checks"]
    rec = measure.RUNS[-1]
    s = rec["spans"]
    names = {k for k in s if k.startswith("sdr.pfb.")}
    assert names == ({"sdr.pfb.channelize", "sdr.pfb.select"}
                     if workload.endswith("replay") else
                     {"sdr.pfb.presum", "sdr.pfb.fft", "sdr.pfb.select"})
    blocks = s["sdr.loop.block"]["count"]
    assert all(s[n]["count"] == blocks for n in names)
    assert rec["counters"]["fft_plans"] == 0
    assert sum(s[n]["seconds"] for n in names) <= \
        s["sdr.loop.step"]["seconds"]
    harness.run(workload, 2 ** 31 + 24, 0.4, False, device="cpu",
                need_card=False, cfg_over=SMALL, mix_over=mix,
                spec=WITH_REALTIME)
    bare = measure.RUNS[-1]
    assert "spans" not in bare and "counters" not in bare


@pytest.mark.chip
@pytest.mark.parametrize("idx, valid", [(0, 0), (1, 1), (0, 1)])
def test_the_channelizer_at_the_cells_shapes(card, idx, valid):
    """#4 (csrc/channelizer.cu, its two prime passes 11 and 101) on 900
    frames of 1111 of a 3-block recording, at the stream's start, inside
    and across the loop seam, against the float64 PFB of the same frames:
    every bin within 1e-5 of the block's rms."""
    from gpu_sdr_tpu_torch.ops.channelizer import (channelizer_at,
                                                   channelizer_consts)
    from gpu_sdr_tpu_torch.ops.pfb import PFBConfig
    nfft, avg, T = 1111, 4, 900
    consts = channelizer_consts(PFBConfig(nfft=nfft, avg=avg,
                                          rate=100_000_000), card)
    g = torch.Generator(device=card).manual_seed(2424)
    X = torch.randn((3 * T, nfft), generator=g, dtype=torch.complex64,
                    device=card)
    y = channelizer_at(*consts, X, idx, valid, T).to(torch.complex128)
    rows = torch.arange(idx * T - avg + 1, (idx + 1) * T, device=card)
    ext = X.to(torch.complex128)[rows % (3 * T)]
    if not valid:
        ext[:avg - 1] = 0
    w = torch.from_numpy(pfb.pfb_window(nfft, avg)).to(card).reshape(
        avg, nfft)
    pre = sum(ext[i:i + T] * w[i] for i in range(avg))
    ref = torch.fft.fft(pre, dim=-1)
    rms = ref.abs().pow(2).mean().sqrt()
    assert float((y - ref).abs().max() / rms) < 1e-5


@pytest.mark.chip
def test_the_float16_control_is_not_correct(card):
    _, entry = harness.find_cell(SPEC, "tones1000.replay")
    limit = harness.load_config(entry)["limits"]["rel_err"]
    for seed, r in control.readings("tones1000.replay", SEEDS, 20_000):
        assert r["bad_packets"] == 0
        assert r["rel_err"] > 10 * limit, (seed, r)


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_pfb_run_is_correct(card, workload):
    out = harness.run(workload, 2 ** 31 + 2424, 2.0, False,
                      spec=WITH_REALTIME)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["failed"] == 0
