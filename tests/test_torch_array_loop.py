"""The port's reference-scale evidence tools on the CPU:
gpu_sdr_tpu_torch/tools/array_loop.py, the 50-resonator closed loop at
tests/test_resonator_array.py's size (its array, its statistics, and the
JAX package's loop on the same array fitting the same resonators:
f0 within 500 Hz, Qr within 1%), and
gpu_sdr_tpu_torch/tools/phase_coherence.py on a short stream in both
modes (the last block bit for bit the earliest block at the same
position in the comb's period, every channel at its amplitude with no
phase)."""

import os

import pytest
import torch

from gpu_sdr_tpu_torch.tools import array_loop, phase_coherence

torch.set_num_threads(2)


def test_make_array_is_the_jax_tests():
    from test_resonator_array import make_array
    assert array_loop.make_array() == make_array()
    assert (array_loop.N_RESO, array_loop.RATE, array_loop.RF) == (
        50, 4_000_000, 10_000_000)


def jax_loop(workdir):
    """tests/test_resonator_array.py's loop on the JAX package: its
    fits."""
    from gpu_sdr_tpu.client import delay as Udelay
    from gpu_sdr_tpu.client import fitting as Ufit
    from gpu_sdr_tpu.client import vna as Uvna
    from gpu_sdr_tpu.engine.channel import make_resonator_channel
    from test_resonator_array import N_RESO, RATE, RF, make_array
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        chan = make_resonator_channel(RATE, make_array(), fft_len=1 << 14)
        Udelay.set_line_delay(RATE, 512e-6 * 1e9)
        try:
            fn = Uvna.Single_VNA(start_f=-1_800_000, last_f=1_800_000,
                                 measure_t=0.45, n_points=3600, tx_gain=0,
                                 Rate=RATE, RF=RF,
                                 output_filename="vna_array", channel=chan)
            Uvna.VNA_analysis(fn)
        finally:
            Udelay.LINE_DELAY.clear()
        assert Ufit.initialize_peaks(fn, N_peaks=N_RESO, peak_width=30e3,
                                     Qr_cutoff=3, Mag_depth_cutoff=0.5,
                                     exclude_center=False)
        assert Ufit.vna_fit(fn, fit_range=40e3)
        return Ufit.get_fit_param(fn)
    finally:
        os.chdir(cwd)


def test_fifty_resonator_closed_loop(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    r = array_loop.run("cpu", str(tmp_path / "port"))
    assert r["failed_checks"] == [], r
    assert r["peak_count_estimated"] == r["peaks_initialized"] == 50
    from gpu_sdr_tpu_torch.client import fitting
    port = sorted(fitting.get_fit_param(
        str(tmp_path / "port" / "vna_array.h5")), key=lambda p: p["f0"])
    jax = sorted(jax_loop(tmp_path / "jax"), key=lambda p: p["f0"])
    assert len(port) == len(jax) == 50
    for a, b in zip(jax, port):
        assert abs(a["f0"] - b["f0"]) * 1e6 <= 500, (a["f0"], b["f0"])
        assert abs(a["Qr"] - b["Qr"]) <= 0.01 * abs(a["Qr"]), \
            (a["Qr"], b["Qr"])


def test_failed_checks_name_each_statistic():
    good = dict(peak_count_estimated=50, init_ok=True, peaks_initialized=50,
                fit_ok=True, n_fitted=50, distinct_matches=50,
                f0_err_hz=dict(median=200.0, p90=500.0, max=700.0),
                qr_rel_err=dict(median=0.01, within_50pct=1.0),
                tones_rf=10_000_000, n_tones=50, noise_channels=50,
                noise_rows=50, psd_finite=True,
                channels_in_dip_fraction=1.0)
    assert array_loop.failed_checks(good) == []
    bad = dict(good, peak_count_estimated=44, distinct_matches=49,
               f0_err_hz=dict(median=200.0, p90=500.0, max=20_000.0),
               channels_in_dip_fraction=0.9)
    assert array_loop.failed_checks(bad) == [
        "peak count within 5", "each fit on its own resonator",
        "max f0 error < 20 kHz", "> 90% of channels in the dip"]


@pytest.mark.parametrize("freqs, L, period", [
    ((0,), 4_000_000, 1),
    ((-40_000_000, 34_666_666), 4_000_000, 25),
    ((34_666_666,), 400_000, 125),
    ((100_000, -400_000), 4_000_000, 1),
    ((1,), 1, 100_000_000)])
def test_period_blocks(freqs, L, period):
    assert phase_coherence.period_blocks(freqs, L, 100_000_000) == period
    # brute force: the block starts at which every phase repeats
    for f in freqs:
        assert (f * L * period) % 100_000_000 == 0


@pytest.mark.parametrize("mode, kernel, period",
                         [("chain", "chain", 25),
                          ("replay", "replay_ddc_t", 1)])
def test_phase_coherence_short_stream(mode, kernel, period):
    r = phase_coherence.run(mode, gsamples=0.01, device="cpu")
    assert r["kernel"] == kernel and r["launches"] == 0   # the CPU's plain
    assert r["period_blocks"] == period
    assert r["blocks"] == period + 2 and r["compared_block"] == 1
    assert r["bit_identical"] and r["last_vs_first_snr_db"] == "inf"
    n = 16 if mode == "chain" else 8
    assert len(r["amp_err"]) == len(r["phase_err_rad"]) == n
    assert max(r["amp_err"]) < 1e-5 and max(r["phase_err_rad"]) < 1e-5
