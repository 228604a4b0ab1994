#!/usr/bin/env python3
"""Closed-loop science at reference scale on the port (its copy of
tools/hw_array_loop.py): a 50-resonator simulated array driven end to
end on `--device` -- wide VNA sweep (chirp synthesis and lock-in) ->
S21 analysis -> extimate_peak_number -> initialize_peaks -> vna_fit ->
get_tones -> 50-tone DIRECT noise readout at the fitted tones -- with
the statistics tests/test_resonator_array.py asserts checked here
(``failed_checks``).

Run:  python -m gpu_sdr_tpu_torch.tools.array_loop --device cuda
Prints one JSON line: peak-count recovery, f0 / Qr error statistics,
each step's seconds and the checks that failed (none, on success).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

N_RESO = 50
RATE = int(4e6)
RF = 10_000_000


def make_array(seed=7):
    """50 resonators in two bands clear of the carrier (+-0.12..1.6 MHz
    baseband), ~59 kHz pitch with jitter (min gap ~49 kHz), linewidth
    f0/Qr ~= 8-12 kHz, dip depth ~6 dB (the port's copy of
    tests/test_resonator_array.py's array).  Qr carries f0's sign, so a
    negative baseband f0 keeps the physical line shape; the absolute
    quality factor is Qr * (RF + f0) / f0 > 0."""
    rng = np.random.default_rng(seed)
    slots = np.concatenate([np.linspace(-1.6e6, -0.12e6, N_RESO // 2),
                            np.linspace(0.12e6, 1.6e6, N_RESO // 2)])
    f0s = slots + rng.uniform(-5e3, 5e3, N_RESO)
    resos = []
    for f0 in sorted(f0s):
        Qr = f0 / rng.uniform(8e3, 12e3)
        resos.append(dict(f0=float(f0), Qr=float(Qr),
                          Qe_re=float(2.0 * Qr)))
    return resos


def failed_checks(r: dict) -> list:
    """The statistics tests/test_resonator_array.py asserts, each that
    does not hold on result `r` named."""
    checks = [
        ("peak count within 5", abs(r["peak_count_estimated"] - N_RESO) <= 5),
        ("every resonator initialized",
         r["init_ok"] and r["peaks_initialized"] == N_RESO),
        ("every resonator fitted", r["fit_ok"] and r["n_fitted"] == N_RESO),
        ("each fit on its own resonator", r["distinct_matches"] == N_RESO),
        ("median f0 error < 3 kHz", r["f0_err_hz"]["median"] < 3_000),
        ("p90 f0 error < 10 kHz", r["f0_err_hz"]["p90"] < 10_000),
        ("max f0 error < 20 kHz", r["f0_err_hz"]["max"] < 20_000),
        ("median Qr error < 20%", r["qr_rel_err"]["median"] < 0.2),
        ("Qr within 50% on > 90%", r["qr_rel_err"]["within_50pct"] > 0.9),
        ("tones at RF, one a resonator",
         r["tones_rf"] == RF and r["n_tones"] == N_RESO),
        ("noise channels", r["noise_channels"] == N_RESO and
         r["noise_rows"] == N_RESO),
        ("PSDs finite", r["psd_finite"]),
        ("> 90% of channels in the dip",
         r["channels_in_dip_fraction"] > 0.9)]
    return [name for name, ok in checks if not ok]


def run(device="cuda", workdir=None) -> dict:
    """The loop in `workdir` (a new temporary folder by default): the
    JSON line's dict."""
    from gpu_sdr_tpu_torch.client import delay as Udelay
    from gpu_sdr_tpu_torch.client import files as Ufiles
    from gpu_sdr_tpu_torch.client import fitting as Ufit
    from gpu_sdr_tpu_torch.client import noise as Unoise
    from gpu_sdr_tpu_torch.client import vna as Uvna
    from gpu_sdr_tpu_torch.config import resolve_device
    from gpu_sdr_tpu_torch.engine.channel import make_resonator_channel

    device = str(resolve_device(device))
    workdir = workdir or tempfile.mkdtemp(prefix="array_loop_")
    cwd = os.getcwd()
    os.chdir(workdir)
    seconds = {}
    try:
        t0 = time.perf_counter()
        resos = make_array()
        chan = make_resonator_channel(RATE, resos, fft_len=1 << 14)
        Udelay.set_line_delay(RATE, 512e-6 * 1e9)
        try:
            fn = Uvna.Single_VNA(start_f=-1_800_000, last_f=1_800_000,
                                 measure_t=0.45, n_points=3600, tx_gain=0,
                                 Rate=RATE, RF=RF,
                                 output_filename="vna_array", channel=chan,
                                 device=device)
            Uvna.VNA_analysis(fn)
        finally:
            Udelay.LINE_DELAY.clear()
        t1 = time.perf_counter()
        seconds["vna"] = t1 - t0

        n_est = Ufit.extimate_peak_number(fn, threshold=0.1,
                                          peak_width=30e3,
                                          exclude_center=False)
        ok_init = Ufit.initialize_peaks(fn, N_peaks=N_RESO, peak_width=30e3,
                                        Qr_cutoff=3, Mag_depth_cutoff=0.5,
                                        exclude_center=False)
        n_init = len(Ufiles.get_init_peaks(fn))
        ok_fit = Ufit.vna_fit(fn, fit_range=40e3)
        params = Ufit.get_fit_param(fn)
        t2 = time.perf_counter()
        seconds["fit"] = t2 - t1

        # nearest-truth matching, robust to ordering
        got = np.array([1e6 * p["f0"] for p in params])
        truth_by_f0 = sorted(resos, key=lambda r: RF + r["f0"])
        truth = np.array([RF + r["f0"] for r in truth_by_f0])
        d = np.abs(got[:, None] - truth[None, :])
        assign = d.argmin(axis=1)
        f0_err = d.min(axis=1)
        qr_rel = []
        for p, ti in zip(params, assign):
            r = truth_by_f0[ti]
            qr_true_abs = r["Qr"] * (RF + r["f0"]) / r["f0"]
            qr_rel.append(abs(p["Qr"] - qr_true_abs) / qr_true_abs)
        qr_rel = np.asarray(qr_rel)

        rf, rel_tones = Ufit.get_tones(fn)
        nf = Unoise.Get_noise(list(rel_tones), measure_t=0.2, rate=RATE,
                              decimation=500, RF=RF, mode="DIRECT",
                              output_filename="noise_array", channel=chan,
                              device=device)
        Unoise.calculate_noise(nf, welch=2, backend="torch", device=device)
        ninfo, _freq, real, imag = Ufiles.get_noise(nf)
        data = Ufiles.openH5file(nf)
        steady = np.abs(data[:, 8:]).mean(axis=1)
        seconds["noise"] = time.perf_counter() - t2
    finally:
        os.chdir(cwd)

    r = {
        "device": device,
        "n_resonators": N_RESO,
        "peak_count_estimated": int(n_est),
        "peaks_initialized": int(n_init),
        "init_ok": bool(ok_init),
        "fit_ok": bool(ok_fit),
        "n_fitted": len(params),
        "distinct_matches": len(set(assign.tolist())),
        "f0_err_hz": {"median": float(np.median(f0_err)),
                      "p90": float(np.percentile(f0_err, 90)),
                      "max": float(np.max(f0_err))},
        "qr_rel_err": {"median": float(np.median(qr_rel)),
                       "p90": float(np.percentile(qr_rel, 90)),
                       "within_50pct": float(np.mean(qr_rel < 0.5))},
        "tones_rf": int(rf),
        "n_tones": len(rel_tones),
        "noise_channels": int(ninfo["n_chan"]),
        "noise_rows": int(data.shape[0]),
        "psd_finite": bool(all(np.isfinite(x).all() for x in real) and
                           all(np.isfinite(x).all() for x in imag)),
        "channels_in_dip_fraction": float(np.mean(steady < 0.95)),
        "seconds": seconds,
        "workdir": workdir,
    }
    r["failed_checks"] = failed_checks(r)
    return r


def main():
    parser = argparse.ArgumentParser(
        description="50-resonator closed loop: VNA -> fit -> noise.")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--folder", type=str, default=None,
                        help="working folder (default: a new temporary one)")
    args = parser.parse_args()
    from gpu_sdr_tpu_torch.scripts import _cli
    _cli.report_from_env()
    r = run(args.device, args.folder)
    print(json.dumps(r), flush=True)
    return 0 if not r["failed_checks"] else 1


if __name__ == "__main__":
    sys.exit(main())
