"""Resonator fitting (a copy of gpu_sdr_tpu/client/fitting.py, which
mirrors pyUSRP/USRP_fitting.py).

Implements the same nonlinear (bifurcation-aware) resonator model with cable
delay and phase (nonlinear_model, USRP_fitting.py:76-125), the scipy
curve_fit wrapper with FWHM-based initialization (do_fit, :142-193), the
gradient-based peak finder (extimate_peak_number, :197-377), the iterative
fit-and-filter initializer (initialize_peaks, :380-586), and vna_fit
(:619-715) writing the Resonators/reso_<i> groups.
"""

from __future__ import annotations

from typing import List

from . import h5
import numpy as np
from scipy import optimize, signal

from . import files as Ufiles
from .files import bound_open, format_filename, get_rx_info, get_VNA_data


def vrms2dbm(vp):
    """Volts RMS -> dBm at 50 Ohm (reference USRP_low_level.py:210)."""
    return 10.0 * np.log10(20.0 * np.asarray(vp) ** 2)


def dbm2vrms(dbm):
    return np.sqrt((10.0 ** (np.asarray(dbm) / 10.0)) / 20.0)


def real_of_complex(z):
    return np.hstack((z.real, z.imag))


def complex_of_real(r):
    n = r.size // 2
    return r[:n] + 1j * r[n:]


def nonlinear_model(f, f0, A, phi, D, dQr, dQe_re, dQe_im, a):
    """Nonlinear resonator S21 model (reference nonlinear_model,
    pyUSRP/USRP_fitting.py:76-125).  f in Hz, f0 in MHz; returns
    real_of_complex(S21)."""
    f0 = f0 * 1e6
    cable_phase = np.exp(2.0j * np.pi * (1e-6 * D * (f - f0) + phi))
    dQe = dQe_re + 1.0j * dQe_im

    x0 = (f - f0) / f0
    y0 = x0 / dQr
    k2 = np.sqrt((y0 ** 3 / 27.0 + y0 / 12.0 + a / 8.0) ** 2 -
                 (y0 ** 2 / 9.0 - 1 / 12.0) ** 3, dtype=np.complex128)
    k1 = np.power(a / 8.0 + y0 / 12.0 + k2 + y0 ** 3 / 27.0, 1.0 / 3)
    eps = (-1.0 + 3 ** 0.5 * 1j) / 2.0

    with np.errstate(divide="ignore", invalid="ignore"):
        y1 = y0 / 3.0 + (y0 ** 2 / 9.0 - 1 / 12.0) / k1 + k1
        y2 = y0 / 3.0 + (y0 ** 2 / 9.0 - 1 / 12.0) / eps / k1 + eps * k1

    zero_k1 = np.abs(k1) == 0.0
    y1[zero_k1] = y0[zero_k1] / 3.0
    y2[zero_k1] = y0[zero_k1] / 3.0

    # pick the right bifurcation branch depending on sweep direction
    thresh = 1e-4
    low_to_high = np.all(np.diff(f) > 0)
    if low_to_high:
        y = y2.real
        mask = np.abs(y2.imag) >= thresh
        y[mask] = y1.real[mask]
    else:
        y = y1.real
        mask = np.abs(y1.imag) >= thresh
        y[mask] = y2.real[mask]

    x = y * dQr
    s21 = A * cable_phase * (1.0 - dQe / (dQr + 2.0j * x))
    return real_of_complex(s21)


def S21_func(f, f0, A, phi, D, dQr, dQe_re, dQe_im, a):
    """Complex S21 of the model (reference S21_func)."""
    return complex_of_real(
        nonlinear_model(f, f0, A, phi, D, dQr, dQe_re, dQe_im, a))


def FWMH(freq, magnitude):
    """Full width at mid height helper (reference FWMH,
    USRP_fitting.py:135-140)."""
    magnitude = np.abs(magnitude)
    MH = (np.max(magnitude) - np.mean([magnitude[0], magnitude[-1]])) / 2.0
    sel = freq[magnitude > MH]
    return np.abs(np.min(sel) - np.max(sel))


def do_fit(freq, re, im, p0=None):
    """Fit one resonator (reference do_fit, USRP_fitting.py:142-193).

    Returns (f0 [MHz], Qi, Qr, zfit, modelwise) with
    modelwise = (f0, A, phi, D, Qi, Qr, Qe_re, Qe_im, a)."""
    mag = np.sqrt(re * re + im * im)
    phase = np.unwrap(np.arctan2(im, re))
    i_m = np.mean([im[0], im[-1]])
    r_m = np.mean([re[0], re[-1]])
    p_m = np.arctan2(i_m, r_m)
    if p0 is None:
        f0 = freq[np.argmin(mag)] / 1.0e6
        scale = np.max(mag)
        phi = p_m / (2 * np.pi)
        A = scale
        D = 0
        fwmh = FWMH(freq, phase) / 1e6
        Qr = 10 * f0 / fwmh
        Qe_re = Qr * 2
        dQe = 1.0 / (Qe_re + 0.0j)
        p0 = (f0, A, phi, D, 1.0 / Qr, dQe.real, dQe.imag, 0.0)

    ydata = np.hstack((re, im))
    popt, _ = optimize.curve_fit(nonlinear_model, freq, ydata, p0=p0)
    f0, A, phi, D, dQr, dQe_re, dQe_im, a = popt
    zfit = complex_of_real(nonlinear_model(freq, *popt))
    Qr = 1 / dQr
    Qi = 1.0 / (dQr - dQe_re)
    Qe = 1.0 / (dQe_re + 1.0j * dQe_im)
    modelwise = (f0, A, phi, D, Qi, Qr, Qe.real, Qe.imag, a)
    return f0, Qi, Qr, zfit, modelwise


# ----------------------------------------------------------------------
# Peak initialization
# ----------------------------------------------------------------------

def _write_tones_init(filename, tones) -> None:
    with h5.File(filename, "r+") as fv:
        if "Resonators" in fv:
            grp = fv["Resonators"]
        else:
            grp = fv.create_group("Resonators")
        grp.attrs["tones_init"] = np.asarray(tones, dtype=np.float64)


def extimate_peak_number(filename, threshold=0.2, smoothing=None,
                         peak_width=200e3, exclude_center=True,
                         edge_cut_fraction=95, verbose=False,
                         diagnostic_plots=False) -> int:
    """Gradient-threshold peak estimator (reference extimate_peak_number,
    USRP_fitting.py:197-377); stores tones_init in the Resonators group and
    returns the count.  Uses scipy find_peaks in place of peakutils.
    `diagnostic_plots` saves a |S21|-with-markers png like the
    reference."""
    filename = format_filename(filename)
    info = get_rx_info(filename)
    center = info.tone
    resolution = abs(info.freq[0] - info.chirp_f[0]) / float(info.swipe_s[0])

    freq, S21 = get_VNA_data(filename, calibrated=True)
    phase = np.unwrap(np.angle(S21))
    magnitude = np.abs(S21)
    cut = max(1, int(len(magnitude) / edge_cut_fraction))
    freq, phase, magnitude = freq[cut:-cut], phase[cut:-cut], magnitude[cut:-cut]
    phase = signal.detrend(phase)

    if smoothing is not None:
        smoothing = int(smoothing)
        freq = signal.decimate(freq, smoothing, ftype="fir")[20:-20]
        magnitude = signal.decimate(magnitude, smoothing, ftype="fir")[20:-20]
        phase = signal.decimate(phase, smoothing, ftype="fir")[20:-20]
        resolution *= smoothing

    S21_val = magnitude * np.exp(1j * phase)
    grad = np.abs(np.gradient(S21_val))
    if exclude_center:
        grad[np.abs(freq - center) < 2 * resolution] = 0.0
    dist = max(1, int(peak_width / resolution))
    idx, _ = signal.find_peaks(grad, height=threshold * np.max(grad),
                               distance=dist)
    tones = freq[idx]
    if verbose:
        print(f"extimate_peak_number: {len(tones)} peaks above "
              f"{threshold:.2f}*max|grad S21|")
    if diagnostic_plots:
        _peak_diagnostic_plot(filename, freq, magnitude, tones,
                              "peak_number_estimation")
    if len(tones) > 0:
        _write_tones_init(filename, tones)
    return len(tones)


def _peak_diagnostic_plot(filename, freq, magnitude, tones, tag) -> str:
    """Diagnostic |S21| plot with candidate-peak markers (the reference's
    diagnostic_plots=True artifact, USRP_fitting.py:300-360)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(freq / 1e6, vrms2dbm(magnitude), lw=0.8)
    for t in tones:
        ax.axvline(t / 1e6, color="r", ls="--", lw=0.8)
    ax.set_xlabel("frequency [MHz]")
    ax.set_ylabel("|S21| [dBm]")
    ax.set_title(f"{tag}: {len(tones)} candidates")
    out = f"{tag}_{format_filename(filename).rsplit('.', 1)[0]}.png"
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out


def initialize_peaks(filename, N_peaks=1, smoothing=None, peak_width=90e3,
                     Qr_cutoff=5e3, a_cutoff=10, Mag_depth_cutoff=0.15,
                     exclude_center=True, edge_cut_fraction=90,
                     verbose=False, diagnostic_plots=False) -> bool:
    """Iterative fit-and-filter peak initializer (reference
    initialize_peaks, USRP_fitting.py:380-586): repeatedly take the largest
    |grad S21|, fit the nonlinear model around it, accept if Qr, asymmetry
    and dip depth pass the cutoffs, then mask the region and iterate."""
    filename = format_filename(filename)
    info = get_rx_info(filename)
    freq, S21 = get_VNA_data(filename, calibrated=True)
    resolution = abs(info.freq[0] - info.chirp_f[0]) / float(len(S21))
    center = info.tone

    phase = np.unwrap(np.angle(S21))
    magnitude = np.abs(S21)
    cut = max(1, int(len(magnitude) / edge_cut_fraction))
    freq, phase, magnitude = freq[cut:-cut], phase[cut:-cut], magnitude[cut:-cut]

    if smoothing is not None:
        smoothing = int(smoothing)
        freq = signal.decimate(freq, smoothing, ftype="fir")[20:-20]
        magnitude = signal.decimate(magnitude, smoothing, ftype="fir")[20:-20]
        phase = signal.decimate(phase, smoothing, ftype="fir")[20:-20]
        resolution *= smoothing

    S21_val = magnitude * np.exp(1j * phase)
    pw = max(1, int(peak_width / resolution))
    Qr_max = 500e3

    mask = np.ones(len(magnitude), dtype=bool)
    if exclude_center:
        mask[np.abs(freq - center) < 50000] = False
    gradS21 = np.abs(np.gradient(S21_val))
    found = []
    while mask.sum() > 0:
        # the largest gradient among the candidates still open: the JAX
        # package takes the first index of that value anywhere, which on
        # a flat trace can be one it already masked, and then loops
        # forever; wherever it ends, both take the same index
        open_idx = np.flatnonzero(mask)
        m = open_idx[np.argmax(gradS21[open_idx])]
        lo, hi = max(m - pw, 0), min(m + pw, len(freq) - 1)
        half_lo = max(int(m - pw / 1.2), 0)
        half_hi = min(int(m + pw / 1.2), len(freq) - 1)
        try:
            f0, Qi, Qr, zfit, modelwise = do_fit(
                freq[lo:hi], S21_val.real[lo:hi], S21_val.imag[lo:hi])
            a = modelwise[8]
            depth = np.abs(np.min(vrms2dbm(np.abs(zfit))) -
                           np.max(vrms2dbm(np.abs(zfit))))
        except (RuntimeError, ValueError):
            Qr, depth, a, f0 = 0, 0, np.inf, 0
        accept = (Qr > Qr_cutoff and Qr < Qr_max and
                  f0 > freq[half_lo] / 1e6 and f0 < freq[half_hi] / 1e6 and
                  a < a_cutoff and depth > Mag_depth_cutoff)
        if verbose:
            print(f"initialize_peaks: candidate {freq[m] / 1e6:.4f} MHz "
                  f"Qr={Qr:.0f} depth={depth:.2f} dB a={a:.2f} -> "
                  f"{'accept' if accept else 'reject'}")
        if accept:
            found.append(freq[m])
        if len(found) >= N_peaks:
            break
        mask[max(m - pw, 0):min(m + pw, len(mask))] = False

    if diagnostic_plots:
        _peak_diagnostic_plot(filename, freq, magnitude,
                              np.asarray(found), "peaks_init")
    if found:
        _write_tones_init(filename, found)
    return len(found) == N_peaks


def initialize_from_VNA(original_VNA, new_VNA) -> None:
    """Seed a new VNA file's peak init from an already-fitted VNA
    (reference initialize_from_VNA, USRP_fitting.py:589-617)."""
    fits = get_fit_param(format_filename(original_VNA))
    if not fits:
        raise ValueError("no resonators in the original file")
    _write_tones_init(format_filename(new_VNA),
                      [r["f0"] * 1e6 for r in fits])


# ----------------------------------------------------------------------
# VNA fit + accessors
# ----------------------------------------------------------------------

def vna_fit(filename, p0=None, fit_range=10e4, verbose=False) -> bool:
    """Fit every initialized peak; write Resonators/reso_<i> groups
    {freq, base_S21, fitted_S21} + attrs f0,A,phi,D,Qr,Qe,a
    (reference vna_fit, USRP_fitting.py:619-715)."""
    filename = format_filename(filename)
    peaks_init = Ufiles.get_init_peaks(filename)
    frequency, S21 = get_VNA_data(filename, calibrated=True)
    if len(peaks_init) == 0:
        raise ValueError("Cannot find any initialized peak")
    fit_number = 0
    with h5.File(filename, "r+") as fv:
        reso_grp = fv["Resonators"]
        for tone in peaks_init:
            sel = np.abs(frequency - tone) < fit_range
            try:
                f0, Qi, Qr, zfit, modelwise = do_fit(
                    frequency[sel], S21.real[sel], S21.imag[sel], p0=p0)
            except (RuntimeError, ValueError):
                continue
            name = f"reso_{fit_number}"
            if name in reso_grp:
                del reso_grp[name]
            g = reso_grp.create_group(name)
            g.create_dataset("freq", data=frequency[sel])
            g.create_dataset("base_S21", data=S21[sel])
            g.create_dataset("fitted_S21", data=zfit)
            (f0, A, phi, D, Qi, Qr, Qe_r, Qe_i, a) = modelwise
            g.attrs["f0"] = f0
            g.attrs["A"] = A
            g.attrs["phi"] = phi
            g.attrs["D"] = D
            g.attrs["Qi"] = Qi
            g.attrs["Qr"] = Qr
            g.attrs["Qe"] = Qe_r + 1j * Qe_i
            g.attrs["a"] = a
            fit_number += 1
    return fit_number == len(peaks_init)


def get_fit_data(filename) -> List[dict]:
    """Fitted vs original S21 per resonator (reference get_fit_data)."""
    with bound_open(filename) as f:
        reso = f["Resonators"]
        out = []
        i = 0
        while f"reso_{i}" in reso:
            g = reso[f"reso_{i}"]
            out.append({"frequency": np.asarray(g["freq"]),
                        "fitted": np.asarray(g["fitted_S21"]),
                        "original": np.asarray(g["base_S21"])})
            i += 1
        return out


def get_fit_param(filename) -> List[dict]:
    """Fit parameters per resonator (reference get_fit_param)."""
    with bound_open(filename) as f:
        reso = f["Resonators"]
        out = []
        i = 0
        while f"reso_{i}" in reso:
            g = reso[f"reso_{i}"]
            out.append({k: g.attrs.get(k)
                        for k in ("f0", "A", "phi", "D", "Qi", "Qr",
                                  "Qe", "a")})
            i += 1
        return out


def get_best_readout(filename) -> List[float]:
    """Best readout frequency per resonator: f0*(1 - a/Qr) in Hz
    (reference get_best_readout, USRP_fitting.py:804-826)."""
    return [1e6 * r["f0"] * (1 - r["a"] / r["Qr"])
            for r in get_fit_param(filename)]


def min_readout_spacing(filename) -> float:
    """Minimum spacing between best-readout f0s (reference
    min_readout_spacing)."""
    f0s = get_best_readout(filename)
    M = [[abs(a - b) if a != b else np.inf for a in f0s] for b in f0s]
    return float(np.min(M))


def get_tones(filename, usrp_number=0):
    """RF + relative tone list from a fitted VNA file
    (reference get_tones, USRP_fitting.py:1228-1271).
    Returns (RF, relative_tones)."""
    rf = get_rx_info(format_filename(filename)).tone
    bro = get_best_readout(filename)
    return rf, np.asarray([b - rf for b in bro])
