"""Multi-tone noise acquisition and PSD analysis (a copy of
gpu_sdr_tpu/client/noise.py; its backend="jax" is backend="torch" here).

Mirrors pyUSRP/USRP_noise.py: `Get_noise` composes a fixed-tone acquisition
in PFB mode (minimum-bin-spacing fft_tones selection + tone quantization to
bin centers, USRP_noise.py:500-571) or DIRECT mode (FIR decimation, 1 Hz
tone quantization, USRP_noise.py:573-625); `calculate_noise` computes Welch
PSDs per channel and writes the Noise<N>/<ant> group {freq, real_i, imag_i}
with per-tone attributes (USRP_noise.py:706-828).
"""

from __future__ import annotations

import datetime
from . import h5
import numpy as np
from scipy import signal

from ..params import AntennaParams, AntMode, UsrpParams, WaveType
from . import files as Ufiles
from .delay import LINE_DELAY

H5PY_compression = "gzip"

#: rates that avoid extra CIC filtering in the USRP firmware
#: (reference USRP_low_level.py:51)
USRP_accepted_rates = [int(1e6), int(2e6), int(5e6), int(1e7), int(2e7),
                       int(5e7), int(1e8), int(2e8)]


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def find_nearest(array, value) -> int:
    array = np.asarray(array)
    return int(np.abs(array - value).argmin())


def quantize_tones(tones, rate, bins) -> np.ndarray:
    """Quantize tones to PFB bin centers (reference quantize_tones,
    pyUSRP/USRP_low_level.py:261-278)."""
    axis = (np.arange(int(bins), dtype=np.float64) * (float(rate) / bins)
            - (float(rate) / bins) * (int(bins) // 2))
    return np.asarray([axis[find_nearest(axis, t)] for t in tones])


def pfb_bins_for_tones(tones, rate, decimation=None) -> int:
    """Choose the PFB size from the minimum tone spacing
    (reference Get_noise PFB branch, USRP_noise.py:500-530)."""
    tones = np.asarray(tones, dtype=np.float64)
    if len(tones) > 1:
        diffs = np.abs(tones[:, None] - tones[None, :]).ravel()
        min_space = np.min(diffs[diffs > 0])
        min_fft = int(np.ceil(float(rate) / float(min_space)))
    else:
        min_fft = 10
    if decimation is not None and decimation >= min_fft:
        final = int(decimation)
    else:
        final = min_fft
    return max(final, 10)   # <10 bins bottlenecks (USRP_noise.py:518-520)


def compose_noise_command(tones, measure_t, rate, decimation=None,
                          amplitudes=None, RF=None, tx_gain=0,
                          Front_end=None, Device=0, delay=None,
                          pf_average=None, mode="DIRECT") -> UsrpParams:
    """Build the noise UsrpParams exactly as the reference client
    (Get_noise, pyUSRP/USRP_noise.py:385-625)."""
    if mode not in ("PFB", "DIRECT"):
        raise ValueError(f"Noise acquisition mode {mode} not defined")
    if measure_t <= 0:
        raise ValueError(
            f"Cannot execute a noise measure with {measure_t}s duration")
    if pf_average is None:
        pf_average = 1 if mode == "DIRECT" else 4
    tx_gain = int(abs(tx_gain))
    if RF is None:
        RF = float(np.mean(tones))
        tones = np.asarray(tones, dtype=np.float64) - RF
    if amplitudes is None:
        amplitudes = [1.0 / len(tones)] * len(tones)
    if Front_end is None:
        Front_end = "A"
    if delay is None:
        delay = LINE_DELAY.get(str(int(rate / 1e6)), 0.0) * 1e-9

    number_of_samples = int(rate * measure_t)
    buffer_len = int(1e6)
    cmd = UsrpParams(usrp_number=int(Device))

    if mode == "PFB":
        final_fft_bins = pfb_bins_for_tones(tones, rate, decimation)
        for t in tones:
            if t > rate / 2:
                raise ValueError(
                    f"Out of bandwidth tone requested: {t / 1e6:.2f} MHz")
        tones = quantize_tones(tones, rate, final_fft_bins)
        wave_rx = [WaveType.TONES] * len(tones)
        rx_extra = dict(fft_tones=final_fft_bins, pf_average=int(pf_average),
                        decim=0)
    else:
        decimation = int(decimation or 0)
        if decimation != 0 and buffer_len % decimation != 0:
            raise ValueError(
                f"Cannot use a decimation factor of {decimation} with a "
                f"buffer len of {buffer_len}")
        tones = [int(t) for t in tones]   # 1 Hz quantization
        wave_rx = [WaveType.DIRECT] * len(tones)
        rx_extra = dict(fft_tones=0, pf_average=int(pf_average),
                        decim=decimation)

    tx = AntennaParams(
        mode=AntMode.TX, rate=int(rate), gain=tx_gain, bw=int(2 * rate),
        tone=int(RF), samples=number_of_samples, delay=1.0,
        buffer_len=buffer_len, fft_tones=100,
        freq=[int(t) for t in tones],
        ampl=[float(a) for a in amplitudes],
        wave_type=[WaveType.TONES] * len(tones))
    rx = AntennaParams(
        mode=AntMode.RX, rate=int(rate), gain=0, bw=int(2 * rate),
        tone=int(RF), samples=number_of_samples, delay=1.0 + delay,
        buffer_len=buffer_len,
        freq=[int(t) for t in tones],
        ampl=[1.0] * len(tones),
        wave_type=wave_rx, **rx_extra)
    setattr(cmd, f"{Front_end}_TXRX", tx)
    setattr(cmd, f"{Front_end}_RX2", rx)
    return cmd


def Get_noise(tones, measure_t, rate, decimation=None, amplitudes=None,
              RF=None, tx_gain=0, output_filename=None, Front_end=None,
              Device=None, delay=None, pf_average=None, mode="DIRECT",
              trigger=None, channel=None, source=None, push_queue=None,
              **kwargs) -> str:
    """Fixed-tone noise acquisition (reference Get_noise,
    pyUSRP/USRP_noise.py:385-650).  `push_queue` receives (meta, data)
    per packet for live consumers (the reference's live_demo path)."""
    from ..measure import run_measurement

    cmd = compose_noise_command(
        tones, measure_t, rate, decimation=decimation, amplitudes=amplitudes,
        RF=RF, tx_gain=tx_gain, Front_end=Front_end, Device=Device or 0,
        delay=delay, pf_average=pf_average, mode=mode)
    if output_filename is None:
        output_filename = "USRP_Noise_" + _timestamp()
    extra = []
    if push_queue is not None:
        from ..engine.sinks import CallbackSink
        extra.append(CallbackSink(
            lambda meta, data: push_queue.put((meta, data))))
    return run_measurement(cmd, output_filename, channel=channel,
                           source=source, trigger=trigger,
                           extra_sinks=extra, meas_type="Noise", **kwargs)


def dual_get_noise(tones_A, tones_B, measure_t, rate, decimation=None,
                   amplitudes_A=None, amplitudes_B=None, RF_A=None,
                   RF_B=None, tx_gain=0, output_filename=None, Device=None,
                   delay=None, pf_average=None, mode="DIRECT", channel=None,
                   **kwargs) -> str:
    """Two-frontend noise acquisition (reference dual_get_noise,
    pyUSRP/USRP_noise.py:52-383)."""
    from ..measure import run_measurement

    cmd_a = compose_noise_command(
        tones_A, measure_t, rate, decimation=decimation,
        amplitudes=amplitudes_A, RF=RF_A, tx_gain=tx_gain, Front_end="A",
        Device=Device or 0, delay=delay, pf_average=pf_average, mode=mode)
    cmd_b = compose_noise_command(
        tones_B, measure_t, rate, decimation=decimation,
        amplitudes=amplitudes_B, RF=RF_B, tx_gain=tx_gain, Front_end="B",
        Device=Device or 0, delay=delay, pf_average=pf_average, mode=mode)
    cmd_a.B_TXRX = cmd_b.B_TXRX
    cmd_a.B_RX2 = cmd_b.B_RX2
    if output_filename is None:
        output_filename = "USRP_Noise_" + _timestamp()
    return run_measurement(cmd_a, output_filename, channel=channel,
                           meas_type="Noise", **kwargs)


# ----------------------------------------------------------------------
# Analysis
# ----------------------------------------------------------------------

def spec_from_samples(samples, sampling_rate=1, welch=None, dbc=False,
                      rotate=True, clip_samples=False):
    """Welch PSD of the real and imaginary parts of a complex timestream
    (reference spec_from_samples, pyUSRP/USRP_noise.py:655-703).

    Returns (frequencies, real_dB, imag_dB)."""
    samples = np.asarray(samples)
    L = len(samples)
    welch = L if welch is None else int(L / welch)
    if not clip_samples:
        s0, s1 = 0, L
    else:
        s0, s1 = int(clip_samples), int(L - clip_samples)
    if rotate:
        samples = samples * (np.abs(np.mean(samples)) / np.mean(samples))
    if dbc:
        samples = samples / np.mean(samples)
        samples = samples - np.mean(samples)
    f, re = signal.welch(samples[s0:s1].real, nperseg=welch,
                         fs=sampling_rate, detrend="linear",
                         scaling="density")
    f, im = signal.welch(samples[s0:s1].imag, nperseg=welch,
                         fs=sampling_rate, detrend="linear",
                         scaling="density")
    return f, _db10(re), _db10(im)


def _db10(power):
    """10*log10 with a floor on zero bins (a detrended constant stream has
    exactly-zero Welch bins; the reference lets them go to -inf dB,
    pyUSRP/USRP_noise.py:699-702 — we clamp so plots and H5 files stay
    finite)."""
    power = np.asarray(power)
    return 10 * np.log10(np.maximum(power, np.finfo(np.float32).tiny))


def expected_samples_per_channel_file(filename, usrp_number=0, ant=None):
    """Per-channel sample count actually stored in a file."""
    with h5.File(Ufiles.format_filename(filename), "r") as f:
        group = f[f"raw_data{int(usrp_number)}"]
        recv = Ufiles.get_receivers(group)
        sub = group[ant if ant is not None else recv[0]]
        if "data" in sub:
            return int(sub["data"].attrs.get("samples",
                                             sub["data"].shape[1]))
        return None


def effective_sampling_rate(p: AntennaParams) -> float:
    """Output rate of the demodulated stream (calculate_noise rate logic,
    USRP_noise.py:740-755)."""
    if p.wave_type[0] == WaveType.DIRECT:
        return float(p.rate) / p.decim if p.decim > 0 else float(p.rate)
    if int(p.fft_tones) <= 0:
        # raw (NODSP) file: no channelization — the reference warns and
        # degrades to rate=1 (USRP_noise.py:743-750) so batch analysis
        # over mixed file sets survives
        import warnings
        warnings.warn("noise analysis on a raw (no fft_tones) file: "
                      "using sampling rate 1 Hz like the reference")
        return 1.0
    r = float(p.rate) / p.fft_tones
    if p.decim > 1:
        r /= float(p.decim)
    return r


def calculate_noise(filename, welch=None, dbc=False, rotate=True,
                    usrp_number=0, ant=None, clip=0.1, n_jobs=None,
                    backend="scipy", device="cuda") -> None:
    """Per-channel Welch PSDs -> Noise<N>/<ant> group
    (reference calculate_noise, pyUSRP/USRP_noise.py:706-828).

    backend="torch" runs all channels' PSDs as one batched call on
    `device` (ops/spectral.welch_psd), the accelerator replacement for
    the reference's joblib-parallel host Welch (the JAX package's
    backend="jax"); "scipy" runs scipy's on the host.  Any other name
    raises ValueError (the JAX package takes it for "scipy")."""
    if backend not in ("scipy", "torch"):
        raise ValueError(f"calculate_noise: backend {backend!r} is not "
                         "'scipy' or 'torch'")
    filename = Ufiles.format_filename(filename)
    params = Ufiles.retrieve_params_from_file(filename, usrp_number)
    if ant is None:
        rx = [n for n, _ in params.active_antennas(AntMode.RX)]
        ant = rx[0]
    p = params.antenna(ant)
    sampling_rate = effective_sampling_rate(p)
    clip_samples = int(clip * sampling_rate) if clip else False
    n_avail = expected_samples_per_channel_file(filename, usrp_number, ant)
    if clip_samples and n_avail and clip_samples * 2 >= n_avail:
        # short acquisition: clipping 2*clip seconds would consume all the
        # data (the reference errors out here); keep at least half
        clip_samples = max(0, n_avail // 4)

    data, errors = Ufiles.openH5file(filename, usrp_number=usrp_number,
                                     front_end=ant, error_coord=True)
    if errors is not None and len(errors) > 0:
        raise ValueError(
            "Cannot evaluate spectra of samples containing errors")

    if backend == "torch":
        from ..ops.spectral import batched_welch
        proc = np.array(data, dtype=np.complex128)
        if rotate:
            m = np.mean(proc, axis=1, keepdims=True)
            proc = proc * (np.abs(m) / m)
        if dbc:
            m = np.mean(proc, axis=1, keepdims=True)
            proc = proc / m - 1.0
        # nperseg from the *unclipped* length (spec_from_samples semantics)
        L0 = proc.shape[1]
        nperseg = L0 if welch is None else int(L0 / welch)
        if clip_samples:
            proc = proc[:, clip_samples:proc.shape[1] - clip_samples]
        # clamp as scipy does (an nperseg beyond the clipped length)
        nperseg = min(nperseg, proc.shape[1])
        f, p_re = batched_welch(proc.real, sampling_rate, nperseg, device)
        _, p_im = batched_welch(proc.imag, sampling_rate, nperseg, device)
        results = [(f, _db10(p_re[i]), _db10(p_im[i]))
                   for i in range(len(proc))]
    else:
        results = [spec_from_samples(ch, sampling_rate=sampling_rate,
                                     welch=welch, dbc=dbc, rotate=rotate,
                                     clip_samples=clip_samples)
                   for ch in data]

    with h5.File(filename, "r+") as fv:
        ng = fv.require_group(f"Noise{int(usrp_number)}")
        if ant in ng:
            del ng[ant]
        sub = ng.create_group(ant)
        sub.attrs.create("welch", welch if welch is not None else 0)
        sub.attrs.create("dbc", dbc)
        sub.attrs.create("rotate", rotate)
        sub.attrs.create("rate", sampling_rate)
        sub.attrs.create("n_chan", len(results))
        sub.create_dataset("freq", data=results[0][0],
                           compression=H5PY_compression)
        for i, (f, re, im) in enumerate(results):
            tone_freq = p.tone + p.freq[i]
            ds = sub.create_dataset(f"real_{i}", data=re.astype(np.float32),
                                    compression=H5PY_compression)
            ds.attrs.create("tone", tone_freq)
            ds = sub.create_dataset(f"imag_{i}", data=im.astype(np.float32),
                                    compression=H5PY_compression)
            ds.attrs.create("tone", tone_freq)


def get_tones(filename, usrp_number=0) -> np.ndarray:
    """Absolute tone frequencies of a noise acquisition."""
    p = Ufiles.get_rx_info(filename)
    return np.asarray([p.tone + f for f in p.freq])


def copy_resonator_group(vna_filename, noise_filename) -> None:
    """Copy the fitted Resonators group from a VNA file into a noise file
    (reference copy_resonator_group, pyUSRP/USRP_noise.py:1111-1151)."""
    vna_filename = Ufiles.format_filename(vna_filename)
    noise_filename = Ufiles.format_filename(noise_filename)
    with h5.File(vna_filename, "r") as src, \
            h5.File(noise_filename, "r+") as dst:
        if "Resonators" not in src:
            raise ValueError(f"no Resonators group in {vna_filename}")
        if "Resonators" in dst:
            del dst["Resonators"]
        src.copy("Resonators", dst)


def get_frequency_timestreams(filename, start_time=None, end_time=None,
                              usrp_number=0, ant=None):
    """Fractional-frequency and Qr timestreams using the fit parameters
    stored in the file's Resonators group (reference
    get_frequency_timestreams, pyUSRP/USRP_noise.py:1153-1227).
    Returns (dff, dqr) arrays of shape (n_chan, n_samples)."""
    from .fitting import get_fit_param
    fit_params = get_fit_param(filename)
    fp = [{"f0": p["f0"] * 1e6, "Qr": p["Qr"],
           "Qe_re": np.real(p["Qe"]), "Qe_im": np.imag(p["Qe"]),
           "A": p["A"], "phi": p["phi"]} for p in fit_params]
    return calculate_frequency_timestream(filename, fp,
                                          usrp_number=usrp_number, ant=ant)


def calculate_frequency_timestream(filename, fit_param, usrp_number=0,
                                   ant=None):
    """Convert IQ channel timestreams to fractional-frequency (df/f) and
    dissipation (dQr) streams using resonator fit parameters
    (reference calculate_frequency_timestream, USRP_noise.py:1070-1108).

    fit_param: list per channel of dicts {f0 [Hz], Qr, Qe_re, Qe_im, A, phi}.
    Returns (dff, dqr) arrays of shape (n_chan, n_samples).
    """
    data = Ufiles.openH5file(filename, usrp_number=usrp_number,
                             front_end=ant)
    dff, dqr = [], []
    for ch, fp in zip(data, fit_param):
        Qe = fp["Qe_re"] + 1j * fp.get("Qe_im", 0.0)
        A = fp.get("A", 1.0)
        phi = fp.get("phi", 0.0)
        s21 = ch / (A * np.exp(2j * np.pi * phi))
        # invert S21 = 1 - (Qr/Qe)/(1+2j*y):  y = (Qr/Qe/(1-S21) - 1)/2j
        w = (fp["Qr"] / Qe) / (1.0 - s21)
        y = (w - 1.0) / 2.0j
        dff.append(np.real(y) / fp["Qr"])          # x = y/Qr = df/f
        dqr.append(np.imag(y) / fp["Qr"])
    return np.asarray(dff), np.asarray(dqr)
