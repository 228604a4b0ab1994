"""Line-delay calibration (a copy of gpu_sdr_tpu/client/delay.py, which
mirrors pyUSRP/USRP_delay.py).

`measure_line_delay` composes a full-band chirp with gpu_decim=200 exactly
like the reference (USRP_delay.py:56-197); `analyze_line_delay` decimates,
takes a Welch PSD of the de-chirped beat and converts the peak frequency to
a delay via coeff = chirp_t/|f1-f0|, rounded to the 5 ns grid
(USRP_delay.py:235-301).  Measured delays persist in the H5 `delay_info`
group and the in-memory LINE_DELAY table keyed by rate in Msps (the
port's own table: the port's vna, noise and full_spec read it).
"""

from __future__ import annotations

import datetime
import glob
import os
from . import h5
import numpy as np
from scipy import signal

from ..params import AntennaParams, AntMode, UsrpParams, WaveType
from . import files as Ufiles

#: Total line delay in ns at a given rate (Msps), keyed by str(rate_msps).
LINE_DELAY = {}


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def measure_line_delay(rate, LO_freq, RF_frontend, USRP_num=0, tx_gain=0,
                       rx_gain=0, output_filename=None, compensate=False,
                       duration=0.01, channel=None, source=None,
                       **kwargs) -> str:
    """Measure the line delay around LO_freq (reference measure_line_delay,
    pyUSRP/USRP_delay.py:56-197): full-band chirp, chirp-demodulated with
    lock-in decimation gpu_decim=200 so a residual line delay shows up as a
    beat tone."""
    from ..measure import run_measurement

    rate = int(abs(rate))
    LO_freq = int(abs(LO_freq))
    if output_filename is None:
        output_filename = "USRP_Delay_" + _timestamp()
    if RF_frontend not in ("A", "B"):
        raise ValueError(f"Cannot find frontend {RF_frontend}")

    measure_t = duration
    n_points = int(rate * measure_t)
    number_of_samples = int(rate * measure_t)
    start_f = int(np.floor(rate / 2)) - 1
    last_f = -start_f
    gpu_decim = 200

    compensation = 0.0
    if compensate:
        compensation = LINE_DELAY.get(str(int(rate / 1e6)), 0.0) * 1e-9

    common = dict(rate=rate, bw=2 * rate, samples=number_of_samples,
                  buffer_len=1_000_000, tone=LO_freq,
                  freq=[start_f], chirp_f=[last_f], swipe_s=[n_points],
                  chirp_t=[float(measure_t)], wave_type=[WaveType.CHIRP])
    cmd = UsrpParams(usrp_number=int(USRP_num))
    setattr(cmd, f"{RF_frontend}_TXRX",
            AntennaParams(mode=AntMode.TX, gain=int(abs(tx_gain)), delay=1.0,
                          ampl=[1.0], **common))
    setattr(cmd, f"{RF_frontend}_RX2",
            AntennaParams(mode=AntMode.RX, gain=int(abs(rx_gain)),
                          delay=1.0 + compensation, decim=gpu_decim,
                          ampl=[1.0], **common))
    return run_measurement(cmd, output_filename, channel=channel,
                           source=source, meas_type="delay", **kwargs)


def analyze_line_delay(filename: str, diagnostic_plots: bool = False) -> float:
    """Extract the line delay in seconds (reference analyze_line_delay,
    pyUSRP/USRP_delay.py:235-301)."""
    decimation = 2
    zz = signal.decimate(Ufiles.openH5file(filename)[0], decimation,
                         ftype="fir")
    info = Ufiles.get_rx_info(filename)
    decimation *= info.decim
    freq, Pxx = signal.welch(zz.real, nperseg=len(zz),
                             fs=int(info.rate / float(decimation)),
                             detrend="linear", scaling="density")
    if diagnostic_plots:
        import matplotlib
        matplotlib.use("agg")
        import matplotlib.pyplot as pl
        fig = pl.figure()
        pl.plot(zz.real, label="real")
        pl.plot(zz.imag, label="imag")
        pl.plot(np.abs(zz), label="abs")
        pl.legend(); pl.grid()
        pl.savefig("Delay_diagnostic.png")
        pl.close(fig)
    coeff = float(info.chirp_t[0]) / float(abs(info.freq[0] - info.chirp_f[0]))
    delay = freq[np.argmax(20 * np.log10(Pxx))] * coeff
    # round to the 5 ns grid (USRP_delay.py:297)
    delay = int(delay * 2e8) / 2.0e8
    return delay


def write_delay_to_file(filename: str, delay: float) -> None:
    """Store the measured delay in the H5 delay_info group
    (reference write_delay_to_file, pyUSRP/USRP_delay.py:199-233)."""
    filename = Ufiles.format_filename(filename)
    info = Ufiles.get_rx_info(filename)
    with h5.File(filename, "r+") as f:
        grp = f.require_group("delay_info")
        grp.attrs[str(int(info.rate / 1e6))] = int(delay * 1e9)


def load_delay_from_file(filename: str):
    """Load a stored delay into LINE_DELAY; returns (rate_msps, delay_ns)
    (reference load_delay_from_file, pyUSRP/USRP_delay.py:303-347)."""
    filename = Ufiles.format_filename(filename)
    with Ufiles.bound_open(filename) as f:
        keys = list(f["delay_info"].attrs.keys())
        if not keys:
            raise ValueError(f"no delay info in {filename}")
        rate = keys[0]
        delay = f["delay_info"].attrs.get(rate)
    LINE_DELAY[str(int(rate))] = int(delay)
    return int(rate), int(delay)


def set_line_delay(rate, delay_ns) -> None:
    """Manually set the LINE_DELAY table (reference set_line_delay)."""
    LINE_DELAY[str(int(rate / 1e6))] = delay_ns


def load_delay_from_folder(foldername: str) -> None:
    """Scan USRP_Delay*.h5 files in a folder into LINE_DELAY
    (reference load_delay_from_folder)."""
    for fn in glob.glob(os.path.join(foldername, "USRP_Delay*.h5")):
        try:
            load_delay_from_file(fn)
        except (ValueError, KeyError, OSError):
            pass
