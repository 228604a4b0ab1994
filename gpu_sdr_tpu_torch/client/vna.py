"""VNA measurements and analysis (a copy of gpu_sdr_tpu/client/vna.py).

Mirrors pyUSRP/USRP_VNA.py: `Single_VNA` / `Dual_VNA` compose the CHIRP
TX+RX command exactly like the reference (buffer 1e6, server-side lock-in at
decim=1, delay from the LINE_DELAY table) and run it on the in-process
engine; `VNA_analysis` reconstructs the frequency axis including the
reference kernel's uint32 chirpness truncation (USRP_VNA.py:740-742) and
writes the `VNA_<N>` group {frequency, S21} with the calibration attribute.
"""

from __future__ import annotations

import datetime
from typing import Optional

from . import h5
import numpy as np

from ..engine.channel import Channel
from ..measure import run_measurement
from ..params import AntennaParams, AntMode, UsrpParams, WaveType
from . import files as Ufiles
from .delay import LINE_DELAY

USRP_power = Ufiles.USRP_power
USRP_calibration = Ufiles.USRP_calibration


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def _chirp_antenna(mode: AntMode, rate: int, gain: int, samples: int,
                   delay: float, start_f: int, last_f: int, n_points: int,
                   measure_t: float, ampl: float, rf: int,
                   decim: int) -> AntennaParams:
    return AntennaParams(
        mode=mode, rate=int(rate), gain=int(gain), bw=int(2 * rate),
        tone=int(rf), samples=int(samples), delay=delay,
        buffer_len=1_000_000, decim=decim,
        freq=[int(start_f)], chirp_f=[int(last_f)],
        swipe_s=[int(n_points)], chirp_t=[float(measure_t)],
        ampl=[float(ampl)], wave_type=[WaveType.CHIRP])


def compose_vna_command(start_f, last_f, measure_t, n_points, tx_gain,
                        Rate=None, decimation=True, RF=None, Front_end=None,
                        Multitone_compensation=None, Iterations=1,
                        Device=0) -> UsrpParams:
    """Build the VNA UsrpParams exactly as the reference client does
    (Single_VNA, pyUSRP/USRP_VNA.py:276-445)."""
    if measure_t <= 0:
        raise ValueError(f"Cannot execute a VNA measure with {measure_t}s "
                         "duration")
    if n_points <= 0:
        raise ValueError(f"Cannot execute a VNA measure with {n_points} "
                         "points")
    if RF is None:
        delta_f = abs(start_f - last_f)
        RF = delta_f / 2.0
        start_f -= RF
        last_f -= RF
    if Front_end is None:
        Front_end = "A"
    ampl = 1.0 if Multitone_compensation is None \
        else 1.0 / Multitone_compensation
    decim = 1 if decimation else 0
    Iterations = max(1, int(Iterations))
    if Rate is None:
        Rate = 100e6
    delay = LINE_DELAY.get(str(int(Rate / 1e6)), 0.0) * 1e-9
    samples = int(Rate * measure_t * Iterations)

    cmd = UsrpParams(usrp_number=int(Device))
    tx = _chirp_antenna(AntMode.TX, int(Rate), tx_gain, samples, 1.0,
                        start_f, last_f, n_points, measure_t, ampl,
                        int(RF), 0)
    rx = _chirp_antenna(AntMode.RX, int(Rate), 0, samples, 1.0 + delay,
                        start_f, last_f, n_points, measure_t, ampl,
                        int(RF), decim)
    setattr(cmd, f"{Front_end}_TXRX", tx)
    setattr(cmd, f"{Front_end}_RX2", rx)
    return cmd


def Single_VNA(start_f, last_f, measure_t, n_points, tx_gain, Rate=None,
               decimation=True, RF=None, Front_end=None, Device=None,
               output_filename=None, Multitone_compensation=None,
               Iterations=1, verbose=False, channel: Optional[Channel] = None,
               source=None, **kwargs) -> str:
    """Perform a VNA scan with one front end (reference Single_VNA,
    pyUSRP/USRP_VNA.py:276-445).  `channel`/`source` select the loopback
    model or replay stream in place of live hardware."""
    cmd = compose_vna_command(
        start_f, last_f, measure_t, n_points, tx_gain, Rate=Rate,
        decimation=decimation, RF=RF, Front_end=Front_end,
        Multitone_compensation=Multitone_compensation,
        Iterations=Iterations, Device=Device or 0)
    if output_filename is None:
        output_filename = "USRP_VNA_" + _timestamp()
    return run_measurement(cmd, output_filename, channel=channel,
                           source=source, meas_type="VNA", **kwargs)


def Dual_VNA(start_f_A, last_f_A, start_f_B, last_f_B, measure_t, n_points,
             tx_gain_A, tx_gain_B, Rate=None, decimation=True, RF_A=None,
             RF_B=None, output_filename=None, Device=None,
             Multitone_compensation_A=None, Multitone_compensation_B=None,
             Iterations=1, channel=None, **kwargs) -> str:
    """VNA scan on both front ends (reference Dual_VNA,
    pyUSRP/USRP_VNA.py:54-272)."""
    cmd_a = compose_vna_command(
        start_f_A, last_f_A, measure_t, n_points, tx_gain_A, Rate=Rate,
        decimation=decimation, RF=RF_A, Front_end="A",
        Multitone_compensation=Multitone_compensation_A,
        Iterations=Iterations, Device=Device or 0)
    cmd_b = compose_vna_command(
        start_f_B, last_f_B, measure_t, n_points, tx_gain_B, Rate=Rate,
        decimation=decimation, RF=RF_B, Front_end="B",
        Multitone_compensation=Multitone_compensation_B,
        Iterations=Iterations, Device=Device or 0)
    cmd_a.B_TXRX = cmd_b.B_TXRX
    cmd_a.B_RX2 = cmd_b.B_RX2
    if output_filename is None:
        output_filename = "USRP_VNA_" + _timestamp()
    return run_measurement(cmd_a, output_filename, channel=channel,
                           meas_type="VNA", **kwargs)


def effective_final_frequency(start_f: int, last_f: int, n_points: int,
                              rate: int) -> float:
    """The actual end frequency of the chirp after the kernel's uint32
    chirpness truncation (reference VNA_analysis, USRP_VNA.py:740-742)."""
    df = int((2.0 ** 32 - 1) * (last_f - start_f) /
             (n_points - 1.0) / float(rate))
    df = df * (n_points - 1.0) * float(rate) / (2.0 ** 32 - 1)
    return df + start_f


def VNA_analysis(filename: str, usrp_number: int = 0) -> None:
    """Analyze a Single_VNA/Dual_VNA file: average iterations, reconstruct
    the frequency axis, write VNA_<N>/{frequency, S21} + calibration
    (reference VNA_analysis, pyUSRP/USRP_VNA.py:683-804)."""
    filename = Ufiles.format_filename(filename)
    params = Ufiles.retrieve_params_from_file(filename, usrp_number)

    front_ends = ["A_RX2", "B_RX2"]
    info, active = [], []
    for ant in front_ends:
        p = params.antenna(ant)
        if p.mode == AntMode.RX and p.wave_type and \
                p.wave_type[0] == WaveType.CHIRP:
            info.append(p)
            active.append(ant)

    gains, ampls = [], []
    for ant in ["A_TXRX", "B_TXRX"]:
        p = params.antenna(ant)
        if p.mode == AntMode.TX and p.wave_type and \
                p.wave_type[0] == WaveType.CHIRP:
            gains.append(p.gain)
            ampls.append(p.ampl[0])

    freq_axis = np.asarray([], dtype=np.float64)
    S21_axis = np.asarray([], dtype=np.complex128)
    lengths, calibration = [], []
    for fr, p in enumerate(info):
        calibration.append(
            (1.0 / ampls[fr]) * USRP_calibration /
            (10 ** ((USRP_power + gains[fr]) / 20.0)))
        eff_final = effective_final_frequency(
            p.freq[0], p.chirp_f[0], p.swipe_s[0], p.rate)

        data = Ufiles.openH5file(filename, front_end=active[fr])[0]
        if p.decim == 1:
            f_tmp = np.linspace(p.freq[0], eff_final, p.swipe_s[0],
                                dtype=np.float64) + p.tone
            n_points = p.swipe_s[0]
        elif p.decim > 1:
            n_points = p.swipe_s[0] // p.decim
            f_tmp = np.linspace(p.freq[0], eff_final, n_points,
                                dtype=np.float64) + p.tone
        else:
            n_points = p.swipe_s[0]
            f_tmp = np.linspace(p.freq[0], p.chirp_f[0], p.swipe_s[0],
                                dtype=np.float64) + p.tone

        if p.decim == 0:
            # undecimated (offline lock-in): the file holds raw
            # demodulated samples — `length` per frequency point, one
            # sweep = steps*length samples (reference VNA_analysis
            # splits into (samples/rate)/chirp_t sweeps FIRST,
            # USRP_VNA.py:768-778); average sweeps, then the
            # samples-per-point within the sweep
            from ..params import chirp_steps_and_length
            steps, length = chirp_steps_and_length(p)
            sweep = steps * length
            nsweeps = max(1, len(data) // sweep)
            s_tmp = data[:nsweeps * sweep].reshape(
                nsweeps, sweep).mean(axis=0)
            s_tmp = s_tmp.reshape(steps, length).mean(axis=1)
        else:
            usable = (len(data) // n_points) * n_points
            iterations = max(1, usable // n_points)
            s_tmp = np.mean(
                np.split(data[:usable], iterations), axis=0) \
                if iterations > 1 else data[:n_points]
        lengths.append(n_points)
        freq_axis = np.concatenate((freq_axis, f_tmp))
        S21_axis = np.concatenate((S21_axis, s_tmp))

    with h5.File(filename, "r+") as f:
        name = f"VNA_{int(usrp_number)}"
        if name in f:
            del f[name]
        grp = f.create_group(name)
        grp.attrs.create("scan_lengths", lengths)
        grp.attrs.create("calibration", calibration)
        grp.create_dataset("frequency", data=freq_axis, dtype=np.float64)
        grp.create_dataset("S21", data=S21_axis, dtype=np.complex128)


def VNA_timestream_analysis(filename: str, usrp_number: int = 0) -> None:
    """Per-iteration (dynamic) VNA analysis: one S21 trace per chirp sweep,
    written to VNA_dynamic_<N> (reference VNA_timestream_analysis,
    pyUSRP/USRP_VNA.py:448-559)."""
    filename = Ufiles.format_filename(filename)
    params = Ufiles.retrieve_params_from_file(filename, usrp_number)
    tx_cal = []
    for ant in ["A_TXRX", "B_TXRX"]:
        p = params.antenna(ant)
        if p.mode == AntMode.TX and p.wave_type and \
                p.wave_type[0] == WaveType.CHIRP:
            tx_cal.append((1.0 / p.ampl[0]) * USRP_calibration /
                          (10 ** ((USRP_power + p.gain) / 20.0)))
    freq_axes, trace_list, calibration = [], [], []
    for ant in ["A_RX2", "B_RX2"]:
        p = params.antenna(ant)
        if p.mode != AntMode.RX or not p.wave_type or \
                p.wave_type[0] != WaveType.CHIRP:
            continue
        data = Ufiles.openH5file(filename, front_end=ant)[0]
        n_points = p.swipe_s[0] // max(p.decim, 1)
        usable = (len(data) // n_points) * n_points
        traces = np.reshape(data[:usable], (-1, n_points))
        eff_final = effective_final_frequency(
            p.freq[0], p.chirp_f[0], p.swipe_s[0], p.rate)
        f_axis = np.linspace(p.freq[0], eff_final, n_points,
                             dtype=np.float64) + p.tone
        freq_axes.append(f_axis)
        trace_list.append(traces)
        calibration.append(tx_cal[len(calibration)]
                           if len(calibration) < len(tx_cal) else 1.0)
    if not trace_list:
        return
    # dual scans: each per-sweep trace spans both frontends' frequency
    # axes side by side (reference concatenates the frontends,
    # pyUSRP/USRP_VNA.py:530-537)
    nsw = min(t.shape[0] for t in trace_list)
    traces = np.concatenate([t[:nsw] for t in trace_list], axis=1)
    f_axis = np.concatenate(freq_axes)
    with h5.File(filename, "r+") as f:
        name = f"VNA_dynamic_{int(usrp_number)}"
        if name in f:
            del f[name]
        grp = f.create_group(name)
        grp.attrs.create("calibration", calibration)
        grp.attrs.create("scan_lengths", [len(a) for a in freq_axes])
        grp.create_dataset("frequency", data=f_axis, dtype=np.float64)
        grp.create_dataset("S21", data=traces.astype(np.complex128))


def is_VNA_analyzed(filename: str, usrp_number: int = 0) -> bool:
    return Ufiles.is_VNA_analyzed(filename, usrp_number)


def get_VNA_data(filename: str, calibrated: bool = True,
                 usrp_number: int = 0):
    return Ufiles.get_VNA_data(filename, calibrated, usrp_number)


def is_VNA_dynamic_analyzed(filename: str, usrp_number: int = 0) -> bool:
    """Check for the VNA_dynamic group (reference is_VNA_dynamic_analyzed,
    pyUSRP/USRP_files.py:1160-1181)."""
    with Ufiles.bound_open(filename) as f:
        try:
            grp = f[f"VNA_dynamic_{int(usrp_number)}"]
            return grp["frequency"] is not None and grp["S21"] is not None
        except KeyError:
            return False


def get_dynamic_VNA_data(filename: str, calibrated: bool = True,
                         usrp_number: int = 0):
    """(frequency, S21 traces) from a dynamic-analyzed VNA file
    (reference get_dynamic_VNA_data, pyUSRP/USRP_files.py:1086-1111)."""
    if not is_VNA_dynamic_analyzed(filename, usrp_number):
        raise ValueError(
            f"file {filename} has no analyzed VNA_dynamic group")
    with Ufiles.bound_open(filename) as f:
        grp = f[f"VNA_dynamic_{int(usrp_number)}"]
        freq = np.asarray(grp["frequency"])
        s21 = np.asarray(grp["S21"])
        if calibrated and "calibration" in grp.attrs:
            s21 = s21 * grp.attrs.get("calibration")[0]
        return freq, s21
