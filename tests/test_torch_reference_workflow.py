"""The reference workflows through the port's facade, on the CPU, held
against the same workflows through the JAX package's facade.

The JAX package's test_reference_workflow.py runs, call for call, what
the reference's measurement and analysis scripts do against
`import pyUSRP as u`; here the same two flows run twice, once with
`import gpu_sdr_tpu.pyusrp as u` and once with
`import gpu_sdr_tpu_torch.pyusrp as u` plus `device="cpu"` on the
measurement calls (the port measures on the card unless told
otherwise):

  * scripts/get_VNA.py:14-42  — LINE_DELAY probe -> measure_line_delay ->
    analyze_line_delay -> write_delay_to_file -> load_delay_from_file ->
    Single_VNA
  * scripts/fit_VNA.py:18-33  — extimate_peak_number / initialize_peaks
    -> vna_fit -> plot_resonators -> plot_VNA

and the port's VNA file, fitted resonators and line delay are compared
with the JAX run's.  The physical line is a simulated resonator channel
(each package's own FrequencyResponseChannel), passed through the
measurement functions' `channel=` hook.  The facade's connection shims
run against the port's server on 127.0.0.1.
"""

import glob
import os
import shutil
import signal
import socket

import h5py
import numpy as np
import pytest
import torch

import gpu_sdr_tpu.pyusrp as ju
import gpu_sdr_tpu_torch.pyusrp as u
from gpu_sdr_tpu import golden

torch.set_num_threads(2)

RATE = 1_000_000
RF = 10_000_000
RESOS = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0),
         dict(f0=200_000.0, Qr=25.0, Qe_re=50.0)]


@pytest.fixture
def clean_delays():
    for m in (u, ju):
        m.LINE_DELAY.clear()
    yield
    for m in (u, ju):
        m.LINE_DELAY.clear()


def _get_vna_flow(m, kw, gain, iter_, rate, freq, front_end, f0, f1, lapse,
                  points, ntones, delay_duration, channel_factory):
    """scripts/get_VNA.py run() (reference :14-42), verbatim argument
    flow through facade `m`; `kw` the measurement keywords
    (device="cpu" for the port)."""
    try:
        if m.LINE_DELAY[str(int(rate / 1e6))]:
            pass
    except KeyError:
        filename = m.measure_line_delay(
            rate, freq, front_end, USRP_num=0, tx_gain=0, rx_gain=0,
            output_filename=None, compensate=True,
            duration=delay_duration, channel=channel_factory(), **kw)
        delay = m.analyze_line_delay(filename, True)
        m.write_delay_to_file(filename, delay)
        m.load_delay_from_file(filename)
        if ntones == 1:
            ntones = None
    return m.Single_VNA(start_f=f0, last_f=f1, measure_t=lapse,
                        n_points=points, tx_gain=gain, Rate=rate,
                        decimation=True, RF=freq, Front_end=front_end,
                        Device=None, output_filename=None,
                        Multitone_compensation=ntones, Iterations=iter_,
                        verbose=False, channel=channel_factory(), **kw)


def _fit_vna_flow(m, file_list, backend, N_peaks, smoothing, a_cutoff,
                  threshold, peak_width, Mag_depth_cutoff, Qr_cutoff):
    """scripts/fit_VNA.py run() (reference :18-33), verbatim argument
    flow through facade `m` (Qr_cutoff parameterized: the reference
    hardcodes 4e3 for GHz-Q MKIDs; the simulated line has Qr ~ 30)."""
    for i in range(len(file_list)):
        if threshold is not None:
            m.extimate_peak_number(
                file_list[i], threshold=threshold, smoothing=smoothing,
                peak_width=peak_width, verbose=False, exclude_center=True,
                diagnostic_plots=True)
        else:
            m.initialize_peaks(
                file_list[i], N_peaks=N_peaks[i], a_cutoff=a_cutoff,
                smoothing=smoothing, peak_width=peak_width,
                Qr_cutoff=Qr_cutoff, verbose=True, exclude_center=True,
                diagnostic_plots=True, Mag_depth_cutoff=Mag_depth_cutoff)
        m.vna_fit(file_list[i], p0=None, fit_range=peak_width,
                  verbose=False)
        single_plots = backend == "matplotlib"
        m.plot_resonators(file_list[i], reso_freq=None, backend="plotly",
                          title_info=None, verbose=False,
                          output_filename=None, auto_open=False,
                          attenuation=None, single_plots=single_plots)
        m.plot_VNA(file_list[i], backend="plotly", auto_open=False)


def run_workflow(m, kw, directory):
    """Both flows through facade `m` in `directory`: (the VNA file, its
    fitted parameters, the line delay loaded)."""
    os.makedirs(directory)
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        assert m.Connect()          # in-process engine: no server needed

        def channel():
            return m.make_resonator_channel(RATE, RESOS, fft_len=1 << 12)

        vna_filename = _get_vna_flow(
            m, kw, gain=0, iter_=1, rate=RATE, freq=RF, front_end="A",
            f0=-400_000, f1=400_000, lapse=0.4, points=1600, ntones=1,
            delay_duration=0.5, channel_factory=channel)
        delay = m.LINE_DELAY[str(int(RATE / 1e6))]
        assert delay > 0
        m.VNA_analysis(vna_filename)
        assert m.is_VNA_analyzed(vna_filename)
        files = sorted(glob.glob("USRP_VNA*.h5"))
        assert files == [m.format_filename(vna_filename)]
        _fit_vna_flow(m, files, backend="plotly", N_peaks=[2],
                      smoothing=None, a_cutoff=10, threshold=None,
                      peak_width=50e3, Mag_depth_cutoff=0.5, Qr_cutoff=5)
        params = m.get_fit_param(files[0])
        assert glob.glob("peaks_init_*.png")
        assert glob.glob("USRP_resonators*.html")
        assert glob.glob("USRP_VNA*.html")
        # the threshold branch of fit_VNA.py (extimate_peak_number path)
        _fit_vna_flow(m, files, backend="matplotlib", N_peaks=[2],
                      smoothing=None, a_cutoff=10, threshold=0.5,
                      peak_width=50e3, Mag_depth_cutoff=0.5, Qr_cutoff=5)
        assert glob.glob("peak_number_estimation_*.png")
        assert m.Disconnect() in (True, None)
        return os.path.abspath(files[0]), params, delay
    finally:
        os.chdir(cwd)


def refit(m, path, tmp_path, tag):
    """fit_VNA.py's initialize_peaks + vna_fit through facade `m` on a
    copy of the VNA file at `path` (its Resonators removed): the fitted
    parameters, by f0."""
    fn = str(tmp_path / f"refit_{tag}.h5")
    shutil.copy(path, fn)
    with h5py.File(fn, "a") as f:
        del f["Resonators"]
    m.initialize_peaks(fn, N_peaks=2, a_cutoff=10, smoothing=None,
                       peak_width=50e3, Qr_cutoff=5, verbose=False,
                       exclude_center=True, diagnostic_plots=False,
                       Mag_depth_cutoff=0.5)
    m.vna_fit(fn, p0=None, fit_range=50e3, verbose=False)
    return by_f0(m.get_fit_param(fn))


def by_f0(params):
    return sorted(params, key=lambda p: p["f0"])


def same_fit(a, b, rtol=1e-9):
    assert len(a) == len(b) == 2
    for p, q in zip(a, b):
        for key in ("f0", "Qr", "Qi"):
            assert abs(p[key] / q[key] - 1) < rtol, (key, p[key], q[key])


def test_reference_get_vna_fit_vna_workflow(tmp_path, clean_delays):
    """The port's run of both flows against the JAX run's: the same line
    delay to a nanosecond; the VNA file's sweep (raw data, the
    calibrated S21, the fit windows) at >= 90 dB and the same frequency
    axes; the fitted resonators those JAX's fitter finds on the port's
    file, and the port's fitter finds JAX's on JAX's file; both runs'
    f0 within 10 kHz of the channel's resonators; the fit at 10.2 MHz the
    same in both runs within 1e-6.  (The fit at 9.85 MHz is not compared
    between the runs: on this line it moves by a few hundred Hz and its Qr
    by tens of percent with the sweep's last digits, which the packages
    round differently; the gaps print with -s.)"""
    jfile, jparams, jdelay = run_workflow(ju, {}, tmp_path / "jax")
    tfile, tparams, tdelay = run_workflow(u, {"device": "cpu"},
                                          tmp_path / "port")
    assert abs(tdelay - jdelay) < 1e-9, (tdelay, jdelay)
    with h5py.File(jfile, "r") as jf, h5py.File(tfile, "r") as tf:
        assert sorted(jf) == sorted(tf)
        for path in ("raw_data0/A_RX2/data", "VNA_0/S21", "VNA_0/frequency",
                     "Resonators/reso_0/freq", "Resonators/reso_1/freq"):
            jd, td = jf[path][()], tf[path][()]
            assert jd.shape == td.shape and jd.dtype == td.dtype, path
            if np.iscomplexobj(jd):
                assert golden.snr_db(jd.astype(np.complex128), td) >= 90.0
            else:
                assert np.array_equal(jd, td), path
    tparams, jparams = by_f0(tparams), by_f0(jparams)
    same_fit(tparams, refit(ju, tfile, tmp_path, "port_file_jax_fit"))
    same_fit(jparams, refit(u, jfile, tmp_path, "jax_file_port_fit"))
    expect = sorted(RF + r["f0"] for r in RESOS)
    for t, j, exp in zip(tparams, jparams, expect):
        assert abs(1e6 * t["f0"] - exp) < 10_000, (t["f0"], exp)
        assert abs(1e6 * j["f0"] - exp) < 10_000, (j["f0"], exp)
        print(f"port - JAX at {exp:.0f} Hz: f0 "
              f"{1e6 * (t['f0'] - j['f0']):+.1f} Hz, Qr "
              f"{t['Qr'] / j['Qr'] - 1:+.2e}, Qi {t['Qi'] / j['Qi'] - 1:+.2e}")
    # the well-conditioned fit, at 10.2 MHz: the two runs' within 1e-6
    same_fit([tparams[1]] * 2, [jparams[1]] * 2, rtol=1e-6)


def test_facade_connection_shims():
    """Every connection-plumbing shim the reference exposes (its sockets
    are module globals) behaves correctly against the port's server on
    127.0.0.1: exercised or dead — none silently padded."""
    from gpu_sdr_tpu_torch.server.main import Server

    srv = Server(async_port=0, data_port=0, host="127.0.0.1", device="cpu")
    srv.start()
    a_port, d_port = srv.ports
    try:
        # not connected yet: the passive shims report that state
        assert u.Async_thread() is False
        assert u.Sync_RX() is False
        assert u.Wait_for_async_connection() is False
        assert u.Wait_for_sync_connection() is False
        assert u.clean_data_queue() == 0

        assert u.Connect(host="127.0.0.1", async_port=a_port,
                         sync_port=d_port)
        assert u.Async_thread() is True
        assert u.Sync_RX() is True
        assert u.Wait_for_async_connection() is True
        assert u.Wait_for_sync_connection() is True
        assert u.Start_Async_RX() and u.Start_Sync_RX()
        assert u.Stop_Async_RX() and u.Stop_Sync_RX()
        assert u.reinit_data_socket() is None
        assert u.reinit_async_socket() is None

        # a residual packet in the data queue is drained + counted
        conn = u.get_connection()
        conn.data_queue.put(({"packet_number": 0}, np.zeros(4)))
        assert u.clean_data_queue() == 1
        assert u.clean_data_queue() == 0

        # EOM ack routing through the reference's payload decoder
        assert not conn.end_of_measure.is_set()
        u.Decode_Async_payload('{"type": "ack", "payload": "EOM"}')
        assert conn.end_of_measure.is_set()

        # header pretty-printer + socket binder
        u.Print_Sync_Header({k: 0 for k in
                             ("usrp_number", "front_end_code",
                              "packet_number", "length", "errors",
                              "channels")})
        s = socket.socket()
        try:
            assert u.USRP_socket_bind(s, ("127.0.0.1", a_port), 5.0) \
                in (True, False)
        finally:
            s.close()

        u.signal_handler(None, None)       # sets end_of_measure
        assert conn.end_of_measure.is_set()
        u.force_ternimate()                # closes the connection
    finally:
        try:
            u.Disconnect()
        except Exception:
            pass
        srv.close()

    assert u.Device_chk(3) is True
    assert u.Front_end_chk("A") and not u.Front_end_chk("Q")
    assert u.to_list_of_str("x") == ["x"]
    assert u.average_tones_diff([1.0, 2.0], [1.0, 2.5]) == 0.25
    with u.nostdout():
        print("swallowed")
    u.print_line("")
    saved = signal.getsignal(signal.SIGINT)
    try:
        u.mgr_init()
        assert signal.getsignal(signal.SIGINT) == signal.SIG_IGN
    finally:
        signal.signal(signal.SIGINT, saved)
    assert len(u.get_timestamp()) > 0
