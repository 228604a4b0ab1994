"""The port's pyusrp facade (gpu_sdr_tpu_torch/pyusrp.py): every public
name of the JAX package's facade, and the counterparts of the JAX
package's test_pyusrp_facade.py and test_facade_replay.py on the port,
the measurements on the CPU (device="cpu"), held against the JAX
facade's where they measure.
"""

import queue
import signal
import socket

import numpy as np
import pytest
import torch

import gpu_sdr_tpu.pyusrp as ju
import gpu_sdr_tpu_torch.pyusrp as u
from gpu_sdr_tpu import golden
from gpu_sdr_tpu_torch.engine.sources import ReplaySource
from gpu_sdr_tpu_torch.params import AntMode

torch.set_num_threads(2)

# the reference pyUSRP package's public names (grep '^def |^class ' over
# pyUSRP/USRP_*.py), as the JAX package's test_pyusrp_facade.py lists them
REFERENCE_NAMES = """
Dual_VNA Single_VNA VNA_timestream_analysis VNA_timestream_plot
VNA_analysis plot_VNA
reinit_data_socket reinit_async_socket clean_data_queue Packets_to_file
USRP_socket_bind Decode_Sync_Header Print_Sync_Header Decode_Async_header
Decode_Async_payload Encode_async_message Async_send Async_thread
Wait_for_async_connection Wait_for_sync_connection Start_Async_RX
Stop_Async_RX Connect Disconnect force_ternimate Sync_RX signal_handler
Start_Sync_RX Stop_Sync_RX
linear_phase
measure_line_delay write_delay_to_file analyze_line_delay
load_delay_from_file set_line_delay load_delay_from_folder
format_filename bound_open chk_multi_usrp get_receivers get_rx_info
get_tx_info openH5file get_noise get_trigger_info get_readout_power
global_parameter Device_chk Front_end_chk Param_to_H5 is_VNA_analyzed
get_VNA_data get_dynamic_VNA_data get_init_peaks is_VNA_dynamic_analyzed
real_of_complex complex_of_real nonlinear_model S21_func FWMH do_fit
extimate_peak_number initialize_peaks initialize_from_VNA vna_fit
get_fit_data get_fit_param get_best_readout min_readout_spacing
plot_resonators plot_reso_stat get_tones
get_NODSP_tones Get_full_spec plot_pfb
mgr_init nostdout to_list_of_str print_warning print_error print_debug
print_line get_timestamp vrms2dbm dbm2vrms find_nearest
average_tones_diff quantize_tones
dual_get_noise Get_noise spec_from_samples calculate_noise
plot_noise_spec calculate_frequency_timestream copy_resonator_group
get_frequency_timestreams plot_frequency_timestreams diagnostic_VNA_noise
calculate_NEF_spectra get_NEF_spec plot_NEF_spectra
get_color style_plotly_figure plot_raw_data
trigger_template deriv_test amplitude_trigger
""".split()


def public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_"))


def test_every_public_name_of_the_jax_facade():
    """Every public name of gpu_sdr_tpu.pyusrp is in the port's facade,
    of the same kind (class, function, module, constant)."""
    missing = [n for n in public(ju) if not hasattr(u, n)]
    assert not missing, f"port facade missing: {missing}"
    for n in public(ju):
        j, t = getattr(ju, n), getattr(u, n)
        assert type(j) is type(t) or callable(j) == callable(t), n


def test_facade_names_come_from_the_port():
    """No name of the port's facade is the JAX package's object: each
    function and class is defined in gpu_sdr_tpu_torch (or is a shared
    library object such as numpy's dtype)."""
    for n in public(u):
        obj = getattr(u, n)
        mod = getattr(obj, "__module__", None) or ""
        assert not mod.startswith("gpu_sdr_tpu."), (n, mod)
        if callable(obj) and mod.startswith("gpu_sdr_tpu"):
            assert mod.startswith("gpu_sdr_tpu_torch"), (n, mod)


def test_facade_wire_constants():
    """The module constants (USRP_low_level): the RX_wrapper header
    dtype, payload dtype and server addresses, the JAX facade's."""
    assert u.data_type is np.complex64
    assert u.header_type.itemsize == 21
    assert [n for n, *_ in u.header_type.descr] == [
        "usrp_number", "front_end_code", "packet_number", "length",
        "errors", "channels"]
    assert u.header_type == ju.header_type
    assert u.USRP_server_address == ju.USRP_server_address
    assert u.USRP_server_address_data == ju.USRP_server_address_data
    assert u.USRP_server_address[1] == 22001
    assert u.USRP_server_address_data[1] == 61360


def test_facade_covers_reference_namespace():
    missing = [n for n in REFERENCE_NAMES if not hasattr(u, n)]
    assert not missing, f"pyusrp facade missing reference names: {missing}"


def test_connection_plumbing_shims():
    # no active connection: these degrade gracefully
    assert u.reinit_data_socket() is None
    assert u.reinit_async_socket() is None
    assert u.clean_data_queue() == 0
    assert u.Async_thread() is False
    assert u.Sync_RX() is False
    u.force_ternimate()          # no-op without a connection
    u.signal_handler(2, None)    # prints a warning, no crash
    u.Decode_Async_payload('{"type": "nack"}')
    u.Decode_Async_payload("not json")


def test_clean_data_queue_counts():
    q = queue.Queue()
    for i in range(5):
        q.put((None, np.zeros(4, np.complex64)))
    assert u.clean_data_queue(q) == 5
    assert u.clean_data_queue(q) == 0


def test_usrp_socket_bind_timeout():
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.settimeout(0.2)
    try:
        # nothing listens on this port; must return False after ~timeout
        assert u.USRP_socket_bind(s, ("127.0.0.1", 1), 0.0) is False
    finally:
        s.close()


def test_print_sync_header(capsys):
    u.Print_Sync_Header({"usrp_number": 0, "front_end_code": 65,
                         "packet_number": 3, "length": 100, "errors": 0,
                         "channels": 2})
    out = capsys.readouterr().out
    assert "packet_number: 3" in out and "channels: 2" in out


def test_style_plotly_figure():
    fig = {"layout": {}}
    u.style_plotly_figure(fig)
    assert fig["layout"]["paper_bgcolor"] == "rgba(0,0,0,0)"
    assert fig["layout"]["plot_bgcolor"] == "rgba(0,0,0,0)"


def test_mgr_init_restores(monkeypatch):
    called = {}
    monkeypatch.setattr(signal, "signal",
                        lambda s, h: called.setdefault("args", (s, h)))
    u.mgr_init()
    assert called["args"] == (signal.SIGINT, signal.SIG_IGN)


@pytest.mark.parametrize("name", ["calculate_NEF_spectra", "get_NEF_spec",
                                  "plot_NEF_spectra"])
def test_nef_spectra_refused_as_in_jax(name):
    with pytest.raises(NotImplementedError):
        getattr(u, name)()
    with pytest.raises(NotImplementedError):
        getattr(ju, name)()


# ------------------------------------------ test_facade_replay.py

def test_facade_exports_reference_api():
    """Every name a reference workflow uses exists on the facade."""
    names = [
        "print_error", "print_warning", "print_debug", "get_timestamp",
        "vrms2dbm", "dbm2vrms", "quantize_tones", "find_nearest",
        "USRP_power", "USRP_calibration", "USRP_accepted_rates",
        "Connect", "Disconnect", "Async_send", "Packets_to_file",
        "openH5file", "get_rx_info", "get_tx_info", "bound_open",
        "format_filename", "Param_to_H5", "get_noise", "get_VNA_data",
        "is_VNA_analyzed", "get_init_peaks", "get_readout_power",
        "global_parameter",
        "Single_VNA", "Dual_VNA", "VNA_analysis",
        "VNA_timestream_analysis", "plot_VNA", "VNA_timestream_plot",
        "Get_noise", "dual_get_noise", "calculate_noise",
        "spec_from_samples", "copy_resonator_group",
        "get_frequency_timestreams", "calculate_frequency_timestream",
        "plot_noise_spec", "diagnostic_VNA_noise",
        "plot_frequency_timestreams",
        "nonlinear_model", "S21_func", "do_fit", "extimate_peak_number",
        "initialize_peaks", "initialize_from_VNA", "vna_fit",
        "get_fit_data", "get_fit_param", "get_best_readout",
        "min_readout_spacing", "get_tones", "plot_resonators",
        "LINE_DELAY", "measure_line_delay", "analyze_line_delay",
        "write_delay_to_file", "load_delay_from_file",
        "load_delay_from_folder", "set_line_delay",
        "Get_full_spec", "get_NODSP_tones", "plot_pfb",
        "trigger_template", "deriv_test", "amplitude_trigger",
        "plot_raw_data", "get_color", "linear_phase",
    ]
    missing = [n for n in names if not hasattr(u, n)]
    assert not missing, f"facade missing: {missing}"


def test_global_parameter_set_get():
    gp = u.global_parameter()
    assert gp.set("A_RX2", "mode", "RX")
    assert gp.set("A_RX2", "rate", 1_000_000)
    assert gp.set("A_RX2", "rf", 300_000_000)
    assert gp.set("A_RX2", "wave_type", ["DIRECT"])
    assert gp.get("A_RX2", "rf") == 300_000_000
    assert gp.get("A_RX2", "mode") == AntMode.RX
    assert gp.self_check()
    jp = ju.global_parameter()
    for key, value in (("mode", "RX"), ("rate", 1_000_000),
                       ("rf", 300_000_000), ("wave_type", ["DIRECT"])):
        jp.set("A_RX2", key, value)
    assert jp.self_check()
    assert gp.to_json() == jp.to_json()


def test_replay_source_measurement(tmp_path, monkeypatch):
    """Record IQ to disk, replay it through a DIRECT demod with the
    facade's run_measurement on the CPU: the tone at its amplitude, and
    the file's data the JAX facade's at >= 90 dB."""
    monkeypatch.chdir(tmp_path)
    rate = 1_000_000
    f0 = 123_456
    n = np.arange(300_000, dtype=np.int64)
    x = (0.7 * np.exp(2j * np.pi * ((f0 * (n % rate)) % rate) / rate)
         ).astype(np.complex64)
    path = str(tmp_path / "recording.npy")
    np.save(path, x)

    def cmd(P):
        c = P.UsrpParams()
        c.A_RX2 = P.AntennaParams(
            mode=P.AntMode.RX, rate=rate, buffer_len=100_000,
            samples=300_000, decim=100, pf_average=4, freq=[f0],
            wave_type=[P.WaveType.DIRECT], delay=1.0)
        return c
    fn = u.run_measurement(cmd(u), "replay_meas", source=ReplaySource(path),
                           device="cpu")
    data = u.openH5file(fn)
    steady = data[0, 8:]
    assert np.allclose(np.abs(steady), 0.7, atol=2e-3)
    from gpu_sdr_tpu.engine.sources import ReplaySource as JReplaySource
    jfn = ju.run_measurement(cmd(ju), "replay_meas_jax",
                             source=JReplaySource(path))
    assert golden.snr_db(ju.openH5file(jfn).astype(np.complex128),
                         data) >= 90.0


def test_replay_source_loop_and_pad(tmp_path):
    src = ReplaySource.__new__(ReplaySource)
    src.data = np.arange(10, dtype=np.complex64)
    src.loop = True
    blocks = list(src.blocks(8, 3))
    assert np.array_equal(blocks[0], np.arange(8))
    assert np.array_equal(blocks[1], [8, 9, 0, 1, 2, 3, 4, 5])
    src2 = ReplaySource.__new__(ReplaySource)
    src2.data = np.arange(10, dtype=np.complex64)
    src2.loop = False
    blocks = list(src2.blocks(8, 2))
    assert np.array_equal(blocks[1], [8, 9, 0, 0, 0, 0, 0, 0])


def test_in_process_measurements_default_to_the_card(monkeypatch,
                                                     tmp_path):
    """Connect() with no host runs in-process: the facade's measurement
    calls run on "cuda" unless `device=` says otherwise, so with no card
    they raise; device="cpu" passes through to run_measurement."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert u.Connect() is True
    kw = dict(measure_t=0.01, rate=1_000_000, RF=0, decimation=100,
              output_filename="noise_dev")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        u.Get_noise([10_000], **kw)
    fn = u.Get_noise([10_000], device="cpu", **kw)
    assert u.openH5file(fn).shape == (1, 100)
    # torch's own refusal of a CUDA tensor here
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        u.calculate_noise(fn, welch=2, backend="torch")
    u.calculate_noise(fn, welch=2, backend="torch", device="cpu")
    assert u.get_noise(fn)[1].size > 0
