"""pyUSRP-compatible facade of the port (the port's copy of
gpu_sdr_tpu/pyusrp.py, every public name of it).

Drop-in namespace mirroring the reference client library: reference-style
workflows change only their import line,

    import gpu_sdr_tpu_torch.pyusrp as u

and keep calling `u.Connect()`, `u.Single_VNA(...)`, `u.Get_noise(...)`,
`u.measure_line_delay(...)`, `u.vna_fit(...)`, etc.

Execution model: by default measurements run in-process on the port's
engine on the CUDA card (no server round trip); every measurement and
analysis call takes ``device=`` ("cuda" by default, "cpu" on request),
and with no card "cuda" raises.  `Connect(host=...)` attaches to a
server (the port's, gpu_sdr_tpu_torch.server.main, or the JAX
package's) over the reference TCP protocol instead.  Neither matplotlib
nor h5py is needed to import it.
"""

from __future__ import annotations

# --- low level (USRP_low_level) --------------------------------------
from .client.files import USRP_calibration, USRP_power  # noqa: F401
from .client.noise import USRP_accepted_rates, find_nearest, quantize_tones  # noqa: F401
from .utils.diagnostics import print_debug, print_error, print_warning  # noqa: F401


def get_timestamp():
    import datetime
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def vrms2dbm(vp):
    from .client.fitting import vrms2dbm as f
    return f(vp)


def dbm2vrms(dbm):
    from .client.fitting import dbm2vrms as f
    return f(dbm)


# --- connections (USRP_connections) ----------------------------------
from .client.connections import (Async_send, Disconnect,  # noqa: F401,E402
                                 Connection, Packets_to_file, get_connection)
from .client import connections as _connections  # noqa: E402


def Connect(timeout: float = 10.0, host=None, **kwargs) -> bool:
    """Reference-compatible Connect().

    With no host (the default) measurements run on the in-process engine
    and no connection is needed — returns True immediately.  Pass
    ``host=...`` to attach to a server over TCP.
    """
    if host is None:
        return True
    return _connections.Connect(timeout=timeout, host=host, **kwargs)

# --- files (USRP_files) ----------------------------------------------
from .client.files import (H5Sink, bound_open, chk_multi_usrp,  # noqa: F401,E402
                           format_filename, get_init_peaks, get_noise,
                           get_readout_power, get_rx_info, get_tx_info,
                           get_VNA_data, is_VNA_analyzed, mixed_streams,
                           openH5file,
                           params_to_h5 as Param_to_H5,
                           retrieve_params_from_file)
from .params import AntennaParams, AntMode, UsrpParams, WaveType  # noqa: F401,E402


class global_parameter(UsrpParams):
    """Back-compat alias: the reference's measure descriptor class."""

    def set(self, ant, key, value):
        key_map = {"rf": "tone"}
        p = self.antenna(ant)
        attr = key_map.get(key, key)
        if key == "wave_type":
            value = [WaveType(v) for v in value]
        if key == "mode":
            value = AntMode(value)
        setattr(p, attr, value)
        return True

    def get(self, ant, key):
        key_map = {"rf": "tone"}
        return getattr(self.antenna(ant), key_map.get(key, key))

    def self_check(self):
        try:
            self.validate()
            return True
        except Exception:
            return False


# --- VNA (USRP_VNA) --------------------------------------------------
from .client.vna import (Dual_VNA, Single_VNA, VNA_analysis,  # noqa: F401,E402
                         VNA_timestream_analysis)
from .client.plotting import plot_VNA, VNA_timestream_plot  # noqa: F401,E402

# --- noise (USRP_noise) ----------------------------------------------
from .client.noise import (Get_noise, calculate_frequency_timestream,  # noqa: F401,E402
                           calculate_noise, copy_resonator_group,
                           dual_get_noise, get_frequency_timestreams,
                           spec_from_samples)
from .client.plotting import (diagnostic_VNA_noise, plot_noise_spec,  # noqa: F401,E402
                              plot_frequency_timestreams)

# --- fitting (USRP_fitting) ------------------------------------------
from .client.fitting import (S21_func, do_fit, extimate_peak_number,  # noqa: F401,E402
                             get_best_readout, get_fit_data, get_fit_param,
                             get_tones, initialize_from_VNA,
                             initialize_peaks, min_readout_spacing,
                             nonlinear_model, vna_fit)
from .client.plotting import plot_resonators  # noqa: F401,E402

# --- delay (USRP_delay) ----------------------------------------------
from .client.delay import (LINE_DELAY, analyze_line_delay,  # noqa: F401,E402
                           load_delay_from_file, load_delay_from_folder,
                           measure_line_delay, set_line_delay,
                           write_delay_to_file)

# --- full spectrum (USRP_full_spec) ----------------------------------
from .client.full_spec import Get_full_spec, get_NODSP_tones  # noqa: F401,E402
from .client.plotting import plot_pfb  # noqa: F401,E402

# --- triggers (USRP_triggers) ----------------------------------------
from .client.triggers import amplitude_trigger, deriv_test, trigger_template  # noqa: F401,E402

# --- plotting (USRP_plotting) ----------------------------------------
from .client.plotting import get_color, plot_raw_data  # noqa: F401,E402

# --- data analysis ----------------------------------------------------
from .client.data_analysis import linear_phase  # noqa: F401,E402

# --- remaining low-level / wire compat names --------------------------
import contextlib as _contextlib  # noqa: E402
import sys as _sys  # noqa: E402

import numpy as _np  # noqa: E402

from .client.files import get_receivers, get_trigger_info  # noqa: F401,E402
from .client.fitting import FWMH, complex_of_real, real_of_complex  # noqa: F401,E402
from .client.vna import get_dynamic_VNA_data, is_VNA_dynamic_analyzed  # noqa: F401,E402
from .client.plotting import plot_reso_stat  # noqa: F401,E402
from .server.wire import (decode_async_header as Decode_Async_header,  # noqa: F401,E402
                          decode_sync_header as Decode_Sync_Header,
                          encode_async_message as Encode_async_message)


def average_tones_diff(tones_original, tones_quantized):
    """Mean |quantization error| (reference USRP_low_level.py:249-259)."""
    if len(tones_original) != len(tones_quantized):
        raise TypeError("Quantized tones and tones differ in length")
    return float(_np.mean(_np.abs(_np.asarray(tones_original) -
                                  _np.asarray(tones_quantized))))


def to_list_of_str(user_input):
    """Coerce a string to a one-element list (reference
    USRP_low_level.py:136-161)."""
    return [user_input] if isinstance(user_input, str) else list(user_input)


def print_line(msg):
    _sys.stdout.write(str(msg))
    _sys.stdout.flush()


@_contextlib.contextmanager
def nostdout():
    """Silence stdout within a context (reference USRP_low_level.py:122)."""
    import io
    saved = _sys.stdout
    _sys.stdout = io.StringIO()
    try:
        yield
    finally:
        _sys.stdout = saved


def Device_chk(device):
    """Accept any device number, defaulting to 0 (reference Device_chk,
    pyUSRP/USRP_files.py:912-927)."""
    return True


def Front_end_chk(front_end):
    """Front-end code must be 'A' or 'B' (reference Front_end_chk)."""
    return front_end in ("A", "B")


# The reference exposes its receiver-thread plumbing (Start/Stop_Async_RX,
# Start/Stop_Sync_RX, Wait_for_*_connection) because its sockets are module
# globals; here the Connection object owns its threads, so these are
# no-op compatibility shims that succeed whenever a connection exists.
def Start_Async_RX(*a, **k):
    return True


def Start_Sync_RX(*a, **k):
    return True


def Stop_Async_RX(*a, **k):
    return True


def Stop_Sync_RX(*a, **k):
    return True


def reinit_data_socket():
    """Reference reinit_data_socket (pyUSRP/USRP_connections.py:49-56):
    re-creates the module-global data socket.  Here sockets belong to the
    Connection object, which recreates them on Connect() — nothing to do."""
    return None


def reinit_async_socket():
    """Reference reinit_async_socket (pyUSRP/USRP_connections.py:59-67);
    see reinit_data_socket."""
    return None


def clean_data_queue(data_queue=None):
    """Drain residual packets from the data queue; returns how many were
    removed (reference clean_data_queue,
    pyUSRP/USRP_connections.py:70-86)."""
    import queue as _queue
    if data_queue is None:
        conn = _connections._global_connection
        if conn is None:
            return 0
        data_queue = conn.data_queue
    residual = 0
    while True:
        try:
            data_queue.get_nowait()
            residual += 1
        except _queue.Empty:
            break
    return residual


def USRP_socket_bind(sock, server_address, timeout):
    """Connect a socket, retrying until `timeout` seconds have elapsed;
    returns True on success (reference USRP_socket_bind,
    pyUSRP/USRP_connections.py:349-391)."""
    import socket as _socket
    import time as _time
    deadline = _time.time() + max(float(timeout), 0.0)
    while True:
        try:
            sock.connect(tuple(server_address))
            return True
        except (_socket.error, OSError):
            if _time.time() >= deadline:
                print_warning("Socket binding timeout")
                return False
            _time.sleep(1)


def Print_Sync_Header(header):
    """Pretty-print a sync-packet header (reference Print_Sync_Header,
    pyUSRP/USRP_connections.py:428-434)."""
    for key in ("usrp_number", "front_end_code", "packet_number",
                "length", "errors", "channels"):
        print(f"{key}: {header[key]}")


def Decode_Async_payload(message):
    """Act on a decoded async JSON server message (reference
    Decode_Async_payload, pyUSRP/USRP_connections.py:446-481): ack payloads
    containing EOM mark end-of-measure on the active connection."""
    import json as _json
    conn = _connections._global_connection
    if conn is not None:
        conn._handle_async(message)
        return
    try:
        res = _json.loads(message)
    except ValueError:
        print_warning("Cannot decode response from server")
        return
    if res.get("type") == "nack":
        print_warning("Server declined the last command")


def Async_thread(*a, **k):
    """The reference runs this function as the command-channel receiver
    thread (pyUSRP/USRP_connections.py:446); the Connection object owns
    that thread here, so this is a no-op that reports whether one runs."""
    return _connections._global_connection is not None


def Sync_RX(*a, **k):
    """Reference data-receiver process body (pyUSRP/USRP_connections.py:814);
    owned by the Connection object here — see Async_thread."""
    return _connections._global_connection is not None


def force_ternimate():
    """Tear the data receiver down immediately (reference force_ternimate
    — sic — pyUSRP/USRP_connections.py:809-811)."""
    conn = _connections._global_connection
    if conn is not None:
        conn.close()


def signal_handler(sig, frame):
    """Ctrl-C: disconnect and save the last chunk (reference
    signal_handler, pyUSRP/USRP_connections.py:976-993).  Packets_to_file
    installs its own handler; this module-level one closes the active
    connection after repeated presses, like the reference."""
    print_warning("Got Ctrl+C, disconnecting and saving last chunk of data.")
    conn = _connections._global_connection
    if conn is not None:
        conn.end_of_measure.set()


def mgr_init():
    """SyncManager initializer: ignore SIGINT inside the manager process so
    Ctrl+C propagates to the client (reference mgr_init,
    pyUSRP/USRP_low_level.py:99-107)."""
    import signal as _signal
    _signal.signal(_signal.SIGINT, _signal.SIG_IGN)


from .client.plotting import style_plotly_figure  # noqa: F401,E402


def Wait_for_async_connection(timeout=None, **k):
    return _connections._global_connection is not None


def Wait_for_sync_connection(timeout=None, **k):
    return _connections._global_connection is not None


# reference declares these NEF helpers but leaves them empty
# (pyUSRP/USRP_noise.py:1660-1669); kept for name compatibility
def calculate_NEF_spectra(*args, **kwargs):
    raise NotImplementedError(
        "NEF spectra are an empty stub in the reference as well")


def get_NEF_spec(*args, **kwargs):
    raise NotImplementedError(
        "NEF spectra are an empty stub in the reference as well")


def plot_NEF_spectra(*args, **kwargs):
    raise NotImplementedError(
        "NEF spectra are an empty stub in the reference as well")


# --- engine extensions (no reference equivalent) ----------------------
from .engine.channel import (ChainChannel, DelayChannel,  # noqa: F401,E402
                             FrequencyResponseChannel, IdealChannel,
                             make_resonator_channel)
from .measure import run_measurement  # noqa: F401,E402

# ----------------------------------------------------------------------
# reference USRP_low_level module-level constants
# (pyUSRP/USRP_low_level.py:23-73): wire dtypes and server address
# ----------------------------------------------------------------------
from .server import wire as _wire  # noqa: E402
header_type = _wire.header_dtype           # RX_wrapper packet header dtype
data_type = _np.complex64                  # payload sample dtype
USRP_IP_ADDR = "127.0.0.1"                 # in-process server default
USRP_server_address = (USRP_IP_ADDR, _wire.ASYNC_PORT)
USRP_server_address_data = (USRP_IP_ADDR, _wire.SYNC_PORT)
