"""The port's server over real sockets on 127.0.0.1, on the CPU: the
counterparts of the JAX package's test_network.py, test_server_sessions.py,
test_server_cli.py, test_server_ingest.py and test_native.py, each on the
port's Server(device="cpu") and the port's client, and the divergences
of the port's server from the JAX one (ROADMAP Queue 3 #31-#33, #35).

Every server binds port 0 and reads its port back; every socket wait has
a deadline (recv_exact's, wait_client's, Packets_to_file's timeout=, a
bounded join), so a fault fails a test instead of hanging the suite.
"""

import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch.client import connections as Uconn
from gpu_sdr_tpu_torch.client import files as Ufiles
from gpu_sdr_tpu_torch.engine.sinks import MemorySink, PacketMeta
from gpu_sdr_tpu_torch.params import (AntennaParams, AntMode,
                                      ServerSettings, UsrpParams, WaveType)
from gpu_sdr_tpu_torch.server import native as native_mod
from gpu_sdr_tpu_torch.server import network, wire
from gpu_sdr_tpu_torch.server.main import Server

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a subprocess's thread pools as small as this process's: the suite's
# workers share the host's cores
THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2",
           "OPENBLAS_NUM_THREADS": "2"}
WAIT_S = 30.0


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def cpu_server(**kw):
    srv = Server(async_port=0, data_port=0, host="127.0.0.1", device="cpu",
                 **kw)
    srv.start()
    return srv


@contextmanager
def serving(srv, once=False, poll=0.5):
    """srv serving in a thread (one measurement when `once`), joined
    within WAIT_S at the end, then closed."""
    stop = threading.Event()

    def loop():
        if once:
            srv.serve_one(timeout=WAIT_S)
            return
        while not stop.is_set():
            srv.serve_one(timeout=poll)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        yield srv.ports
    finally:
        stop.set()
        th.join(timeout=WAIT_S)
        srv.close()
        assert not th.is_alive(), "the server loop did not end"


def connect(ports):
    return Uconn.Connection(host="127.0.0.1", async_port=ports[0],
                            sync_port=ports[1])


def to_file(conn, cmd, name):
    return Uconn.Packets_to_file(conn, cmd, filename=name, progress=False,
                                 timeout=WAIT_S)


def _direct_command(rate=1_000_000, samples=300_000):
    freqs = [100_000, -200_000]
    cmd = UsrpParams(usrp_number=0)
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=100_000, samples=samples,
        freq=freqs, ampl=[0.4, 0.4], wave_type=[WaveType.TONES] * 2,
        delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=samples,
        decim=100, pf_average=4, freq=freqs,
        wave_type=[WaveType.DIRECT] * 2, delay=1.0)
    return cmd


def _cmd(freq, samples=100_000, fe="A"):
    cmd = UsrpParams()
    setattr(cmd, f"{fe}_TXRX", AntennaParams(
        mode=AntMode.TX, rate=1_000_000, buffer_len=100_000,
        samples=samples, freq=[freq], ampl=[0.5],
        wave_type=[WaveType.TONES], delay=1.0))
    setattr(cmd, f"{fe}_RX2", AntennaParams(
        mode=AntMode.RX, rate=1_000_000, buffer_len=100_000,
        samples=samples, decim=100, pf_average=4, freq=[freq],
        wave_type=[WaveType.DIRECT], delay=1.0))
    return cmd


def in_process(cmd):
    """(rows, channels) of the same measurement through the port's
    run_measurement on the CPU."""
    sink = MemorySink()
    measure.run_measurement(UsrpParams.from_json(cmd.to_json()),
                            extra_sinks=[sink], device="cpu")
    return sink.data


# ---------------------------------------------------------------- wire

def test_wire_sync_roundtrip():
    data = (np.arange(10) + 1j * np.arange(10)).astype(np.complex64)
    buf = wire.encode_sync_packet(0, b"B", 7, 2, 5, data)
    assert len(buf) == wire.HEADER_SIZE + 80
    meta = wire.decode_sync_header(buf[:wire.HEADER_SIZE])
    assert meta == {"usrp_number": 0, "front_end_code": "A_RX2",
                    "packet_number": 7, "length": 10, "errors": 2,
                    "channels": 5}
    back = np.frombuffer(buf[wire.HEADER_SIZE:], dtype=np.complex64)
    assert np.array_equal(back, data)


def test_wire_async_roundtrip():
    msg = wire.encode_async_message('{"a": 1}')
    assert wire.decode_async_header(msg[:8]) == 8
    assert msg[8:] == b'{"a": 1}'


def test_params_json_roundtrip():
    """The JSON command survives the wire: from_json(to_json(p)) == p,
    and validate() on the copy gives the same warnings."""
    cmd = _direct_command()
    back = UsrpParams.from_json(cmd.to_json())
    assert back == cmd and back is not cmd
    assert back.copy() == cmd
    assert back.validate() == cmd.copy().validate()


# ------------------------------------------------- TCP (test_network.py)

def test_tcp_end_to_end_measurement(tmp_chdir):
    """Server + client over real sockets: a DIRECT command, the
    demodulated packets streamed back into an HDF5 file: the physics, and
    the file's data the in-process run's bit for bit."""
    cmd = _direct_command()
    with serving(cpu_server(file_writing=False), once=True) as ports:
        conn = connect(ports)
        try:
            conn.send_params(cmd)
            fn = to_file(conn, cmd, "tcp_meas")
        finally:
            conn.close()
    data = Ufiles.openH5file(fn)
    assert data.shape == (2, 300_000 // 100)
    steady = data[:, 8:]
    assert np.allclose(np.abs(steady[0]), 0.4, atol=2e-3)
    assert np.allclose(np.abs(steady[1]), 0.4, atol=2e-3)
    assert np.array_equal(data, in_process(cmd).T)


def test_tcp_nack_on_bad_command(tmp_chdir):
    with serving(cpu_server(), once=True) as ports:
        conn = connect(ports)
        try:
            # out-of-Nyquist tone -> server must nack and set error status
            bad = _direct_command()
            bad.A_RX2.wave_type = [WaveType.TONES] * 2
            bad.A_RX2.freq = [5_000_000, 0]
            bad.A_RX2.fft_tones = 16
            conn.send_params(bad)
            assert conn.end_of_measure.wait(timeout=WAIT_S)
            assert conn.error_status.is_set()
        finally:
            conn.close()


def test_pyusrp_style_global_api(tmp_chdir):
    """Connect()/Async_send()/Disconnect() module-level mirror."""
    with serving(cpu_server(), once=True) as (a_port, d_port):
        try:
            assert Uconn.Connect(host="127.0.0.1", async_port=a_port,
                                 sync_port=d_port)
            cmd = _direct_command(samples=100_000)
            conn = Uconn.get_connection()
            conn.send_params(cmd)
            fn = to_file(conn, cmd, "tcp_meas2")
            data = Ufiles.openH5file(fn)
            assert data.shape[1] == 100_000 // 100
        finally:
            Uconn.Disconnect()
    with pytest.raises(RuntimeError, match="not connected"):
        Uconn.get_connection()


# ------------------------------------- sessions (test_server_sessions.py)

def test_many_sequential_measurements(tmp_chdir):
    """Five measurements back-to-back on one connection, each correct."""
    with serving(cpu_server()) as ports:
        conn = connect(ports)
        try:
            for i in range(5):
                cmd = _cmd(freq=10_000 * (i + 1))
                conn.send_params(cmd)
                data = Ufiles.openH5file(to_file(conn, cmd, f"seq_{i}"))
                assert data.shape == (1, 1000)
                assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3), i
        finally:
            conn.close()


def test_dual_rx_over_tcp(tmp_chdir):
    """Dual-frontend measurement over TCP: packets route by front-end code
    into the right H5 groups."""
    cmd = _cmd(freq=50_000, fe="A")
    b = _cmd(freq=-70_000, fe="B")
    cmd.B_TXRX = b.B_TXRX
    cmd.B_RX2 = b.B_RX2
    with serving(cpu_server(), once=True) as ports:
        conn = connect(ports)
        try:
            conn.send_params(cmd)
            fn = to_file(conn, cmd, "dual_tcp")
        finally:
            conn.close()
    for ant in ("A_RX2", "B_RX2"):
        data = Ufiles.openH5file(fn, front_end=ant)
        assert data.shape == (1, 1000), ant
        assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3), ant


@pytest.mark.parametrize("use_native", [False, True])
def test_client_reconnect(tmp_chdir, use_native):
    """A client that disconnects entirely and reconnects gets served again
    (the reference's reconnect_data/reconnect_async + virtual_pinger
    watchdog, cpp/USRP_server_network.cpp:3-4,135-161) — on both the
    Python and the native C++ data plane."""
    srv = cpu_server(use_native=use_native)
    assert isinstance(srv.sync, native_mod.NativeSyncServer if use_native
                      else network.SyncServer)
    with serving(srv) as ports:
        for i in range(2):                  # full disconnect between runs
            conn = connect(ports)
            try:
                cmd = _cmd(freq=20_000 * (i + 1))
                conn.send_params(cmd)
                data = Ufiles.openH5file(to_file(conn, cmd, f"reconn_{i}"))
                assert data.shape == (1, 1000)
                assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3), i
            finally:
                conn.close()


def test_ninety_measurements_no_degradation(tmp_chdir):
    """The reference UHD server crashed after ~83 measurements (the
    disabled reset_usrp_host workaround, cpp/USRP_hardware_manager.cpp:
    8-52).  Run 90 back-to-back measurements on one connection and check
    the last ones are as correct as the first."""
    with serving(cpu_server(), poll=0.2) as ports:
        conn = connect(ports)
        try:
            for i in range(90):
                cmd = _cmd(freq=1000 * (i % 37 + 1), samples=20_000)
                conn.send_params(cmd)
                fn = to_file(conn, cmd, f"m{i:03d}")
                if i < 2 or i >= 85:
                    data = Ufiles.openH5file(fn)
                    assert data.shape == (1, 200), i
                    assert np.allclose(np.abs(data[0, 8:]), 0.5,
                                       atol=2e-3), i
        finally:
            conn.close()


def test_server_dual_uses_lockstep_path(tmp_chdir, monkeypatch):
    """A server-driven dual (A+B) measurement dispatches the lock-step
    DualFused program, not sequential front ends: TXRX hands channel=None
    through to run_measurement."""
    import gpu_sdr_tpu_torch.engine.dual as dual_mod
    from gpu_sdr_tpu_torch.server.txrx import TXRX

    made = []
    orig = dual_mod.DualFused.__init__

    def spy(self, *a, **k):
        made.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(dual_mod.DualFused, "__init__", spy)
    cmd = _cmd(100_000)
    b = _cmd(-200_000, fe="B")
    cmd.B_TXRX = b.B_TXRX
    cmd.B_RX2 = b.B_RX2
    txrx = TXRX(ServerSettings(tcp_streaming=False, file_writing=True),
                device="cpu")
    txrx.set(cmd)
    txrx.start()
    assert txrx.wait(timeout=120)
    assert txrx.error is None
    assert made, "dual measurement did not take the DualFused path"
    assert measure.last_dispatch()[0][1] == "dual_fused"
    assert os.path.exists(Ufiles.format_filename(txrx.last_filename))


def test_server_death_mid_measure_raises_not_hangs(tmp_chdir):
    """If the server vanishes mid-measure, Packets_to_file raises
    promptly instead of spinning on an empty queue (the RX threads flag
    error/EOM on an EOF that precedes the EOM)."""
    srv = cpu_server()
    conn = connect(srv.ports)
    killer = threading.Timer(0.5, srv.close)
    try:
        # no measurement is ever started; killing the server must still
        # release a waiting consumer via the EOF path
        killer.start()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            Uconn.Packets_to_file(conn, _cmd(freq=10_000),
                                  filename="dead_server", progress=False)
        assert time.monotonic() - t0 < WAIT_S
    finally:
        killer.join(timeout=WAIT_S)
        conn.close()
        srv.close()


# ----------------------------------------------- CLI (test_server_cli.py)

def spawn_cli(tmp_path, *args, blocked=(), env=()):
    """The CLI in a subprocess (`blocked` modules set to None first,
    `env` added to the environment)."""
    code = "".join(f"import sys; sys.modules[{m!r}] = None; "
                   for m in blocked)
    code += ("from gpu_sdr_tpu_torch.server.main import main; "
             f"raise SystemExit(main({list(args)!r}))")
    return subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=REPO, **THREADS, **dict(env)))


def ready_ports(proc):
    """The ports of the CLI's "server ready" line."""
    line, t0 = "", time.monotonic()
    while "server ready" not in line:
        line = proc.stdout.readline()
        assert line or proc.poll() is None, "the server exited"
        assert time.monotonic() - t0 < 60, "server did not start"
    m = re.search(r"async port (\d+), data port (\d+)", line)
    assert "on cpu" in line, line
    return int(m.group(1)), int(m.group(2))


def test_server_cli_daemon(tmp_path):
    """`main(--one_shot --device cpu)` in a subprocess with jax and the
    JAX package unimportable: connect over TCP, run a measurement, read
    the streamed results; the daemon exits after its one measurement."""
    proc = spawn_cli(tmp_path, "--one_shot", "--async_port", "0",
                     "--data_port", "0", "--device", "cpu",
                     blocked=("jax", "gpu_sdr_tpu"))
    try:
        conn = connect(ready_ports(proc))
        try:
            cmd = _cmd(50_000, samples=200_000)
            conn.send_params(cmd)
            fn = to_file(conn, cmd, str(tmp_path / "cli_meas"))
            data = Ufiles.openH5file(fn)
            assert data.shape == (1, 2000)
            assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3)
        finally:
            conn.close()
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)


def test_cli_flags_match_jax():
    """The port's CLI takes every flag of the JAX package's, with the
    same defaults, and --device besides (ROADMAP Queue 3 #31)."""
    from gpu_sdr_tpu.server.main import build_arg_parser as jparser
    from gpu_sdr_tpu_torch.server.main import build_arg_parser
    jacts = {a.dest: a for a in jparser()._actions}
    tacts = {a.dest: a for a in build_arg_parser()._actions}
    assert set(tacts) - set(jacts) == {"device"}
    assert set(jacts) <= set(tacts)
    for dest, a in jacts.items():
        assert tacts[dest].option_strings == a.option_strings, dest
        assert tacts[dest].default == a.default, dest
    assert tacts["device"].default == "cuda"
    args = build_arg_parser().parse_args(["--device", "cuda:1", "--ingest"])
    assert (args.device, args.ingest) == ("cuda:1", wire.INGEST_PORT)


def test_deriv_trigger_passes_glitchy_data():
    from gpu_sdr_tpu_torch.client.triggers import deriv_test
    trig = deriv_test(threshold=1.1)
    n_chan, L = 2, 600
    base = np.ones(L * n_chan, dtype=np.complex64)
    md = {"channels": n_chan, "length": L * n_chan}
    # two quiet packets accumulate
    out, md1 = trig.trigger(base.copy(), dict(md))
    assert md1["length"] == 0
    out, md2 = trig.trigger(base.copy(), dict(md))
    assert md2["length"] == 0
    # third packet has a glitch -> all accumulated data released
    glitchy = base.copy()
    glitchy[100] += 50
    out, md3 = trig.trigger(glitchy, dict(md))
    assert md3["length"] == 3 * L * n_chan
    assert len(out) == 3 * L * n_chan


# ------------------------------------- ingest (test_server_ingest.py)

def test_ingest_measurement_over_server(tmp_chdir):
    """The server binds the native ingest receiver, announces its port in
    an ack, a producer streams raw complex64 IQ to it and the demodulated
    packets come back over the data plane: the file's data the port's
    in-process run of the same samples, bit for bit."""
    from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
    from gpu_sdr_tpu_torch.engine.sources import ArraySource
    rate, samples = 1_000_000, 400_000
    cmd = UsrpParams()
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=samples,
        decim=100, pf_average=4, freq=[100_000],
        wave_type=[WaveType.DIRECT])
    t = np.arange(samples)
    iq = (0.4 * np.exp(2j * np.pi * 100_000 * t / rate)).astype(np.complex64)
    with serving(cpu_server(ingest_port=0), once=True) as ports:
        conn = connect(ports)

        def produce():
            deadline = time.monotonic() + WAIT_S
            while conn.ingest_port is None:
                if time.monotonic() > deadline:
                    return
                time.sleep(0.01)
            with socket.create_connection(("127.0.0.1", conn.ingest_port),
                                          timeout=WAIT_S) as s:
                s.sendall(iq.tobytes())

        producer = threading.Thread(target=produce, daemon=True)
        try:
            conn.send_params(cmd)
            producer.start()
            fn = to_file(conn, cmd, "ingest_meas")
        finally:
            producer.join(timeout=WAIT_S)
            conn.close()
        assert not producer.is_alive()
        assert conn.ingest_port is not None
    data = Ufiles.openH5file(fn)
    assert data.shape == (1, samples // 100)
    assert np.allclose(np.abs(data[0, 8:]), 0.4, atol=2e-3)
    ref = MemorySink()
    run_pipeline(make_demodulator(cmd.A_RX2, "cpu"), ArraySource(iq), [ref])
    assert np.array_equal(data, ref.data.T)


# ---------------------------------------------- native (test_native.py)

def test_native_streamer_roundtrip():
    """Push packets through the C++ streamer, receive them with the
    client-side decoder: framing and payload intact, in order; the ring's
    slots grow past their initial size; stats count what was sent."""
    srv = native_mod.NativeSyncServer(port=0, slot_bytes=1 << 12,
                                      queue_len=32)
    try:
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        c.settimeout(5)
        rng = np.random.default_rng(0)
        sent = []
        for i in range(20):
            data = (rng.standard_normal(500) + 1j *
                    rng.standard_normal(500)).astype(np.complex64)
            meta = PacketMeta(usrp_number=0, front_end_code="A",
                              packet_number=i, length=500, errors=0,
                              channels=5)
            assert srv.push(meta, data)
            sent.append(data)
        for i in range(20):
            raw = wire.recv_exact(c, wire.HEADER_SIZE)
            meta = wire.decode_sync_header(raw)
            assert meta["packet_number"] == i
            assert meta["channels"] == 5
            assert meta["front_end_code"] == "A_RX2"
            payload = wire.recv_exact(c, 8 * meta["length"])
            got = np.frombuffer(payload, dtype=np.complex64)
            assert np.array_equal(got, sent[i])
        srv.flush()
        assert srv.stats == {"packets_sent": 20,
                             "bytes_sent": 20 * (wire.HEADER_SIZE + 4000)}
        c.close()
    finally:
        srv.close()
    assert srv.stats == {"packets_sent": 0, "bytes_sent": 0}
    srv.drop_client()           # a call after close() is harmless


def test_native_end_to_end_measurement(tmp_chdir):
    """Full TCP measurement with the native data plane serving packets:
    every packet the server sent is in the file."""
    cmd = _cmd(100_000, samples=200_000)
    srv = cpu_server(use_native=True)
    with serving(srv, once=True) as ports:
        conn = connect(ports)
        try:
            conn.send_params(cmd)
            fn = to_file(conn, cmd, "native_meas")
            sent = srv.sync.stats
        finally:
            conn.close()
    data = Ufiles.openH5file(fn)
    assert data.shape == (1, 2000)
    assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3)
    assert sent["packets_sent"] == 2
    assert sent["bytes_sent"] == 2 * wire.HEADER_SIZE + 8 * 2000


def test_native_build_hashes_and_reuses(monkeypatch, tmp_path):
    """g++ builds the streamer at first use into the build directory,
    under a name of its own (not the ingest receiver's); a second build
    runs no compiler; the JAX package's CMake build is never read."""
    monkeypatch.setattr(native_mod, "BUILD_DIR", tmp_path / "build")
    first = native_mod.build("stream")
    assert first.is_file() and first.name.startswith("libsdr_stream_")
    assert first != native_mod.library_path("ingest")
    assert not list((tmp_path / "build").glob("*.tmp"))

    def no_compiler(*a, **k):
        raise AssertionError("rebuilt an unchanged source")
    monkeypatch.setattr(native_mod.subprocess, "run", no_compiler)
    assert native_mod.build("stream") == first
    monkeypatch.undo()
    lib = native_mod.load_library("stream")
    assert lib._name == str(native_mod.library_path("stream"))
    assert "native/build" not in lib._name
    assert native_mod.available() and native_mod.ingest_available()


# --------------------------------------- divergences (Queue 3 #31-#33)

def test_divergence_31_device_argument(monkeypatch, tmp_path):
    """#31: Server, TXRX and the CLI take a device, "cuda" by default;
    with no card "cuda" raises, before any port is bound."""
    from gpu_sdr_tpu_torch.server.txrx import TXRX
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bound = []
    orig = network._SingleClientServer.__init__

    def spy(self, *a, **k):
        bound.append(a)
        orig(self, *a, **k)
    monkeypatch.setattr(network._SingleClientServer, "__init__", spy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(async_port=0, data_port=0, host="127.0.0.1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TXRX(ServerSettings())
    assert not bound
    srv = Server(async_port=0, data_port=0, host="127.0.0.1", device="cpu",
                 use_native=False)
    try:
        assert srv.device == torch.device("cpu") and len(bound) == 2
    finally:
        srv.close()


def test_divergence_31_cli_without_card_raises(tmp_path):
    """#31: the CLI with no --device runs on "cuda" and exits non-zero
    on a host with no card (none visible to the subprocess), naming the
    device."""
    proc = spawn_cli(tmp_path, "--one_shot", "--async_port", "0",
                     "--data_port", "0", env={"CUDA_VISIBLE_DEVICES": ""})
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "no CUDA device" in out and "server ready" not in out


def test_divergence_32_device_index_is_the_cuda_ordinal(monkeypatch):
    """#32: ServerSettings.device_index is the CUDA ordinal of a server
    asked for "cuda" (JAX declares it and never reads it); a device with
    an index overrides it and is written back."""
    from gpu_sdr_tpu_torch.server import txrx as txrx_mod
    seen = []

    def resolve(dev):
        seen.append(torch.device(dev))
        return torch.device(dev)
    monkeypatch.setattr(txrx_mod, "resolve_device", resolve)
    s = ServerSettings(device_index=3)
    assert txrx_mod.TXRX(s).device == torch.device("cuda", 3)
    s = ServerSettings(device_index=3)
    assert txrx_mod.TXRX(s, device="cuda:1").device == \
        torch.device("cuda", 1)
    assert s.device_index == 1
    s = ServerSettings(device_index=3)
    assert txrx_mod.TXRX(s, device="cpu").device == torch.device("cpu")
    assert s.device_index == 3
    assert seen == [torch.device("cuda", 3), torch.device("cuda", 1),
                    torch.device("cpu")]


def test_divergence_33_no_silent_fallback(monkeypatch, tmp_path):
    """#33: a server builds the native streamer (JAX falls back to the
    Python one when its library is absent): a g++ failure on
    native/stream_server.cpp raises; use_native=False is the caller's
    own choice of the Python streamer."""
    src = tmp_path / "native"
    shutil.copytree(native_mod.NATIVE_DIR, src,
                    ignore=shutil.ignore_patterns("build"))
    (src / "stream_server.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_mod, "NATIVE_DIR", src)
    monkeypatch.setattr(native_mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_mod, "_libs", {})
    assert native_mod.available()          # g++ is here; the build fails
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on "
                       "native/stream_server.cpp"):
        Server(async_port=0, data_port=0, host="127.0.0.1", device="cpu")
    srv = Server(async_port=0, data_port=0, host="127.0.0.1", device="cpu",
                 use_native=False)
    try:
        assert isinstance(srv.sync, network.SyncServer)
    finally:
        srv.close()


def test_divergence_35_python_streamer_keeps_a_taken_packet():
    """#35: a packet the Python streamer takes from its queue while its
    client goes away is sent to the next client (JAX's streamer drops it,
    so a fast measurement after a reconnect lost its data), as the native
    streamer keeps it in its ring."""
    srv = network.SyncServer(port=0, host="127.0.0.1")
    srv.start()
    try:
        first = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=5)
        assert srv.wait_client(timeout=5)
        time.sleep(0.3)                 # the loop waits in queue.get
        srv.drop_client()
        data = np.arange(6, dtype=np.complex64)
        assert srv.push(PacketMeta(packet_number=4, length=6, channels=2),
                        data)
        first.close()
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5) as c:
            c.settimeout(5)
            meta = wire.decode_sync_header(wire.recv_exact(
                c, wire.HEADER_SIZE))
            got = np.frombuffer(wire.recv_exact(c, 8 * meta["length"]),
                                dtype=np.complex64)
        assert meta["packet_number"] == 4 and np.array_equal(got, data)
    finally:
        srv.close()
