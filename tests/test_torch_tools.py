"""The port's user tools (gpu_sdr_tpu_torch/tools) against the JAX
package's (tools/), and what the port's workflow scripts add to the JAX
package's (divergence 37), on the CPU:

* read_filter_window, read_server_log and make_test_recording on the
  same arguments as JAX's tools: the same windows, table rows and
  samples; science_producer streaming a resonator-filtered VNA chirp
  into the port's ``server.main --ingest`` over 127.0.0.1, the port's
  client writing the file and its fit finding both resonators;
* every script's flags and defaults are its JAX script's, plus
  ``--device`` and, where it plots, ``--backend``; ``--device cuda``
  without a card raises before any file or folder is written; the
  matplotlib default still draws PNGs;
* the live view: Get_noise's push_queue keeps each packet's own array
  (no later block overwrites a packet still queued), and the live
  server streams every packet of its acquisition and then ends.
"""

import argparse
import http.client
import json
import os
import queue
import re
import runpy
import subprocess
import sys
import time

import h5py
import numpy as np
import pytest

from test_torch_scripts import (ENV, REPO, folders, jax_cmd, port_cmd,
                                run, run_chains, same_lines)

SCRIPTS = ["analyze_VNA", "analyze_dynamic_VNA", "analyze_noise",
           "diagnostic_noise", "fit_VNA", "freqts_plot", "get_VNA",
           "get_dual_VNA", "get_dual_noise", "get_line_delay", "get_noise",
           "get_noise_full", "get_raw_data", "large_VNA", "last_file_plot",
           "network_test", "plot_spectrogram", "raw_data_analisys",
           "raw_plot", "swipe_parameter", "beam_mapper/beam_mapper",
           "live_demo/live_server"]
# the scripts that draw a plot file take --backend
PLOTTING = {"analyze_VNA", "analyze_dynamic_VNA", "analyze_noise",
            "diagnostic_noise", "fit_VNA", "freqts_plot", "get_VNA",
            "get_line_delay", "last_file_plot", "plot_spectrogram",
            "raw_data_analisys", "raw_plot", "swipe_parameter"}


def tool_cmd(name, *args):
    return [sys.executable, os.path.join(REPO, "gpu_sdr_tpu_torch", "tools",
                                         name + ".py"), *args]


class _Parsed(Exception):
    pass


def parser_of(path, monkeypatch):
    """The argparse parser a script's main() builds, caught at
    parse_args."""
    caught = {}

    def grab(self, *a, **k):
        caught["p"] = self
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.syspath_prepend(os.path.dirname(path))
    ns = runpy.run_path(path)
    with pytest.raises(_Parsed):
        ns["main"]()
    return caught["p"]


def flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", SCRIPTS)
def test_divergence_37_script_flags(name, monkeypatch):
    """The port's script takes its JAX script's flags with their
    defaults, and --device (default cuda), and --backend {matplotlib,
    html} (default matplotlib) where it plots."""
    jp = parser_of(os.path.join(REPO, "scripts", name + ".py"), monkeypatch)
    pp = parser_of(os.path.join(REPO, "gpu_sdr_tpu_torch", "scripts",
                                name + ".py"), monkeypatch)
    jf, pf = flags(jp), flags(pp)
    extra = {"device"} | ({"backend"} if name in PLOTTING else set())
    assert set(pf) - set(jf) == extra
    assert {k: pf[k] for k in jf} == jf
    assert pf["device"][:2] == (("--device",), "cuda")
    if "backend" in pf:
        assert pf["backend"][1] == "matplotlib"
        assert pf["backend"][4] == ["matplotlib", "html"]


def test_scripts_import_nothing_of_jax_h5py_or_matplotlib():
    """Every script module imports with jax, the JAX package, h5py and
    matplotlib unimportable."""
    mods = [n.replace("/", ".") for n in SCRIPTS]
    code = ("import sys, importlib\n"
            "for m in ('jax', 'gpu_sdr_tpu', 'h5py', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            f"for n in {mods!r}:\n"
            "    importlib.import_module('gpu_sdr_tpu_torch.scripts.' + n)\n"
            "for n in ('read_filter_window', 'read_server_log',"
            " 'make_test_recording', 'science_producer', 'array_loop',"
            " 'phase_coherence'):\n"
            "    importlib.import_module('gpu_sdr_tpu_torch.tools.' + n)\n"
            "print('ok')\n")
    assert run([sys.executable, "-c", code], REPO).strip() == "ok"


def test_divergence_37_device_cuda_without_a_card_raises(tmp_path):
    """With no card, --device cuda (the default) raises before the
    script writes anything, its folder included."""
    import torch
    assert not torch.cuda.is_available()
    folder = tmp_path / "data"
    p = subprocess.run(
        [sys.executable, "-m", "gpu_sdr_tpu_torch.scripts.get_VNA",
         "--folder", str(folder), "--rate", "1", "--freq", "10",
         "--points", "200", "--time", "0.1"],
        capture_output=True, text=True, cwd=tmp_path, env=ENV, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device is available" in p.stderr
    assert os.listdir(tmp_path) == []
    from gpu_sdr_tpu_torch.scripts import _cli
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cli.start(argparse.Namespace(device=dev))
    with pytest.raises(ValueError, match="unsupported device"):
        _cli.start(argparse.Namespace(device="meta"))


def test_divergence_37_matplotlib_backend_draws_png(tmp_path):
    """The default --backend matplotlib draws the JAX script's PNG."""
    j, p = folders(tmp_path)
    args = ("--rate", "1", "--freq", "10", "--time", "0.1")
    run(port_cmd("get_raw_data.py", "--folder", str(p), *args, plot=False),
        p)
    out = run([sys.executable, "-m", "gpu_sdr_tpu_torch.scripts.raw_plot",
               "--folder", str(p), "--device", "cpu"], p)
    assert out.strip() == "plot written to USRP_raw_data.png"
    assert (p / "USRP_raw_data.png").stat().st_size > 0


def test_run_report(tmp_path):
    """GPU_SDR_TPU_RUN_REPORT: each run_measurement's planned and
    recorded dispatch, seconds and samples, and the launch counts."""
    report = tmp_path / "report.json"
    env = dict(ENV, GPU_SDR_TPU_RUN_REPORT=str(report))
    p = subprocess.run(
        port_cmd("get_VNA.py", "--folder", str(tmp_path / "d"), "--rate",
                 "1", "--freq", "10", "--points", "200", "--time", "0.1"),
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    r = json.loads(report.read_text())
    assert len(r["runs"]) == 2                 # the line delay, the VNA
    for run_ in r["runs"]:
        assert run_["plan"] == run_["dispatch"]
        assert run_["seconds"] > run_["stream_seconds"] > 0
        assert run_["samples"] > 0
    # the line delay fused; the VNA, its RX delayed by the measured line
    # delay, host-fed
    assert [d["dispatch"][0][1] for d in r["runs"]] == [
        "fused_loopback", "host_pipeline"]
    # 0.1 s at 1 Msps, streamed as one whole block of the plan's 1M
    assert r["runs"][1]["samples"] == 1_000_000
    assert set(r["launches"]) >= {"lockin_self", "channelizer", "chain"}
    assert not any(r["launches"].values())      # the CPU launches none


def test_read_filter_window_tool(tmp_path):
    j, p = folders(tmp_path)
    for args in (("--nfft", "64", "--average", "4"),
                 ("--decim", "100", "--average", "4")):
        (jo,), (po,) = run_chains(
            [([*jax_cmd("../tools/read_filter_window.py"), *args, "-o",
               str(j / "win.png")], j)],
            [(tool_cmd("read_filter_window", *args, "-o",
                       str(p / "win.png")), p)])
        same_lines(jo.replace(str(j), ""), po.replace(str(p), ""))
        assert (j / "win.png").exists() and (p / "win.png").exists()
    out = run(tool_cmd("read_filter_window", "--backend", "html", "-o",
                       str(p / "win.html")), p)
    assert "win.html" in out and (p / "win.html").stat().st_size > 0


def test_read_server_log_tool(tmp_path):
    """A log the port's utils/log writes, rendered by both tools: the
    same table rows."""
    code = ("import logging\n"
            "from gpu_sdr_tpu_torch.utils import log\n"
            "log.init_logger('logs')\n"
            "g = log.get_logger('server')\n"
            "g.info('measurement <1> started')\n"
            "g.warning('ring overflow; 3 blocks')\n"
            "g.error('client lost')\n")
    run([sys.executable, "-c", code], tmp_path)
    (logf,) = (tmp_path / "logs").iterdir()
    outs = []
    for cmd, name in ((jax_cmd("../tools/read_server_log.py"), "j.html"),
                      (tool_cmd("read_server_log"), "p.html")):
        out = run([*cmd, "--log", str(logf), "--out", str(tmp_path / name)],
                  tmp_path)
        assert out.strip() == f"3 records written to {tmp_path / name}"
        rows = re.findall(r"<tr class=.*?</tr>",
                          (tmp_path / name).read_text())
        outs.append(rows)
    assert outs[0] == outs[1] and len(outs[0]) == 3
    assert "measurement &lt;1&gt; started" in outs[1][0]


@pytest.mark.parametrize("extra", [(), ("--resonator", "150000", "30",
                                        "60")])
def test_make_test_recording_tool(tmp_path, extra):
    j, p = folders(tmp_path)
    args = ("--rate", "1e6", "--seconds", "0.05", "--tones", "100e3",
            "20e3", "--noise", "1e-3", "--seed", "3", *extra)
    (jo,), (po,) = run_chains(
        [([*jax_cmd("../tools/make_test_recording.py"), "-o",
           str(j / "rec.npy"), *args], j)],
        [(tool_cmd("make_test_recording", "-o", str(p / "rec.npy"),
                   *args), p)])
    same_lines(jo.replace(str(j), ""), po.replace(str(p), ""))
    a, b = np.load(j / "rec.npy"), np.load(p / "rec.npy")
    assert a.dtype == b.dtype == np.complex64 and a.shape == (50_000,)
    assert np.array_equal(a, b)


RESOS = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0),
         dict(f0=200_000.0, Qr=25.0, Qe_re=50.0)]


def test_science_producer_into_the_ports_server(tmp_path, monkeypatch):
    """The port's producer into the port's server.main --ingest on
    127.0.0.1 (its JAX counterpart: tests/test_science_loop.py): the
    port's client writes the streamed file; the fit finds both
    resonators within 10 kHz."""
    from gpu_sdr_tpu_torch.client import connections as Uconn
    from gpu_sdr_tpu_torch.client import delay as Udelay
    from gpu_sdr_tpu_torch.client import files as Ufiles
    from gpu_sdr_tpu_torch.client import fitting as Ufit
    from gpu_sdr_tpu_torch.client import vna as Uvna
    monkeypatch.chdir(tmp_path)
    code = ("from gpu_sdr_tpu_torch.server.main import main\n"
            "raise SystemExit(main(['--async_port', '0', '--data_port', "
            "'0', '--ingest', '0', '--one_shot', '--device', 'cpu']))\n")
    server = subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    producer = conn = None
    Udelay.set_line_delay(1_000_000, 512e-6 * 1e9)
    try:
        line, t0 = "", time.monotonic()
        while "server ready" not in line:
            line = server.stdout.readline()
            assert line or server.poll() is None, "the server exited"
            assert time.monotonic() - t0 < 60, "server did not start"
        m = re.search(r"async port (\d+), data port (\d+)", line)
        cmd = Uvna.compose_vna_command(
            start_f=-400_000, last_f=400_000, measure_t=0.4,
            n_points=1600, tx_gain=0, Rate=1_000_000, RF=10_000_000)
        (tmp_path / "cmd.json").write_text(cmd.to_json())
        portfile = tmp_path / "ingest_port.txt"
        producer = subprocess.Popen(
            tool_cmd("science_producer", "--params",
                     str(tmp_path / "cmd.json"), "--portfile",
                     str(portfile), "--resonators", json.dumps(RESOS)),
            cwd=tmp_path, env=ENV, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        conn = Uconn.Connection(host="127.0.0.1",
                                async_port=int(m.group(1)),
                                sync_port=int(m.group(2)))
        conn.send_params(cmd)
        t0 = time.monotonic()
        while conn.ingest_port is None:
            assert time.monotonic() - t0 < 60, "no ingest port announced"
            time.sleep(0.02)
        portfile.write_text(str(conn.ingest_port))
        fn = Uconn.Packets_to_file(conn, cmd, filename="science_vna",
                                   meas_type="VNA", progress=False)
        out, _ = producer.communicate(timeout=120)
        assert producer.returncode == 0, out[-2000:]
        assert "producer done: 1000000 samples" in out   # one whole block
    finally:
        Udelay.LINE_DELAY.clear()
        if conn is not None:
            conn.close()
        for proc in (producer, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    Uvna.VNA_analysis(fn)
    assert Ufit.initialize_peaks(fn, N_peaks=2, peak_width=50e3,
                                 Qr_cutoff=5, Mag_depth_cutoff=0.5,
                                 exclude_center=False)
    assert len(Ufiles.get_init_peaks(fn)) == 2
    assert Ufit.vna_fit(fn, fit_range=60e3)
    f0s = sorted(1e6 * q["f0"] for q in Ufit.get_fit_param(fn))
    for got, exp in zip(f0s, sorted(10_000_000 + r["f0"] for r in RESOS)):
        assert abs(got - exp) < 10_000, (got, exp)


def test_live_view_packets_are_not_overwritten(tmp_path, monkeypatch):
    """Get_noise's push_queue on the CPU, fused and host-fed through a
    channel that adds fresh noise to every block: every queued packet,
    read only after the acquisition ended, is bit for bit its rows of
    the file, and no two packets are alike, so a packet overwritten by a
    later block would show."""
    import gpu_sdr_tpu_torch.pyusrp as u
    from gpu_sdr_tpu_torch.engine.channel import Channel

    class Noisy(Channel):
        rng = np.random.default_rng(11)

        def __call__(self, block):
            n = self.rng.standard_normal((2, len(block))) * 1e-2
            return (block + n[0] + 1j * n[1]).astype(np.complex64)

    monkeypatch.chdir(tmp_path)
    for k, channel in enumerate((None, Noisy())):
        q = queue.Queue()
        fn = u.Get_noise([100_000.0, 200_000.0], measure_t=3, rate=1e6,
                         decimation=100, RF=0, output_filename=f"live{k}",
                         push_queue=q, device="cpu", channel=channel)
        packets = []
        while not q.empty():
            packets.append(q.get_nowait())
        assert [m.packet_number for m, _ in packets] == [0, 1, 2]
        data = np.concatenate([d for _, d in packets])    # (rows, ch)
        assert np.array_equal(data.T, u.openH5file(fn))
        if channel is not None:
            assert not any(np.array_equal(a, b) for (_, a), (_, b) in
                           zip(packets, packets[1:]))


def test_live_server_streams_then_ends(tmp_path):
    """The live server on the CPU (port 0): /stream sends every packet
    of its acquisition, each packet's channel magnitudes those of its
    rows in the file, then an end event; the process then exits."""
    proc = subprocess.Popen(
        port_cmd("live_demo/live_server.py", "--port", "0", "--tones",
                 "0.1", "0.2", "--time", "3", plot=False),
        cwd=tmp_path, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"localhost:(\d+)/", line).group(1))
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/")
        page = c.getresponse().read().decode()
        assert "EventSource('/stream')" in page
        c.request("GET", "/stream")
        r = c.getresponse()
        events, buf = [], b""
        while b"event: end" not in buf:
            chunk = r.read1(65536)
            assert chunk, "stream closed before its end event"
            buf += chunk
        for block in buf.decode().split("\n\n"):
            if block.startswith("data: "):
                events.append(json.loads(block[6:]))
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert [e["packet"] for e in events] == list(range(3))
    with h5py.File(tmp_path / "live_noise.h5", "r") as f:
        data = np.asarray(f["raw_data0/A_RX2/data"])      # (ch, rows)
    rows = data.shape[1] // 3
    for k, e in enumerate(events):
        # the server's reduction: (rows, ch) rows in order, in float32
        blk = np.ascontiguousarray(data[:, k * rows:(k + 1) * rows].T)
        assert e["mags"] == [float(m) for m in np.abs(blk).mean(axis=0)]
