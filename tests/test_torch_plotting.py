"""The port's plotting (client/plotting.py, client/htmlplot.py) and
utilities (utils/), on the CPU: the counterparts of the plotting cases
of the JAX package's test_fullspec_triggers_plotting.py and of its
test_utils.py, on files the port's own measurements write; each HTML
page the port draws from a file is the JAX package's page for that file,
byte for byte; and the port imports matplotlib only where a plot draws
with it (ROADMAP Queue 3 #34).
"""

import logging
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from gpu_sdr_tpu.client import full_spec as jfs
from gpu_sdr_tpu.client import noise as jnoise
from gpu_sdr_tpu.client import plotting as jplot
from gpu_sdr_tpu.client import vna as jvna
from gpu_sdr_tpu_torch.client import full_spec as Ufs
from gpu_sdr_tpu_torch.client import noise as Unoise
from gpu_sdr_tpu_torch.client import plotting as Uplot
from gpu_sdr_tpu_torch.client import vna as Uvna
from gpu_sdr_tpu_torch.params import (AntennaParams, AntMode, UsrpParams,
                                      WaveType)
from gpu_sdr_tpu_torch.utils.diagnostics import (StopWatch, ThroughputMeter,
                                                 print_params)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a subprocess's thread pools as small as this process's: the suite's
# workers share the host's cores
THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2",
           "OPENBLAS_NUM_THREADS": "2"}
CPU = {"device": "cpu"}


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def vna_file(mod, name, **kw):
    fn = mod.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                        n_points=100, tx_gain=0, Rate=int(1e6), RF=0,
                        output_filename=name, **kw)
    mod.VNA_analysis(fn)
    return fn


def noise_file(mod, name, **kw):
    nf = mod.Get_noise([10_000], measure_t=0.2, rate=int(1e6), RF=0,
                       decimation=100, mode="DIRECT", output_filename=name,
                       **kw)
    mod.calculate_noise(nf, welch=2)
    return nf


def test_plotting_outputs(tmp_chdir):
    fn = vna_file(Uvna, "vna_plot", **CPU)
    out = Uplot.plot_VNA(fn, output_filename="vna_fig")
    assert out == "vna_fig.png" and os.path.exists(out)
    nf = noise_file(Unoise, "noise_plot", **CPU)
    out2 = Uplot.plot_noise_spec(nf, output_filename="noise_fig")
    assert os.path.exists(out2)
    out3 = Uplot.plot_raw_data(nf, output_filename="raw_fig")
    assert os.path.exists(out3)
    out4 = Uplot.diagnostic_VNA_noise(nf, fn, output_filename="diag_fig")
    assert os.path.exists(out4)


def test_plotting_html_backend(tmp_chdir):
    """The interactive backend writes self-contained HTML with the trace
    data embedded (reference plotly parity: plot_VNA
    pyUSRP/USRP_VNA.py:807-1100); unknown backends raise."""
    fn = vna_file(Uvna, "vna_plot_h", **CPU)
    out = Uplot.plot_VNA(fn, backend="plotly", output_filename="vna_h")
    assert out.endswith(".html") and os.path.exists(out)
    body = open(out).read()
    assert "<svg" in body or "svg" in body
    assert "S21 Magnitude" in body
    nf = noise_file(Unoise, "noise_plot_h", **CPU)
    out2 = Uplot.plot_noise_spec(nf, backend="html",
                                 output_filename="noise_h")
    assert os.path.exists(out2) and "PSD" in open(out2).read()
    out3 = Uplot.plot_raw_data(nf, backend="plotly",
                               output_filename="raw_h")
    assert os.path.exists(out3)
    out4 = Uplot.diagnostic_VNA_noise(nf, fn, backend="plotly",
                                      output_filename="diag_h")
    assert os.path.exists(out4)
    with pytest.raises(ValueError, match="backend"):
        Uplot.plot_VNA(fn, backend="gnuplot")


def test_plot_resonators_html(tmp_chdir):
    """Fit resonators (simulated channel) then render the interactive
    resonator grid and its statistics."""
    from gpu_sdr_tpu_torch.client import fitting as Ufit
    from gpu_sdr_tpu_torch.engine.channel import make_resonator_channel
    rate = int(1e6)
    chan = make_resonator_channel(
        rate, [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0)],
        fft_len=1 << 12)
    fn = Uvna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.2,
                         n_points=800, tx_gain=0, Rate=rate, RF=0,
                         output_filename="vna_reso_h", channel=chan, **CPU)
    Uvna.VNA_analysis(fn)
    assert Ufit.initialize_peaks(fn, N_peaks=1, peak_width=50e3,
                                 Qr_cutoff=5, Mag_depth_cutoff=0.5,
                                 exclude_center=False)
    assert Ufit.vna_fit(fn, fit_range=60e3)
    out = Uplot.plot_resonators(fn, backend="plotly",
                                output_filename="reso_h")
    assert out.endswith(".html") and os.path.exists(out)
    assert "reso 0" in open(out).read()
    assert os.path.exists(Uplot.plot_resonators(fn, output_filename="reso"))
    out2 = Uplot.plot_reso_stat(fn, backend="plotly",
                                output_filename="stat_h")
    assert "Qr" in open(out2).read()


def test_plot_pfb_and_timestream(tmp_chdir):
    """The waterfall plots, HTML (an embedded data-URI heatmap with
    interactive axes) and PNG."""
    rate = int(1_024_000)
    fn = Ufs.Get_full_spec([5 * rate // 64], channels=64, measure_t=0.1,
                           rate=rate, RF=0, output_filename="fs_html", **CPU)
    out = Uplot.plot_pfb(fn, backend="plotly", output_filename="pfb_h")
    assert out.endswith(".html") and os.path.exists(out)
    assert "data:image/png;base64" in open(out).read()
    assert os.path.exists(Uplot.plot_pfb(fn, output_filename="pfb"))
    fn2 = Uvna.Single_VNA(start_f=-100_000, last_f=100_000,
                          measure_t=0.05, n_points=100, tx_gain=0,
                          Rate=int(1e6), RF=0, iterations=3,
                          output_filename="vna_ts_h", **CPU)
    Uvna.VNA_timestream_analysis(fn2)
    out2 = Uplot.VNA_timestream_plot(fn2, backend="html",
                                     output_filename="vnats_h")
    assert "data:image/png;base64" in open(out2).read()
    assert os.path.exists(Uplot.VNA_timestream_plot(
        fn2, output_filename="vnats"))


def test_html_pages_are_jaxs(tmp_chdir):
    """Every HTML page the port draws from a file (written by the JAX
    package here, through h5py) is the page the JAX package draws from
    it, byte for byte; the PNG backend writes a file of the same name."""
    rate = int(1e6)
    fn = vna_file(jvna, "vna_j")
    nf = noise_file(jnoise, "noise_j")
    fs = jfs.Get_full_spec([5 * 1_024_000 // 64], channels=64,
                           measure_t=0.1, rate=1_024_000, RF=0,
                           output_filename="fs_j")
    ts = jvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=100, tx_gain=0, Rate=rate, RF=0,
                         iterations=3, output_filename="vna_ts_j")
    jvna.VNA_timestream_analysis(ts)
    calls = {
        "plot_VNA": ((fn,), {}),
        "plot_noise_spec": ((nf,), {}),
        "plot_raw_data": ((nf,), {"mode": "PM"}),
        "plot_frequency_timestreams": ((nf,), {}),
        "diagnostic_VNA_noise": ((nf, fn), {}),
        "plot_pfb": ((fs,), {}),
        "VNA_timestream_plot": ((ts,), {}),
    }
    for name, (args, kw) in calls.items():
        pages = []
        for tag, mod in (("jax", jplot), ("port", Uplot)):
            out = getattr(mod, name)(*args, backend="plotly",
                                     output_filename=f"{name}_{tag}", **kw)
            with open(out, "rb") as f:
                pages.append(f.read())
        assert pages[0] == pages[1], name
        assert getattr(Uplot, name)(*args, **kw).endswith(".png")


def test_divergence_34_matplotlib_imported_where_a_plot_draws(tmp_path):
    """#34: the facade and the plotting module import with matplotlib
    unimportable (JAX's plotting imports it at the top); the HTML
    backend draws lines without it; a plot that needs it raises
    ImportError naming it."""
    code = textwrap.dedent("""
        import sys
        sys.modules["matplotlib"] = None
        sys.modules["jax"] = None
        sys.modules["gpu_sdr_tpu"] = None
        import gpu_sdr_tpu_torch.pyusrp as u
        from gpu_sdr_tpu_torch.client import htmlplot
        fig = htmlplot.Figure(title="t")
        fig.panel(ylabel="y").line([1, 2], [3, 4], name="a")
        assert fig.write_html("page.html") == "page.html"
        fn = u.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                          n_points=100, tx_gain=0, Rate=1_000_000, RF=0,
                          output_filename="vna", device="cpu")
        u.VNA_analysis(fn)
        assert u.plot_VNA(fn, backend="plotly").endswith(".html")
        for call in (lambda: u.plot_VNA(fn),
                     lambda: fig.panel().image([[1, 2]], [0, 1, 0, 1])):
            try:
                call()
            except ImportError as e:
                assert "matplotlib" in str(e), e
            else:
                raise AssertionError("drew without matplotlib")
        assert not any(m.split(".")[0] in ("matplotlib", "jax",
                                           "gpu_sdr_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO, **THREADS))
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip().endswith("OK")


# ------------------------------------------------- utils (test_utils.py)

def test_stopwatch_cycles():
    sw = StopWatch()
    for _ in range(3):
        sw.start()
        time.sleep(0.01)
        sw.store()
    assert len(sw.history) == 3
    assert 0.005 < sw.get_average() < 0.1


def test_throughput_meter():
    tm = ThroughputMeter()
    tm.add(1000)
    tm.add(1000)
    assert tm.blocks == 2
    assert tm.msps > 0


def test_print_params_lists_active_antennas(capsys):
    from gpu_sdr_tpu.utils.diagnostics import print_params as jprint
    p = UsrpParams()
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000, freq=[1000],
                            wave_type=[WaveType.DIRECT], decim=10)
    text = print_params(p)
    assert "A_RX2" in text and "DIRECT" in text
    assert "B_RX2" not in text
    assert text == jprint(p)


def test_log_record_format(tmp_path, monkeypatch):
    """Record format matches the reference:
    TimeStamp;ThreadName;Severity;Message, under the port's logger; the
    repo's log viewer renders it.  The logger's handler and level are
    restored after."""
    import importlib
    import threading

    import gpu_sdr_tpu_torch.utils.log as L
    monkeypatch.chdir(tmp_path)
    root = logging.getLogger(L.ROOT)
    level, handlers = root.level, list(root.handlers)
    name = threading.current_thread().name
    importlib.reload(L)
    try:
        L.init_logger(log_dir=str(tmp_path / "logs"))
        L.set_this_thread_name("test_thread")
        L.get_logger("unit").warning("hello world")
        root.handlers[-1].flush()
    finally:
        for h in root.handlers[len(handlers):]:
            h.close()
            root.removeHandler(h)
        root.setLevel(level)
        threading.current_thread().name = name
        importlib.reload(L)
    logs = list((tmp_path / "logs").glob("*.log"))
    assert logs
    line = logs[0].read_text().strip().splitlines()[-1]
    parts = line.split(";", 3)
    assert len(parts) == 4
    assert parts[1] == "test_thread"
    assert parts[2] == "WARNING"
    assert parts[3] == "hello world"

    out = tmp_path / "log.html"
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "read_server_log.py"),
         "--log", str(logs[0]), "--out", str(out)],
        capture_output=True, text=True, timeout=30,
        env=dict(os.environ, **THREADS))
    assert p.returncode == 0, p.stderr
    assert "hello world" in out.read_text()
