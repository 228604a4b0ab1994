"""The port's analysis client (gpu_sdr_tpu_torch/client: delay, vna,
fitting, noise, full_spec, data_analysis, triggers) against the JAX
package's, on the CPU.

Three layers:

* the same file, two analyses: one acquisition file written by the JAX
  package, copied; JAX's analysis on one copy and the port's on the
  other (VNA_analysis, VNA_timestream_analysis, initialize_peaks +
  vna_fit, the line delay written and loaded, calculate_noise with
  scipy, copy_resonator_group) must leave the two files the same bit
  for bit, read back through h5py; the port's torch Welch within 1e-4
  relative (linear power) of JAX's backend="jax"; a noise file JAX
  analysed (gzip datasets) reads through the port's get_noise exactly
  as through JAX's;
* end to end: each package acquires and analyses its own files from the
  same commands and the same seeded channel: fitted f0 within one VNA
  point, Qr within 1%, noise PSDs within 0.05 dB;
* the port counterparts of tests/test_noise_fitting.py and
  tests/test_vna_delay.py, with their asserts, and the captures of
  full_spec and the dual commands against JAX's files.

The science loop also runs with jax, gpu_sdr_tpu, h5py and matplotlib
unimportable.
"""

import os
import queue
import shutil
import subprocess
import sys
import textwrap

import h5py
import numpy as np
import pytest
import torch

from gpu_sdr_tpu.client import delay as jdelay
from gpu_sdr_tpu.client import files as jfiles
from gpu_sdr_tpu.client import fitting as jfit
from gpu_sdr_tpu.client import full_spec as jfull
from gpu_sdr_tpu.client import noise as jnoise
from gpu_sdr_tpu.client import vna as jvna
from gpu_sdr_tpu.engine import channel as jchannel
from gpu_sdr_tpu_torch.client import data_analysis
from gpu_sdr_tpu_torch.client import delay as tdelay
from gpu_sdr_tpu_torch.client import files as tfiles
from gpu_sdr_tpu_torch.client import fitting as tfit
from gpu_sdr_tpu_torch.client import full_spec as tfull
from gpu_sdr_tpu_torch.client import noise as tnoise
from gpu_sdr_tpu_torch.client import vna as tvna
from gpu_sdr_tpu_torch.engine import channel as tchannel
from test_torch_files import assert_same_file
from test_torch_h5 import assert_same, items

torch.set_num_threads(2)

RATE = 1_000_000
RF = 10_000_000
RESOS = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0),
         dict(f0=200_000.0, Qr=25.0, Qe_re=50.0)]
GROUP_DELAY_NS = 512e-6 * 1e9       # the resonator channel's causal shift
VNA = dict(start_f=-400_000, last_f=400_000, measure_t=0.4, n_points=1600,
           tx_gain=0, Rate=RATE, RF=RF)
VNA_POINT = 800_000 / 1600          # Hz between VNA points
NOISE_TONES = [100_000, -150_000]
PEAKS = dict(N_peaks=2, peak_width=50e3, Qr_cutoff=5, Mag_depth_cutoff=0.5,
             exclude_center=False)


@pytest.fixture(autouse=True)
def no_line_delay():
    """Neither package's LINE_DELAY table leaks into another test."""
    jdelay.LINE_DELAY.clear()
    tdelay.LINE_DELAY.clear()
    yield
    jdelay.LINE_DELAY.clear()
    tdelay.LINE_DELAY.clear()


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def resonators(ch):
    return ch.make_resonator_channel(RATE, RESOS, fft_len=1 << 12)


def noise_channel(ch, seed=5, rms=1e-2):
    return ch.ChainChannel([ch.IdealChannel()], noise_rms=rms, seed=seed)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Acquisition files written by the JAX package: a VNA of two
    resonators (two sweeps), a line-delay chirp through a 40-sample
    delay, a two-tone DIRECT noise capture with white noise."""
    d = tmp_path_factory.mktemp("jax_files")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        jdelay.set_line_delay(RATE, GROUP_DELAY_NS)
        vna = jvna.Single_VNA(**VNA, Iterations=2, output_filename="vna",
                              channel=resonators(jchannel))
        jdelay.LINE_DELAY.clear()
        delay = jdelay.measure_line_delay(
            RATE, RF, "A", duration=0.5, output_filename="delay",
            channel=jchannel.DelayChannel(40))
        noise = jnoise.Get_noise(NOISE_TONES, measure_t=0.5, rate=RATE,
                                 decimation=100, RF=RF, mode="DIRECT",
                                 output_filename="noise",
                                 channel=noise_channel(jchannel))
    finally:
        os.chdir(cwd)
    return {k: str(d / v) for k, v in (("vna", vna), ("delay", delay),
                                       ("noise", noise))}


def two_copies(src, tmp_path):
    """(jax copy, port copy) of a file."""
    out = []
    for side in ("jax", "port"):
        dst = str(tmp_path / f"{side}_{os.path.basename(src)}")
        shutil.copy(src, dst)
        out.append(dst)
    return out


def assert_same_files(a, b):
    theirs = items(a, h5py)
    assert_same(items(b, h5py), theirs)
    assert_same(items(b, tfiles.h5), theirs)


# ----------------------------------------------------------------------
# The same file, two analyses


@pytest.mark.parametrize("analysis", ["VNA_analysis",
                                      "VNA_timestream_analysis"])
def test_vna_analysis_writes_jaxs_group(jax_files, tmp_path, analysis):
    jf, tf = two_copies(jax_files["vna"], tmp_path)
    getattr(jvna, analysis)(jf)
    getattr(tvna, analysis)(tf)
    assert_same_files(jf, tf)
    group = "VNA_0" if analysis == "VNA_analysis" else "VNA_dynamic_0"
    with h5py.File(tf, "r") as f:
        assert f[group]["S21"].dtype == np.complex128
        assert f[group]["S21"].shape[-1] == VNA["n_points"]
    assert tvna.is_VNA_analyzed(tf) == (analysis == "VNA_analysis")
    if analysis == "VNA_timestream_analysis":
        assert tvna.is_VNA_dynamic_analyzed(tf)
        for a, b in zip(tvna.get_dynamic_VNA_data(tf),
                        jvna.get_dynamic_VNA_data(jf)):
            assert np.array_equal(a, b)


def test_fit_writes_jaxs_resonators(jax_files, tmp_path):
    """initialize_peaks + vna_fit on a VNA file JAX analysed: the same
    tones_init, reso_* groups and fit attributes (Qe a complex scalar),
    and the same accessors."""
    jf, tf = two_copies(jax_files["vna"], tmp_path)
    for f in (jf, tf):
        jvna.VNA_analysis(f)
    assert jfit.initialize_peaks(jf, **PEAKS)
    assert tfit.initialize_peaks(tf, **PEAKS)
    assert jfit.vna_fit(jf, fit_range=60e3)
    assert tfit.vna_fit(tf, fit_range=60e3)
    assert_same_files(jf, tf)
    tp, jp = tfit.get_fit_param(tf), jfit.get_fit_param(jf)
    assert len(tp) == 2 and tp == jp
    assert isinstance(tp[0]["Qe"], np.complex128)
    assert tfit.get_best_readout(tf) == jfit.get_best_readout(jf)
    assert tfit.min_readout_spacing(tf) == jfit.min_readout_spacing(jf)
    for a, b in zip(tfit.get_fit_data(tf), jfit.get_fit_data(jf)):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    # extimate_peak_number writes tones_init too
    assert tfit.extimate_peak_number(tf, threshold=0.5) == \
        jfit.extimate_peak_number(jf, threshold=0.5)
    assert_same_files(jf, tf)


def test_line_delay_writes_jaxs_delay_info(jax_files, tmp_path):
    jf, tf = two_copies(jax_files["delay"], tmp_path)
    d = tdelay.analyze_line_delay(tf)
    assert d == jdelay.analyze_line_delay(jf)
    assert abs(d - 40e-6) < 0.3 * 40e-6
    jdelay.write_delay_to_file(jf, d)
    tdelay.write_delay_to_file(tf, d)
    assert_same_files(jf, tf)
    assert tdelay.load_delay_from_file(tf) == \
        jdelay.load_delay_from_file(jf) == (1, int(d * 1e9))
    assert tdelay.LINE_DELAY == jdelay.LINE_DELAY == {"1": int(d * 1e9)}
    tdelay.LINE_DELAY.clear()
    os.rename(tf, str(tmp_path / "USRP_Delay_port.h5"))
    tdelay.load_delay_from_folder(str(tmp_path))
    assert tdelay.LINE_DELAY == {"1": int(d * 1e9)}


@pytest.mark.parametrize("welch, dbc", [(4, False), (None, True)])
def test_calculate_noise_scipy_writes_jaxs_group(jax_files, tmp_path, welch,
                                                 dbc):
    """backend="scipy" in both: the Noise0 group bit for bit (gzip
    float32 PSDs, float64 axis), run twice so the second session
    deletes and rewrites the group."""
    jf, tf = two_copies(jax_files["noise"], tmp_path)
    for _ in range(2):
        jnoise.calculate_noise(jf, welch=welch, dbc=dbc)
        tnoise.calculate_noise(tf, welch=welch, dbc=dbc)
    assert_same_files(jf, tf)
    with h5py.File(tf, "r") as f:
        d = f["Noise0/A_RX2/real_1"]
        assert (d.dtype, d.compression, d.compression_opts) == \
            (np.float32, "gzip", 4)


def test_calculate_noise_torch_is_jaxs_within_1e4(jax_files, tmp_path):
    """backend="torch" on the CPU against JAX's backend="jax": linear
    power within 1e-4 relative, the same attributes and axis values
    (divergence 29: JAX's axis is float32, the port's float64 as with
    scipy).  The lowest bins are the exception: after the rotation the
    real part's mean is the tone's amplitude, and JAX's float32 DFT
    matmul loses part of the small detrended power there (bins 0 and 1
    of the real parts: the two up to 3.5e-3 apart; JAX's up to 3.4e-3
    and the port's up to 3.8e-4 from scipy's float64 estimate of the
    same file, printed by test_welch_keeps_jaxs_arithmetic_at_dc); a
    bin where the two are more than 1e-4 apart holds the port no
    further from scipy's float64 value than JAX is."""
    jf, tf = two_copies(jax_files["noise"], tmp_path)
    jnoise.calculate_noise(jf, welch=4, backend="jax")
    tnoise.calculate_noise(tf, welch=4, backend="torch", device="cpu")
    (ji, jfr, jre, jim), (ti, tfr, tre, tim) = (jfiles.get_noise(jf),
                                                tfiles.get_noise(tf))
    assert ji == ti
    assert jfr.dtype == np.float32 and tfr.dtype == np.float64
    assert np.array_equal(tfr.astype(np.float32), jfr)
    sf = str(tmp_path / "scipy.h5")
    shutil.copy(jax_files["noise"], sf)
    with np.errstate(over="ignore"):
        tnoise.calculate_noise(sf, welch=4, backend="scipy")
    _i, _f, sre, sim = tfiles.get_noise(sf)
    for a, b, ref in zip(jre + jim, tre + tim, sre + sim):
        lin_a, lin_b, lin_ref = (10 ** (x.astype(np.float64) / 10.0)
                                 for x in (a, b, ref))
        apart = np.abs(lin_b - lin_a) > 1e-4 * lin_a
        assert apart.sum() <= 2
        assert np.all(np.abs(lin_b - lin_ref)[apart] <=
                      np.abs(lin_a - lin_ref)[apart])
    with pytest.raises(ValueError, match="backend 'jax'"):
        tnoise.calculate_noise(tf, backend="jax")         # divergence 28


def dc_gaps(lin, ref):
    """The largest relative gap of bins 0 and 1 over the real parts."""
    return max(float(np.max(np.abs(a[:2] - r[:2]) / r[:2]))
               for a, r in zip(lin, ref))


def test_welch_keeps_jaxs_arithmetic_at_dc(jax_files, tmp_path,
                                           monkeypatch):
    """Why the port's Welch removes no row mean before the per-segment
    detrend (the same estimate in exact arithmetic): on the noise file,
    removing it first leaves bins 0 and 1 of the rotated real parts
    further from scipy's float64 estimate, not nearer.  Prints the gaps
    of both and of JAX's backend="jax" (pytest -s)."""
    from gpu_sdr_tpu_torch.ops import spectral
    welch_psd = spectral.welch_psd

    def row_mean_first(x, fs, nperseg):
        return welch_psd(x - torch.mean(x, dim=-1, keepdim=True), fs,
                         nperseg)

    def real_parts(fn, backend, **kw):
        with np.errstate(over="ignore"):
            pkg = jnoise if backend == "jax" else tnoise
            pkg.calculate_noise(fn, welch=4, backend=backend, **kw)
        return [10 ** (r.astype(np.float64) / 10.0)
                for r in tfiles.get_noise(fn)[2]]

    runs = {}
    for name, backend, kw in (("scipy", "scipy", {}), ("jax", "jax", {}),
                              ("port", "torch", dict(device="cpu")),
                              ("row mean first", "torch",
                               dict(device="cpu"))):
        if name == "row mean first":
            monkeypatch.setattr(spectral, "welch_psd", row_mean_first)
        fn = str(tmp_path / f"{name.replace(' ', '_')}.h5")
        shutil.copy(jax_files["noise"], fn)
        runs[name] = real_parts(fn, backend, **kw)
    gaps = {k: dc_gaps(v, runs["scipy"]) for k, v in runs.items()
            if k != "scipy"}
    print("bins 0-1 of the real parts, largest relative gap to scipy:",
          gaps, "; port to jax:", dc_gaps(runs["port"], runs["jax"]))
    assert gaps["port"] <= gaps["row mean first"]
    assert gaps["port"] <= gaps["jax"]


def test_jax_analyzed_noise_file_reads_the_same(jax_files, tmp_path):
    """A noise file JAX analysed (every Noise dataset gzip): the port's
    get_noise gives exactly JAX's."""
    jf, _ = two_copies(jax_files["noise"], tmp_path)
    jnoise.calculate_noise(jf, welch=4)
    ji, jfr, jre, jim = jfiles.get_noise(jf)
    ti, tfr, tre, tim = tfiles.get_noise(jf)
    assert ti == ji
    for a, b in zip([jfr] + jre + jim, [tfr] + tre + tim):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_resonators_copied_and_frequency_timestreams(jax_files, tmp_path):
    """copy_resonator_group from a fitted VNA file into a noise file in
    each package: the same files; get_frequency_timestreams the same."""
    vna = str(tmp_path / "vna.h5")
    shutil.copy(jax_files["vna"], vna)
    jvna.VNA_analysis(vna)
    jfit.initialize_peaks(vna, **PEAKS)
    jfit.vna_fit(vna, fit_range=60e3)
    jf, tf = two_copies(jax_files["noise"], tmp_path)
    for _ in range(2):
        jnoise.copy_resonator_group(vna, jf)
        tnoise.copy_resonator_group(vna, tf)
    assert_same_files(jf, tf)
    for a, b in zip(tnoise.get_frequency_timestreams(tf),
                    jnoise.get_frequency_timestreams(jf)):
        assert a.shape == (2, 5000) and np.array_equal(a, b)
    with pytest.raises(ValueError, match="no Resonators"):
        tnoise.copy_resonator_group(jax_files["noise"], tf)


# ----------------------------------------------------------------------
# End to end: each package its own files


def science_loop(pkg, ch, kw, tones=None):
    """Line delay, VNA, fit, noise at `tones` (by default the fitted
    ones), PSD: (fit parameters, the noise file's get_noise, the fitted
    tones)."""
    delay, vna, fitting, noise, files = pkg
    fn = delay.measure_line_delay(RATE, RF, "A", duration=0.5,
                                  output_filename="delay",
                                  channel=resonators(ch), **kw)
    d = delay.analyze_line_delay(fn)
    assert abs(d - GROUP_DELAY_NS * 1e-9) < 20e-6, d
    delay.write_delay_to_file(fn, d)
    delay.load_delay_from_file(fn)
    fn = vna.Single_VNA(**VNA, output_filename="vna",
                        channel=resonators(ch), **kw)
    vna.VNA_analysis(fn)
    assert fitting.initialize_peaks(fn, **PEAKS)
    assert fitting.vna_fit(fn, fit_range=60e3)
    rf, fitted = fitting.get_tones(fn)
    nf = noise.Get_noise(fitted if tones is None else tones, measure_t=0.5, rate=RATE, decimation=100,
                         RF=rf, output_filename="noise",
                         channel=noise_channel(ch), **kw)
    noise.copy_resonator_group(fn, nf)
    noise.calculate_noise(nf, welch=4)
    dff, _dqr = noise.get_frequency_timestreams(nf)
    assert dff.shape == (2, 5000) and np.isfinite(dff).all()
    return fitting.get_fit_param(fn), files.get_noise(nf), fitted


def test_science_loop_end_to_end_matches_jax(tmp_path, monkeypatch):
    """Each package its own line delay, VNA, fit and noise capture; the
    noise command (the same in both) at JAX's fitted tones."""
    out = []
    for side, pkg, ch, kw in (
            ("jax", (jdelay, jvna, jfit, jnoise, jfiles), jchannel, {}),
            ("port", (tdelay, tvna, tfit, tnoise, tfiles), tchannel,
             dict(device="cpu"))):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        out.append(science_loop(pkg, ch, kw,
                                tones=out[0][2] if out else None))
    (jp, jn, _), (tp, tn, _) = out
    assert tdelay.LINE_DELAY == jdelay.LINE_DELAY
    assert len(tp) == len(jp) == 2
    for a, b in zip(tp, jp):
        assert abs(a["f0"] - b["f0"]) * 1e6 < VNA_POINT, (a["f0"], b["f0"])
        assert abs(a["Qr"] - b["Qr"]) < 0.01 * b["Qr"], (a["Qr"], b["Qr"])
    assert tn[0] == jn[0] and np.array_equal(tn[1], jn[1])
    for a, b in zip(tn[2] + tn[3], jn[2] + jn[3]):
        assert np.max(np.abs(a - b)) < 0.05


# ----------------------------------------------------------------------
# The port counterparts of tests/test_noise_fitting.py


def test_get_noise_direct_and_psd(tmp_chdir):
    """DIRECT-mode noise acquisition with additive noise: PSD of each
    channel must be flat at the injected noise level."""
    rate = int(1e6)
    tones = [100_000, -150_000]
    chan = noise_channel(tchannel, rms=1e-3)
    fn = tnoise.Get_noise(tones, measure_t=0.5, rate=rate, decimation=100,
                          RF=10_000_000, mode="DIRECT",
                          output_filename="noise_direct", channel=chan,
                          device="cpu")
    info = tfiles.get_rx_info(fn)
    assert info.decim == 100
    assert [f + info.tone for f in info.freq] == \
        [10_000_000 + t for t in tones]

    tnoise.calculate_noise(fn, welch=4)
    ninfo, freq, real, imag = tfiles.get_noise(fn)
    assert ninfo["n_chan"] == 2
    assert ninfo["rate"] == rate / 100
    assert len(real) == 2 and len(imag) == 2
    assert ninfo["tones"][0] == 10_000_000 + tones[0]
    assert np.isfinite(real[0]).all()


def test_get_noise_pfb_quantization(tmp_chdir):
    """PFB-mode noise: tones are quantized to bin centers and the command
    uses the minimum-spacing PFB size (reference USRP_noise.py:500-530),
    the same command as JAX's."""
    rate = int(1e6)
    tones = [100_000, 120_000]
    cmd = tnoise.compose_noise_command(tones, 0.1, rate, RF=0, mode="PFB")
    jcmd = jnoise.compose_noise_command(tones, 0.1, rate, RF=0, mode="PFB")
    for ant in ("A_TXRX", "A_RX2"):
        assert cmd.antenna(ant).to_json_dict() == \
            jcmd.antenna(ant).to_json_dict()
    rx = cmd.A_RX2
    assert rx.fft_tones >= 50
    bin_w = rate / rx.fft_tones
    for f in rx.freq:
        assert abs(f / bin_w - round(f / bin_w)) < 1e-6
    fn = tnoise.Get_noise(tones, measure_t=0.2, rate=rate, mode="PFB",
                          RF=0, output_filename="noise_pfb", device="cpu")
    data = tfiles.openH5file(fn)
    assert data.shape[0] == 2
    steady = data[:, 16:]
    assert np.abs(steady).std() < 0.05 * np.abs(steady).mean()


def test_full_fitting_workflow(tmp_chdir):
    """VNA over two simulated resonators -> initialize_peaks -> vna_fit
    recovers f0 and Qr; get_best_readout/get_tones give sensible values."""
    tdelay.set_line_delay(RATE, GROUP_DELAY_NS)
    fn = tvna.Single_VNA(**VNA, output_filename="vna_fit_wf",
                         channel=resonators(tchannel), device="cpu")
    tvna.VNA_analysis(fn)
    tdelay.LINE_DELAY.clear()

    ok = tfit.initialize_peaks(fn, **PEAKS)
    inits = tfiles.get_init_peaks(fn)
    assert len(inits) == 2, f"found {len(inits)} peaks"
    assert ok

    assert tfit.vna_fit(fn, fit_range=60e3)
    params = tfit.get_fit_param(fn)
    assert len(params) == 2
    f0s = sorted(1e6 * p["f0"] for p in params)
    expect = sorted(10_000_000 + r["f0"] for r in RESOS)
    for got, exp in zip(f0s, expect):
        assert abs(got - exp) < 10_000, (got, exp)
    for p in params:
        assert np.isfinite(p["Qr"]) and p["Qr"] > 0

    data = tfit.get_fit_data(fn)
    assert len(data) == 2
    assert len(data[0]["fitted"]) == len(data[0]["frequency"])
    for d in data:
        resid = np.linalg.norm(d["fitted"] - d["original"]) / \
            np.linalg.norm(d["original"])
        assert resid < 0.2, resid

    bro = tfit.get_best_readout(fn)
    assert len(bro) == 2
    rf, rel = tfit.get_tones(fn)
    assert rf == 10_000_000
    spacing = tfit.min_readout_spacing(fn)
    assert 300_000 < spacing < 400_000


def test_nonlinear_model_roundtrip():
    """do_fit recovers parameters of a synthetic nonlinear_model trace,
    as JAX's does, and the helpers are JAX's."""
    f = np.linspace(99.95e6, 100.05e6, 400)
    truth = dict(f0=100.0, A=1.0, phi=0.01, D=0.0, dQr=1.0 / 20000,
                 dQe_re=1.0 / 40000, dQe_im=0.0, a=0.1)
    z = tfit.complex_of_real(tfit.nonlinear_model(f, *truth.values()))
    f0, Qi, Qr, zfit, modelwise = tfit.do_fit(f, z.real, z.imag)
    assert abs(f0 - 100.0) < 1e-3
    assert abs(Qr - 20000) / 20000 < 0.05
    assert abs(modelwise[8] - 0.1) < 0.05
    jout = jfit.do_fit(f, z.real, z.imag)
    assert np.array_equal(zfit, jout[3]) and modelwise == jout[4]
    assert np.array_equal(tfit.dbm2vrms(tfit.vrms2dbm(0.3)), 0.3) or \
        abs(tfit.dbm2vrms(tfit.vrms2dbm(0.3)) - 0.3) < 1e-12
    phase = np.cumsum(np.full(50, 3.0))
    assert np.array_equal(data_analysis.linear_phase(phase),
                          __import__("gpu_sdr_tpu.client.data_analysis",
                                     fromlist=["x"]).linear_phase(phase))


def test_amplitude_trigger_from_vna_file(tmp_chdir):
    """amplitude_trigger(vna=...) loads fit params and calibration from a
    fitted VNA file (the reference's construction path)."""
    from gpu_sdr_tpu_torch.client.triggers import amplitude_trigger

    rate = int(1e6)
    chan = tchannel.make_resonator_channel(
        rate, [dict(f0=150_000.0, Qr=25.0, Qe_re=50.0)], fft_len=1 << 12)
    tdelay.set_line_delay(rate, GROUP_DELAY_NS)
    fn = tvna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.2,
                         n_points=800, tx_gain=0, Rate=rate, RF=10_000_000,
                         output_filename="vna_for_trig", channel=chan,
                         device="cpu")
    tvna.VNA_analysis(fn)
    tdelay.LINE_DELAY.clear()
    assert tfit.initialize_peaks(fn, N_peaks=1, peak_width=50e3,
                                 Qr_cutoff=5, Mag_depth_cutoff=0.5,
                                 exclude_center=False)
    tfit.vna_fit(fn, fit_range=60e3)

    trig = amplitude_trigger(sample_rate=10_000, threshold=5, vna=fn)
    assert trig.fit_params and len(trig.fit_params) == 1
    assert trig.cal > 0
    trig.accum = 0.5
    data = np.ones(10_000, dtype=np.complex64) * 0.5
    md = {"channels": 1, "length": 10_000}
    out, md2 = trig.trigger(data, dict(md))
    assert md2["length"] >= 0


# ----------------------------------------------------------------------
# The port counterparts of tests/test_vna_delay.py


def test_single_vna_flat_line(tmp_chdir):
    fn = tvna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.1,
                         n_points=500, tx_gain=0, Rate=int(1e6),
                         RF=10_000_000, output_filename="vna_flat",
                         device="cpu")
    assert os.path.exists(fn)
    tvna.VNA_analysis(fn)
    assert tvna.is_VNA_analyzed(fn)
    freq, s21 = tvna.get_VNA_data(fn, calibrated=False)
    assert len(freq) == 500
    assert abs(freq[0] - (10_000_000 - 400_000)) < 1
    assert freq[-1] > 10_000_000 + 399_000
    assert np.allclose(np.abs(s21), 1.0, atol=1e-3)
    info = tfiles.get_rx_info(fn)
    assert info.swipe_s == [500]
    assert info.decim == 1


def test_vna_resonator_dip_with_delay_calibration(tmp_chdir):
    """Measure the line delay through the resonator channel, register it,
    then the VNA (compensated from LINE_DELAY) finds the resonator at the
    right frequency and depth."""
    rate = int(1e6)
    f0, Qr, Qe = 100_000.0, 20.0, 40.0

    def fresh_channel():
        return tchannel.make_resonator_channel(
            rate, [dict(f0=f0, Qr=Qr, Qe_re=Qe)], fft_len=1 << 12)

    fn_d = tdelay.measure_line_delay(rate, 0, "A", duration=0.5,
                                     output_filename="delay_for_vna",
                                     channel=fresh_channel(), device="cpu")
    d = tdelay.analyze_line_delay(fn_d)
    assert abs(d - 512e-6) < 20e-6, d
    tdelay.set_line_delay(rate, d * 1e9)
    assert tvna.LINE_DELAY["1"] == d * 1e9

    fn = tvna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.2,
                         n_points=800, tx_gain=0, Rate=rate, RF=0,
                         output_filename="vna_reso",
                         channel=fresh_channel(), device="cpu")
    assert tfiles.get_rx_info(fn).delay == 1.0 + d
    tvna.VNA_analysis(fn)
    freq, s21 = tvna.get_VNA_data(fn, calibrated=False)
    interior = slice(20, None)
    a = np.abs(s21[interior])
    fi = freq[interior]
    dip_f = fi[np.argmin(a)]
    assert abs(dip_f - f0) < 5_000, f"dip at {dip_f}, expected {f0}"
    expected_depth = abs(1 - Qr / Qe)
    assert abs(a.min() - expected_depth) < 0.1
    far = np.abs(fi - f0) > 100_000
    assert np.allclose(a[far], 1.0, atol=0.05)


def test_line_delay_roundtrip(tmp_chdir):
    rate = int(1e6)
    fn = tdelay.measure_line_delay(rate, 10_000_000, "A", duration=0.5,
                                   output_filename="delay_meas",
                                   channel=tchannel.DelayChannel(40),
                                   device="cpu")
    d = tdelay.analyze_line_delay(fn)
    assert abs(d - 40e-6) < 0.3 * 40e-6, d
    tdelay.write_delay_to_file(fn, d)
    rate_msps, delay_ns = tdelay.load_delay_from_file(fn)
    assert rate_msps == 1
    assert delay_ns == int(d * 1e9)
    assert tdelay.LINE_DELAY["1"] == delay_ns


def test_vna_iterations_average(tmp_chdir):
    fn = tvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=250, tx_gain=0, Rate=int(1e6), RF=0,
                         Iterations=4, output_filename="vna_iter",
                         device="cpu")
    assert tfiles.openH5file(fn).shape[1] == 4 * 250
    tvna.VNA_analysis(fn)
    freq, s21 = tvna.get_VNA_data(fn, calibrated=False)
    assert len(freq) == 250
    assert np.allclose(np.abs(s21), 1.0, atol=1e-3)


def test_vna_calibration_attr(tmp_chdir):
    fn = tvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=100, tx_gain=10, Rate=int(1e6), RF=0,
                         output_filename="vna_cal", device="cpu")
    tvna.VNA_analysis(fn)
    freq, s21_cal = tvna.get_VNA_data(fn, calibrated=True)
    _, s21_raw = tvna.get_VNA_data(fn, calibrated=False)
    expected = tfiles.USRP_calibration / \
        (10 ** ((tfiles.USRP_power + 10) / 20))
    assert np.allclose(s21_cal, s21_raw * expected)


def test_vna_undecimated_analysis(tmp_chdir):
    """decimation=False: raw samples average per sweep, then per
    frequency point; a delay channel's phase ramp survives."""
    d = 40
    fn = tvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=250, tx_gain=0, Rate=int(1e6), RF=0,
                         decimation=False, channel=tchannel.DelayChannel(d),
                         output_filename="vna_undecim", device="cpu")
    tvna.VNA_analysis(fn)
    freq, s21 = tvna.get_VNA_data(fn, calibrated=False)
    assert len(freq) == 250
    assert np.allclose(np.abs(s21[5:]), 1.0, atol=2e-2)
    want = np.angle(np.exp(-2j * np.pi * freq[5:] * d / 1e6))
    err = np.angle(np.exp(1j * (np.angle(s21[5:]) - want)))
    assert np.abs(err).max() < 0.05, np.abs(err).max()


# ----------------------------------------------------------------------
# Captures and dual commands against JAX's files


def _full_spec(m, **kw):
    return m.Get_full_spec([100_000, -200_000], channels=100,
                           measure_t=0.05, rate=RATE, RF=RF,
                           output_filename="full", **kw)


def _nodsp(m, **kw):
    return m.get_NODSP_tones([100_000], measure_t=0.02, rate=RATE, RF=RF,
                             output_filename="raw", **kw)


def _dual_vna(m, **kw):
    return m.Dual_VNA(-200_000, 200_000, -100_000, 100_000, 0.05, 250, 0, 0,
                      Rate=RATE, output_filename="dual_vna", **kw)


def _dual_noise(m, **kw):
    return m.dual_get_noise([100_000], [-50_000], 0.1, RATE, decimation=100,
                            output_filename="dual_noise", **kw)


@pytest.mark.parametrize("case, acquire, modules", [
    ("full_spec", _full_spec, (jfull, tfull)),
    ("nodsp", _nodsp, (jfull, tfull)),
    ("dual_vna", _dual_vna, (jvna, tvna)),
    ("dual_noise", _dual_noise, (jnoise, tnoise)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_captures_match_jaxs_files(tmp_path, monkeypatch, case, acquire,
                                   modules):
    """Get_full_spec (with push_queue), get_NODSP_tones, Dual_VNA and
    dual_get_noise in both packages: the same files (complex data at
    >= 90 dB, the rest equal); push_queue gets every packet."""
    names = []
    for side, m, kw in (("jax", modules[0], {}),
                        ("port", modules[1], dict(device="cpu"))):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        q = queue.Queue()
        if case in ("full_spec", "nodsp"):
            kw = dict(kw, push_queue=q)
        names.append((str(tmp_path / side / acquire(m, **kw)), q.qsize()))
    (jfn, jq), (tfn, tq) = names
    assert tq == jq and (tq > 0) == (case in ("full_spec", "nodsp"))
    assert_same_file(jfn, tfn)


def test_science_loop_runs_with_jax_h5py_and_matplotlib_blocked(tmp_path):
    """With jax, gpu_sdr_tpu, h5py and matplotlib unimportable the port
    runs the whole science loop on the CPU: line delay, VNA, analysis,
    fit, noise at the fitted tones, the torch Welch, the frequency
    timestreams, a trigger from the VNA file."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "gpu_sdr_tpu", "h5py", "matplotlib"):
            sys.modules[name] = None
        import numpy as np, torch
        torch.set_num_threads(2)
        from gpu_sdr_tpu_torch.client import (delay, fitting, noise, vna,
                                              files, triggers)
        from gpu_sdr_tpu_torch.engine import channel as ch
        resos = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0),
                 dict(f0=200_000.0, Qr=25.0, Qe_re=50.0)]
        chan = lambda: ch.make_resonator_channel(1_000_000, resos,
                                                 fft_len=1 << 12)
        fn = delay.measure_line_delay(1_000_000, 10_000_000, "A",
                                      duration=0.5, output_filename="d",
                                      channel=chan(), device="cpu")
        d = delay.analyze_line_delay(fn)
        delay.write_delay_to_file(fn, d)
        print("delay", delay.load_delay_from_file(fn))
        fn = vna.Single_VNA(-400_000, 400_000, 0.4, 1600, 0,
                            Rate=1_000_000, RF=10_000_000,
                            output_filename="v", channel=chan(),
                            device="cpu")
        vna.VNA_analysis(fn)
        vna.VNA_timestream_analysis(fn)
        assert fitting.initialize_peaks(fn, N_peaks=2, peak_width=50e3,
                                        Qr_cutoff=5, Mag_depth_cutoff=0.5,
                                        exclude_center=False)
        assert fitting.vna_fit(fn, fit_range=60e3)
        rf, tones = fitting.get_tones(fn)
        nf = noise.Get_noise(tones, measure_t=0.5, rate=1_000_000,
                             decimation=100, RF=rf, output_filename="n",
                             channel=ch.ChainChannel([chan()],
                                                     noise_rms=1e-3,
                                                     seed=5),
                             device="cpu")
        noise.copy_resonator_group(fn, nf)
        noise.calculate_noise(nf, welch=4, backend="torch", device="cpu")
        info, freq, real, imag = files.get_noise(nf)
        assert info["n_chan"] == 2 and np.isfinite(real[0]).all()
        dff, dqr = noise.get_frequency_timestreams(nf)
        assert dff.shape == (2, 5000) and np.isfinite(dff).all()
        t = triggers.amplitude_trigger(sample_rate=10_000, threshold=5,
                                       vna=fn)
        assert len(t.fit_params) == 2 and t.cal > 0
        loaded = [m for m in sys.modules if m.split(".")[0] in
                  ("jax", "gpu_sdr_tpu", "h5py", "matplotlib")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("science loop ok", [round(p["f0"], 4)
                                  for p in fitting.get_fit_param(fn)])
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "science loop ok" in r.stdout
