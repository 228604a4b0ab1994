"""The port's fit, noise-from-fit and sweep scripts against the JAX
package's, on the CPU (see test_torch_scripts.py): fit_VNA on a VNA
file through one resonator, get_noise at the fitted tone (--VNA),
diagnostic_noise and freqts_plot on that noise file, and
swipe_parameter's VNA -> fit -> noise sweep on the ideal loopback.
Fits agree to f0 within 500 Hz and Qr within 1%."""

import os
import re
import sys

import h5py
import numpy as np
import pytest

from test_torch_scripts import (assert_files_agree, folders, jax_cmd,
                                one_file, port_cmd, run_chains, same_lines)

RATE, RF = 1_000_000, 10_000_000
RESOS = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0)]
VNA_NAME = "USRP_VNA_reso.h5"


@pytest.fixture(scope="module")
def resonator_vna(tmp_path_factory):
    """A VNA file through one resonator, written by the JAX package: the
    input both fit_VNA scripts fit."""
    from gpu_sdr_tpu.client import delay, vna
    from gpu_sdr_tpu.engine.channel import make_resonator_channel
    d = tmp_path_factory.mktemp("vna")
    cwd = os.getcwd()
    os.chdir(d)
    delay.set_line_delay(RATE, 512e-6 * 1e9)
    try:
        vna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.4,
                       n_points=1600, tx_gain=0, Rate=RATE, RF=RF,
                       output_filename=VNA_NAME[:-3],
                       channel=make_resonator_channel(RATE, RESOS,
                                                      fft_len=1 << 14))
    finally:
        delay.LINE_DELAY.clear()
        os.chdir(cwd)
    return d / VNA_NAME


def fits(fn):
    with h5py.File(fn, "r") as f:
        g = f["Resonators"]
        return [dict(g[k].attrs) for k in sorted(g)]


def fits_agree(fj, fp):
    assert len(fj) == len(fp) >= 1
    for a, b in zip(fj, fp):
        assert abs(a["f0"] - b["f0"]) * 1e6 <= 500, (a["f0"], b["f0"])
        assert abs(a["Qr"] - b["Qr"]) <= 0.01 * abs(a["Qr"]), \
            (a["Qr"], b["Qr"])


def no_fit_numbers(out):
    return re.sub(r"=[-\d.]+", "=", out)


def test_fit_vna_noise_diagnostic_scripts(tmp_path, resonator_vna):
    j, p = folders(tmp_path)
    for d in (j, p):
        (d / VNA_NAME).write_bytes(resonator_vna.read_bytes())
    steps = [
        ("fit_VNA.py", ("--Qr_cutoff", "5", "--fit_range", "40e3")),
        ("get_noise.py", ("--VNA", VNA_NAME, "--rate", "1", "--time", "0.2",
                          "--decimation", "100")),
        ("diagnostic_noise.py", ()),
        ("freqts_plot.py", ())]
    jout, pout = run_chains(
        [(jax_cmd(s, "--folder", str(j), *a), j) for s, a in steps],
        [(port_cmd(s, "--folder", str(p), *a, as_module=k % 2 == 1,
                   plot=s != "get_noise.py"), p)
         for k, (s, a) in enumerate(steps)])
    assert "initialize_peaks: ok" in pout[0] and "plot written" in pout[0]
    assert "1 tones from" in pout[1] and "noise data written" in pout[1]
    assert "diagnostic written" in pout[2] and "plot written" in pout[3]
    for jo, po in zip(jout, pout):
        same_lines(no_fit_numbers(jo), no_fit_numbers(po))
    fits_agree(fits(j / VNA_NAME), fits(p / VNA_NAME))
    jn, pn = one_file(j, "USRP_Noise*.h5"), one_file(p, "USRP_Noise*.h5")
    # the noise tone is the fitted f0 (to 1 Hz), copied with the fit
    assert_files_agree(jn, pn, skip=("Resonators", "freq"))
    fits_agree(fits(jn), fits(pn))
    with h5py.File(jn, "r") as fj, h5py.File(pn, "r") as fp:
        tj = fj["raw_data0/A_RX2"].attrs["freq"]
        tp = fp["raw_data0/A_RX2"].attrs["freq"]
    assert np.all(np.abs(np.asarray(tj) - np.asarray(tp)) <= 500), (tj, tp)


def test_swipe_parameter_script(tmp_path):
    j, p = folders(tmp_path)
    args = ("--rate", "1", "--freq", "10", "--f0", "-0.4", "--f1", "0.4",
            "--points", "400", "--vna_time", "0.2", "--noise_time", "0.2",
            "--gains", "0")
    (jo,), (po,) = run_chains(
        [(jax_cmd("swipe_parameter.py", "--folder", str(j), *args), j)],
        [(port_cmd("swipe_parameter.py", "--folder", str(p), *args), p)])
    assert "--- gain 0 dB ---" in po
    same_lines(jo, po)
    assert_files_agree(one_file(j, "USRP_VNA_gain0.h5"),
                       one_file(p, "USRP_VNA_gain0.h5"))


def test_initialize_peaks_ends_on_a_flat_trace(tmp_path):
    """The port's initialize_peaks picks the largest gradient among the
    candidates it has not masked yet.  On the ideal loopback's flat
    trace JAX's rule (the first index of that value anywhere) picked a
    masked one again and never ended, which swipe_parameter hits; the
    port's gives up, as JAX's does on the trace JAX's engine writes."""
    code = (
        "import sys, os\n"
        "sys.modules['jax'] = None\n"
        "from gpu_sdr_tpu_torch.client import fitting, vna\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "fn = vna.Single_VNA(start_f=-400_000, last_f=400_000,"
        " measure_t=0.2, n_points=400, tx_gain=0, Rate=1_000_000,"
        " RF=10_000_000, output_filename='flat', device='cpu')\n"
        "vna.VNA_analysis(fn)\n"
        "print(fitting.initialize_peaks(fn, N_peaks=1))\n")
    out = run_chains([([sys.executable, "-c", code], tmp_path)])[0][0]
    assert out.strip() == "False", out
