"""The port's workflow scripts (gpu_sdr_tpu_torch/scripts) against the
JAX package's (scripts/), on the CPU: the quick start (line delay, VNA,
analysis, fit, noise, noise analysis, raw plot), the counterparts of
tests/test_scripts.py's first two tests.

Each test runs the JAX script and the port's (``--device cpu
--backend html``) on the same arguments in separate folders, the two
chains side by side.  The port's subprocess runs with jax, gpu_sdr_tpu,
h5py and matplotlib unimportable; the files of both are read back
through h5py and compared: raw datasets >= 90 dB against JAX's, the line
delay within one sample, fits f0 within 500 Hz and Qr within 1%, PSDs
within 0.05 dB (where one package's bin holds no power at all, as in
a noise-free loopback, both under -120 dB: the other's rounding), every
other dataset and attribute the same; the printed
lines are the same once timestamps and plot extensions are masked.
The helpers here serve the other test_torch_scripts_*.py files too.
"""

import concurrent.futures
import glob
import os
import re
import subprocess
import sys

import h5py
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
           OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
           OPENBLAS_NUM_THREADS="2")
BLOCKED = ("jax", "gpu_sdr_tpu", "h5py", "matplotlib")
# a port script, run by file path or as a module with packages made
# unimportable: argv[1] those packages, argv[2] the path or module, the
# rest its flags
RUNNER = (
    "import runpy, sys\n"
    "blocked, target, sys.argv = sys.argv[1], sys.argv[2], sys.argv[2:]\n"
    "for _m in blocked.split(','):\n"
    "    sys.modules[_m] = None\n"
    "if target.endswith('.py'):\n"
    "    runpy.run_path(target, run_name='__main__')\n"
    "else:\n"
    "    runpy.run_module(target, run_name='__main__', alter_sys=True)\n")
PORT_FLAGS = ("--device", "cpu")
SNR_DB = 90.0
PSD_DB = 0.05
# a PSD bin of exactly zero power (a noise-free loopback's detrended
# stream) lies near -379 dB; where one package's bin is that, the
# other's holds only its rounding, which must stay under -120 dB
ZERO_POWER_DB = -300.0
ROUNDING_DB = -120.0
TIMEOUT = 240


def jax_cmd(rel, *args):
    return [sys.executable, os.path.join(REPO, "scripts", rel), *args]


def port_cmd(rel, *args, as_module=False, plot=True, heatmap=False):
    """The port's counterpart of scripts/<rel>, by file path or (with
    `as_module`) as ``-m gpu_sdr_tpu_torch.scripts.<name>``, with the
    BLOCKED packages unimportable; a `heatmap` plot keeps matplotlib,
    which renders an HTML page's heatmap (divergence 34)."""
    target = (("gpu_sdr_tpu_torch.scripts." +
               rel[:-3].replace("/", ".")) if as_module else
              os.path.join(REPO, "gpu_sdr_tpu_torch", "scripts", rel))
    extra = PORT_FLAGS + (("--backend", "html") if plot else ())
    blocked = [m for m in BLOCKED if not (heatmap and m == "matplotlib")]
    return [sys.executable, "-c", RUNNER, ",".join(blocked), target, *args,
            *extra]


def run(cmd, cwd, timeout=TIMEOUT):
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd,
                       env=ENV, timeout=timeout)
    assert p.returncode == 0, f"{cmd[-1]} failed:\n{p.stdout}\n{p.stderr}"
    return p.stdout


def run_chains(*chains):
    """Run each chain of (cmd, cwd) steps in order, the chains side by
    side; returns each chain's outputs."""
    def one(chain):
        return [run(cmd, cwd) for cmd, cwd in chain]
    with concurrent.futures.ThreadPoolExecutor(len(chains)) as ex:
        return [f.result() for f in [ex.submit(one, c) for c in chains]]


def folders(tmp_path):
    j, p = tmp_path / "jax", tmp_path / "port"
    j.mkdir()
    p.mkdir()
    return j, p


def masked(out: str, numbers: bool = False):
    """Printed lines with timestamps, plot extensions and (with
    `numbers`) decimal numbers masked."""
    out = re.sub(r"\d{8}_\d{6}", "<ts>", out)
    out = re.sub(r"\.(png|html)\b", ".<plot>", out)
    if numbers:
        out = re.sub(r"\d+\.\d*", "<x>", out)
    return out.splitlines()


def same_lines(jax_out, port_out, numbers=False):
    assert masked(jax_out, numbers) == masked(port_out, numbers), \
        (jax_out, port_out)


def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(test, np.complex128) - ref
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2) /
                               max(np.sum(np.abs(err) ** 2), 1e-300)))


def _attrs_agree(a, b, where, skip=()):
    assert sorted(a.attrs) == sorted(b.attrs), where
    for k in a.attrs:
        if k in skip:
            continue
        x, y = a.attrs[k], b.attrs[k]
        if isinstance(x, (bytes, str)) or np.asarray(x).dtype.kind in "OSU":
            assert np.array_equal(np.asarray(x), np.asarray(y)), (where, k)
        else:
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-12,
                                       err_msg=f"{where} {k}")


def assert_files_agree(jfn, pfn, snr_bar=SNR_DB, psd_db=PSD_DB, skip=()):
    """Every group, dataset and attribute of JAX's file in the port's:
    raw data and S21 >= `snr_bar` dB, PSDs (Noise groups' real_k /
    imag_k, in dB) within `psd_db`, everything else the same; the
    objects under the top-level groups and the attributes named in
    `skip` are left to the caller."""
    with h5py.File(jfn, "r") as fj, h5py.File(pfn, "r") as fp:
        names = []
        fj.visit(names.append)
        pnames = []
        fp.visit(pnames.append)
        assert sorted(names) == sorted(pnames), (names, pnames)
        _attrs_agree(fj, fp, "/")
        for n in names:
            if n.split("/")[0] in skip and "/" in n:
                continue
            a, b = fj[n], fp[n]
            _attrs_agree(a, b, n, skip)
            if not isinstance(a, h5py.Dataset):
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, \
                (n, a.shape, b.shape, a.dtype, b.dtype)
            x, y = a[()], b[()]
            leaf = n.rsplit("/", 1)[-1]
            if a.dtype.kind == "c" and np.size(x):
                assert snr_db(x, y) >= snr_bar, (n, snr_db(x, y))
            elif n.startswith("Noise") and re.match(r"(real|imag)_\d+$",
                                                    leaf):
                live = (x > ZERO_POWER_DB) & (y > ZERO_POWER_DB)
                assert np.all(np.abs(y - x)[live] <= psd_db), \
                    (n, np.max(np.abs(y - x)[live]))
                assert np.all(np.maximum(x, y)[~live] < ROUNDING_DB), n
            elif a.dtype.kind == "f":
                np.testing.assert_allclose(y, x, rtol=1e-9, atol=0,
                                           err_msg=n)
            else:
                assert np.array_equal(x, y), n


def one_file(folder, pattern):
    found = sorted(glob.glob(str(folder / pattern)))
    assert len(found) == 1, found
    return found[0]


def test_get_line_delay_script(tmp_path):
    j, p = folders(tmp_path)
    args = ("--rate", "1", "--freq", "10", "--duration", "0.3")
    (jo,), (po,) = run_chains(
        [(jax_cmd("get_line_delay.py", "--folder", str(j), *args), j)],
        [(port_cmd("get_line_delay.py", "--folder", str(p), *args,
                   as_module=True), p)])
    assert "Line delay" in po
    same_lines(jo, po)
    jfn, pfn = one_file(j, "USRP_Delay*.h5"), one_file(p, "USRP_Delay*.h5")
    with h5py.File(jfn, "r") as fj, h5py.File(pfn, "r") as fp:
        dj = fj["delay_info"].attrs["1"]
        dp = fp["delay_info"].attrs["1"]
    assert abs(int(dp) - int(dj)) <= 1e9 / 1e6, (dj, dp)   # one sample
    assert_files_agree(jfn, pfn)
    # the diagnostic PNG is the matplotlib backend's alone (divergence 37)
    assert os.path.exists(j / "Delay_diagnostic.png")
    assert not os.path.exists(p / "Delay_diagnostic.png")


def test_vna_fit_noise_scripts(tmp_path):
    j, p = folders(tmp_path)
    steps = [
        ("get_VNA.py", ("--rate", "1", "--freq", "10", "--f0", "-0.4",
                        "--f1", "0.4", "--points", "400", "--time", "0.2",
                        "--delay_over", "0")),
        ("analyze_VNA.py", ()),
        ("get_noise.py", ("--rate", "1", "--freq", "10", "--tones", "0.1",
                          "--time", "0.3", "--decimation", "100")),
        ("analyze_noise.py", ()),
        ("raw_plot.py", ())]
    jout, pout = run_chains(
        [(jax_cmd(s, "--folder", str(j), *a), j) for s, a in steps],
        [(port_cmd(s, "--folder", str(p), *a, as_module=k % 2 == 0,
                   plot=s != "get_noise.py"), p)
         for k, (s, a) in enumerate(steps)])
    assert "analyzed" in pout[1] and "noise data written" in pout[2]
    assert "analyzed" in pout[3] and "plot written" in pout[4]
    for jo, po in zip(jout, pout):
        same_lines(jo, po)
    assert_files_agree(one_file(j, "USRP_VNA*.h5"),
                       one_file(p, "USRP_VNA*.h5"))
    assert_files_agree(one_file(j, "USRP_Noise*.h5"),
                       one_file(p, "USRP_Noise*.h5"))
    for name in ("USRP_VNA", "USRP_noise_spec", "USRP_raw_data"):
        assert os.path.exists(j / f"{name}.png")
        assert os.path.exists(p / f"{name}.html")
