"""The port's capture scripts against the JAX package's, on the CPU (see
test_torch_scripts.py): the full spectrum and its plot, the raw (NODSP)
capture and its analysis, the throughput stress test and the dynamic
VNA, the counterparts of tests/test_scripts.py's
test_full_spec_scripts, test_raw_capture_script and
test_network_test_script and of tests/test_scripts_extra.py's
test_raw_analysis_script."""

import os

from test_torch_scripts import (assert_files_agree,
                                folders, jax_cmd, one_file, port_cmd,
                                run_chains, same_lines)


def test_full_spec_scripts(tmp_path):
    j, p = folders(tmp_path)
    steps = [("get_noise_full.py", ("--rate", "1", "--freq", "10",
                                    "--channels", "64", "--time", "0.2",
                                    "--tones", "0.1")),
             ("plot_spectrogram.py", ())]
    jout, pout = run_chains(
        [(jax_cmd(s, "--folder", str(j), *a), j) for s, a in steps],
        [(port_cmd(s, "--folder", str(p), *a,
                   plot=s == "plot_spectrogram.py",
                   heatmap=s == "plot_spectrogram.py"), p)
         for s, a in steps])
    assert "PFB data written" in pout[0] and "plot written" in pout[1]
    for jo, po in zip(jout, pout):
        same_lines(jo, po)
    assert_files_agree(one_file(j, "USRP_PFB*.h5"),
                       one_file(p, "USRP_PFB*.h5"))


def test_raw_capture_script(tmp_path):
    j, p = folders(tmp_path)
    args = ("--rate", "1", "--freq", "10", "--time", "0.1")
    (jo,), (po,) = run_chains(
        [(jax_cmd("get_raw_data.py", "--folder", str(j), *args), j)],
        [(port_cmd("get_raw_data.py", "--folder", str(p), *args,
                   as_module=True, plot=False), p)])
    assert "raw data written" in po
    same_lines(jo, po)
    assert_files_agree(one_file(j, "USRP_*.h5"), one_file(p, "USRP_*.h5"))


def test_raw_analysis_script(tmp_path):
    j, p = folders(tmp_path)
    steps = [("get_raw_data.py", ("--rate", "1", "--freq", "10", "--time",
                                  "0.1")),
             ("raw_data_analisys.py", ()),
             ("last_file_plot.py", ())]
    jout, pout = run_chains(
        [(jax_cmd(s, "--folder", str(j), *a), j) for s, a in steps],
        [(port_cmd(s, "--folder", str(p), *a,
                   plot=s != "get_raw_data.py"), p) for s, a in steps])
    assert "spectrum written" in pout[1] and "plot written" in pout[2]
    for jo, po in zip(jout, pout):
        same_lines(jo, po)
    assert os.path.exists(j / "raw_spectrum.png")
    assert os.path.exists(p / "raw_spectrum.html")


def test_network_test_script(tmp_path):
    j, p = folders(tmp_path)
    args = ("--channels", "100", "--rate", "1", "--time", "0.5")
    (jo,), (po,) = run_chains(
        [(jax_cmd("network_test.py", *args), j)],
        [(port_cmd("network_test.py", *args, as_module=True, plot=False),
          p)])
    assert "Msps sustained" in po
    same_lines(jo, po, numbers=True)          # timing aside, rows out too
