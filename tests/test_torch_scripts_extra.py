"""The port's secondary workflow scripts against the JAX package's, on
the CPU (see test_torch_scripts.py): dual VNA, dual noise, the stitched
large VNA, the beam mapper and the dynamic VNA, the counterparts of
tests/test_scripts_extra.py.  The stitched VNA and the beam map are
written by the port through its own HDF5 module (client/h5.py) and read
back here through h5py: the frequency axes and the positions equal
JAX's, the responses within 1e-4 relative."""

import os
import sys

import h5py
import numpy as np

from test_torch_scripts import (REPO, assert_files_agree, folders, jax_cmd,
                                one_file, port_cmd, run_chains, same_lines)

REL = 1e-4


def test_dual_vna_script(tmp_path):
    j, p = folders(tmp_path)
    args = ("--rate", "1", "--freq_a", "10", "--freq_b", "20", "--points",
            "200", "--time", "0.2", "--f0", "-0.4", "--f1", "0.4")
    (jo,), (po,) = run_chains(
        [(jax_cmd("get_dual_VNA.py", "--folder", str(j), *args), j)],
        [(port_cmd("get_dual_VNA.py", "--folder", str(p), *args,
                   plot=False), p)])
    assert "dual VNA" in po
    same_lines(jo, po)
    pfn = one_file(p, "USRP_VNA*.h5")
    with h5py.File(pfn, "r") as f:
        assert "A_RX2" in f["raw_data0"] and "B_RX2" in f["raw_data0"]
        assert len(f["VNA_0"]["frequency"]) == 400
    assert_files_agree(one_file(j, "USRP_VNA*.h5"), pfn)


def test_dual_noise_script(tmp_path):
    j, p = folders(tmp_path)
    args = ("--rate", "1", "--freq_a", "10", "--freq_b", "20", "--tones_a",
            "0.1", "--tones_b", "0.15", "--time", "0.2")
    (jo,), (po,) = run_chains(
        [(jax_cmd("get_dual_noise.py", "--folder", str(j), *args), j)],
        [(port_cmd("get_dual_noise.py", "--folder", str(p), *args,
                   as_module=True, plot=False), p)])
    assert "dual noise" in po
    same_lines(jo, po)
    assert_files_agree(one_file(j, "USRP_Noise*.h5"),
                       one_file(p, "USRP_Noise*.h5"))


def stitched(fn):
    with h5py.File(fn, "r") as f:
        g = f["VNA_0"]
        return (dict(g.attrs), np.asarray(g["frequency"]),
                np.asarray(g["S21"]), g["S21"].dtype)


def test_large_vna_script(tmp_path):
    j, p = folders(tmp_path)
    args = ("--rate", "1", "--start", "10", "--stop", "12",
            "--points_per_segment", "200", "--time", "0.2", "--out",
            "bigvna")
    (jo,), (po,) = run_chains(
        [(jax_cmd("large_VNA.py", "--folder", str(j), *args), j)],
        [(port_cmd("large_VNA.py", "--folder", str(p), *args,
                   plot=False), p)])
    assert "stitched" in po
    same_lines(jo, po)
    (ja, jf, js, jt), (pa, pf, ps, pt) = (stitched(j / "bigvna.h5"),
                                          stitched(p / "bigvna.h5"))
    assert pf.min() >= 10e6 - 1 and pf.max() <= 12e6 + 1
    assert np.all(np.diff(pf) >= 0)
    assert np.array_equal(jf, pf) and jt == pt
    assert np.max(np.abs(ps - js) / np.abs(js)) <= REL
    assert sorted(ja) == sorted(pa) == ["calibration", "segments"]
    assert np.array_equal(ja["calibration"], pa["calibration"])
    assert int(ja["segments"]) == int(pa["segments"]) == 3
    for s in range(3):
        assert_files_agree(j / f"bigvna_seg{s}.h5", p / f"bigvna_seg{s}.h5")


def test_beam_mapper_simulated(tmp_path):
    j, p = folders(tmp_path)
    args = ("--nx", "2", "--ny", "2", "--rate", "1", "--time", "0.1",
            "--tones", "0.1")
    (jo,), (po,) = run_chains(
        [([sys.executable, os.path.join(REPO, "scripts", "beam_mapper",
                                        "beam_mapper.py"),
           "--folder", str(j), *args], j)],
        [(port_cmd("beam_mapper/beam_mapper.py", "--folder", str(p), *args,
                   plot=False), p)])
    assert "beam map written" in po
    same_lines(jo, po, numbers=True)

    def beam_map(folder):
        with h5py.File(folder / "beam_map.h5", "r") as f:
            g = f["beam_map"]
            return (dict(g.attrs), np.asarray(g["positions"]),
                    np.asarray(g["responses"]))
    (ja, jpos, jr), (pa, ppos, pr) = beam_map(j), beam_map(p)
    assert ppos.shape == (4, 2) and pr.shape == (4, 1)
    assert np.array_equal(jpos, ppos) and jr.dtype == pr.dtype
    assert np.max(np.abs(pr - jr) / np.abs(jr)) <= REL
    assert sorted(ja) == sorted(pa)
    for k in ja:
        assert np.array_equal(ja[k], pa[k]), k
    for i in range(4):
        assert_files_agree(j / f"map_{i:04d}.h5", p / f"map_{i:04d}.h5")


def test_dynamic_vna_script(tmp_path):
    j, p = folders(tmp_path)
    steps = [("get_VNA.py", ("--rate", "1", "--freq", "10", "--f0", "-0.4",
                             "--f1", "0.4", "--points", "200", "--time",
                             "0.1", "--iter", "3", "--delay_over", "0")),
             ("analyze_dynamic_VNA.py", ())]
    jout, pout = run_chains(
        [(jax_cmd(s, "--folder", str(j), *a), j) for s, a in steps],
        [(port_cmd(s, "--folder", str(p), *a,
                   heatmap=s == "analyze_dynamic_VNA.py"), p)
         for s, a in steps])
    assert "waterfall written" in pout[1]
    for jo, po in zip(jout, pout):
        same_lines(jo, po)
    assert_files_agree(one_file(j, "USRP_VNA*.h5"),
                       one_file(p, "USRP_VNA*.h5"))
