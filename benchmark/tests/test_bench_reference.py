"""The plain references against direct float64 sums at small sizes."""

import numpy as np
import pytest
import torch

import harness
from configs import chirp, direct

RNG = np.random.default_rng(7)


def _cfg_direct():
    return {"rx": {"rate": 1000, "buffer_len": 200, "decim": 10,
                   "pf_average": 4, "freq": [-313, 0, 97, 450]},
            "input": {"tone_amplitude": [0.5, 1.0], "noise_rms": 0.1}}


def _crandn(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64)


def test_fir_taps_are_the_windowed_sinc():
    h = direct.fir_taps(100, 4)
    assert h.shape == (400,) and abs(h.sum() - 1.0) < 1e-12
    i, fc = 57, 0.75 / 200
    k = i - 399 // 2
    w = 2 * fc * np.sin(2 * np.pi * fc * k) / (2 * np.pi * fc * k) * (
        0.54 - 0.46 * np.cos(2 * np.pi * i / 399))
    unnorm = [2 * fc * np.sin(2 * np.pi * fc * (j - 199)) /
              (2 * np.pi * fc * (j - 199)) if j != 199 else 2 * fc
              for j in range(400)]
    total = sum(u * (0.54 - 0.46 * np.cos(2 * np.pi * j / 399))
                for j, u in enumerate(unnorm))
    assert h[i] == pytest.approx(w / total, rel=1e-12)


@pytest.mark.parametrize("k", [0, 1, 4, 7])
def test_direct_reference_is_the_float64_sum(k):
    cfg = _cfg_direct()
    rx = cfg["rx"]
    W, L, M, f = rx["rate"], rx["buffer_len"], rx["decim"], rx["pf_average"]
    rec = _crandn(3 * L)
    ref = direct.Reference(cfg, rec, torch.device("cpu"))
    y = ref.output(k).numpy()
    h = direct.fir_taps(M, f)
    stream = np.concatenate([rec] * (k // 3 + 2))

    def x(a):                           # the looped stream, zero before 0
        return stream[a] if a >= 0 else 0.0
    want = np.zeros((L // M, len(rx["freq"])), np.complex128)
    for n in range(L // M):
        for c, fc in enumerate(rx["freq"]):
            for i in range(f * M):
                a = k * L + n * M - (f - 1) * M + i
                want[n, c] += h[i] * x(a) * np.exp(
                    -2j * np.pi * ((fc * a) % W) / W)
    assert np.max(np.abs(y - want)) < 1e-12 * np.max(np.abs(want))


def test_direct_recording_is_the_seeded_comb():
    cfg = _cfg_direct()
    cfg["input"]["noise_rms"] = 0.0
    a = direct.make_recording(cfg, 2 ** 33 + 5, 2, "cpu").numpy()
    b = direct.make_recording(cfg, 2 ** 33 + 5, 2, "cpu").numpy()
    assert a.shape == (400,) and np.array_equal(a, b)
    # a comb of the configured tones: exactly a sum of those phasors,
    # each amplitude within the configured range
    n = np.arange(400)
    basis = np.exp(2j * np.pi * np.outer(n, cfg["rx"]["freq"]) / 1000)
    coef, *_ = np.linalg.lstsq(basis, a.astype(np.complex128), rcond=None)
    assert np.linalg.norm(basis @ coef - a) < 1e-5 * np.linalg.norm(a)
    assert np.all((np.abs(coef) > 0.5 - 1e-5) & (np.abs(coef) < 1 + 1e-5))


def _cfg_chirp():
    return {"rx": {"rate": 100_000, "buffer_len": 1000, "decim": 2,
                   "freq": [-40_000], "chirp_f": [30_000],
                   "chirp_t": [0.01], "swipe_s": [10]},
            "input": {"resonators": 2, "resonator_hz": [-20_000, 20_000],
                      "depth": [0.3, 0.9], "linewidth_hz": [1000, 3000],
                      "amplitude": [0.5, 1.0], "delay_s": [1e-6, 2e-6],
                      "noise_rms": 0.01}}


def _idx_bigint(q, pos):
    """The reference's phase accumulator in Python integers."""
    fi = pos // q["length"]
    v = (pos * (fi * q["chirpness"] + q["f0"]) -
         q["chirpness"] * q["length"] * fi * (fi + 1) // 2) % 2 ** 32
    return v - 2 ** 32 if v >= 2 ** 31 else v


def test_chirp_quantization_is_the_reference_constructor():
    q = chirp.quantize({"rate": 100_000_000, "freq": [-40_000_000],
                        "chirp_f": [40_000_000], "chirp_t": [1.0],
                        "swipe_s": [5000]})
    assert (q["steps"], q["length"], q["period"]) == (5000, 20_000,
                                                      100_000_000)
    assert q["chirpness"] == int((2 ** 32 - 1) * 80e6 / (4999 * 1e8))
    assert q["f0"] == (int((2 ** 32 - 1) * -0.4)) % 2 ** 32


def test_chirp_phase_index_is_exact():
    q = chirp.quantize({"rate": 100_000_000, "freq": [-40_000_000],
                        "chirp_f": [40_000_000], "chirp_t": [1.0],
                        "swipe_s": [5000]})
    pos = np.concatenate([[0, 1, 19_999, 20_000, 99_999_999],
                          RNG.integers(0, 100_000_000, 200)])
    got = chirp.phase_index(q, torch.from_numpy(pos))
    assert got.tolist() == [_idx_bigint(q, int(p)) for p in pos]


@pytest.mark.parametrize("k", [0, 3, 11])
def test_chirp_reference_is_the_float64_sum(k):
    cfg = _cfg_chirp()
    q = chirp.quantize(cfg["rx"])
    L, ppt = cfg["rx"]["buffer_len"], q["length"] * cfg["rx"]["decim"]
    rec = _crandn(2 * L)
    y = chirp.Reference(cfg, rec, torch.device("cpu")).output(k).numpy()
    w = np.zeros(ppt)
    w[ppt // 10:] = 1.0 / (ppt - ppt // 10)
    blk = rec[(k % 2) * L:(k % 2 + 1) * L].astype(np.complex128)
    want = []
    for s in range(L // ppt):
        acc = 0j
        for j in range(ppt):
            n = (k * L + s * ppt + j) % q["period"]
            th = np.pi * _idx_bigint(q, n) / 2147483647.5
            acc += w[j] * np.conj(np.sin(th) - 1j * np.cos(th)) * \
                blk[s * ppt + j]
        want.append(acc)
    assert np.max(np.abs(y[:, 0] - want)) < 1e-12


def test_chirp_recording_is_the_chirp_through_s21():
    cfg = _cfg_chirp()
    cfg["input"]["noise_rms"] = 0.0
    x = chirp.make_recording(cfg, 3, 2, "cpu")
    ref = chirp.Reference(cfg, x.numpy(), torch.device("cpu"))
    # the lock-in of the noiseless recording reads back |S21| <= amplitude
    pts = torch.cat([ref.output(k)[:, 0] for k in range(2)]).abs()
    assert 0 < float(pts.min()) and float(pts.max()) <= 1.0 + 1e-9


def test_rel_err_is_the_worst_channel_over_its_rms():
    ref = torch.ones((4, 2), dtype=torch.complex128)
    ref[:, 1] *= 2.0
    y = ref.numpy().astype(np.complex64).copy()
    y[2, 1] += 0.02
    assert harness.rel_err(y, ref) == pytest.approx(0.01, rel=1e-6)
