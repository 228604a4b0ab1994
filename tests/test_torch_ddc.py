"""Parity of the port's DIRECT DDC+FIR (ops/ddc.py, kernel #7's plain
version on the CPU) with the JAX package and the float64 oracle.

Inputs come from numpy with a fixed seed and go through both packages.
Bars: 85 dB SNR against the JAX Pallas kernel in interpret mode, which
runs its 3-pass bf16 hi/lo split (its own bar against float32,
tests/test_pallas_ddc.py:93); 90 dB against the JAX XLA path and the
float64 oracle (gpu_sdr_tpu.golden); exact equality for carried integer
phases and for the carried history samples, which are copies.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import ddc as jddc
from gpu_sdr_tpu.ops.pallas_ddc import ddc_fused as jddc_fused
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch.ops import ddc

torch.set_num_threads(2)

RATE = 10_000


def crandn(rng, n):
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


def configs(freqs, M, f):
    kw = dict(rate=RATE, decim=M, pf_average=f, freqs=tuple(freqs),
              phases=(0,) * len(freqs))
    return ddc.DirectDDCConfig(**kw), jddc.DirectDDCConfig(**kw)


class Stream:
    """One DIRECT stream through the port's ddc_fused (plain on CPU)."""

    def __init__(self, cfg, L, state=None):
        self.cfg, self.L = cfg, L
        self.hmod = cfg.modulated_taps("cpu")
        self.ramp = cfg.carrier_ramp(L // cfg.M, "cpu")
        self.step_v = ddc.ddc_carrier_step(cfg, L, "cpu")
        self.phase, self.hist = state or (
            ddc.ddc_carrier_init(cfg, "cpu"),
            torch.zeros((cfg.f - 1) * cfg.M, dtype=torch.complex64))

    def __call__(self, x):
        c = self.cfg
        self.phase, self.hist, y = ddc.ddc_fused(
            self.hmod, self.ramp, self.step_v, c.rate, c.M, c.f, self.phase,
            self.hist, torch.from_numpy(x))
        return y.numpy()


class JaxStream:
    """The same stream through the JAX package's ddc_fused: the Pallas
    kernel in interpret mode, or its XLA path where it falls back."""

    def __init__(self, jcfg, L):
        self.hmod = jcfg.modulated_taps()
        self.ramp = jcfg.carrier_ramp(L // jcfg.M)
        step_v = jddc.ddc_carrier_step(jcfg, L)
        self.phase = jddc.ddc_carrier_init(jcfg, L)
        self.hist = jcplx.zeros((jcfg.f - 1) * jcfg.M)
        self.fn = jax.jit(lambda p, h, x: jddc_fused(
            self.hmod, self.ramp, step_v, jcfg.rate, jcfg.M, jcfg.f, p, h,
            x, interpret=True))

    def __call__(self, x):
        self.phase, self.hist, y = self.fn(self.phase, self.hist,
                                           jcplx.from_np(x))
        return jcplx.to_np(y)


def golden_stream(freqs, M, f, blocks):
    g = golden.GoldenDirectDemodulator(freqs, RATE, M, f)
    return np.concatenate([g(b) for b in blocks], axis=1).T


def test_config_constants_match_jax():
    """Taps, carrier ramp, initial phase and step: the same numbers."""
    cfg, jcfg = configs((1000, -2500, 333, 4999), 10, 4)
    np.testing.assert_array_equal(cfg.modulated_taps_np(),
                                  jcfg.modulated_taps_np())
    np.testing.assert_array_equal(cfg.modulated_taps("cpu").numpy(),
                                  jcplx.to_np(jcfg.modulated_taps()))
    np.testing.assert_array_equal(cfg.carrier_ramp(48, "cpu").numpy(),
                                  jcplx.to_np(jcfg.carrier_ramp(48)))
    assert np.array_equal(ddc.ddc_carrier_init(cfg, "cpu").numpy(),
                          np.asarray(jddc.ddc_carrier_init(jcfg, 480)))
    assert np.array_equal(ddc.ddc_carrier_step(cfg, 480, "cpu").numpy(),
                          np.asarray(jddc.ddc_carrier_step(jcfg, 480)))


@pytest.mark.parametrize("n_tones,M,f,L", [
    (7, 10, 4, 480),      # config-3-like shape, small
    (1, 10, 4, 480),      # single channel (config 1)
    (5, 16, 2, 512),      # short FIR
    (3, 8, 8, 1024),      # long overlap (f-1 = 7 history rows)
])
def test_ddc_fused_matches_jax_and_golden(n_tones, M, f, L):
    """Three blocks through both packages' ddc_fused: the same outputs,
    phases and histories after every block, and the float64 oracle on
    every row, startup rows included."""
    rng = np.random.default_rng(11)
    freqs = tuple(int(x) for x in np.linspace(-RATE // 3, RATE // 3,
                                              n_tones))
    cfg, jcfg = configs(freqs, M, f)
    port, jax_ = Stream(cfg, L), JaxStream(jcfg, L)
    blocks = [crandn(rng, L) for _ in range(3)]
    outs = []
    for b in blocks:
        y, jy = port(b), jax_(b)
        assert y.dtype == np.complex64 and y.shape == (L // M, n_tones)
        assert golden.snr_db(jy, y) > 85.0
        assert np.array_equal(port.phase.numpy(), np.asarray(jax_.phase))
        assert np.array_equal(port.hist.numpy(), jcplx.to_np(jax_.hist))
        outs.append(y)
    assert golden.snr_db(golden_stream(freqs, M, f, blocks),
                         np.concatenate(outs)) > 90.0


def test_pure_mixdown_matches_jax_and_golden():
    """decim = 0: no FIR (M = f = 1, unit tap), the undecimated branch."""
    rng = np.random.default_rng(5)
    freqs, L = (1000, -2500, 3333), 400
    cfg, jcfg = configs(freqs, 0, 4)
    assert (cfg.M, cfg.f) == (1, 1)
    port, jax_ = Stream(cfg, L), JaxStream(jcfg, L)   # XLA path: f < 2
    blocks = [crandn(rng, L) for _ in range(3)]
    ys = [port(b) for b in blocks]
    jys = [jax_(b) for b in blocks]
    assert port.hist.shape == (0,)
    assert np.array_equal(port.phase.numpy(), np.asarray(jax_.phase))
    y = np.concatenate(ys)
    assert golden.snr_db(np.concatenate(jys), y) > 90.0
    g = golden.GoldenDirectDemodulator(freqs, RATE, 0, 4)
    ref = np.concatenate([g(b) for b in blocks], axis=1).T
    assert golden.snr_db(ref, y) > 90.0


def test_stream_continues_from_jax_state():
    """A stream started in the JAX package and stopped after two blocks
    continues in the port through convert.ddc_state."""
    rng = np.random.default_rng(17)
    freqs, M, f, L = (1000, -2500, 333), 10, 4, 800
    cfg, jcfg = configs(freqs, M, f)
    blocks = [crandn(rng, L) for _ in range(4)]
    jax_ = JaxStream(jcfg, L)
    jys = [jax_(b) for b in blocks[:2]]
    port = Stream(cfg, L, convert.ddc_state((jax_.phase, jax_.hist), "cpu"))
    assert port.phase.dtype == torch.int64
    ys = [port(b) for b in blocks[2:]]
    jys += [jax_(b) for b in blocks[2:]]
    assert np.array_equal(port.phase.numpy(), np.asarray(jax_.phase))
    assert golden.snr_db(np.concatenate(jys[2:]), np.concatenate(ys)) > 85.0
    ref = golden_stream(freqs, M, f, blocks)
    assert golden.snr_db(ref[2 * (L // M):], np.concatenate(ys)) > 90.0


def test_kernel_geometry():
    """The kernel's thread mappings: one thread per output row up to 8
    channels, lanes over channels beyond."""
    assert ddc.few_channels(1) and ddc.few_channels(8)
    assert not ddc.few_channels(9)


def test_wrappers_take_the_kernel_only_on_cuda():
    """On the CPU ddc_fused runs the plain version and counts nothing;
    the kernel launcher itself refuses CPU tensors."""
    cfg, _ = configs((1000,), 10, 4)
    s = Stream(cfg, 480)
    before = ddc.ddc_fused.launches
    s(np.ones(480, np.complex64))
    assert ddc.ddc_fused.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        ddc.launch_ddc(torch.ones(480, dtype=torch.complex64), s.hist,
                       s.hmod, s.ramp, s.phase, RATE, 10, 4, 48, True)
