"""Parity of the table lock-in (ops/lockin_table.py: TPU kernels #16 and
#17, their plain versions on the CPU) with the JAX package's Pallas
kernels in interpret mode and with the float64 oracle.

Geometry of tests/test_pallas_lockin.py:113-148: rate 1e6, 128 steps of
1000 samples (ppt 1000, decim 1), 64,000-sample blocks of 64 segments,
two blocks per period.  Bars: 120 dB SNR against the JAX kernels (the
same float32 products, summed in another order); 90 dB against the
float64 oracle (golden.chirp_demod + GoldenVNADecimator); the self
mode's imaginary half exactly 0, as the JAX self kernel's
(tests/test_pallas_lockin.py:151-192).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden as jgolden
from gpu_sdr_tpu.ops import chirp as jchirp
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops.pallas_lockin import (pallas_chirp_lockin_table,
                                           pallas_chirp_lockin_table_self)
from gpu_sdr_tpu_torch.ops import chirp, lockin, lockin_table

torch.set_num_threads(2)

ARGS = (-300_000, 300_000, 1_000_000, 128, 0.128)
PPT, L = 1000, 64_000
NSEG = L // PPT
RNG_SEED = 17


def tables(scale=1.0):
    """The port's and the JAX package's one-period tables, (128, ppt)."""
    cfg = chirp.ChirpConfig.from_params(*ARGS)
    jcfg = jchirp.ChirpConfig.from_params(*ARGS)
    ours = chirp.chirp_period_table(cfg, L, PPT, scale=scale, device="cpu")

    def body(last, _):
        return jchirp.chirp_block(jcfg, last, L, scale=scale)
    _, cs = jax.lax.scan(body, jnp.uint32(0), None, length=cfg.period // L)
    theirs = jcplx.C(cs.re.reshape(-1, PPT), cs.im.reshape(-1, PPT))
    return ours, theirs


def signal(rows):
    rng = np.random.default_rng(RNG_SEED)
    return (rng.standard_normal((rows, PPT)) +
            1j * rng.standard_normal((rows, PPT))).astype(np.complex64)


def test_table_mode_matches_jax_kernel():
    """#17 with the signal's block index apart from the oscillator's
    (the replay case, sig_idx != blk_idx), over every pair of blocks."""
    C, jC = tables()
    x = signal(3 * NSEG)
    prof = lockin.lockin_profile(PPT)
    for o in range(2):
        for i in range(3):
            y = lockin_table.lockin_table(torch.from_numpy(prof), C,
                                          torch.from_numpy(x), o, i, NSEG)
            jy = pallas_chirp_lockin_table(
                jnp.asarray(prof), jC, jcplx.from_np(x), jnp.int32(o), NSEG,
                interpret=True, sig_idx=jnp.int32(i))
            assert y.shape == (NSEG,) and y.dtype == torch.complex64
            assert jgolden.snr_db(jcplx.to_np(jy), y.numpy()) > 120.0


def test_self_mode_matches_jax_kernel_imag_exactly_zero():
    """#16 on a scaled table with the amplitude folded into the profile,
    as the fused chain runs it: the real half against the JAX self
    kernel, the imaginary half exactly 0, every row the amplitude."""
    C, jC = tables(scale=0.7)
    prof = lockin.lockin_profile(PPT) / 0.7
    for o in range(2):
        y = lockin_table.lockin_self(torch.from_numpy(prof), C, o, NSEG)
        jy = pallas_chirp_lockin_table_self(jnp.asarray(prof), jC,
                                            jnp.int32(o), NSEG,
                                            interpret=True)
        assert jgolden.snr_db(jcplx.to_np(jy), y.numpy()) > 120.0
        assert torch.equal(y.imag, torch.zeros(NSEG))
        np.testing.assert_allclose(y.real.numpy(), 0.7, rtol=1e-5)


def test_table_mode_matches_golden_demod_and_decimator():
    """Oscillator block o against the stream's samples at o*L: the
    float64 chirp demod and the reference's lock-in decimator."""
    C, _ = tables()
    x = signal(2 * NSEG)
    cp = jgolden.ChirpParameter(*ARGS)
    prof = torch.from_numpy(lockin.lockin_profile(PPT))
    for o in range(2):
        y = lockin_table.lockin_table(prof, C, torch.from_numpy(x), o, o,
                                      NSEG)
        blk = x[o * NSEG:(o + 1) * NSEG].reshape(-1)
        ref = jgolden.GoldenVNADecimator(PPT)(
            jgolden.chirp_demod(cp, o * L, blk))
        assert jgolden.snr_db(ref, y.numpy()) > 90.0


def test_self_mode_equals_table_mode_on_the_table():
    """Self mode is table mode with the signal the table itself: the real
    halves agree to float32 rounding, and self mode's imaginary half is
    exactly the true 0 where table mode's is only close to it."""
    C, _ = tables()
    prof = torch.from_numpy(lockin.lockin_profile(PPT))
    for o in range(2):
        s = lockin_table.lockin_self(prof, C, o, NSEG)
        t = lockin_table.lockin_table(prof, C, C, o, o, NSEG)
        assert jgolden.snr_db(t.real.numpy(), s.real.numpy()) > 120.0
        assert np.abs(t.imag.numpy()).max() < 1e-6
        assert torch.equal(s.imag, torch.zeros(NSEG))


def test_wrappers_count_no_cpu_launch_and_check_operands():
    C, _ = tables()
    prof = torch.from_numpy(lockin.lockin_profile(PPT))
    before = (lockin_table.lockin_table.launches,
              lockin_table.lockin_self.launches)
    lockin_table.lockin_self(prof, C, 1, NSEG)
    lockin_table.lockin_table(prof, C, C, 0, 1, NSEG)
    assert (lockin_table.lockin_table.launches,
            lockin_table.lockin_self.launches) == before
    with pytest.raises(ValueError, match="outside the table"):
        lockin_table.lockin_self(prof, C, 2, NSEG)
    with pytest.raises(ValueError, match="outside the table"):
        lockin_table.lockin_table(prof, C, C[:NSEG], 0, 1, NSEG)
    with pytest.raises(ValueError, match="rows must be"):
        lockin_table.lockin_self(prof[:-1], C, 0, NSEG)
    with pytest.raises(TypeError, match="float32 profile"):
        lockin_table.lockin_self(prof.double(), C, 0, NSEG)
    with pytest.raises(ValueError, match="unsupported device"):
        lockin_table._launch(prof, C, None, 0, 0, NSEG)
