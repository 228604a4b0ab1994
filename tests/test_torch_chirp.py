"""Parity of the port's chirp ops (ops/chirp.py, ops/lockin.py) and of
its own copies of the parameter structs and float64 helpers (params.py,
golden.py) with the JAX package and its float64 oracle.

Bars: exact equality for the integer phase index (the reference's
uint32 arithmetic, ROADMAP Queue 3 watch item 2), for the quantized
chirp descriptor and for every copied helper; 120 dB SNR against the
JAX package's float32 chirp (the two differ only in float32 sin/cos
rounding, a few ulp); 90 dB against the float64 oracle
(tests/test_ops_pfb_chirp.py:50-51).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden as jgolden
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu.ops import chirp as jchirp
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import lockin as jlockin
from gpu_sdr_tpu_torch import golden, params
from gpu_sdr_tpu_torch.ops import chirp, lockin

torch.set_num_threads(2)

# (f_start, f_end, rate, swipe_s, chirp_t)
CHIRPS = {
    "config2": (-40_000_000, 40_000_000, 100_000_000, 5000, 1.0),
    "down": (40_000_000, -40_000_000, 100_000_000, 5000, 1.0),
    "small": (-300_000, 300_000, 1_000_000, 128, 0.128),
    "small_down": (250_000, -100_000, 1_000_000, 50, 0.01),
    "no_steps": (0, 200_000, 1_000_000, 0, 0.0005),
}


def configs(name):
    args = CHIRPS[name]
    return (chirp.ChirpConfig.from_params(*args),
            jchirp.ChirpConfig.from_params(*args),
            jgolden.ChirpParameter(*args))


def offsets(period):
    """Sample offsets at both ends of the period and across its seam."""
    rng = np.random.default_rng(7)
    n = np.unique(np.concatenate([
        np.arange(512), period - 1 - np.arange(512),
        period + np.arange(-8, 8), rng.integers(0, 2 ** 31 - 1, 2048)]))
    return n[n >= 0]


@pytest.mark.parametrize("name", sorted(CHIRPS))
def test_chirp_config_matches_jax(name):
    t, j, g = configs(name)
    assert (t.num_steps, t.length, t.chirpness, t.f0) == \
        (j.num_steps, j.length, j.chirpness, j.f0)
    assert t.period == j.period == g.period()


@pytest.mark.parametrize("name", sorted(CHIRPS))
def test_chirp_phase_index_exact(name):
    """Exactly the JAX package's uint32 result and the float64 oracle's
    uint64 one, with the stream position at 0, mid-period and just
    before the seam, and offsets near period - 1 and past it."""
    t, j, g = configs(name)
    P = t.period
    n = offsets(P)
    for last in (0, 12_345 % P, P - 1, P - 3):
        ours = chirp.chirp_phase_index(t, last, torch.from_numpy(n)).numpy()
        theirs = np.asarray(jchirp.chirp_phase_index(
            j, jnp.uint32(last), jnp.asarray(n.astype(np.uint32))))
        gold = jgolden.chirp_phase_index(g, last, n.astype(np.uint64))
        np.testing.assert_array_equal(ours, theirs.astype(np.int64))
        np.testing.assert_array_equal(ours, gold.astype(np.int64))
        assert ours.min() >= -2 ** 31 and ours.max() < 2 ** 31


@pytest.mark.parametrize("name", sorted(CHIRPS))
def test_chirp_wave_uses_the_exact_phase_index(name):
    """The blocks the runtime makes (chirp_block, chirp_demod_block, the
    table) are, bit for bit, the wave of chirp_phase_index's exact
    indices: at the seam, just before it, and over blocks longer than
    the period."""
    t, _, _ = configs(name)
    P = t.period
    for last, L in ((P - 1, 300), (P - 3, 7), (0, 2 * P + 5),
                    (P // 2, min(P, 5000))):
        idx = chirp.chirp_phase_index(t, last, torch.arange(L))
        th = (idx.to(torch.float32) * chirp.INV_2_31_5) * chirp.PI_F32
        want = torch.complex(torch.sin(th), -torch.cos(th))
        assert torch.equal(chirp._chirp_wave(t, last, L, "cpu"), want)


def test_down_chirp_products_pass_int63():
    """A down-chirp's chirpness wraps to >= 2^31 (golden.py:258-259), so
    chirpness * (length * q_phase) multiplies two 32-bit values whose
    plain int64 product passes 2^63.  The split product keeps every
    partial product in range and gives exactly the low 32 bits, as
    uint32 arithmetic does."""
    t, _, _ = configs("down")
    assert t.chirpness >= 2 ** 31
    k = (t.length * t.chirpness) % 2 ** 32
    rng = np.random.default_rng(3)
    a = np.concatenate([[2 ** 32 - 1, 2 ** 31, 0, 1],
                        rng.integers(0, 2 ** 32, 2000)])
    for kk in (k, t.chirpness, 2 ** 32 - 1, 0xFFFF, 0x10000):
        assert any(int(x) * kk >= 2 ** 63 for x in a) or kk < 2 ** 31
        got = chirp._mul32_by(torch.from_numpy(a), kk).numpy()
        np.testing.assert_array_equal(got, [(int(x) * kk) % 2 ** 32
                                            for x in a])


@pytest.mark.parametrize("name", ["small", "small_down", "config2"])
def test_chirp_block_matches_jax_and_golden(name):
    """A block that crosses the period seam, scaled, and the carried
    stream position."""
    t, j, g = configs(name)
    L = min(4000, t.period)
    last = t.period - L // 3
    new, x = chirp.chirp_block(t, last, L, scale=0.7, device="cpu")
    jnew, jx = jchirp.chirp_block(j, jnp.uint32(last), L, scale=0.7)
    assert new == int(jnew)
    assert x.dtype == torch.complex64 and x.shape == (L,)
    assert jgolden.snr_db(jcplx.to_np(jx), x.numpy()) > 120.0
    assert jgolden.snr_db(jgolden.chirp_signal(g, last, L, scale=0.7),
                          x.numpy()) > 90.0


def test_chirp_block_longer_than_the_period():
    """A block of 8.6 periods (a 500-sample chirp): positions wrap
    through a division rather than one subtraction."""
    t, j, g = configs("no_steps")
    assert t.period == 500
    new, x = chirp.chirp_block(t, 123, 4300, device="cpu")
    jnew, jx = jchirp.chirp_block(j, jnp.uint32(123), 4300)
    assert new == int(jnew) == (123 + 4300) % 500
    assert jgolden.snr_db(jcplx.to_np(jx), x.numpy()) > 120.0
    assert jgolden.snr_db(jgolden.chirp_signal(g, 123, 4300), x.numpy()) > 90


@pytest.mark.parametrize("name", ["small", "small_down"])
def test_chirp_demod_block_matches_jax_and_golden(name):
    t, j, g = configs(name)
    rng = np.random.default_rng(11)
    L = 3000
    x = (rng.standard_normal(L) + 1j * rng.standard_normal(L)
         ).astype(np.complex64)
    last = t.period - 1000
    new, z = chirp.chirp_demod_block(t, last, torch.from_numpy(x))
    jnew, jz = jchirp.chirp_demod_block(j, jnp.uint32(last),
                                        jcplx.from_np(x))
    assert new == int(jnew) == (last + L) % t.period
    assert jgolden.snr_db(jcplx.to_np(jz), z.numpy()) > 120.0
    assert jgolden.snr_db(jgolden.chirp_demod(g, last, x), z.numpy()) > 90.0


def test_chirp_period_table_is_the_stream():
    """The one-period table, built block by block, is the chirp stream
    from position 0, as segment rows."""
    t, j, _ = configs("small")
    table = chirp.chirp_period_table(t, 64_000, 1000, scale=0.5,
                                     device="cpu")
    assert table.shape == (128, 1000)
    _, whole = chirp.chirp_block(t, 0, t.period, scale=0.5, device="cpu")
    assert torch.equal(table.reshape(-1), whole)
    with pytest.raises(ValueError, match="must divide the period"):
        chirp.chirp_period_table(t, 96_000, 1000, device="cpu")


@pytest.mark.parametrize("ppt", [1, 9, 10, 1000, 20_000])
def test_lockin_profile_equal_to_jax(ppt):
    ours = lockin.lockin_profile(ppt)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jlockin.lockin_profile(ppt))


def test_lockin_decimate_matches_jax_and_golden():
    rng = np.random.default_rng(5)
    ppt, nseg = 1000, 12
    z = (rng.standard_normal(ppt * nseg) +
         1j * rng.standard_normal(ppt * nseg)).astype(np.complex64)
    prof = lockin.lockin_profile(ppt)
    y = lockin.lockin_decimate(torch.from_numpy(prof), torch.from_numpy(z))
    jy = jlockin.lockin_decimate(jnp.asarray(prof), jcplx.from_np(z))
    assert y.shape == (nseg,) and y.dtype == torch.complex64
    assert jgolden.snr_db(jcplx.to_np(jy), y.numpy()) > 120.0
    assert jgolden.snr_db(jgolden.GoldenVNADecimator(ppt)(z),
                          y.numpy()) > 90.0


def test_golden_copies_equal_the_jax_package():
    np.testing.assert_array_equal(golden.make_flat_window(2000, 200),
                                  jgolden.make_flat_window(2000, 200))
    for n, fc in ((400, 0.75 / 200), (4000, 1 / 2000), (1, 0.3)):
        np.testing.assert_array_equal(golden.make_sinc_window(n, fc),
                                      jgolden.make_sinc_window(n, fc))
    freqs = [-499_000, -1234, 0, 77_777, 499_999]
    np.testing.assert_array_equal(golden.tone_bins(freqs, 1_000_000, 1000),
                                  jgolden.tone_bins(freqs, 1_000_000, 1000))
    assert golden.TWO_31_5 == jgolden.TWO_31_5
    for args in CHIRPS.values():
        a, b = golden.ChirpParameter(*args), jgolden.ChirpParameter(*args)
        assert vars(a) == vars(b)
        assert type(a.chirpness) is type(b.chirpness) is np.uint32
        assert type(a.f0) is type(b.f0) is np.int32


def _antenna(mod, **kw):
    base = dict(mode=mod.AntMode.RX, rate=1_000_000, buffer_len=64_000,
                samples=640_000, freq=[-300_000], chirp_f=[300_000],
                chirp_t=[0.128], swipe_s=[128], decim=1,
                wave_type=[mod.WaveType.CHIRP])
    base.update(kw)
    return mod.AntennaParams(**base)


@pytest.mark.parametrize("kw", [
    {}, dict(decim=0), dict(decim=3), dict(swipe_s=[]), dict(swipe_s=[0]),
    dict(chirp_t=[1e-4], swipe_s=[1000]),
    dict(wave_type=["DIRECT"], decim=20, freq=[1000]),
    dict(wave_type=["TONES"], fft_tones=1000, decim=4, freq=[1000]),
    dict(wave_type=["NODSP"], freq=[]),
], ids=lambda kw: ",".join(kw) or "chirp")
def test_params_copy_matches_jax(kw):
    """The port's parameter structs resolve, validate and size a
    measurement exactly as the JAX package's; their enums compare equal
    across the packages."""
    def mk(mod):
        k = dict(kw)
        if "wave_type" in k:
            k["wave_type"] = [mod.WaveType(w) for w in k["wave_type"]]
        return _antenna(mod, **k)
    a, b = mk(params), mk(jparams)
    assert a.validate("A_RX2") == b.validate("A_RX2")
    assert vars(a) == vars(b)
    assert params.expected_samples_per_channel(a) == \
        jparams.expected_samples_per_channel(b)
    if a.wave_type[0] == params.WaveType.CHIRP:
        assert params.chirp_steps_and_length(a) == \
            jparams.chirp_steps_and_length(b)


def test_params_validation_errors_match_jax():
    for mod in (params, jparams):
        p = mod.UsrpParams()
        p.A_RX2 = _antenna(mod, chirp_f=[])
        with pytest.raises(mod.ParamError, match="Missing chirp_f"):
            p.validate()
        p.A_RX2 = _antenna(mod, freq=[2_000_000])
        with pytest.raises(ValueError, match="Nyquist"):
            p.validate()
    p = params.UsrpParams(A_RX2=_antenna(params), A_TXRX=_antenna(
        params, mode=params.AntMode.TX))
    assert [n for n, _ in p.active_antennas(params.AntMode.RX)] == ["A_RX2"]
    assert [n for n, _ in p.active_antennas(jparams.AntMode.TX)] == \
        ["A_TXRX"]
    assert p.antenna("A_RX2") is p.A_RX2
    with pytest.raises(KeyError):
        p.antenna("C_RX2")
    assert params.WaveType.CHIRP == jparams.WaveType.CHIRP
    assert {(jparams.WaveType.CHIRP, jparams.WaveType.CHIRP)} == \
        {(params.WaveType.CHIRP, params.WaveType.CHIRP)}
