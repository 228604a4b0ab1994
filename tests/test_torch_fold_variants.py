"""Parity of the port's fold variants (ops/fold.py: kernels #12, #13 and
#14's plain versions on the CPU) with the JAX package's Pallas kernels in
interpret mode, on inputs made from the configuration alone (the fold
has no input), and with the float64 oracle (tone_gen +
direct_demodulator_integer + FIR of the reference):

* #12, TonesDirectFoldKernel.invoke: multi_step with time_shards = 2;
* #13, invoke_factored_rotg: multi_step with rotg = True;
* #14, TonesDirectFoldT.invoke_t, channel-major, at the JAX test's shape
  (tests/test_pallas_chain.py:278-283).

Each runs two multi_step calls of several blocks (the state carries),
for a receiver at the TX tones (JAX's self-ramp case) and one off them.
Bars: 90 dB SNR against the JAX kernel and against the oracle on every
row; 80 dB on the stream's startup rows, the partial-fold correction
(tests/test_fold_chain.py:57), transposed for #14; exact equality for
the carried phases.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import ddc as jddc
from gpu_sdr_tpu.ops.pallas_chain import TonesDirectFoldKernel, \
    TonesDirectFoldT as JTonesDirectFoldT
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch.ops import ddc, fold

torch.set_num_threads(2)

RATE = 1_000_000
SNR_JAX, SNR_GOLD, SNR_START = 90.0, 90.0, 80.0
TX3 = (12_345, -67_891, 300_001)
AMPL3 = (0.3, 0.3, 0.4)
RX3 = {"self_ramp": TX3, "streamed_ramp": (12_345, -67_891, 299_999)}
TX10 = tuple(int(x) for x in np.linspace(-400_000, 400_000, 10))
RX10 = {"self_ramp": TX10, "streamed_ramp": tuple(f + 1000 for f in TX10)}


def configs(rx, M, f):
    kw = dict(rate=RATE, decim=M, pf_average=f, freqs=tuple(rx),
              phases=(0,) * len(rx))
    return ddc.DirectDDCConfig(**kw), jddc.DirectDDCConfig(**kw)


def golden_loopback(tx, ampls, rx, M, f, L, n_blocks):
    """(n_blocks * L // M, C) float64 readout of the looped-back comb."""
    x = golden.tone_block(tx, ampls, RATE, 0, n_blocks * L)
    g = golden.GoldenDirectDemodulator(rx, RATE, M, f)
    return np.concatenate([g(x[k * L:(k + 1) * L]) for k in range(n_blocks)],
                          axis=1).T


def run(chain, calls, K):
    st = chain.init_state()
    outs, states = [], []
    for _ in range(calls):
        st, y = chain.multi_step(st, K)
        outs.append(y.numpy() if isinstance(y, torch.Tensor)
                    else jcplx.to_np(y))
        states.append(st)
    return outs, states


def held(out, jout, ref, f, axis=0):
    """Each call's output against JAX's; the stream against the oracle,
    its startup rows on their own."""
    for a, b in zip(out, jout):
        assert a.shape == b.shape
        assert golden.snr_db(b, a) > SNR_JAX
    y = np.concatenate(out, axis=axis)
    if axis:
        y = y.T
    assert y.shape == ref.shape
    assert golden.snr_db(ref, y) > SNR_GOLD
    assert golden.snr_db(ref[:f - 1], y[:f - 1]) > SNR_START


def same_states(states, jstates):
    for (sph, dph, pv), (jsph, jdph, jpv) in zip(states, jstates):
        assert np.array_equal(sph.numpy(), np.asarray(jsph))
        assert np.array_equal(dph.numpy(), np.asarray(jdph))
        assert pv == float(jpv) == 1.0


# (option, block length, decimation): the time-sharded geometry needs a
# row tile dividing nb / 2 in JAX (nb 800, 400 a shard)
VARIANTS = {"time_shards": (dict(time_shards=2), 80_000, 100),
            "rotg": (dict(rotg=True), 100_000, 100)}


@pytest.mark.parametrize("rx", list(RX3), ids=list(RX3))
@pytest.mark.parametrize("variant", list(VARIANTS), ids=list(VARIANTS))
def test_variant_matches_jax_and_golden(variant, rx):
    """#12 (time_shards = 2) and #13 (rotg): two calls of K = 2 blocks."""
    opt, L, M = VARIANTS[variant]
    cfg, jcfg = configs(RX3[rx], M, 4)
    chain = fold.TonesDirectFold(RATE, TX3, AMPL3, cfg, L, "cpu", **opt)
    jchain = TonesDirectFoldKernel(rate=RATE, tx_freqs=TX3, tx_ampls=AMPL3,
                                   cfg=jcfg, block_len=L, interpret=True,
                                   **opt)
    assert jchain.ok and jchain.self_ramp == (rx == "self_ramp")
    before = (fold.fold.launches, fold.fold_streamed.launches,
              fold.fold_rotg.launches)
    out, states = run(chain, 2, 2)
    assert (fold.fold.launches, fold.fold_streamed.launches,
            fold.fold_rotg.launches) == before
    jout, jstates = run(jchain, 2, 2)
    held(out, jout, golden_loopback(TX3, AMPL3, RX3[rx], M, 4, L, 4), 4)
    same_states(states, jstates)


@pytest.mark.parametrize("variant", list(VARIANTS), ids=list(VARIANTS))
def test_variant_is_the_factored_fold(variant):
    """Each variant computes #11's function: against the default fold's
    multi_step, K blocks at once and block by block."""
    opt, L, M = VARIANTS[variant]
    cfg, _ = configs(RX3["streamed_ramp"], M, 4)
    a = fold.TonesDirectFold(RATE, TX3, AMPL3, cfg, L, "cpu")
    b = fold.TonesDirectFold(RATE, TX3, AMPL3, cfg, L, "cpu", **opt)
    ya = np.concatenate(run(a, 3, 1)[0])
    yb = run(b, 1, 3)[0][0]
    assert golden.snr_db(ya, yb) > 120.0


@pytest.mark.parametrize("rx", list(RX10), ids=list(RX10))
def test_fold_t_matches_jax_and_golden(rx):
    """#14 at the JAX test's shape (nb 2560, tiles of 128 multiples in
    JAX, 40 masked-free tiles of 64 here): two calls of K = 3 blocks,
    the first with the transposed startup correction; against JAX's
    channel-major kernel, the oracle and the port's row-major fold
    transposed."""
    L, M = 25_600, 10
    ampls = (0.1,) * 10
    cfg, jcfg = configs(RX10[rx], M, 4)
    chain = fold.TonesDirectFoldT(RATE, TX10, ampls, cfg, L, "cpu")
    jchain = JTonesDirectFoldT(rate=RATE, tx_freqs=TX10, tx_ampls=ampls,
                               cfg=jcfg, block_len=L, interpret=True)
    assert jchain.ok and jchain.R % 128 == 0
    before = fold.fold_t.launches
    out, states = run(chain, 2, 3)
    assert fold.fold_t.launches == before
    assert out[0].shape == (10, 3 * L // M)
    jout, jstates = run(jchain, 2, 3)
    held(out, jout, golden_loopback(TX10, ampls, RX10[rx], M, 4, L, 6), 4,
         axis=1)
    same_states(states, jstates)
    rows = np.concatenate(run(chain.base, 2, 3)[0])
    assert golden.snr_db(rows, np.concatenate(out, axis=1).T) > 120.0


def test_fold_t_continues_from_jax_state():
    """A channel-major stream started in the JAX package continues in the
    port through convert.fold_state."""
    L, M = 25_600, 10
    ampls = (0.1,) * 10
    cfg, jcfg = configs(TX10, M, 4)
    chain = fold.TonesDirectFoldT(RATE, TX10, ampls, cfg, L, "cpu")
    jchain = JTonesDirectFoldT(rate=RATE, tx_freqs=TX10, tx_ampls=ampls,
                               cfg=jcfg, block_len=L, interpret=True)
    jst, _ = jchain.multi_step(jchain.init_state(), 2)
    st, y = chain.multi_step(convert.fold_state(jst, "cpu"), 2)
    jst, jy = jchain.multi_step(jst, 2)
    assert golden.snr_db(jcplx.to_np(jy), y.numpy()) > SNR_JAX
    assert np.array_equal(st[1].numpy(), np.asarray(jst[1]))
    ref = golden_loopback(TX10, ampls, TX10, M, 4, L, 4)[2 * (L // M):]
    assert golden.snr_db(ref, y.numpy().T) > SNR_GOLD


@pytest.mark.parametrize("variant", ["time_shards", "fold_t"])
def test_geometry_is_wider_than_jax(variant):
    """Where JAX refuses the block, the port's masked tiles take it
    (ROADMAP Queue 3, divergence 20): nb = 2500 rows a block has no
    8-aligned divisor of its 1250-row shard (#12) and no 128-multiple
    divisor (#14).  The port still matches the oracle."""
    L, M = 50_000, 20
    tx = TX10[:6]
    ampls = (0.1,) * 6
    cfg, jcfg = configs(tx, M, 4)
    kw = dict(rate=RATE, tx_freqs=tx, tx_ampls=ampls, cfg=jcfg, block_len=L)
    if variant == "time_shards":
        assert not TonesDirectFoldKernel(time_shards=2, **kw).ok
        chain = fold.TonesDirectFold(RATE, tx, ampls, cfg, L, "cpu",
                                     time_shards=2)
        y = chain.multi_step(chain.init_state(), 2)[1].numpy()
    else:
        assert not JTonesDirectFoldT(**kw).ok
        chain = fold.TonesDirectFoldT(RATE, tx, ampls, cfg, L, "cpu")
        y = chain.multi_step(chain.init_state(), 2)[1].numpy().T
    assert (L // M) % fold.FOLD_TILE
    assert golden.snr_db(golden_loopback(tx, ampls, tx, M, 4, L, 2),
                         y) > SNR_GOLD


def test_wrappers_check_operands():
    """Each wrapper refuses operands of the wrong shape, on the CPU too."""
    cfg, _ = configs(TX3, 100, 4)
    chain = fold.TonesDirectFold(RATE, TX3, AMPL3, cfg, 80_000, "cpu",
                                 time_shards=2)
    _, srots, drots = chain.rotations(chain.init_state(), 2)
    crot, qrot = chain.tile_rotations(srots, drots)
    args = (chain.P1, chain.G2, crot, qrot, chain.ramp1, chain.nb)
    assert fold.fold_rotg(*args, 2).shape == (2 * chain.nb, 3)
    with pytest.raises(ValueError, match="fold_rotg shapes"):
        fold.fold_rotg(*args, 1)
    with pytest.raises(ValueError, match="fold_t shapes"):
        fold.fold_t(*args, 2)                       # ramp1 not transposed
    with pytest.raises(ValueError, match="fold_streamed shapes"):
        fold.fold_streamed(chain.P, chain.G2, srots[:1], drots, chain.ramp,
                           chain.nb, 2)
    with pytest.raises(ValueError, match="time_shards"):
        fold.TonesDirectFold(RATE, TX3, AMPL3, cfg, 80_000, "cpu",
                             time_shards=0)
