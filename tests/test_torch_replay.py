"""Parity of the port's replay DDC (ops/replay_ddc.py, kernels #8 and
#9's plain version on the CPU) with the JAX package and the float64
oracle, on a looped multi-block recording run past its seam.

Bars: 85 dB SNR against the JAX Pallas kernels in interpret mode (their
3-pass bf16 split, tests/test_pallas_ddc.py:93); 90 dB against the
float64 oracle; exact equality for the carried block index, phase and
started flag.  The first block of the stream sees zero history, every
later block (the loop seam included) the recording rows before it:
ROADMAP Queue 3, watch list item 3.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu.ops import ddc as jddc
from gpu_sdr_tpu.ops import pallas_replay as jreplay
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch.ops import ddc, replay_ddc

torch.set_num_threads(2)

RATE, M, F, L = 1_000_000, 20, 4, 8_000
NBLK, K = 3, 2                    # recording blocks, JAX blocks per exec


def configs(freqs, f=F, m=M):
    kw = dict(rate=RATE, decim=m, pf_average=f, freqs=tuple(freqs),
              phases=(0,) * len(freqs))
    return ddc.DirectDDCConfig(**kw), jddc.DirectDDCConfig(**kw)


def recording(seed):
    rng = np.random.default_rng(seed)
    n = NBLK * L
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


def golden_replay(freqs, rec, n_blocks):
    """The looped recording as one continuous stream."""
    g = golden.GoldenDirectDemodulator(freqs, RATE, M, F)
    return np.concatenate([g(rec[(k % NBLK) * L:(k % NBLK + 1) * L])
                           for k in range(n_blocks)], axis=1).T


def jax_state(st):
    idx, phase, started = st
    return int(idx), np.asarray(phase), int(started)


@pytest.mark.parametrize("n_tones,kind", [(3, "replay_kernel_t"),
                                          (12, "replay_kernel")])
def test_replay_matches_jax_past_the_seam(n_tones, kind):
    freqs = [int(x) for x in np.linspace(-0.4 * RATE, 0.4 * RATE, n_tones)]
    cfg, jcfg = configs(freqs)
    rec = recording(n_tones)
    rk = replay_ddc.make_replay_ddc(cfg, rec, L, "cpu")
    jrk = jreplay.make_replay_ddc(jcfg, rec, L, blocks_per_exec=K,
                                  interpret=True)
    assert jrk.ok and rk.path_name == kind
    assert type(jrk).__name__ == type(rk).__name__
    assert replay_ddc.replay_ddc_kind(cfg, len(rec), L) == \
        jreplay.replay_ddc_kind(jcfg, len(rec), L) == kind
    st, jst = rk.init_state(), jrk.init_state()
    assert (st[0], st[2]) == (0, 0)
    outs, jouts = [], []
    for _ in range(3):                         # 6 blocks: past the seam
        jst, jy = jrk.multi_step(jst)
        jouts.append(jcplx.to_np(jy))
        for _ in range(K):
            st, y = rk.step(st)
            assert y.dtype == torch.complex64 and y.shape == (L // M,
                                                             n_tones)
            outs.append(y.numpy())
        idx, phase, started = jax_state(jst)
        assert (st[0], st[2]) == (idx, started)
        assert np.array_equal(st[1].numpy(), phase)
    out, jout = np.concatenate(outs), np.concatenate(jouts)
    assert golden.snr_db(jout, out) > 85.0
    assert golden.snr_db(golden_replay(freqs, rec, 3 * K), out) > 90.0
    # the stream's first block saw zero history: its first f-1 rows
    # differ from a block that wrapped in the recording's tail
    wrapped = rk.block_plain((0, ddc.ddc_carrier_init(cfg, "cpu"), 1))
    assert not np.allclose(wrapped.numpy()[:F - 1], out[:F - 1])
    np.testing.assert_array_equal(wrapped.numpy()[F - 1:], out[F - 1:L // M])


def test_replay_continues_from_jax_state():
    """A replay started in the JAX package continues in the port through
    convert.replay_state, seam included."""
    freqs = (100_000, -250_000)
    cfg, jcfg = configs(freqs)
    rec = recording(3)
    jrk = jreplay.make_replay_ddc(jcfg, rec, L, blocks_per_exec=K,
                                  interpret=True)
    jst, _ = jrk.multi_step(jrk.init_state())
    rk = replay_ddc.make_replay_ddc(cfg, rec, L, "cpu")
    st = convert.replay_state(jst, "cpu")
    assert st[1].dtype == torch.int64 and (st[0], st[2]) == (K, 1)
    outs = []
    for _ in range(2):
        st, y = rk.step(st)
        outs.append(y.numpy())
    jst, jy = jrk.multi_step(jst)
    assert golden.snr_db(jcplx.to_np(jy), np.concatenate(outs)) > 85.0
    assert (st[0], st[2]) == (int(jst[0]), int(jst[2]))
    assert np.array_equal(st[1].numpy(), np.asarray(jst[1]))
    ref = golden_replay(freqs, rec, 2 * K)[K * (L // M):]
    assert golden.snr_db(ref, np.concatenate(outs)) > 90.0


@pytest.mark.parametrize("n_tones,f,m,n,block,port,jax_kind", [
    (1, 4, 20, 3 * L, L, "replay_kernel_t", "replay_kernel_t"),
    (8, 4, 20, 3 * L, L, "replay_kernel_t", "replay_kernel_t"),
    (9, 4, 20, 3 * L, L, "replay_kernel", "replay_kernel"),
    (40, 4, 20, 3 * L, L, "replay_kernel", "replay_kernel"),
    (3, 1, 20, 3 * L, L, None, None),           # no FIR: not a replay
    (3, 4, 20, 75_000, 50_000, None, None),     # not block-commensurate
    # the port is wider: nbr = 2500 has no 8-aligned divisor, and
    # f - 1 = 11 exceeds the JAX kernel's 8-row halo unit
    (3, 4, 20, 100_000, 50_000, "replay_kernel_t", None),
    (12, 4, 20, 100_000, 50_000, "replay_kernel", None),
    (12, 12, 20, 3 * L, L, "replay_kernel", None),
])
def test_replay_kind(n_tones, f, m, n, block, port, jax_kind):
    """replay_ddc_kind names: the JAX names where both packages take the
    geometry, and the port's where only its kernel does (ROADMAP Queue 3,
    divergence 4)."""
    freqs = [1000 * (k + 1) for k in range(n_tones)]
    cfg, jcfg = configs(freqs, f, m)
    assert replay_ddc.replay_ddc_kind(cfg, n, block) == port
    assert jreplay.replay_ddc_kind(jcfg, n, block) == jax_kind
    rk = replay_ddc.make_replay_ddc(cfg, np.zeros(n, np.complex64), block,
                                    "cpu")
    assert (rk.path_name if rk is not None else None) == port


def test_replay_counts_no_cpu_launch():
    cfg, _ = configs((1000, 2000))
    rk = replay_ddc.make_replay_ddc(cfg, recording(1), L, "cpu")
    before = (replay_ddc.ReplayDDC.launches, replay_ddc.ReplayDDCT.launches)
    rk.step(rk.init_state())
    assert (replay_ddc.ReplayDDC.launches,
            replay_ddc.ReplayDDCT.launches) == before
