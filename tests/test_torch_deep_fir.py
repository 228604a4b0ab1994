"""A deep FIR (pf_average in the hundreds) on the port: the DDC and chain
kernels stage a tile's extended rows a chunk of taps at a time, so their
shared memory is bounded for any f.  On the CPU: the staging plan that
ops/ddc.py and ops/chain.py mirror from csrc/ddc.cu and csrc/chain.cu
fits one block's default 48 KB (the launch size, no opt-in) and the
H100's 227 KB for every f up to 4096, its constants those of the CUDA
sources; and the port's host-fed DIRECT readout at pf_average 400
matches the JAX package's direct_ddc_fir route and the float64 oracle
at 90 dB SNR.  The kernels themselves run at such
depths only on the card (chip_smoke.py, its deep-FIR phase).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu.engine.channel import IdealChannel as JIdealChannel
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.params import AntMode, AntennaParams, UsrpParams, WaveType
from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch.engine.channel import IdealChannel
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.ops import chain, ddc

torch.set_num_threads(2)

H100_SMEM = 232_448             # bytes a block may use with the opt-in
F_MAX = 4096
RATE, M, F, BLOCK, N_BLOCKS = 1_000_000, 20, 400, 64_000, 2
FREQS = [100_003, -250_001, 333_333]


@pytest.mark.parametrize("kernel", ["ddc_channel", "ddc_row", "chain"])
def test_staging_plan_fits_for_every_f(kernel):
    """Every f in 1..4096: within the launch size and the card's limit,
    growing with f only up to one pass of taps, then flat."""
    plan = {"ddc_channel": lambda f: ddc.smem_bytes(f, False),
            "ddc_row": lambda f: ddc.smem_bytes(f, True),
            "chain": chain.smem_bytes}[kernel]
    sizes = np.array([plan(f) for f in range(1, F_MAX + 1)])
    assert sizes.max() <= ddc.SMEM_DEFAULT <= H100_SMEM
    assert np.all(np.diff(sizes) >= 0)
    taps = int(np.argmax(sizes))            # f - 1 of the first flat size
    assert 8 <= taps and sizes[taps] == sizes[-1]


def source_constants(name):
    """The integer ``constexpr int`` constants of csrc/`name` whose value
    is a product of literals and earlier such constants."""
    text = (Path(ddc.__file__).parent.parent / "csrc" / name).read_text()
    consts = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([\w\s*]+);", text):
        consts[key] = int(np.prod([int(consts.get(t.strip(), t))
                                   for t in expr.split("*")]))
    return consts


def test_taps_per_pass_mirror_the_sources():
    """The mirrored constants, read from the CUDA sources: 31 taps a pass
    in the DDC's channel mode (64 rows x 65 samples), 59 in row mode
    (128 x 33), 123 in the chain (64 x 33), the most that fit 48 KB."""
    d, c = source_constants("ddc.cu"), source_constants("chain.cu")
    assert ddc.DDC_TILES == {False: (d["kTileC"], d["kChunkC"]),
                             True: (d["kTileR"], d["kChunkR"])}
    assert (chain.CHAIN_TILE, chain.CHAIN_CHUNK) == (c["kTile"], c["kChunk"])
    assert ddc.SMEM_DEFAULT == d["kSmemDefault"] == c["kSmemDefault"]
    assert ddc.ROW_MODE_MAX_CHANNELS == d["kMaxRowChannels"]
    assert [ddc.taps_per_pass(*ddc.DDC_TILES[m]) for m in (False, True)] == \
        [31, 59]
    assert ddc.taps_per_pass(chain.CHAIN_TILE, chain.CHAIN_CHUNK) == 123
    for tile, chunk in (*ddc.DDC_TILES.values(),
                        (chain.CHAIN_TILE, chain.CHAIN_CHUNK)):
        J = ddc.taps_per_pass(tile, chunk)
        assert (tile + J - 1) * (chunk + 1) * 8 <= ddc.SMEM_DEFAULT < \
            (tile + J) * (chunk + 1) * 8


def make_params(p_cls, ant_cls, mode, wave):
    ampl = 0.5 / len(FREQS)
    p = p_cls()
    p.A_TXRX = ant_cls(mode=mode.TX, rate=RATE, buffer_len=BLOCK,
                       freq=list(FREQS), ampl=[ampl] * len(FREQS),
                       wave_type=[wave.TONES] * len(FREQS))
    p.A_RX2 = ant_cls(mode=mode.RX, rate=RATE, buffer_len=BLOCK,
                      samples=N_BLOCKS * BLOCK, decim=M, pf_average=F,
                      freq=list(FREQS), wave_type=[wave.DIRECT] * len(FREQS))
    return p


def test_host_fed_direct_at_pf_average_400_matches_jax_and_golden():
    """Host-fed DIRECT at an 8000-tap FIR (f - 1 = 399 rows of history,
    past every block's first tiles): the port's pipeline (the DDC
    kernel's plain version on the CPU) against JAX's (direct_ddc_fir,
    no Pallas switch) and the float64 oracle, startup rows included."""
    from gpu_sdr_tpu_torch import params as tparams
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(
        make_params(UsrpParams, AntennaParams, AntMode, WaveType),
        channel=JIdealChannel(), extra_sinks=[js])
    before = ddc.ddc_fused.launches
    measure.run_measurement(
        make_params(tparams.UsrpParams, tparams.AntennaParams,
                    tparams.AntMode, tparams.WaveType),
        channel=IdealChannel(), extra_sinks=[ts], device="cpu")
    assert ddc.ddc_fused.launches == before
    assert jmeasure.last_dispatch() == measure.last_dispatch() == \
        (("A_RX2", "host_pipeline", None),)
    assert ts.data.shape == js.data.shape == (N_BLOCKS * BLOCK // M, 3)
    x = golden.tone_block(FREQS, [0.5 / 3] * 3, RATE, 0, N_BLOCKS * BLOCK)
    g = golden.GoldenDirectDemodulator(FREQS, RATE, M, F)
    ref = np.concatenate([g(x[k * BLOCK:(k + 1) * BLOCK])
                          for k in range(N_BLOCKS)], axis=1).T
    assert golden.snr_db(js.data, ts.data) > 90.0
    assert golden.snr_db(ref, ts.data) > 90.0
    assert golden.snr_db(ref[:F - 1], ts.data[:F - 1]) > 90.0
