"""A deep FIR (pf_average in the hundreds) on the port: the DDC's channel
mode runs the window's k axis in chunks, its row mode stages a tile's
span a pass of taps at a time, and the chain a tile's extended rows a
chunk of taps at a time, so their shared memory is bounded for any f.
On the CPU: the staging plan that ops/ddc.py and ops/chain.py mirror
from csrc/ddc.cu and csrc/chain.cu fits for every f up to 4096, the
DDC's channel mode (two stages of a window chunk and its taps, at
config 3's 100 channels) and the chain (its ring of G items beside two
buffers of rows, at config 3's widths) the H100's 227 KB, the DDC's row
mode two blocks an SM, its constants those of the CUDA sources; and the
port's host-fed DIRECT readout at pf_average 400 matches the JAX
package's direct_ddc_fir route and the float64 oracle at 90 dB SNR.
The kernels themselves run at such depths only on the card
(chip_smoke.py, its deep-FIR phase).
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
SM_SMEM = 233_472               # an SM's shared memory, 1 KB a block reserved
F_MAX = 4096
RATE, M, F, BLOCK, N_BLOCKS = 1_000_000, 20, 400, 64_000, 2
FREQS = [100_003, -250_001, 333_333]


@pytest.mark.parametrize("kernel", ["ddc_channel", "ddc_row", "chain"])
def test_staging_plan_fits_for_every_f(kernel):
    """Every f in 1..4096: within the launch size (the DDC's channel mode
    at config 3's 100 channels and the chain at its 100 tones and
    channels: the card's limit; the DDC's row mode at the deep FIR's
    decimation 10 and one channel: two blocks an SM); the row mode and
    the chain growing with f only up to one pass of taps (the row mode's
    320 tap rows in one stage, then two), then flat; the channel mode
    flat from f 1 (its k-loop takes any depth)."""
    plan, limit = {
        "ddc_channel": (lambda f: ddc.smem_bytes(f, False), H100_SMEM),
        "ddc_row": (lambda f: ddc.row_plan(10, f, 1)["smem"],
                    SM_SMEM // 2 - 1024),
        "chain": (lambda f: chain.smem_bytes(f, 100, 100), H100_SMEM)}[kernel]
    sizes = np.array([plan(f) for f in range(1, F_MAX + 1)])
    assert sizes.max() <= limit <= H100_SMEM
    assert np.all(np.diff(sizes) >= 0)
    grows = np.flatnonzero(sizes != sizes[-1])
    flat = int(grows[-1]) + 1 if grows.size else 0          # f - 1
    assert np.all(sizes[flat:] == sizes[-1])
    if kernel == "ddc_row":
        assert flat == ddc.row_plan(10, F_MAX, 1)["J"] == 320
        assert sizes.max() <= ddc.smem_bytes(F_MAX, True, 1)
    else:
        assert flat == 0 if kernel == "ddc_channel" else 8 <= flat < 100


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
    """The mirrored constants, read from the CUDA sources: in the DDC's
    channel mode chunks of 32 window columns at a pitch of 34, 8 rows by
    4 channels a thread, two stages, at config 3's 100 channels 80 rows
    a block (10 row groups by 25 channel groups) in 94,720 bytes, within
    227 KB; in row mode 8 warps of 8 rows at one channel, stages of 7104
    samples, 320 tap rows a pass at decimation 10 (the most, a multiple
    of 4, whose 64 + J - 1 window rows and J taps of 10 samples fit a
    stage); 28 in the chain at config 3's widths, the most whose two
    buffers of 64 + J - 1 rows of 204 floats fit beside its ring of two
    G items (52 tones x 100 channels, complex) in 227 KB; at f 4, the
    main path's, two items a tap."""
    d, c = source_constants("ddc.cu"), source_constants("chain.cu")
    t = source_constants("tc.cuh")
    ch = ddc.DDC_TILES[False]
    assert ddc.DDC_TILES[True] == dict(
        warps=d["kWarpsR"], rows_warp=d["kRowsWarp"], acc=d["kAccR"],
        arm=d["kArmR"], stage=d["kStageR"], stages=d["kStagesR"])
    assert (ch["rows"], ch["channels"], ch["chunk"], ch["pitch"],
            ch["stages"]) == (d["kTM"], d["kTN"], d["kKC"], d["kKP"],
                              d["kStages"]) == (8, 4, 32, 34, 2)
    assert (chain.CHAIN_TILE, chain.CHAIN_MAX_CHANNELS, chain.SMEM_MAX) == \
        (t["kRows"], c["kChanMax"], t["kSmemMax"]) == (64, 112, H100_SMEM)
    assert chain.CHAIN_MIN_TAPS == c["kMinTaps"]
    assert ddc.SMEM_MAX == d["kSmemMax"] == H100_SMEM
    assert ddc.ROW_MODE_MAX_CHANNELS == d["kMaxRowChannels"]
    rt = ddc.DDC_TILES[True]
    p = ddc.row_plan(10, F_MAX, 1)
    R, J, arm = p["R"], p["J"], rt["arm"]
    assert (R, J, p["P"], p["nmc"]) == (64, 320, 10, 1)
    assert (R + J - 1) * 10 + J * 10 <= rt["stage"] < \
        (R + J + arm - 1) * 10 + (J + arm) * 10
    p = ddc.channel_plan(100)                       # config 3
    assert (p["BM"], p["RG"], p["CG"]) == (80, 10, 25)
    assert ddc.smem_bytes(4, False) == ddc.smem_bytes(F_MAX, False) == \
        p["smem"] == 2 * (80 * 34 + 32 * 100) * 8 <= H100_SMEM
    ring, row = 2 * 52 * 100 * 8, (2 * 100 + 4) * 4
    p = chain.plan(4, 100, 100)             # config 3
    assert (p["nc"], p["CN"], p["nke"], p["KE"], p["KG"], p["nsub"],
            p["taps"]) == (1, 100, 1, 100, 52, 2, 4)
    assert p["smem"] == ring + 2 * (chain.CHAIN_TILE + 3) * row
    p = chain.plan(F_MAX, 100, 100)
    J = p["taps"]
    assert (J, p["KE"], p["KG"], p["nc"]) == (28, 100, 52, 1)
    assert ring + 2 * (chain.CHAIN_TILE + J - 1) * row == p["smem"] <= \
        H100_SMEM < ring + 2 * (chain.CHAIN_TILE + J) * row


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
