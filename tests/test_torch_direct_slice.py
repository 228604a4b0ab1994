"""The port's DIRECT readout against the JAX package: ``run_measurement``
for a TONES comb looped back into a DIRECT receiver, fused on the device
and host-fed, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(GPU_SDR_TPU_PALLAS=1).  Bars: the same dispatch and shapes on both
sides; 90 dB SNR against the float64 oracle (golden.
GoldenDirectDemodulator) on every row, startup rows included; 85 dB
against JAX, whose kernels run their 3-pass bf16 split
(tests/test_pallas_ddc.py:93); no kernel launch on the CPU.
"""

import os
import subprocess
import sys
import textwrap

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
from gpu_sdr_tpu_torch.ops.ddc import ddc_fused
from gpu_sdr_tpu_torch.ops.fold import fold
from gpu_sdr_tpu_torch.ops.replay_ddc import ReplayDDC, ReplayDDCT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE, M, F = 1_000_000, 20, 4
BLOCK = 64_000          # nb = 3200 rows: tileable for every JAX kernel
N_BLOCKS = 2
PERIODIC3 = [100_000, -250_000, 40_000]               # period 100
PERIODIC16 = [k * 10_000 for k in range(-8, 8)]        # period 100
APERIODIC = [int(f) for f in np.linspace(-0.45 * RATE, 0.45 * RATE, 24)]


def make_params(freqs, n_blocks=N_BLOCKS, pf_average=F, block=BLOCK):
    ampl = 0.5 / len(freqs)
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=block,
                             freq=list(freqs), ampl=[ampl] * len(freqs),
                             wave_type=[WaveType.TONES] * len(freqs))
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=block,
                            samples=n_blocks * block, decim=M,
                            pf_average=pf_average, freq=list(freqs),
                            wave_type=[WaveType.DIRECT] * len(freqs))
    return p


def golden_stream(freqs, pf_average=F, n_blocks=N_BLOCKS, block=BLOCK):
    x = golden.tone_block(freqs, [0.5 / len(freqs)] * len(freqs), RATE, 0,
                          n_blocks * block)
    g = golden.GoldenDirectDemodulator(freqs, RATE, M, pf_average)
    return np.concatenate([g(x[k * block:(k + 1) * block])
                           for k in range(n_blocks)], axis=1).T


def launches():
    return (ddc_fused.launches, ReplayDDC.launches, ReplayDDCT.launches,
            fold.launches)


def run_both(monkeypatch, freqs, host, pf_average=F, block=BLOCK):
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    js, ts = JMemorySink(), MemorySink()
    jmeasure.run_measurement(make_params(freqs, pf_average=pf_average,
                                         block=block),
                             channel=JIdealChannel() if host else None,
                             extra_sinks=[js])
    jdisp = jmeasure.last_dispatch()
    before = launches()
    measure.run_measurement(make_params(freqs, pf_average=pf_average,
                                        block=block),
                            channel=IdealChannel() if host else None,
                            extra_sinks=[ts], device="cpu")
    assert launches() == before
    assert [m.packet_number for m in ts.metas] == list(range(N_BLOCKS))
    assert ts.data.dtype == np.complex64
    assert ts.data.shape == (N_BLOCKS * block // M, len(freqs))
    return jdisp, measure.last_dispatch(), js.data, ts.data


@pytest.mark.parametrize("freqs,host,pf_average,path", [
    (PERIODIC3, False, F, "replay_kernel_t"),
    (PERIODIC16, False, F, "replay_kernel"),
    (APERIODIC, False, F, "fold_kernel"),
    (PERIODIC3, False, 1, "generic_scan"),
    (APERIODIC, True, F, None),
], ids=["replay_kernel_t", "replay_kernel", "fold_kernel", "generic_scan",
        "host_pipeline"])
def test_direct_slice_matches_jax_and_golden(monkeypatch, freqs, host,
                                             pf_average, path):
    jdisp, disp, jdata, data = run_both(monkeypatch, freqs, host,
                                        pf_average)
    assert disp == jdisp == ((("A_RX2", "host_pipeline", None),) if host
                             else (("A_RX2", "fused_loopback", path),))
    assert data.shape == jdata.shape
    assert golden.snr_db(golden_stream(freqs, pf_average), data) > 90.0
    assert golden.snr_db(jdata, data) > 85.0


@pytest.mark.parametrize("freqs,path,jax_path", [
    (PERIODIC3, "replay_kernel_t", "generic_scan"),
    (APERIODIC, "fold_kernel", "fold_chain"),
], ids=["replay", "fold"])
def test_dispatch_is_wider_than_jax(monkeypatch, freqs, path, jax_path):
    """At a 50,000-sample block (nb = 2500, no 8-aligned divisor) the JAX
    replay and fold kernels refuse the geometry; the port's kernels mask
    their last tile and take it (ROADMAP Queue 3, divergences 4 and 5).
    Both packages still agree with the oracle."""
    jdisp, disp, jdata, data = run_both(monkeypatch, freqs, False,
                                        block=50_000)
    assert jdisp == (("A_RX2", "fused_loopback", jax_path),)
    assert disp == (("A_RX2", "fused_loopback", path),)
    ref = golden_stream(freqs, block=50_000)
    assert golden.snr_db(ref, data) > 90.0
    assert golden.snr_db(jdata, data) > 90.0


def test_steady_amplitudes():
    """Every tone lands at DC with its TX amplitude once the FIR history
    is full (tests/test_fused.py:153-155)."""
    s = MemorySink()
    measure.run_measurement(make_params(PERIODIC3), extra_sinks=[s],
                            device="cpu")
    np.testing.assert_allclose(np.abs(s.data[F - 1:]), 0.5 / 3, rtol=1e-2)


def test_direct_runs_with_jax_blocked():
    """The port imports nothing of JAX or of the JAX package: importing
    every module of the port loads neither, and with both unimportable
    the fused and host-fed DIRECT readouts and a host-fed CHIRP readout
    still run."""
    code = textwrap.dedent("""
        import sys
        import gpu_sdr_tpu_torch
        from gpu_sdr_tpu_torch import (config, convert, golden, measure,
                                       params, probe)
        from gpu_sdr_tpu_torch.ops import (chirp, channelizer, cplx, ddc,
                                           fir, fold, lockin, lockin_table,
                                           pfb, presum, replay_ddc,
                                           tonegen, windows)
        from gpu_sdr_tpu_torch.engine import (channel, demodulator, fused,
                                              ingest, pipeline, planner,
                                              sinks, sources)
        from gpu_sdr_tpu_torch.kernels import build
        from gpu_sdr_tpu_torch.client import files, triggers
        from gpu_sdr_tpu_torch.server import native
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gpu_sdr_tpu")], \
            "importing the port loaded jax or the JAX package"
        sys.modules["jax"] = None
        sys.modules["gpu_sdr_tpu"] = None
        import numpy as np, torch
        torch.set_num_threads(2)
        from gpu_sdr_tpu_torch.params import (AntMode, AntennaParams,
                                              UsrpParams, WaveType)
        from gpu_sdr_tpu_torch.engine.channel import IdealChannel
        from gpu_sdr_tpu_torch.engine.sinks import MemorySink
        for freqs in ([100_000, -250_000], [123_457, -345_677]):
            for ch in (None, IdealChannel()):
                p = UsrpParams()
                p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=1_000_000,
                                         buffer_len=64_000, freq=freqs,
                                         ampl=[0.25, 0.25],
                                         wave_type=[WaveType.TONES] * 2)
                p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                                        buffer_len=64_000, samples=64_000,
                                        decim=20, pf_average=4, freq=freqs,
                                        wave_type=[WaveType.DIRECT] * 2)
                s = MemorySink()
                measure.run_measurement(p, channel=ch, extra_sinks=[s],
                                        device="cpu")
                assert s.data.shape == (3200, 2), s.data.shape
                np.testing.assert_allclose(abs(s.data[3:]), 0.25,
                                           rtol=1e-2)
                print(measure.last_dispatch()[0][2])
        p = UsrpParams()
        c = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
                 swipe_s=[128], wave_type=[WaveType.CHIRP])
        p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=1_000_000,
                                 buffer_len=64_000, ampl=[0.25], **c)
        p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000,
                                buffer_len=96_000, samples=96_000,
                                decim=1, **c)
        s = MemorySink()
        measure.run_measurement(p, channel=IdealChannel(), extra_sinks=[s],
                                device="cpu")
        assert s.data.shape == (96, 1), s.data.shape
        np.testing.assert_allclose(abs(s.data), 0.25, rtol=1e-5)
        print(measure.last_dispatch()[0][1])
        assert sys.modules["jax"] is None
        assert sys.modules["gpu_sdr_tpu"] is None
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gpu_sdr_tpu")
                    and sys.modules[m] is not None]
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["replay_kernel_t", "None", "fold_kernel",
                                  "None", "host_pipeline"]
