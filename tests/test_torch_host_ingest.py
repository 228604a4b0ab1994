"""The port's per-host sharded ingest (gpu_sdr_tpu_torch/parallel/
host_ingest.py), mirroring tests/test_host_ingest.py without its skip:
the port builds its own receiver (g++, server/native.py).  One process
owns the whole (4, 2) CPU mesh here, so its stream is the whole
recording; the multi-process form runs in tests/test_torch_multihost.py.
A producer feeds 127.0.0.1; every socket wait has a timeout."""

import socket
import threading

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.engine import make_demodulator as jmake_demodulator
from gpu_sdr_tpu.engine import run_pipeline as jrun_pipeline
from gpu_sdr_tpu.engine.sinks import MemorySink as JMemorySink
from gpu_sdr_tpu.engine.sources import ArraySource as JArraySource
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource
from gpu_sdr_tpu_torch.parallel import make_mesh
from gpu_sdr_tpu_torch.parallel.host_ingest import (PerHostIngest,
                                                    host_stream_for)

torch.set_num_threads(2)

RATE = 1_000_000
FREQS = [100_000, -200_000, 50_000, -350_000]
WAIT_S = 30.0


def _rx(P, samples=400_000):
    return P.AntennaParams(mode=P.AntMode.RX, rate=RATE, decim=100,
                           pf_average=4, buffer_len=100_000,
                           samples=samples, freq=FREQS,
                           wave_type=[P.WaveType.DIRECT] * 4)


def _send_all(port, payload, chunk=65536):
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=WAIT_S) as s:
        view = memoryview(payload)
        for i in range(0, len(view), chunk):
            s.sendall(view[i:i + chunk])


def _mesh():
    return make_mesh((4, 2), ("time", "channels"), devices=["cpu"] * 8)


def test_per_host_ingest_matches_array_source():
    """The per-host shard assembly demodulates exactly as the same
    recording served whole from memory through the one-device pipeline,
    and within 90 dB of JAX's."""
    rx = _rx(tparams)
    mesh = _mesh()
    demod = make_demodulator(rx, mesh=mesh)
    L, nb = demod.plan.block_len, demod.plan.n_blocks
    t = np.arange(nb * L)
    rec = sum(a * np.exp(2j * np.pi * f * t / RATE)
              for f, a in zip(FREQS, [0.4, 0.25, 0.2, 0.1])
              ).astype(np.complex64)

    ref = MemorySink()
    run_pipeline(make_demodulator(rx, "cpu"), ArraySource(rec), [ref])
    jref = JMemorySink()
    jrun_pipeline(jmake_demodulator(_rx(jparams)), JArraySource(rec), [jref])

    with PerHostIngest(mesh, L, timeout=WAIT_S) as ing:
        # one process: it owns the whole mesh, so its stream is the whole
        # recording
        payload = host_stream_for(rec, ing, nb)
        np.testing.assert_array_equal(payload, rec)
        assert (ing.offset, ing.local_len) == (0, L)
        producer = threading.Thread(
            target=_send_all, args=(ing.port, payload.tobytes()),
            daemon=True)
        producer.start()
        state = demod.init_state()
        outs, errs = [], []
        for grid, e in ing.device_blocks(L, nb):
            assert all(p is not None and p.shape == (L // 4,)
                       for row in grid for p in row)
            state, y = demod.step(state, grid)
            outs.append(y.gather().numpy())
            errs.append(e)
        producer.join(timeout=WAIT_S)
        assert not producer.is_alive()
        assert not ing.aborted
    got = np.concatenate(outs, axis=0)
    assert errs == [0] * nb
    assert got.shape == ref.data.shape
    assert golden.snr_db(ref.data.ravel(), got.ravel()) > 90
    assert golden.snr_db(jref.data.ravel(), got.ravel()) > 90


def test_per_host_ingest_abort_ends_short():
    """A producer hangup ends the sharded stream short: the step never
    advances on fabricated samples (reference abort,
    cpp/USRP_hardware_manager.cpp:1546-1560); the padded tail's samples
    are stamped on the tail block."""
    rx = _rx(tparams)
    mesh = _mesh()
    demod = make_demodulator(rx, mesh=mesh)
    L, nb = demod.plan.block_len, demod.plan.n_blocks
    assert nb >= 3
    rec = np.ones(nb * L, dtype=np.complex64)

    with PerHostIngest(mesh, L, timeout=WAIT_S) as ing:
        payload = host_stream_for(rec, ing, nb)
        short = payload[:L + L // 2]          # the producer dies 1.5 in
        producer = threading.Thread(
            target=_send_all, args=(ing.port, short.tobytes()),
            daemon=True)
        producer.start()
        errs = []
        state = demod.init_state()
        for grid, e in ing.device_blocks(L, nb):
            state, _y = demod.step(state, grid)
            errs.append(e)
        producer.join(timeout=WAIT_S)
    assert ing.aborted
    assert len(errs) == 2                     # delivered + padded tail
    assert ing.shortfall_blocks == nb - 2
    assert errs == [0, L - L // 2]            # stamped on the tail


def test_block_that_does_not_split_raises():
    with pytest.raises(ValueError, match="must split"):
        PerHostIngest(_mesh(), 100_001)
