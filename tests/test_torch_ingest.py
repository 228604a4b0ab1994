"""Socket ingest in the port: server/native.py builds the native TCP
receiver (native/stream_ingest.cpp) with g++ into the port's build
directory, under a name hashed from its sources, and a second build
reuses it; engine/ingest.SocketIngestSource streamed by a producer over
127.0.0.1 gives, through run_pipeline, exactly the ArraySource run; a
producer that hangs up ends the measurement short, the file shrunk and
stamped aborted, as in the JAX package (tests/test_ingest.py).  Every
wait has its own timeout.
"""

import shutil
import socket
import threading

import h5py
import numpy as np
import pytest
import torch

from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu.engine.ingest import \
    SocketIngestSource as JSocketIngestSource
from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.engine import make_demodulator, run_pipeline
from gpu_sdr_tpu_torch.engine.ingest import SocketIngestSource
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource
from gpu_sdr_tpu_torch.server import native
from test_torch_files import assert_same_file

torch.set_num_threads(2)

RATE = 1_000_000
BLOCK = 50_000
WAIT_S = 30.0


def rx_params(P, n_blocks=4):
    return P.AntennaParams(mode=P.AntMode.RX, rate=RATE, buffer_len=BLOCK,
                           samples=n_blocks * BLOCK, decim=100, pf_average=4,
                           freq=[100_000, -250_000, 31_000],
                           wave_type=[P.WaveType.DIRECT] * 3)


def comb(n):
    t = np.arange(n)
    x = sum(a * np.exp(2j * np.pi * f * t / RATE)
            for f, a in ((100_000, 0.3), (-250_000, 0.2), (31_000, 0.1)))
    return x.astype(np.complex64)


def send(port, payload, chunk=65536):
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
        view = memoryview(payload)
        for i in range(0, len(view), chunk):
            s.sendall(view[i:i + chunk])


def producer(port, data):
    th = threading.Thread(target=send, args=(port, data.tobytes()),
                          daemon=True)
    th.start()
    return th


def joined(th):
    th.join(timeout=WAIT_S)
    assert not th.is_alive(), "the producer did not finish"


def test_build_hashes_and_reuses(monkeypatch, tmp_path):
    """g++ builds the library at first use into the build directory; a
    second build finds it and runs no compiler; an edited source builds
    another library; a source g++ refuses raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = native.build("ingest")
    assert first.is_file() and first.parent == tmp_path / "build"
    assert first.name.startswith("libsdr_ingest_")
    assert not list((tmp_path / "build").glob("*.tmp"))

    def no_compiler(*a, **k):
        raise AssertionError("rebuilt an unchanged source")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.build("ingest") == first
    monkeypatch.undo()

    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    (src / "stream_ingest.cpp").write_text(
        (src / "stream_ingest.cpp").read_text() + "\n// edited\n")
    assert native.library_path("ingest") != first
    assert native.build("ingest").is_file()
    (src / "stream_ingest.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("ingest")


def test_library_is_the_ports_own():
    lib = native.load_library("ingest")
    assert native.library_path("ingest").is_file()
    assert lib._name == str(native.library_path("ingest"))
    assert "native/build" not in lib._name


def test_socket_ingest_matches_array_source():
    rx = rx_params(tparams)
    data = comb(4 * BLOCK)
    ref = MemorySink()
    run_pipeline(make_demodulator(rx, "cpu"), ArraySource(data), [ref])
    with SocketIngestSource(block_len=BLOCK, timeout=WAIT_S) as src:
        th = producer(src.port, data)
        sink = MemorySink()
        res = run_pipeline(make_demodulator(rx, "cpu"), src, [sink])
        joined(th)
        stats = src.stats
        assert not src.aborted
    assert np.array_equal(ref.data, sink.data)
    assert res.n_blocks == 4 and stats["blocks_received"] == 4
    assert stats["overflows"] == stats["padded"] == 0
    assert [m.errors for m in sink.metas] == [0] * 4


def test_wrong_block_length_raises():
    with SocketIngestSource(block_len=BLOCK, timeout=1.0) as src:
        with pytest.raises(ValueError, match="native ring"):
            next(src.blocks(BLOCK + 1, 1))


def test_short_producer_aborts_as_in_jax(tmp_path):
    """1.5 blocks, then the producer hangs up: two blocks delivered (the
    second zero-padded and error-stamped), two short; the file holds the
    two blocks' rows, stamped aborted, the same file as JAX's."""
    data = comb(BLOCK + BLOCK // 2)
    fns = []
    for P, Src, run, kw in (
            (jparams, JSocketIngestSource, jmeasure.run_measurement, {}),
            (tparams, SocketIngestSource, measure.run_measurement,
             dict(device="cpu"))):
        p = P.UsrpParams()
        p.A_RX2 = rx_params(P)
        (tmp_path / P.__name__).mkdir()
        with Src(block_len=BLOCK, timeout=WAIT_S) as src:
            th = producer(src.port, data)
            fns.append(run(p, filename=str(tmp_path / P.__name__ / "short"),
                           source=src, **kw))
            joined(th)
            assert src.aborted and src.shortfall_blocks == 2
            assert src.stats["padded"] == BLOCK - BLOCK // 2
    assert_same_file(*fns)
    rows = BLOCK // 100
    with h5py.File(fns[1], "r") as f:
        g = f["raw_data0"]["A_RX2"]
        assert g["data"].shape == (3, 2 * rows)
        assert g["data"].attrs["samples"] == 2 * rows
        assert bool(g.attrs["aborted"])
        assert int(g.attrs["shortfall_blocks"]) == 2
        errs = g["errors"][()]
        assert len(errs) >= 1 and 0 < errs[-1][1] <= 2 * rows


def test_overflow_counts_as_errors():
    """A consumer that falls behind: the ring drops blocks and counts
    them, and take_errors reports each once."""
    import time
    with SocketIngestSource(block_len=BLOCK, queue_len=3,
                            timeout=WAIT_S) as src:
        send(src.port, np.zeros(BLOCK * 8, np.complex64).tobytes())
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            st = src.stats
            if st["blocks_received"] + st["overflows"] >= 8:
                break
            time.sleep(0.01)
        st = src.stats
        assert st["overflows"] > 0
        assert st["blocks_received"] + st["overflows"] == 8
        assert src.take_errors() == st["overflows"]
        assert src.take_errors() == 0
