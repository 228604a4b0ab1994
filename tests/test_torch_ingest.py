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


def _ring_pending(src) -> int:
    ing = src._ingest
    return int(ing._lib.sdr_ingest_pending(ing._h))


def _wait_for(cond, what):
    import time
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _short_producer(src, data, order):
    """1.5 blocks, then a hang-up, in one of two orders: "all_first"
    sends everything and waits until the receiver has pushed the padded
    tail before the run starts; "ring_empty" sends block 0, waits until
    the run has popped it, then sends the half block."""
    if order == "all_first":
        joined(producer(src.port, data))
        _wait_for(lambda: src.stats["blocks_received"] == 2,
                  "the padded tail")
        return None

    def send_in_two():
        with socket.create_connection(("127.0.0.1", src.port),
                                      timeout=WAIT_S) as s:
            s.sendall(data[:BLOCK].tobytes())
            _wait_for(lambda: src.stats["blocks_received"] == 1 and
                      _ring_pending(src) == 0, "block 0's pop")
            s.sendall(data[BLOCK:].tobytes())

    th = threading.Thread(target=send_in_two, daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("order", ["all_first", "ring_empty"])
def test_short_producer_aborts_as_in_jax(tmp_path, order):
    """1.5 blocks, then the producer hangs up: two blocks delivered (the
    second zero-padded and error-stamped), two short; the file holds the
    two blocks' rows, stamped aborted, the same file as JAX's but for
    `errors`.  JAX stamps the padding on whichever block its feeder pops
    after the receiver counted it, [0, 500] or [500, 1000] by timing;
    the port stamps it on the tail that carries it, [500, 1000], in
    either order (divergence 36)."""
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
            th = _short_producer(src, data, order)
            fns.append(run(p, filename=str(tmp_path / P.__name__ / "short"),
                           source=src, **kw))
            if th is not None:
                joined(th)
            assert src.aborted and src.shortfall_blocks == 2
            assert src.stats["padded"] == BLOCK - BLOCK // 2
    rows = BLOCK // 100
    errors = []
    for fn in fns:
        with h5py.File(fn, "r") as f:
            g = f["raw_data0"]["A_RX2"]
            errors.append(g["errors"][()].tolist())
    assert errors[0] in ([[0, rows]], [[rows, 2 * rows]]), errors[0]
    assert errors[1] == [[rows, 2 * rows]], errors[1]
    assert_same_file(*fns, skip=("raw_data0/A_RX2/errors",))
    with h5py.File(fns[1], "r") as f:
        g = f["raw_data0"]["A_RX2"]
        assert g["data"].shape == (3, 2 * rows)
        assert g["data"].attrs["samples"] == 2 * rows
        assert bool(g.attrs["aborted"])
        assert int(g.attrs["shortfall_blocks"]) == 2


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


def _settled(src, n_sent):
    _wait_for(lambda: src.stats["blocks_received"] + src.stats["overflows"]
              == n_sent, f"{n_sent} blocks received or dropped")


def test_overflow_is_stamped_on_the_block_popped_after_it():
    """Where an overflow lands, in the port as in JAX: the drops made
    before the first pop go on block 0; drops made after block 0 was
    popped, before block 1 was, go on block 1, the block popped after
    them; no block is popped ahead, so block 0's pop frees exactly one
    slot for the second burst."""
    stamps = []
    for Src in (JSocketIngestSource, SocketIngestSource):
        with Src(block_len=BLOCK, queue_len=3, timeout=WAIT_S) as src:
            send(src.port, np.zeros(BLOCK * 6, np.complex64).tobytes())
            _settled(src, 6)
            cap = src.stats["blocks_received"]
            first = src.stats["overflows"]
            assert first == 6 - cap > 0
            gen = src.blocks(BLOCK, cap + 1)
            next(gen)
            errs = [src.take_errors()]
            send(src.port, np.zeros(BLOCK * 3, np.complex64).tobytes())
            _settled(src, 9)
            assert src.stats["overflows"] == first + 2
            for _ in gen:
                errs.append(src.take_errors())
            assert not src.aborted
            stamps.append(errs)
            assert errs == [first, 2] + [0] * (cap - 1), errs
    assert stamps[0] == stamps[1]

