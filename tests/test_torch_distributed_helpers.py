"""The port's multi-process helpers (gpu_sdr_tpu_torch/parallel/
distributed.py) and the mesh across processes (parallel/mesh.py) against
the JAX package's (gpu_sdr_tpu/parallel/distributed.py): the span of
time shards a process owns, the slice of a global block it feeds, the
error for a span that is not contiguous; a multi-process mesh's local
view (grid, first, row devices); and, on two gloo processes over
127.0.0.1, the halo ring, the row psum and the gather against their
one-process results, and initialize_distributed's idempotence.  Every
spawned process gets 2 OpenMP threads and a free port; every wait has a
deadline."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gpu_sdr_tpu.parallel import distributed as jdist
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu_torch.parallel import Mesh, make_mesh
from gpu_sdr_tpu_torch.parallel.distributed import (host_local_block,
                                                    host_time_span)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120.0


def view(ranks, rank):
    """A mesh of CPU shards as rank `rank` of a group sees it, owners
    `ranks` (no process group needed for the geometry)."""
    ranks = np.asarray(ranks)
    return Mesh(np.full(ranks.shape, torch.device("cpu"), dtype=object),
                ("time", "channels"), ranks=ranks, rank=rank)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)], ids=str)
def test_one_process_owns_everything_as_in_jax(shape):
    jm = jmake_mesh(shape, ("time", "channels"))
    m = make_mesh(shape, devices=["cpu"] * 8)
    assert host_time_span(m) == jdist.host_time_span(jm) == \
        (0, shape[0], shape[0])
    x = np.arange(800, dtype=np.complex64)
    for (a, ao), (b, bo) in [(host_local_block(x, m),
                              jdist.host_local_block(x, jm))]:
        assert ao == bo == 0 and np.array_equal(a, b) and len(a) == 800


@pytest.mark.parametrize("ranks, rank, span", [
    ([[0, 0], [0, 0], [1, 1], [1, 1]], 0, (0, 2, 4)),
    ([[0, 0], [0, 0], [1, 1], [1, 1]], 1, (2, 4, 4)),
    ([[0, 0, 1, 1], [2, 2, 3, 3]], 1, (0, 1, 2)),    # a row over two ranks
    ([[0, 0, 1, 1], [2, 2, 3, 3]], 3, (1, 2, 2)),
    ([[0], [1], [2], [3]], 2, (2, 3, 4))], ids=str)
def test_host_time_span_and_local_block(ranks, rank, span):
    m = view(ranks, rank)
    assert host_time_span(m) == span
    start, stop, T = span
    x = np.arange(T * 10, dtype=np.complex64)
    local, off = host_local_block(x, m)
    assert off == start * 10
    assert np.array_equal(local, x[start * 10:stop * 10])


def test_a_span_that_is_not_contiguous_raises():
    m = view([[0, 0], [1, 1], [0, 0], [1, 1]], 0)
    with pytest.raises(ValueError, match="not contiguous"):
        host_time_span(m)
    with pytest.raises(ValueError, match="not contiguous"):
        host_local_block(np.zeros(40, np.complex64), m)


def test_multi_process_view():
    """grid calls only this rank's shards; first is its first; a time row
    is computed on its first local shard of the row."""
    m = view([[0, 0, 1, 1], [2, 2, 3, 3]], 1)
    assert m.multiprocess and m.T == 2 and m.Kc == 4
    g = m.grid(lambda t, c, d: (t, c))
    assert g == [[None, None, (0, 2), (0, 3)], [None] * 4]
    assert m.first == torch.device("cpu")
    assert [m.row_shard(t) for t in range(2)] == [2, None]
    assert m.row_device(1) is None
    assert [m.is_local(0, c) for c in range(4)] == [False] * 2 + [True] * 2
    with pytest.raises(ValueError, match="owns no entry"):
        view([[0, 0], [2, 2]], 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    torch.set_num_threads(2)
    from gpu_sdr_tpu_torch.parallel import distributed as D
    from gpu_sdr_tpu_torch.parallel.mesh import (Mesh, Sharded, make_mesh,
                                                 ppermute, psum)
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    D.initialize_distributed(f"tcp://127.0.0.1:{port}", 2, rank,
                             backend="gloo", timeout_s=60)
    D.initialize_distributed(f"tcp://127.0.0.1:{port}", 2, rank)  # again
    import torch.distributed as dist
    assert dist.get_world_size() == 2 and D.cpu_group() is not None
    # 2 x 4 with a time row over both ranks: (t, c) owned by c // 2
    m = make_mesh((1, 4), devices=["cpu"] * 2)
    m2 = Mesh(np.full((2, 4), torch.device("cpu"), dtype=object),
              ("time", "channels"), ranks=[[0, 0, 1, 1], [0, 0, 1, 1]],
              rank=rank)
    assert m.ranks.tolist() == [[0, 0, 1, 1]] and m.multiprocess
    rng = np.random.default_rng(0)
    full = [[torch.from_numpy((rng.standard_normal((3, 5)) +
                               1j * rng.standard_normal((3, 5))
                               ).astype(np.complex64))
             for c in range(4)] for t in range(2)]
    mine = [[p if m2.is_local(t, c) else None for c, p in enumerate(row)]
            for t, row in enumerate(full)]
    # the gather: every rank the one-process result, bit for bit
    want = Sharded(full).gather()
    got = Sharded(mine, m2).gather()
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    assert torch.equal(Sharded(mine, m2).columns(7).gather(), want[:, :7])
    # the ring of each channel column
    for c in range(4):
        col = [full[t][c] for t in range(2)]
        ref = ppermute(col, [torch.device("cpu")] * 2)
        out = m2.ring(c, [mine[t][c] for t in range(2)])
        for t in range(2):
            if m2.is_local(t, c):
                assert torch.equal(out[t], ref[t])
            else:
                assert out[t] is None
    # the psum of each row: owner-local parts, the others exactly 0
    for t in range(2):
        parts = [full[t][c] * (1.0 if c == t + 1 else 0.0)
                 for c in range(4)]
        ref = psum(parts, "cpu")
        got = m2.psum_row(t, [p if m2.is_local(t, c) else None
                              for c, p in enumerate(parts)])
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(ref))
    # a row-replicated result: the row's lowest rank contributes
    rows = [[full[t][0]] for t in range(2)]
    got = Sharded(rows, m2).gather()
    assert torch.equal(got, Sharded(rows).gather())
    D.shutdown()
    print("ok", rank)
""")


def test_collectives_across_two_processes():
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"ok {r}" in out, out[-3000:]


def test_a_rank_converts_its_shards_and_cannot_checkpoint(tmp_path):
    """A JAX ShardedDDC state converted for rank 1 of a (2, 4) mesh over
    two ranks: its own shards are the one-process conversion's, the
    others None; and save_state refuses the state, as the JAX package's
    save_state cannot save an array that is not fully addressable."""
    from gpu_sdr_tpu.engine import make_demodulator as jmake_demod
    from gpu_sdr_tpu.ops import cplx as jcplx
    from gpu_sdr_tpu.params import AntMode, AntennaParams, WaveType
    from gpu_sdr_tpu_torch import convert
    from gpu_sdr_tpu_torch.engine.checkpoint import save_state
    from gpu_sdr_tpu_torch.parallel.sharded import ShardedDDC
    from gpu_sdr_tpu_torch.engine.demodulator import direct_config
    freqs = [100_000, -200_000, 50_000, -350_000]
    rx = AntennaParams(mode=AntMode.RX, rate=1_000_000, decim=10,
                       pf_average=4, buffer_len=40_000, samples=80_000,
                       freq=freqs, wave_type=[WaveType.DIRECT] * 4)
    jm = jmake_mesh((2, 4), ("time", "channels"))
    jd = jmake_demod(rx, mesh=jm)
    L = jd.plan.block_len
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(L) +
         1j * rng.standard_normal(L)).astype(np.complex64)
    js, _ = jd.step(jd.init_state(), jcplx.from_np(x))
    from gpu_sdr_tpu_torch import params as tparams
    trx = tparams.AntennaParams(
        mode=tparams.AntMode.RX, rate=1_000_000, decim=10, pf_average=4,
        buffer_len=40_000, samples=80_000, freq=freqs,
        wave_type=[tparams.WaveType.DIRECT] * 4)
    cfg = direct_config(trx)
    one = ShardedDDC(cfg, make_mesh((2, 4), devices=["cpu"] * 8), L)
    mine = ShardedDDC(cfg, view([[0, 0, 0, 0], [1, 1, 1, 1]], 1), L)
    ref, got = (convert.sharded_ddc_state(js, sd) for sd in (one, mine))
    for r, g in zip(ref, got):
        assert all(g[0][c] is None for c in range(4))
        assert all(torch.equal(r[1][c], g[1][c]) for c in range(4))
    save_state(ref, str(tmp_path / "one"))           # one process: saves
    with pytest.raises(ValueError, match="shards of other processes"):
        save_state(got, str(tmp_path / "rank1"))
