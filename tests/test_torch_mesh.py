"""The port's mesh (gpu_sdr_tpu_torch/parallel/mesh.py) against the JAX
package's (gpu_sdr_tpu/parallel/mesh.py): the same shapes and axis
names over 8 virtual CPU devices on the JAX side and 8 "cpu" shards on
the port's, devices that repeat, the refusals, and the two collectives
(the time ring, the channel sum) and the sharded result's global view.
"""

import pytest
import torch

from gpu_sdr_tpu.parallel import default_mesh as jdefault_mesh
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu_torch.parallel import Sharded, default_mesh, make_mesh
from gpu_sdr_tpu_torch.parallel.mesh import ppermute, psum, shard_input

CPU8 = ["cpu"] * 8
SHAPES = [(1, 1), (2, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_shape_matches_jax(shape):
    jm = jmake_mesh(shape, ("time", "channels"))
    m = make_mesh(shape, ("time", "channels"), devices=CPU8)
    assert dict(m.shape) == dict(jm.shape)
    assert m.axis_names == tuple(jm.axis_names)
    assert (m.T, m.Kc) == (jm.shape.get("time", 1),
                           jm.shape.get("channels", 1))
    assert m.devices.shape == shape
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.device(shape[0] - 1, shape[1] - 1) == torch.device("cpu")


def test_one_axis_mesh_and_grid():
    m = make_mesh((4,), ("time",), devices=CPU8)
    jm = jmake_mesh((4,), ("time",))
    assert m.shape == dict(jm.shape) == {"time": 4}
    assert (m.T, m.Kc) == (4, 1)
    g = m.grid(lambda t, c, d: (t, c, str(d)))
    assert g == [[(t, 0, "cpu")] for t in range(4)]
    assert make_mesh((2,), ("channels",), devices=CPU8).Kc == 2


def test_default_mesh_rule_matches_jax(monkeypatch):
    """Time gets the smaller factor: (2, n/2) for even n >= 4."""
    for n in (1, 2, 4, 8):
        jm = jdefault_mesh(n)
        t = 2 if (n % 2 == 0 and n >= 4) else 1
        assert dict(jm.shape) == {"time": t, "channels": n // t}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh((2, 4), devices=["cpu"] * 4)
    jax_err = None
    try:
        jmake_mesh((4, 4), ("time", "channels"))
    except ValueError as e:
        jax_err = str(e)
    assert jax_err and "needs 16 devices" in jax_err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2, 1))                       # every visible card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2, 1), devices=["cuda:0"] * 2)   # named, but no card


def test_ppermute_is_one_step_of_the_time_ring():
    parts = [torch.full((3,), float(t)) for t in range(4)]
    got = ppermute(parts, [torch.device("cpu")] * 4)
    assert [float(p[0]) for p in got] == [3.0, 0.0, 1.0, 2.0]


def test_psum_and_sharded_views():
    parts = [torch.arange(4.0) * (c + 1) for c in range(3)]
    assert torch.equal(psum(parts, "cpu"), torch.arange(4.0) * 6)
    # a (4 rows, 6 columns) result over a (2, 3) grid
    full = torch.arange(24.0).reshape(4, 6)
    s = Sharded([[full[2 * t:2 * t + 2, 2 * c:2 * c + 2] for c in range(3)]
                 for t in range(2)])
    assert torch.equal(s.gather(), full)
    assert torch.equal(s.columns(5).gather(), full[:, :5])
    assert torch.equal(s.columns(1).gather(), full[:, :1])
    assert torch.equal(s.map(lambda p: p * 2).gather(), full * 2)
    assert torch.equal(Sharded([[full]]).gather("cpu"), full)


def test_shard_input_splits_the_block_over_time():
    m = make_mesh((4, 2), devices=CPU8)
    x = torch.arange(16.0)
    g = shard_input(m, x)
    assert len(g) == 4 and all(len(row) == 2 for row in g)
    for t in range(4):
        for c in range(2):
            assert torch.equal(g[t][c], x[4 * t:4 * t + 4])
    assert shard_input(m, g) is g
