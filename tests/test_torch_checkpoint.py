"""Checkpoint / resume of the port's streaming state (gpu_sdr_tpu_torch/
engine/checkpoint.py): stop after k blocks, save, load into a fresh
chain's template, and the continuation must be bit-identical to an
uninterrupted run.  tests/test_checkpoint.py's three waves through the
port's demodulators, then every FusedLoopback sub-path, every
DeviceReplay sub-path, SegmentedDeviceReplay across a segment boundary,
DualFused, the sharded chains and replays (segmented too) on CPU
meshes; the leaves' kinds and devices; a config mismatch; and a
checkpoint the JAX package wrote resumed in the port (np.load and
convert) within 90 dB of JAX's continuation.
"""

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu.engine import make_demodulator as jmake_demodulator
from gpu_sdr_tpu.engine.checkpoint import save_state as jsave_state
from gpu_sdr_tpu.ops import cplx as jcplx
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu_torch import convert
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.engine import load_state, make_demodulator, save_state
from gpu_sdr_tpu_torch.engine.dual import DualFused, plan_dual
from gpu_sdr_tpu_torch.engine.fused import FusedLoopback
from gpu_sdr_tpu_torch.engine.replay import (DeviceReplay,
                                             SegmentedDeviceReplay)
from gpu_sdr_tpu_torch.params import AntennaParams, AntMode, WaveType
from gpu_sdr_tpu_torch.parallel import Sharded, make_mesh
from gpu_sdr_tpu_torch.parallel.fused_sharded import (make_sharded_fused,
                                                      plan_sharded_block)
from gpu_sdr_tpu_torch.parallel.sharded_replay import (
    ShardedDeviceReplay, ShardedSegmentedReplay)

torch.set_num_threads(2)

RATE = 1_000_000
RNG = np.random.default_rng(21)
FOLD = [12_345, -67_891, 300_001]
COMB16 = [k * 10_000 for k in range(-8, 8)]


def crandn(n, rng=RNG):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def host(y) -> np.ndarray:
    return (y.gather() if isinstance(y, Sharded) else y).numpy()


def resumed(make, n_before: int, n_after: int, tmp_path):
    """(uninterrupted outputs, resumed outputs, restored state): `make()`
    builds a chain with init_state and step; the resumed run saves after
    n_before blocks and continues on a fresh chain from its template."""
    def run(chain, st, n):
        outs = []
        for _ in range(n):
            st, y = chain.step(st)
            outs.append(host(y))
        return outs, st

    def from_start(n):
        chain = make()
        return run(chain, chain.init_state(), n)

    ref, _ = from_start(n_before + n_after)
    _, st = from_start(n_before)
    path = str(tmp_path / "carry")
    save_state(st, path, block_index=n_before)
    fresh = make()
    st2, k = load_state(path, like=fresh.init_state())
    assert k == n_before
    out, _ = run(fresh, st2, n_after)
    return ref[n_before:], out, st2


def assert_bit_identical(ref, out):
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert a.shape == b.shape and np.array_equal(a, b), \
            "resumed stream differs"


# ---------------------------------------------------------------------
# the host-fed demodulators (tests/test_checkpoint.py's three waves)

WAVES = [
    (WaveType.DIRECT, dict(decim=50, pf_average=4, freq=[12_345, -200_000],
                           buffer_len=50_000)),
    (WaveType.TONES, dict(fft_tones=50, pf_average=4, freq=[100_000],
                          buffer_len=50_000)),
    (WaveType.CHIRP, dict(decim=1, freq=[-200_000], chirp_f=[200_000],
                          chirp_t=[0.05], swipe_s=[500],
                          buffer_len=50_000)),
]


class HostFed:
    """A host-fed demodulator over fixed random blocks, as a chain."""

    def __init__(self, p, blocks):
        self.demod = make_demodulator(p, "cpu")
        self.blocks = blocks

    def init_state(self):
        return (self.demod.init_state(), 0)

    def step(self, state):
        st, i = state
        st, y = self.demod.step(st, torch.from_numpy(self.blocks[i]))
        return (st, i + 1), y


@pytest.mark.parametrize("wave, extra", WAVES,
                         ids=["direct", "tones", "chirp"])
def test_host_fed_resume_bit_identical(tmp_path, wave, extra):
    n_ch = len(extra["freq"])
    p = AntennaParams(mode=AntMode.RX, rate=RATE, samples=400_000,
                      wave_type=[wave] * n_ch, **extra)
    L = make_demodulator(p, "cpu").plan.block_len
    blocks = [crandn(L) for _ in range(4)]
    ref, out, _ = resumed(lambda: HostFed(p, blocks), 2, 2, tmp_path)
    assert_bit_identical(ref, out)


def test_config_mismatch_raises(tmp_path):
    def rx(pf_average):
        return AntennaParams(mode=AntMode.RX, rate=RATE, samples=100_000,
                             decim=50, pf_average=pf_average, freq=[1000],
                             wave_type=[WaveType.DIRECT], buffer_len=50_000)
    save_state(make_demodulator(rx(4), "cpu").init_state(),
               str(tmp_path / "c1"))
    with pytest.raises(ValueError, match="mismatch"):
        load_state(str(tmp_path / "c1"),
                   like=make_demodulator(rx(8), "cpu").init_state())


@pytest.mark.parametrize("saved, like, match", [
    ((1, torch.zeros(3)), (1, torch.zeros(3), 2), "leaves"),
    ((1, torch.zeros(3)), [1, torch.zeros(3)], "tree"),
    ((1, torch.zeros(3)), (1.0, torch.zeros(3)), "mismatch"),
    ((1, torch.zeros(3)), (1, torch.zeros(3, dtype=torch.complex64)),
     "mismatch"),
    ((torch.zeros(2), 1), (1, torch.zeros(2)), "mismatch"),
], ids=["count", "tree", "scalar_kind", "dtype", "leaf_kind"])
def test_mismatch_raises_value_error(tmp_path, saved, like, match):
    save_state(saved, str(tmp_path / "s"))
    with pytest.raises(ValueError, match=match):
        load_state(str(tmp_path / "s"), like=like)


def test_leaves_keep_kind_and_template_device(tmp_path):
    """Python scalars come back as Python scalars of their kind; each
    tensor lands on its template leaf's device (here the CPU and the
    meta device), in tuples, lists, dicts and a Sharded grid."""
    state = {"pos": 123_456_789_012, "pv": 0.25, "started": True,
             "grid": Sharded([[torch.arange(3)], [torch.ones(2, 2)]]),
             "phase": [torch.tensor([1, 2], dtype=torch.int64),
                       (torch.full((2,), 1 + 2j, dtype=torch.complex64),)]}
    save_state(state, str(tmp_path / "s.npz"), block_index=7)
    like = {"pos": 0, "pv": 0.0, "started": False,
            "grid": Sharded([[torch.zeros(3, dtype=torch.int64,
                                          device="meta")],
                             [torch.zeros(2, 2)]]),
            "phase": [torch.zeros(2, dtype=torch.int64),
                      (torch.zeros(2, dtype=torch.complex64),)]}
    st, k = load_state(str(tmp_path / "s"), like=like)
    assert k == 7
    assert type(st["pos"]) is int and st["pos"] == 123_456_789_012
    assert type(st["pv"]) is float and st["pv"] == 0.25
    assert st["started"] is True
    assert st["grid"].parts[0][0].device.type == "meta"
    assert st["grid"].parts[1][0].device.type == "cpu"
    assert torch.equal(st["grid"].parts[1][0], torch.ones(2, 2))
    assert isinstance(st["phase"], list) and isinstance(st["phase"][1],
                                                        tuple)
    assert torch.equal(st["phase"][1][0], state["phase"][1][0])


# ---------------------------------------------------------------------
# every FusedLoopback sub-path, DualFused


def tones_direct(freqs, burst=False):
    n = len(freqs)
    tx = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=100_000,
                       freq=list(freqs), ampl=[0.5 / n] * n,
                       wave_type=[WaveType.TONES] * n)
    if burst:
        tx.burst_on, tx.burst_off = 0.03, 0.02
    rx = AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=100_000,
                       samples=400_000, decim=100, pf_average=4,
                       freq=list(freqs), wave_type=[WaveType.DIRECT] * n)
    return tx, rx


def tones(freqs=(50_000, -200_000), block=128_000, blocks=4):
    kw = dict(rate=RATE, buffer_len=block, freq=list(freqs),
              wave_type=[WaveType.TONES] * len(freqs))
    return (AntennaParams(mode=AntMode.TX, ampl=[0.25] * len(freqs), **kw),
            AntennaParams(mode=AntMode.RX, fft_tones=1000, pf_average=4,
                          samples=blocks * block, **kw))


def chirp(chirp_t=0.128):
    kw = dict(rate=RATE, buffer_len=64_000, samples=256_000,
              freq=[-300_000], chirp_f=[300_000], chirp_t=[chirp_t],
              swipe_s=[64], wave_type=[WaveType.CHIRP])
    return (AntennaParams(mode=AntMode.TX, ampl=[0.7], **kw),
            AntennaParams(mode=AntMode.RX, decim=1, **kw))


PAIRS = {
    "replay_kernel_t": lambda: tones_direct([100_000]),
    "replay_kernel": lambda: tones_direct(COMB16),
    "fold_kernel": lambda: tones_direct(FOLD),
    "generic_scan": lambda: tones_direct(FOLD, burst=True),
    "chirp_wavetable": chirp,
    "channelizer_wavetable": tones,
}


@pytest.mark.parametrize("path", sorted(PAIRS))
def test_fused_loopback_resume(tmp_path, path):
    tx, rx = PAIRS[path]()

    def make():
        fused = FusedLoopback(tx, rx, device="cpu")
        assert fused.path == path
        return fused
    ref, out, _ = resumed(make, 2, 2, tmp_path)
    assert_bit_identical(ref, out)


def test_dual_fused_resume(tmp_path):
    p = tparams.UsrpParams()
    p.A_TXRX, p.A_RX2 = tones_direct(FOLD)
    p.B_TXRX, p.B_RX2 = tones_direct([100_000])

    class Chain:
        def __init__(self):
            self.d = DualFused(plan_dual(p), device="cpu")

        def init_state(self):
            return self.d.init_state()

        def step(self, st):
            st, ys = self.d.step(st)
            return st, torch.cat(ys, dim=1)
    ref, out, st = resumed(Chain, 1, 3, tmp_path)
    assert isinstance(st, list) and len(st) == 2
    assert_bit_identical(ref, out)


# ---------------------------------------------------------------------
# every DeviceReplay sub-path, SegmentedDeviceReplay


def receiver(kind):
    def rx(block, **kw):
        return AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=block,
                             samples=8 * block, **kw)
    ch = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
              swipe_s=[128], wave_type=[WaveType.CHIRP], decim=1)
    return {
        "replay_kernel_t": lambda: rx(50_000, decim=10, pf_average=4,
                                      freq=[100_000, -250_000],
                                      wave_type=[WaveType.DIRECT] * 2),
        "replay_kernel": lambda: rx(50_000, decim=10, pf_average=4,
                                    freq=COMB16[:10],
                                    wave_type=[WaveType.DIRECT] * 10),
        "channelizer_at": lambda: rx(128_000, fft_tones=1000, pf_average=4,
                                     freq=[50_000, -200_000],
                                     wave_type=[WaveType.TONES] * 2),
        "pfb_at": lambda: rx(64 * 1009, fft_tones=1009, pf_average=4,
                             freq=[0], wave_type=[WaveType.NOISE]),
        "chirp_table": lambda: rx(64_000, **ch),
        "chirp_at": lambda: rx(96_000, **ch),
        "scan": lambda: rx(50_000, decim=10, pf_average=4,
                           freq=[100_000, -250_000],
                           wave_type=[WaveType.DIRECT] * 2),
    }[kind]()


@pytest.mark.parametrize("path", ["replay_kernel_t", "replay_kernel",
                                  "channelizer_at", "pfb_at", "chirp_table",
                                  "chirp_at", "scan"])
def test_device_replay_resume(tmp_path, path):
    rx = receiver(path)
    L = int(rx.buffer_len)
    loop = path != "scan"
    # looped: three blocks, so the resumed run crosses the loop seam
    rec = crandn(3 * L if loop else 2 * L + L // 2, np.random.default_rng(5))

    def make():
        dr = DeviceReplay(rx, rec, loop=loop, device="cpu")
        assert dr.path == path
        return dr
    ref, out, _ = resumed(make, 2, 3, tmp_path)
    assert_bit_identical(ref, out)


@pytest.mark.parametrize("n_before", [2, 3], ids=["at", "inside"])
def test_segmented_replay_resume_across_segments(tmp_path, n_before):
    """Two-block segments of a 5.5-block recording: saved at a segment
    boundary and inside a segment, the resumed replay stages its segment
    anew and crosses the next boundary bit-identically."""
    rx = receiver("scan")
    L = int(rx.buffer_len)
    rec = crandn(5 * L + L // 2, np.random.default_rng(6))

    def make():
        return SegmentedDeviceReplay(rx, rec, segment_bytes=2 * L * 8,
                                     device="cpu")
    ref, out, st = resumed(make, n_before, 7 - n_before, tmp_path)
    assert st[1] == n_before
    assert_bit_identical(ref, out)


# ---------------------------------------------------------------------
# the sharded chains and a sharded replay, on CPU meshes


SHARDED = {
    "channelizer_wavetable": ((2, 1), tones),
    "pfb_scan": ((1, 2), tones),
    "pfb_scan_aperiodic": ((2, 2), lambda: tones((50_300, -200_000))),
    "fold_kernel": ((2, 1), lambda: tones_direct(FOLD)),
    "chirp_table": ((2, 1), chirp),
    "chirp_lockin": ((2, 1), lambda: chirp(chirp_t=0.1)),
}


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_fused_resume(tmp_path, name):
    shape, pair = SHARDED[name]
    mesh = make_mesh(shape, devices=["cpu"] * 8)
    tx, rx = pair()
    L, _ = plan_sharded_block(rx, mesh)

    def make():
        sf = make_sharded_fused(tx, rx, mesh, block_len=L)
        assert sf.path == name.split("_aperiodic")[0]
        return sf
    ref, out, _ = resumed(make, 2, 2, tmp_path)
    assert_bit_identical(ref, out)


@pytest.mark.parametrize("n_before", [2, 3], ids=["at", "inside"])
def test_sharded_segmented_replay_resume(tmp_path, n_before):
    """ShardedSegmentedReplay on a (2, 1) CPU mesh, two-block segments:
    resumed at a segment boundary and inside one, bit-identically."""
    mesh = make_mesh((2, 1), devices=["cpu"] * 2)
    rx = receiver("scan")
    L = int(rx.buffer_len)
    rec = crandn(5 * L + L // 2, np.random.default_rng(9))

    def make():
        return ShardedSegmentedReplay(rx, rec, mesh,
                                      segment_bytes=2 * L * 8)
    ref, out, st = resumed(make, n_before, 7 - n_before, tmp_path)
    assert st[1] == n_before
    assert_bit_identical(ref, out)


@pytest.mark.parametrize("path, loop", [("replay_kernel", True),
                                        ("channelizer_at", True),
                                        ("scan", False)])
def test_sharded_replay_resume(tmp_path, path, loop):
    mesh = make_mesh((2, 1), devices=["cpu"] * 2)
    rx = receiver("channelizer_at" if path == "channelizer_at"
                  else "replay_kernel_t")
    L = int(rx.buffer_len)
    rec = crandn(3 * L if loop else 2 * L + L // 2, np.random.default_rng(7))

    def make():
        sr = ShardedDeviceReplay(rx, rec, mesh, loop=loop)
        assert sr.path == path
        return sr
    ref, out, _ = resumed(make, 2, 3, tmp_path)
    assert_bit_identical(ref, out)


# ---------------------------------------------------------------------
# a checkpoint of the JAX package, resumed in the port


@pytest.mark.parametrize("wave", ["direct", "tones"])
def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch, wave):
    """JAX's save_state of a host-fed DIRECT / TONES demodulator after two
    blocks: its leaves through np.load and convert (ddc_state,
    host_spare) into the port's demodulator, which continues within
    90 dB of JAX's continuation."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    w, extra = WAVES[0] if wave == "direct" else WAVES[1]
    n = len(extra["freq"])
    jp = jparams.AntennaParams(mode=jparams.AntMode.RX, rate=RATE,
                               samples=400_000, **extra,
                               wave_type=[jparams.WaveType[w.name]] * n)
    tp = AntennaParams(mode=AntMode.RX, rate=RATE, samples=400_000,
                       **extra, wave_type=[w] * n)
    jd = jmake_demodulator(jp)
    L = jd.plan.block_len
    blocks = [crandn(L, np.random.default_rng(8 + i)) for i in range(4)]
    st = jd.init_state()
    for b in blocks[:2]:
        st, _ = jd.step(st, jcplx.from_np(b))
    path = str(tmp_path / "jax_carry")
    jsave_state(st, path, block_index=2)
    jref = []
    for b in blocks[2:]:
        st, y = jd.step(st, jcplx.from_np(b))
        jref.append(jcplx.to_np(y))

    with np.load(path + ".npz") as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    if wave == "direct":
        tst = convert.ddc_state((leaves[0], (leaves[1], leaves[2])), "cpu")
    else:
        tst = convert.host_spare((leaves[0], leaves[1]), 4, 50, "cpu")
    td = make_demodulator(tp, "cpu")
    for b, ref in zip(blocks[2:], jref):
        tst, y = td.step(tst, torch.from_numpy(b))
        assert golden.snr_db(ref, y.numpy()) > 90.0


# ---------------------------------------------------------------------
# mixed wave types: a tuple of the groups' states (DIRECT + CHIRP, the
# geometry of tests/test_mixed_modes.py)


def mixed_rx(P):
    W = P.WaveType
    return P.AntennaParams(
        mode=P.AntMode.RX, rate=RATE, buffer_len=100_000, samples=400_000,
        decim=100, pf_average=4, freq=[100_000, -200_000, -300_000],
        wave_type=[W.DIRECT, W.DIRECT, W.CHIRP], chirp_f=[0, 0, 300_000],
        chirp_t=[0.0, 0.0, 0.1], swipe_s=[0, 0, 1000])


class MixedFed:
    """A mixed demodulator over fixed blocks, as a chain whose output is
    its groups' outputs side by side."""

    def __init__(self, blocks, mesh_shape=None):
        mesh = (make_mesh(mesh_shape, devices=["cpu"] * 2)
                if mesh_shape else None)
        self.demod = make_demodulator(mixed_rx(tparams), "cpu", mesh=mesh)
        self.blocks = blocks

    def init_state(self):
        return (self.demod.init_state(), 0)

    def step(self, state):
        st, i = state
        st, ys = self.demod.step(st, torch.from_numpy(self.blocks[i]))
        return (st, i + 1), torch.cat([torch.from_numpy(host(y)).flatten()
                                       for y in ys])


@pytest.mark.parametrize("mesh_shape", [None, (2, 1)], ids=["one", "mesh"])
def test_mixed_resume_bit_identical(tmp_path, mesh_shape):
    blocks = [crandn(100_000) for _ in range(4)]
    ref, out, st = resumed(lambda: MixedFed(blocks, mesh_shape), 2, 2,
                           tmp_path)
    assert_bit_identical(ref, out)
    groups, i = st
    assert i == 2 and isinstance(groups, tuple) and len(groups) == 2


@pytest.mark.parametrize("mesh_shape", [None, (2, 1)], ids=["one", "mesh"])
def test_jax_mixed_state_continues_in_port(monkeypatch, mesh_shape):
    """A JAX MixedDemodulator stopped after two blocks: its state through
    convert.mixed_state into the port's, which continues within 90 dB of
    JAX's continuation, group by group."""
    from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    jmesh = (jmake_mesh(mesh_shape, ("time", "channels"))
             if mesh_shape else None)
    jd = jmake_demodulator(mixed_rx(jparams), mesh=jmesh)
    blocks = [crandn(100_000, np.random.default_rng(30 + i))
              for i in range(4)]
    st = jd.init_state()
    for b in blocks[:2]:
        st, _ = jd.step(st, jcplx.from_np(b))
    tst = convert.mixed_state(st, MixedFed(blocks, mesh_shape).demod)
    td = MixedFed(blocks, mesh_shape).demod
    for b in blocks[2:]:
        st, jys = jd.step(st, jcplx.from_np(b))
        tst, ys = td.step(tst, torch.from_numpy(b))
        for jy, y in zip(jys, ys):
            assert golden.snr_db(jcplx.to_np(jy), host(y)) > 90.0
    with pytest.raises(ValueError, match="group states"):
        convert.mixed_state(st[:1], td)
