"""The port's HDF5 output against the JAX package's: the same
``run_measurement(filename=...)`` in both packages, and the two files
compared group by group.

Each path of run_measurement writes its file: fused TONES, DIRECT and
CHIRP; NOISE; device and segmented replay; two front ends into one file
(dual); a (2, 1) mesh, fused and replayed; the host pipeline through a
channel model with dropouts (the `errors` rows), for one front end and
for two in turn (the second appends to a file the first has closed,
each to its own `data`, many chunks long); the two triggers
(deriv_test, amplitude_trigger with fit parameters).  The files must
hold the same groups, datasets and attributes (tags included), the
same shapes, dtypes, chunks and maxshapes, integer datasets equal and
complex data at >= 90 dB SNR (tests/test_ops_pfb_chirp.py:50-51).  Each
package's readers read the other's file the same as its own, and an
acquisition that ends short is stamped `aborted`.  The JAX side runs
its Pallas kernels in interpret mode (GPU_SDR_TPU_PALLAS=1).
"""

import h5py
import numpy as np
import pytest
import torch

from gpu_sdr_tpu import golden
from gpu_sdr_tpu import measure as jmeasure
from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu.client import files as jfiles
from gpu_sdr_tpu.client import triggers as jtriggers
from gpu_sdr_tpu.engine import channel as jchannel
from gpu_sdr_tpu.engine import replay as jreplay
from gpu_sdr_tpu.engine.sources import ArraySource as JArraySource
from gpu_sdr_tpu.parallel import make_mesh as jmake_mesh
from gpu_sdr_tpu_torch import measure
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.client import files as tfiles
from gpu_sdr_tpu_torch.client import triggers as ttriggers
from gpu_sdr_tpu_torch.engine import channel as tchannel
from gpu_sdr_tpu_torch.engine import replay as treplay
from gpu_sdr_tpu_torch.engine.sinks import MemorySink
from gpu_sdr_tpu_torch.engine.sources import ArraySource
from gpu_sdr_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

RATE = 1_000_000
SNR_DB = 90.0
TAGS = dict(note="h5 parity", run_id=7)
FOLD = [12_345, -67_891, 300_001]
CHIRP = dict(freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
             swipe_s=[128])


def _tones(P, p, fe="A", rx_wave="TONES", freqs=(50_000, -200_000)):
    n = len(freqs)
    kw = dict(rate=RATE, buffer_len=128_000)
    setattr(p, f"{fe}_TXRX", P.AntennaParams(
        mode=P.AntMode.TX, freq=list(freqs), ampl=[0.25] * n,
        wave_type=[P.WaveType.TONES] * n, **kw))
    tones = rx_wave == "TONES"
    setattr(p, f"{fe}_RX2", P.AntennaParams(
        mode=P.AntMode.RX, fft_tones=1000, pf_average=4, samples=256_000,
        freq=list(freqs) if tones else [0],
        wave_type=[P.WaveType(rx_wave)] * (n if tones else 1), **kw))


def _direct(P, p, n_blocks=2):
    n = len(FOLD)
    kw = dict(rate=RATE, buffer_len=100_000, freq=list(FOLD))
    p.A_TXRX = P.AntennaParams(mode=P.AntMode.TX, ampl=[0.5 / n] * n,
                               wave_type=[P.WaveType.TONES] * n, **kw)
    p.A_RX2 = P.AntennaParams(mode=P.AntMode.RX, decim=100, pf_average=4,
                              samples=n_blocks * 100_000,
                              wave_type=[P.WaveType.DIRECT] * n, **kw)


def _direct_ab(P, p):
    """Front ends A and B each DIRECT, B at other tones: through a
    channel model they stream one after the other into one file."""
    _direct(P, p, 4)
    freqs = [f // 2 for f in FOLD]
    p.B_TXRX = P.AntennaParams(**{**vars(p.A_TXRX), "freq": freqs})
    p.B_RX2 = P.AntennaParams(**{**vars(p.A_RX2), "freq": freqs})


def _chirp(P, p):
    kw = dict(rate=RATE, buffer_len=64_000, wave_type=[P.WaveType.CHIRP],
              **{k: list(v) for k, v in CHIRP.items()})
    p.A_TXRX = P.AntennaParams(mode=P.AntMode.TX, ampl=[0.7], **kw)
    p.A_RX2 = P.AntennaParams(mode=P.AntMode.RX, decim=1, samples=256_000,
                              **kw)


def _receiver(P, p, kind):
    """One RX antenna fed from a recording (no TX)."""
    if kind == "tones":
        p.A_RX2 = P.AntennaParams(
            mode=P.AntMode.RX, rate=RATE, buffer_len=128_000,
            samples=256_000, fft_tones=1000, pf_average=4,
            freq=[50_000, -200_000], wave_type=[P.WaveType.TONES] * 2)
    else:
        p.A_RX2 = P.AntennaParams(
            mode=P.AntMode.RX, rate=RATE, buffer_len=50_000,
            samples=100_000, decim=10, pf_average=4,
            freq=[100_000, -250_000], wave_type=[P.WaveType.DIRECT] * 2)


def recording(n, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) +
            1j * rng.standard_normal(n)).astype(np.complex64)


# name -> (edit(P, p), recording (n samples, looped) or None, mesh shape,
# channel kind, segmented, the dispatch both packages must take)
CASES = {
    "fused_tones": (_tones, None, None, None, False,
                    ("fused_loopback", "channelizer_wavetable")),
    "fused_direct": (_direct, None, None, None, False,
                     ("fused_loopback", "fold_kernel")),
    "fused_chirp": (_chirp, None, None, None, False,
                    ("fused_loopback", "chirp_wavetable")),
    "noise": (lambda P, p: _tones(P, p, rx_wave="NOISE"), None, None, None,
              False, ("fused_loopback", "channelizer_wavetable")),
    "device_replay": (lambda P, p: _receiver(P, p, "tones"),
                      (256_000, True), None, None, False,
                      ("device_replay", "channelizer_at")),
    "segmented_replay": (lambda P, p: _receiver(P, p, "direct"),
                         (100_000, False), None, None, True,
                         ("segmented_replay", None)),
    "dual": (lambda P, p: (_tones(P, p, "A"),
                           _tones(P, p, "B", freqs=(120_000, -30_000))),
             None, None, None, False,
             ("dual_fused", "channelizer_wavetable")),
    "mesh_fused": (_tones, None, (2, 1), None, False,
                   ("sharded_fused", "channelizer_wavetable")),
    "mesh_replay": (lambda P, p: _receiver(P, p, "tones"), (256_000, True),
                    (2, 1), None, False,
                    ("sharded_replay", "channelizer_at")),
    "host_channel": (lambda P, p: _direct(P, p, 4), None, None, "dropout",
                     False, ("host_pipeline", None)),
    "host_channel_ab": (_direct_ab, None, None, "dropout", False,
                        ("host_pipeline", None)),
}


def _channel(mod, kind):
    if kind is None:
        return None
    return mod.ChainChannel([mod.DelayChannel(137), mod.DropoutChannel(
        rate=RATE, events_per_second=10.0, dropout_len=500, seed=5)])


def run_case(monkeypatch, tmp_path, name, trigger=None):
    """Run case `name` in both packages, each into its own file: (JAX's
    file, the port's, JAX's dispatch)."""
    edit, rec, mesh_shape, ch, segmented, _want = CASES[name]
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    if segmented:
        monkeypatch.setattr(jreplay, "DEVICE_REPLAY_MAX_BYTES", 40_000 * 8)
        monkeypatch.setattr(treplay, "DEVICE_REPLAY_MAX_BYTES", 40_000 * 8)
    out = []
    for P, mod, Source, mk_mesh, trig, side in (
            (jparams, jchannel, JArraySource,
             lambda s: jmake_mesh(s, ("time", "channels")), trigger, "jax"),
            (tparams, tchannel, ArraySource,
             lambda s: make_mesh(s, devices=["cpu"] * 8),
             trigger, "torch")):
        p = P.UsrpParams()
        edit(P, p)
        src = None
        if rec is not None:
            src = Source(recording(rec[0]))
            src.loop = rec[1]
        kw = dict(filename=str(tmp_path / side / "meas"), source=src,
                  channel=_channel(mod, ch),
                  mesh=mk_mesh(mesh_shape) if mesh_shape else None,
                  trigger=trig() if trig else None, **TAGS)
        (tmp_path / side).mkdir()
        if side == "jax":
            fn = jmeasure.run_measurement(p, **kw)
            jdisp = jmeasure.last_dispatch()
        else:
            fn = measure.run_measurement(p, device="cpu", **kw)
            assert measure.last_dispatch() == jdisp
        assert fn == str(tmp_path / side / "meas.h5")
        out.append(fn)
    return out[0], out[1], jdisp


def h5_items(path):
    """{name: (kind, attrs, dataset properties and values)} of a file."""
    def attrs(obj):
        return {k: obj.attrs[k] for k in obj.attrs}
    items = {"/": ("group", attrs, None)}
    with h5py.File(path, "r") as f:
        items["/"] = ("group", attrs(f), None)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                items[name] = ("dataset", attrs(obj),
                               (obj.shape, obj.dtype, obj.chunks,
                                obj.maxshape, obj[()]))
            else:
                items[name] = ("group", attrs(obj), None)
        f.visititems(visit)
    return items


# attributes computed from the demodulated data (amplitude_trigger's
# thresholds): equal to float32's precision, every other one exactly
COMPUTED_ATTRS = {"bounds": 1e-5}


def same_value(a, b, rtol=None) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return (np.array_equal(a, b) if rtol is None
            else np.allclose(a, b, rtol=rtol, atol=0.0))


def assert_same_file(jpath, tpath, skip=()):
    """The two files hold the same groups, datasets and attributes; the
    same dataset properties; integer data equal, complex data >= 90 dB;
    but the values of the datasets named in `skip`."""
    ji, ti = h5_items(jpath), h5_items(tpath)
    assert sorted(ji) == sorted(ti)
    for name in ji:
        jkind, jattrs, jds = ji[name]
        tkind, tattrs, tds = ti[name]
        assert jkind == tkind, name
        assert sorted(jattrs) == sorted(tattrs), name
        for k in jattrs:
            assert same_value(jattrs[k], tattrs[k], COMPUTED_ATTRS.get(k)), \
                (name, k, jattrs[k], tattrs[k])
        if jds is None:
            continue
        assert jds[:4] == tds[:4], (name, jds[:4], tds[:4])
        if name in skip:
            continue
        jv, tv = jds[4], tds[4]
        if np.iscomplexobj(jv):
            if jv.size:
                snr = golden.snr_db(jv.astype(np.complex128), tv)
                assert snr >= SNR_DB, f"{name}: {snr:.1f} dB"
        else:
            assert np.array_equal(jv, tv), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_file_matches_jax(monkeypatch, tmp_path, name):
    jfn, tfn, jdisp = run_case(monkeypatch, tmp_path, name)
    assert {d[1:] for d in jdisp} == {CASES[name][5]}
    assert_same_file(jfn, tfn)
    with h5py.File(tfn, "r") as f:
        g = f["raw_data0"]
        assert {k: g.attrs[k] for k in TAGS} == TAGS
        for rx_name, _kind, _sub in jdisp:
            ds = g[rx_name]["data"]
            assert ds.attrs["samples"] == ds.shape[1] > 0
            if CASES[name][3] == "dropout":
                assert len(g[rx_name]["errors"]) > 0
            else:
                assert g[rx_name]["errors"].shape == (0, 0)


@pytest.mark.parametrize("name", ["noise", "dual", "host_channel",
                                  "host_channel_ab"])
def test_readers_cross_read(monkeypatch, tmp_path, name):
    """Each package's readers give the same on either package's file."""
    jfn, tfn, jdisp = run_case(monkeypatch, tmp_path, name)
    rx_names = [d[0] for d in jdisp]
    for reader_mod in (jfiles, tfiles):
        for fn in (jfn, tfn):
            ref = reader_mod.openH5file(jfn, front_end=rx_names[-1],
                                        error_coord=True)
            got = reader_mod.openH5file(fn, front_end=rx_names[-1],
                                        error_coord=True)
            assert np.array_equal(ref[1], got[1])
            assert golden.snr_db(ref[0].astype(np.complex128),
                                 got[0]) >= SNR_DB
            for rx in rx_names:
                assert reader_mod.get_rx_info(fn, rx) == \
                    reader_mod.get_rx_info(jfn, rx)
            assert reader_mod.retrieve_params_from_file(fn) == \
                reader_mod.retrieve_params_from_file(jfn)
            assert reader_mod.get_tx_info(fn) == reader_mod.get_tx_info(jfn)
            assert reader_mod.mixed_streams(fn) == [("data", {})]
    # the port's readers build the port's parameter structs
    assert isinstance(tfiles.get_rx_info(jfn), tparams.AntennaParams)
    assert tfiles.get_rx_info(tfn).to_json_dict() == \
        jfiles.get_rx_info(jfn).to_json_dict()


def _amplitude(mod):
    return lambda: mod.amplitude_trigger(
        sample_rate=RATE / 100, threshold=3.0, accumulation_t=0.1,
        window_t=0.002,
        fit_params=[{"Qr": 1e4, "Qe": 2e4, "A": 1.0, "phi": 0.0}] * 3,
        channels=[0, 1])


@pytest.mark.parametrize("trigger", ["deriv_test", "amplitude_trigger"])
def test_triggered_file_matches_jax(monkeypatch, tmp_path, trigger):
    """The trigger filters the host pipeline's packets (dropouts make
    the glitches); `data` grows from empty, and the trigger's
    bookkeeping lands on the `trigger` dataset's attributes."""
    trig = {"deriv_test": lambda mod: (lambda: mod.deriv_test(1.1)),
            "amplitude_trigger": _amplitude}[trigger]
    pair = iter([trig(jtriggers), trig(ttriggers)])

    def make():
        return next(pair)()
    jfn, tfn, _ = run_case(monkeypatch, tmp_path, "host_channel",
                           trigger=make)
    assert_same_file(jfn, tfn)
    with h5py.File(tfn, "r") as f:
        sub = f["raw_data0"]["A_RX2"]
        assert sub["trigger"].attrs["trigger_fcn"] == trigger
        assert sub["data"].attrs["samples"] == sub["data"].shape[1] > 0
        if trigger == "amplitude_trigger":
            assert list(sub["trigger"].attrs["triggering_chs"]) == [0, 1]
            assert sub["trigger"].attrs["nglitch"].sum() > 0
    assert tfiles.get_trigger_info(tfn)[0] == \
        jfiles.get_trigger_info(jfn)[0] == trigger


class ShortSource:
    """Delivers `n_good` blocks of a recording, then ends short, as the
    socket ingest does when its producer hangs up."""

    def __init__(self, data, n_good):
        self.rec, self.n_good = data, n_good
        self.aborted, self.shortfall_blocks = False, 0

    def blocks(self, block_len, n_blocks):
        for i in range(n_blocks):
            if i == self.n_good:
                self.aborted = True
                self.shortfall_blocks = n_blocks - i
                return
            yield self.rec[i * block_len:(i + 1) * block_len]


def test_aborted_run_is_stamped(monkeypatch, tmp_path):
    """A source that ends 2 blocks short: the file shrinks to the rows
    written, and its group is stamped aborted, in both packages alike."""
    monkeypatch.setenv("GPU_SDR_TPU_PALLAS", "1")
    rec = recording(4 * 50_000)
    fns = []
    for P, run, kw in ((jparams, jmeasure.run_measurement, {}),
                       (tparams, measure.run_measurement,
                        dict(device="cpu"))):
        p = P.UsrpParams()
        _receiver(P, p, "direct")
        p.A_RX2.samples = 4 * 50_000
        side = tmp_path / P.__name__
        side.mkdir()
        fns.append(run(p, filename=str(side / "short"),
                       source=ShortSource(rec, 2), **kw))
    assert_same_file(*fns)
    with h5py.File(fns[1], "r") as f:
        g = f["raw_data0"]["A_RX2"]
        assert g.attrs["aborted"] and g.attrs["shortfall_blocks"] == 2
        assert g["data"].shape == (2, 2 * 50_000 // 10)
        assert g["data"].attrs["samples"] == 2 * 50_000 // 10


def test_h5_sink_copies_what_the_memory_sink_gets(monkeypatch, tmp_path):
    """The file's `data` is the packets the other sinks receive,
    transposed, bit for bit, on the port alone."""
    p = tparams.UsrpParams()
    _direct(tparams, p, 3)
    mem = MemorySink()
    fn = measure.run_measurement(p, filename=str(tmp_path / "m"),
                                 extra_sinks=[mem], device="cpu")
    data = tfiles.openH5file(fn)
    assert np.array_equal(data, mem.data.T)
    assert tfiles.get_rx_info(fn) == p.A_RX2
