"""The port's HDF5 module (gpu_sdr_tpu_torch/client/h5.py) against h5py,
both ways: what it writes h5py reads the same (groups, attributes of
every kind the files use, datasets' shapes, dtypes, chunks, maxshapes
and data), and what h5py writes it reads the same; appends in sizes
that do and do not fill chunks, a shrink, a B-tree of more than one
level, a file reopened to add an attribute, two handles on one file,
h5py's chunk guess for many shapes.  The analysis' writes both ways:
contiguous datasets, gzip (deflate at level 4, h5py's chunk guess; a
chunk's filter mask honoured, other filters refused by id), float32 and
complex128 data, complex attributes, require_group, deletes and a
rewrite in a second session, groups of many objects, copies between
two open files.
"""

import zlib

import h5py
import numpy as np
import pytest

from gpu_sdr_tpu_torch.client import h5

ATTRS = {
    "text": "hello",
    "empty_text": "",
    "int": 7,
    "neg": np.int64(-3),
    "float": 1.5,
    "flag": True,
    "ints": np.arange(5, dtype=np.int64),
    "floats": np.linspace(0, 1, 4),
    "empty": np.asarray([]),
    "grid": np.arange(12, dtype=np.float64).reshape(2, 3, 2),
    "words": np.asarray(["TONES", "DIRECT", "ünïcode"],
                        dtype=h5py.string_dtype()),
    "int32": np.arange(3, dtype=np.int32),
}


def items(path, module):
    """{name: (kind, attrs, dataset properties and data)} of a file."""
    out = {}
    with module.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: obj.attrs[k] for k in obj.attrs}
            if hasattr(obj, "shape"):
                out[name] = ("dataset", attrs, (obj.shape, obj.dtype,
                                                obj.chunks, obj.maxshape,
                                                obj.compression,
                                                obj.compression_opts),
                             obj[()])
            else:
                out[name] = ("group", attrs, None, None)
                for k in obj.keys():
                    visit(f"{name}/{k}", obj[k])
        visit("", f)
    return out


def assert_same(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        ka, aa, pa, da = a[name]
        kb, ab, pb, db = b[name]
        assert (ka, pa) == (kb, pb), name
        assert sorted(aa) == sorted(ab), name
        for k in aa:
            x, y = np.asarray(aa[k]), np.asarray(ab[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (name, k)
            assert np.array_equal(x, y), (name, k)
        if da is not None:
            assert np.array_equal(da, db), name


def build(module, path, blocks):
    """The same file through either module: groups, attributes, and
    datasets appended block by block as the H5 sink does."""
    rng = np.random.default_rng(3)
    with module.File(path, "w") as f:
        g = f.create_group("raw_data0")
        for k, v in ATTRS.items():
            g.attrs.create(k, v)
        f.create_group("raw_data0/B_TXRX")
        a = g.create_group("A_RX2")
        a.attrs["aborted"] = False
        d = a.create_dataset("data", (37, 100), dtype=np.complex64,
                             maxshape=(None, None), chunks=True)
        e = a.create_dataset("errors", (0, 0), dtype=np.int64,
                             maxshape=(None, None))
        t = a.create_dataset("trigger", shape=(0,), dtype=np.int64,
                             maxshape=(None,), chunks=True)
        t.attrs.create("trigger_fcn", data="deriv_test")
        w = 0
        for n in blocks:
            x = (rng.standard_normal((n, 37)) +
                 1j * rng.standard_normal((n, 37))).astype(np.complex64)
            if w + n > d.shape[1]:
                d.resize((37, w + n))
            d[:, w:w + n] = x.T
            k = len(e)
            e.resize((k + 1, 2))
            e[k] = (w, w + n)
            t.resize((len(t) + 1,))
            t[len(t) - 1] = n
            w += n
        d.resize((37, w - 3))
        d.attrs.create("samples", w - 3)


@pytest.mark.parametrize("blocks", [[100], [750, 750], [333, 1000, 7],
                                    [4096] * 3], ids=str)
def test_written_file_reads_the_same_in_h5py(tmp_path, blocks):
    build(h5, tmp_path / "port.h5", blocks)
    build(h5py, tmp_path / "h5py.h5", blocks)
    theirs = items(tmp_path / "h5py.h5", h5py)
    assert_same(items(tmp_path / "port.h5", h5py), theirs)
    assert_same(items(tmp_path / "port.h5", h5), theirs)
    assert_same(items(tmp_path / "h5py.h5", h5), theirs)


def test_many_chunks_make_a_deep_btree(tmp_path):
    """More than 64 x 64 chunks: a chunk B-tree of three levels."""
    x = np.arange(40 * 9000, dtype=np.int64).reshape(40, 9000)
    with h5.File(tmp_path / "deep.h5", "w") as f:
        d = f.create_dataset("d", (40, 0), dtype=np.int64,
                             maxshape=(40, None), chunks=(1, 2))
        for a in range(0, 9000, 1500):
            d.resize((40, a + 1500))
            d[:, a:a + 1500] = x[:, a:a + 1500]
    with h5py.File(tmp_path / "deep.h5", "r") as f:
        assert f["d"].chunks == (1, 2)
        assert np.array_equal(f["d"][()], x)
    with h5.File(tmp_path / "deep.h5", "r") as f:
        assert np.array_equal(f["d"][()], x)


def test_reopened_file_keeps_its_data(tmp_path):
    """Appending attributes ("a", as measure._flag_aborted does) keeps
    the data and the earlier attributes."""
    build(h5, tmp_path / "f.h5", [500, 500])
    before = items(tmp_path / "f.h5", h5py)
    with h5.File(tmp_path / "f.h5", "a") as f:
        g = f["raw_data0"]["A_RX2"]
        g.attrs["aborted"] = True
        g.attrs["shortfall_blocks"] = 4
    after = items(tmp_path / "f.h5", h5py)
    assert after["/raw_data0/A_RX2"][1]["aborted"]
    assert after["/raw_data0/A_RX2"][1]["shortfall_blocks"] == 4
    for name in before:
        if name != "/raw_data0/A_RX2":
            assert_same({name: before[name]}, {name: after[name]})


def test_two_handles_share_one_file(tmp_path):
    """Two handles in one process (two front ends' sinks): both see
    each other's objects; the file is written when the last closes."""
    a = h5.File(tmp_path / "two.h5", "a")
    a.create_group("raw_data0").create_group("A_RX2")
    b = h5.File(tmp_path / "two.h5", "a")
    assert "raw_data0/A_RX2" in b
    b["raw_data0"].create_group("B_RX2").create_dataset(
        "data", (2, 4), dtype=np.complex64, maxshape=(None, None),
        chunks=True)[:, :] = np.ones((2, 4), np.complex64)
    a.close()
    b["raw_data0"]["A_RX2"].attrs["x"] = 1
    b.close()
    with h5py.File(tmp_path / "two.h5", "r") as f:
        assert sorted(f["raw_data0"]) == ["A_RX2", "B_RX2"]
        assert f["raw_data0/A_RX2"].attrs["x"] == 1
        assert np.array_equal(f["raw_data0/B_RX2/data"][()],
                              np.ones((2, 4), np.complex64))


def test_h5py_layouts_and_long_headers_read(tmp_path):
    """What h5py writes beyond the sink's datasets: contiguous and
    compact datasets, a scalar, and an object header long enough to
    continue in a second block."""
    x = np.linspace(0, 1, 1000)
    with h5py.File(tmp_path / "f.h5", "w") as f:
        g = f.create_group("VNA_0")
        g.create_dataset("frequency", data=x)
        g.create_dataset("S21", data=(x * 1j).astype(np.complex64))
        g.create_dataset("one", data=3.0)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        sid = h5py.h5s.create_simple((4,))
        h5py.h5d.create(g.id, b"compact", h5py.h5t.NATIVE_INT64, sid,
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                         np.arange(4, dtype=np.int64))
        for k in range(60):
            g.attrs[f"attr_{k:02d}"] = np.arange(k + 1)
    with h5.File(tmp_path / "f.h5", "r") as f:
        g = f["VNA_0"]
        assert np.array_equal(g["frequency"][()], x)
        assert np.array_equal(g["S21"][()], (x * 1j).astype(np.complex64))
        assert g["one"][()] == 3.0
        assert np.array_equal(g["compact"][()], np.arange(4))
        assert len(g.attrs) == 60
        assert np.array_equal(g.attrs["attr_59"], np.arange(60))


@pytest.mark.parametrize("shape", [(0,), (0, 0), (1, 50), (1000, 60_000),
                                   (100, 400_000), (1, 20), (3, 10),
                                   (7, 3, 1000), (12345,)], ids=str)
@pytest.mark.parametrize("itemsize", [8, 16])
def test_chunk_guess_is_h5pys(shape, itemsize):
    from h5py._hl.filters import guess_chunk
    assert h5.guess_chunk(shape, itemsize) == guess_chunk(shape, None,
                                                          itemsize)


def test_misuse_raises(tmp_path):
    build(h5, tmp_path / "f.h5", [100])
    with h5.File(tmp_path / "f.h5", "r") as f:
        with pytest.raises(OSError, match="read-only"):
            f.create_group("x")
        with pytest.raises(KeyError):
            f["nothing"]
    (tmp_path / "junk.h5").write_bytes(b"not hdf5" * 20)
    with pytest.raises(OSError, match="not an HDF5 file"):
        h5.File(tmp_path / "junk.h5", "r")
    with h5.File(tmp_path / "g.h5", "w") as f:
        d = f.create_dataset("d", (2, 0), dtype=np.complex64,
                             maxshape=(2, None), chunks=(2, 4))
        d.resize((2, 8))
        d[:, :8] = np.ones((2, 8))
        with pytest.raises(NotImplementedError, match="already in the file"):
            d[:, 0:2] = np.zeros((2, 2))
        with pytest.raises(ValueError, match="exceeds maxshape"):
            d.resize((3, 8))


def test_second_writer_appends_after_the_first_closes(tmp_path):
    """Two sinks one after the other (the sequential branch with two
    RX): the first creates both datasets and closes; the second reopens
    the file and appends to its own across many chunk columns.  A
    dataset never written has no chunks in the file, as in h5py's."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 4000)) +
         1j * rng.standard_normal((3, 4000))).astype(np.complex64)
    for module, name in ((h5, "port.h5"), (h5py, "h5py.h5")):
        with module.File(tmp_path / name, "a") as f:
            for fe in ("A_RX2", "B_RX2"):
                f.create_group(fe).create_dataset(
                    "data", (3, 4000), dtype=np.complex64,
                    maxshape=(None, None), chunks=True)
            for a in range(0, 4000, 700):
                f["A_RX2/data"][:, a:a + 700] = x[:, a:a + 700]
        with h5py.File(tmp_path / name, "r") as f:
            assert f["B_RX2/data"].id.get_num_chunks() == 0
        with module.File(tmp_path / name, "a") as f:
            d = f["B_RX2/data"]
            for a in range(0, 3900, 650):
                d[:, a:a + 650] = -x[:, a:a + 650]
            d.resize((3, 3900))
            d.attrs.create("samples", 3900)
    theirs = items(tmp_path / "h5py.h5", h5py)
    assert_same(items(tmp_path / "port.h5", h5py), theirs)
    assert_same(items(tmp_path / "port.h5", h5), theirs)
    with h5.File(tmp_path / "port.h5", "a") as f:
        with pytest.raises(NotImplementedError, match="already in the file"):
            f["B_RX2/data"][:, 100:200] = x[:, :100]


KEYS = [(), (slice(None), slice(1234, 1240)), (5, slice(None, None, 7)),
        (slice(None, None, -3), 4000), ([0, 7, 3], slice(100, 5000)),
        (Ellipsis, -1), (-2, Ellipsis), ([-1, 2], [10, 8999])]


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_a_read_takes_only_the_chunks_it_overlaps(tmp_path, monkeypatch,
                                                  key):
    """A slice of a file many chunks long (openH5file's start_sample /
    ch_list, a big_file handle) reads the chunks that overlap it, and
    gives what numpy gives (h5py takes no negative step nor unsorted
    index list)."""
    x = np.arange(8 * 9000, dtype=np.int64).reshape(8, 9000)
    with h5.File(tmp_path / "long.h5", "w") as f:
        f.create_dataset("d", (8, 0), dtype=np.int64, maxshape=(8, None),
                         chunks=(2, 100))
        f["d"].resize((8, 9000))
        f["d"][:, :] = x
    with h5py.File(tmp_path / "long.h5", "r") as f:
        assert np.array_equal(f["d"][()], x)
    want = x[key]
    box, _ = h5._read_box(key, x.shape)
    overlap = int(np.prod([-(-s.stop // c) - s.start // c
                           for s, c in zip(box, (2, 100))]))
    reads = []
    real = h5._State._read
    monkeypatch.setattr(h5._State, "_read", lambda st, addr, n: (
        reads.append(n), real(st, addr, n))[1])
    with h5.File(tmp_path / "long.h5", "r") as f:
        got = f["d"][key]
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert len(reads) == overlap
    assert overlap < 4 * 90 or key == ()


def test_unchunked_datasets_are_kept_and_refuse_writes(tmp_path):
    """h5py's contiguous, compact and scalar datasets come through a
    reopened file's rewrite as they were; writing them raises."""
    with h5py.File(tmp_path / "f.h5", "w") as f:
        f.create_dataset("frequency", data=np.linspace(0, 1, 100))
        f.create_dataset("one", data=3.0)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT64,
                        h5py.h5s.create_simple((4,)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype=np.int64))
    before = items(tmp_path / "f.h5", h5py)
    with h5.File(tmp_path / "f.h5", "a") as f:
        f.attrs["aborted"] = True
        for name in ("frequency", "one", "compact"):
            with pytest.raises(NotImplementedError, match="not chunked"):
                f[name][0:1] = 0
            with pytest.raises(NotImplementedError, match="not chunked"):
                f[name].resize((1,))
    after = items(tmp_path / "f.h5", h5py)
    assert after[""][1]["aborted"]
    for name in ("/frequency", "/one", "/compact"):
        assert_same({name: before[name]}, {name: after[name]})
    with h5py.File(tmp_path / "f.h5", "r") as f:
        assert f["compact"].id.get_create_plist().get_layout() == \
            h5py.h5d.COMPACT
        assert f["frequency"].id.get_create_plist().get_layout() == \
            h5py.h5d.CONTIGUOUS


@pytest.mark.parametrize("cuts", [(6, 10), (8, 13), (3, 9), (10, 12)],
                         ids=str)
def test_shrink_then_grow_reads_as_h5py(tmp_path, cuts):
    """A dataset cut inside a chunk that is in the file, then grown and
    appended to: the columns cut off read as zeros, as in h5py."""
    x = np.arange(2 * 10, dtype=np.int64).reshape(2, 10) + 1
    for module, name in ((h5, "port.h5"), (h5py, "h5py.h5")):
        with module.File(tmp_path / name, "w") as f:
            d = f.create_dataset("d", (2, 10), dtype=np.int64,
                                 maxshape=(2, None), chunks=(2, 4))
            d[:, 0:10] = x
            d.resize((2, cuts[0]))
            d.resize((2, cuts[1]))
            d[:, cuts[1] - 1:cuts[1]] = -1
    assert_same(items(tmp_path / "port.h5", h5py),
                items(tmp_path / "h5py.h5", h5py))


def test_gzip_reproducer_reads_bit_for_bit(tmp_path):
    """h5py's gzip float32 dataset of 180 samples: the reader once took
    the deflated bytes for the data (a chunk's filter mask of 0 means
    every filter was applied)."""
    x = np.random.default_rng(0).standard_normal(180).astype(np.float32)
    with h5py.File(tmp_path / "g.h5", "w") as f:
        f.create_dataset("real_0", data=x, compression="gzip")
    with h5.File(tmp_path / "g.h5", "r") as f:
        d = f["real_0"]
        assert (d.compression, d.compression_opts) == ("gzip", 4)
        y = np.asarray(d)
    assert y.dtype == x.dtype and np.array_equal(y, x)


def _data(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


@pytest.mark.parametrize("rows", [None, 3], ids=["1d", "2d"])
@pytest.mark.parametrize("n", [1, 7, 180, 1000, 4097, 70_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64],
                         ids=lambda d: np.dtype(d).name)
def test_gzip_datasets_read_bit_for_bit(tmp_path, dtype, n, rows):
    """gzip datasets at a sweep of lengths, 1-D and 2-D: h5py's read bit
    for bit by the port, the port's by h5py, with h5py's chunk guess and
    level 4 on both."""
    shape = (n,) if rows is None else (rows, n)
    x = _data(dtype, shape, n)
    with h5py.File(tmp_path / "h.h5", "w") as f:
        f.create_dataset("x", data=x, compression="gzip")
    with h5.File(tmp_path / "p.h5", "w") as f:
        f.create_dataset("x", data=x, compression="gzip")
    want = (x.shape, x.dtype, h5.guess_chunk(shape, x.dtype.itemsize),
            "gzip", 4)
    for path in ("h.h5", "p.h5"):
        for module in (h5, h5py):
            with module.File(tmp_path / path, "r") as f:
                d = f["x"]
                assert (d.shape, d.dtype, d.chunks, d.compression,
                        d.compression_opts) == want, (path, module)
                assert np.array_equal(d[()], x), (path, module)


def test_filter_mask_and_other_filters(tmp_path):
    """A chunk whose mask says deflate was skipped is read raw; shuffle
    (2) and fletcher32 (3) are refused by id on read, and kept through
    a rewrite of the file."""
    x = np.arange(2000, dtype=np.float64)
    with h5py.File(tmp_path / "m.h5", "w") as f:
        d = f.create_dataset("m", shape=(2000,), dtype=np.float64,
                             chunks=(1000,), compression="gzip")
        d.id.write_direct_chunk((0,), zlib.compress(x[:1000].tobytes(), 4))
        d.id.write_direct_chunk((1000,), x[1000:].tobytes(), filter_mask=1)
        f.create_dataset("s", data=x, chunks=(500,), shuffle=True)
        f.create_dataset("g", data=x, chunks=(500,), compression="gzip",
                         fletcher32=True)
    before = items(tmp_path / "m.h5", h5py)
    with h5.File(tmp_path / "m.h5", "a") as f:
        assert np.array_equal(f["m"][()], x)
        with pytest.raises(NotImplementedError, match=r"filter 2 \(shuffle"):
            f["s"][()]
        with pytest.raises(NotImplementedError,
                           match=r"filter 3 \(fletcher32"):
            f["g"][()]
        f.attrs["touched"] = True
    after = items(tmp_path / "m.h5", h5py)
    for name in ("/m", "/s", "/g"):
        assert_same({name: before[name]}, {name: after[name]})


def analysis_writes(module, path, n_noise=40):
    """The writes of the analysis modules (vna, fitting, noise, delay),
    through either module, into a file of the sink's layout."""
    rng = np.random.default_rng(8)
    build(module, path, [300])
    with module.File(path, "r+") as f:
        g = f.require_group("VNA_0")
        assert f.require_group("VNA_0").name == g.name
        g.attrs.create("scan_lengths", [800])
        g.attrs.create("calibration", [0.25])
        g.create_dataset("frequency", data=np.linspace(9.6e6, 1.04e7, 800),
                         dtype=np.float64)
        g.create_dataset("S21", data=_data(np.complex64, 800, 1),
                         dtype=np.complex128)
        res = f.create_group("Resonators")
        res.attrs["tones_init"] = np.asarray([9.85e6, 1.02e7])
        r = res.create_group("reso_0")
        r.create_dataset("freq", data=np.linspace(9.8e6, 9.9e6, 120))
        r.create_dataset("fitted_S21", data=_data(np.complex128, 120, 2))
        r.attrs["f0"] = np.float64(9.85)
        r.attrs["Qe"] = 5e4 + 1j * -3e2
        f.require_group("delay_info").attrs["1"] = 512_000
        ng = f.require_group("Noise0")
        sub = ng.create_group("A_RX2")
        sub.attrs.create("dbc", False)
        sub.attrs.create("rate", 1e4)
        sub.create_dataset("freq", data=np.linspace(0, 5e3, 2501),
                           compression="gzip")
        for i in range(n_noise):
            ds = sub.create_dataset(
                f"real_{i}", data=rng.standard_normal(2501).astype(
                    np.float32), compression="gzip")
            ds.attrs.create("tone", 10_000_000 + i)
        f.create_dataset("scalar", data=2.5)
        f.create_dataset("empty", data=np.zeros(0, np.float32))


def rewrite(module, path):
    """A second session: delete and re-create what a second analysis
    run does (calculate_noise, VNA_analysis), and add a group."""
    with module.File(path, "r+") as f:
        ng = f.require_group("Noise0")
        del ng["A_RX2"]
        sub = ng.create_group("A_RX2")
        sub.create_dataset("freq", data=np.linspace(0, 5e3, 1251),
                           compression="gzip")
        sub.create_dataset("real_0", data=np.ones(1251, np.float32),
                           compression="gzip")
        del f["VNA_0/S21"]
        f["VNA_0"].create_dataset("S21", data=_data(np.complex128, 800, 3))
        del f["Resonators"]
        f.require_group("Resonators").attrs["tones_init"] = [1.0]


@pytest.mark.parametrize("second_session", [False, True],
                         ids=["written", "rewritten"])
def test_analysis_writes_read_the_same_both_ways(tmp_path, second_session):
    """The analysis' writes through the port and through h5py: each
    file reads the same in either module (data, dtypes, attributes,
    contiguous or chunked, gzip at level 4), after a delete and a
    rewrite in a second "r+" session too."""
    for module, name in ((h5, "port.h5"), (h5py, "h5py.h5")):
        analysis_writes(module, tmp_path / name)
        if second_session:
            rewrite(module, tmp_path / name)
    theirs = items(tmp_path / "h5py.h5", h5py)
    assert_same(items(tmp_path / "port.h5", h5py), theirs)
    assert_same(items(tmp_path / "port.h5", h5), theirs)
    assert_same(items(tmp_path / "h5py.h5", h5), theirs)
    with h5py.File(tmp_path / "port.h5", "r") as f:
        plist = f["VNA_0/frequency"].id.get_create_plist()
        assert plist.get_layout() == h5py.h5d.CONTIGUOUS
        assert f["Noise0/A_RX2/real_0"].id.get_create_plist(
            ).get_filter(0)[:3] == (h5py.h5z.FILTER_DEFLATE, 1, (4,))
        assert isinstance(f["VNA_0"].attrs["calibration"], np.ndarray)
    with h5.File(tmp_path / "port.h5", "r+") as f:
        with pytest.raises(NotImplementedError, match="not chunked"):
            f["VNA_0/frequency"][0:1] = 0
        with pytest.raises(KeyError):
            del f["VNA_0/nothing"]
        with pytest.raises(TypeError, match="not a group"):
            f.require_group("scalar")


@pytest.mark.parametrize("n", [1, 32, 33, 1025])
def test_groups_of_many_objects(tmp_path, n):
    """A group of more objects than one symbol table node holds (32): a
    B-tree of nodes, of two levels past 32 nodes."""
    for module, name in ((h5, "port.h5"), (h5py, "h5py.h5")):
        with module.File(tmp_path / name, "w") as f:
            g = f.create_group("Noise0")
            for i in range(n):
                g.create_dataset(f"imag_{i}", data=np.full(3, i, np.int64))
    theirs = items(tmp_path / "h5py.h5", h5py)
    assert_same(items(tmp_path / "port.h5", h5py), theirs)
    assert_same(items(tmp_path / "port.h5", h5), theirs)


def test_copy_between_open_files(tmp_path):
    """Group.copy from one open file into another (copy_resonator_group):
    groups, datasets with their layout and filter, and attributes."""
    analysis_writes(h5py, tmp_path / "src.h5")
    for module, name in ((h5, "port.h5"), (h5py, "h5py.h5")):
        build(module, tmp_path / name, [100])
        with module.File(tmp_path / "src.h5", "r") as src, \
                module.File(tmp_path / name, "r+") as dst:
            src.copy("Resonators", dst)
            src.copy("Noise0", dst)
            src.copy("VNA_0/S21", dst, name="S21_copy")
    theirs = items(tmp_path / "h5py.h5", h5py)
    assert_same(items(tmp_path / "port.h5", h5py), theirs)
    assert_same(items(tmp_path / "port.h5", h5), theirs)
