"""A small HDF5 reader and writer in numpy, for the measurement files.

The port's hosts need not have h5py (nor the HDF5 library), so the file
layer (client/files.py) and the analysis modules write and read HDF5
through this module, which speaks the subset of the format those files
use, in its earliest versions (what h5py writes by default):

* a version-0 superblock; groups as symbol tables (a v1 B-tree, a local
  heap of names, symbol table nodes); version-1 object headers, with
  continuation blocks when reading;
* attributes of 64-bit integers, 64-bit floats, complex numbers (h5py's
  compound of 'r', 'i'), booleans (h5py's enum of FALSE / TRUE), and
  variable-length UTF-8 strings (a global heap), scalars or arrays;
* datasets of integers, float32, float64, complex64 and complex128,
  contiguous or chunked (a v1 B-tree of chunks), the chunks raw or
  deflated (the gzip filter, filter 1; a chunk's filter mask says which
  filters it skipped); h5py's layout rule (chunked when chunks, maxshape
  or compression is given) and its chunk-shape guess.

The interface is the part of h5py's that the file layer and the
analysis call: ``File``, groups (``create_group``, ``require_group``,
``create_dataset``, ``del``, ``copy``), datasets (``shape``, ``dtype``,
``chunks``, ``maxshape``, ``compression``, ``resize``, item reads and
writes, ``attrs``) and ``string_dtype``.  A file's objects are parsed on
opening and live in memory while it is open; a read takes only the
chunks its selection overlaps.  Only what the sink and the analysis do
is written: datasets created (a contiguous one with its data, once),
chunked ones appended to along the last axis (or, while none of their
chunks is in the file, by row), shrunk, objects deleted and attributes
set; anything else raises.  A dataset streams: once a write has filled
every chunk of a run of columns along its last axis (the way the H5
sink appends packets), those chunks go to the end of the file and leave
memory; a dataset of a reopened file takes appends from the end of its
last chunk column on.  Closing the file writes the rest of the data and
then all metadata at the end of the file, and finally the superblock,
so a file reopened to add an attribute keeps its data where it is; the
space of a deleted object is not reclaimed, as in h5py.  Handles to one
file in one process share its objects, as the HDF5 library's do; the
file is written when the last one closes.  A process that dies before
that leaves no readable file.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF          # the undefined address
UNLIMITED = 0xFFFFFFFFFFFFFFFF      # an unlimited maximum dimension
SIGNATURE = b"\x89HDF\r\n\x1a\n"
SUPERBLOCK_BYTES = 96               # version 0, 8-byte offsets and lengths
LEAF_K, GROUP_K, CHUNK_K = 16, 16, 32   # B-tree node widths
FREE_NULL = 1                       # end of a local heap's free list
DEFLATE, GZIP_LEVEL = 1, 4          # the gzip filter's id; h5py's level
FILTER_OPTIONAL = 1                 # how h5py's set_deflate adds it
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset", 32000: "lzf"}

# h5py's chunk guess (h5py/_hl/filters.py): the target chunk grows with
# the dataset, within [CHUNK_MIN, CHUNK_MAX] bytes
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024

_VLEN_STR = np.dtype("O", metadata={"vlen": str})
_COMPLEX_NAMES = (b"r", b"i")


def string_dtype():
    """The dtype of variable-length UTF-8 strings (h5py.string_dtype())."""
    return _VLEN_STR


def guess_chunk(shape, typesize: int) -> Tuple[int, ...]:
    """The chunk shape h5py picks for ``chunks=True``: halve the axes in
    turn until the chunk is near a size that grows with the dataset."""
    shape = tuple((x if x != 0 else 1024) for x in shape)
    chunks = np.array(shape, dtype="=f8")
    dset_size = float(np.prod(chunks)) * typesize
    target = CHUNK_BASE * (2 ** np.log10(dset_size / (1024. * 1024)))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = float(np.prod(chunks)) * typesize
        if (chunk_bytes < target or
                abs(chunk_bytes - target) / target < 0.5) and \
                chunk_bytes < CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


# ----------------------------------------------------------------------
# Datatypes: numpy dtype <-> datatype message


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _fixed(size: int, signed: bool) -> bytes:
    return struct.pack("<B3BIHH", 0x10, 0x08 if signed else 0, 0, 0, size,
                       0, size * 8)


def _float(size: int) -> bytes:
    exp_loc, exp_size, mant, bias = ((23, 8, 23, 127) if size == 4
                                     else (52, 11, 52, 1023))
    return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, size * 8 - 1, 0, size, 0,
                       size * 8, exp_loc, exp_size, 0, mant, bias)


def _compound_complex(part: int) -> bytes:
    """h5py's complex type: a compound of two floats of `part` bytes."""
    out = struct.pack("<B3BI", 0x16, 2, 0, 0, 2 * part)
    for k, name in enumerate(_COMPLEX_NAMES):
        out += _pad8(name + b"\0") + struct.pack("<IB3xI4x16x", part * k, 0,
                                                 0)
        out += _float(part)
    return out


def _enum_bool() -> bytes:
    out = struct.pack("<B3BI", 0x18, 2, 0, 0, 1) + _fixed(1, True)
    out += _pad8(b"FALSE\0") + _pad8(b"TRUE\0")
    return out + bytes([0, 1])


def _vlen_string() -> bytes:
    return struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16) + _fixed(1, False)


def encode_dtype(dt: np.dtype) -> bytes:
    """The datatype message of a numpy dtype the files use."""
    if dt.kind == "O":
        return _vlen_string()
    if dt.kind == "c" and dt.itemsize in (8, 16):
        return _compound_complex(dt.itemsize // 2)
    if dt == np.bool_:
        return _enum_bool()
    if dt.kind in "iu":
        return _fixed(dt.itemsize, dt.kind == "i")
    if dt.kind == "f":
        return _float(dt.itemsize)
    raise TypeError(f"h5: no HDF5 datatype for {dt}")


class _Reader:
    """Little-endian reads from a bytes-like at a moving position."""

    def __init__(self, buf, pos: int = 0):
        self.buf, self.pos = buf, pos

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) != 1 else vals[0]

    def raw(self, n: int) -> bytes:
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out


def decode_dtype(r: _Reader):
    """(numpy dtype, element size) of the datatype message at r.pos; a
    variable-length string is the object dtype."""
    cv, b0, b1, _b2, size = r.take("B3BI")
    cls, version = cv & 0x0F, cv >> 4
    if cls == 0:                                    # fixed-point
        r.take("HH")
        if b0 & 0x01:
            raise NotImplementedError("h5: big-endian integers")
        return np.dtype(("i" if b0 & 0x08 else "u") + str(size)), size
    if cls == 1:                                    # floating point
        r.take("HHBBBBI")
        return np.dtype("f" + str(size)), size
    if cls == 6:                                    # compound
        names, types = [], []
        for _ in range(b0 | (b1 << 8)):
            if version < 3:
                start = r.pos
                end = bytes(r.buf[start:start + 256]).index(b"\0")
                names.append(bytes(r.buf[start:start + end]))
                r.pos = start + ((end + 8) // 8) * 8
                if version == 1:
                    r.take("IB3xI4x16x")
                else:
                    r.take("I")
            else:
                end = bytes(r.buf[r.pos:r.pos + 256]).index(b"\0")
                names.append(r.raw(end))
                r.pos += 1
                nb = max(1, (size.bit_length() + 7) // 8)
                r.raw(nb)
            types.append(decode_dtype(r)[0])
        if tuple(names) == _COMPLEX_NAMES and types == [np.dtype("f4")] * 2:
            return np.dtype(np.complex64), size
        if tuple(names) == _COMPLEX_NAMES and types == [np.dtype("f8")] * 2:
            return np.dtype(np.complex128), size
        raise NotImplementedError(f"h5: compound {names}")
    if cls == 8:                                    # enumeration
        n = b0 | (b1 << 8)
        base, _ = decode_dtype(r)
        names = []
        for _ in range(n):
            start = r.pos
            end = bytes(r.buf[start:start + 256]).index(b"\0")
            names.append(bytes(r.buf[start:start + end]))
            r.pos = start + (((end + 8) // 8) * 8 if version < 3 else end + 1)
        r.raw(n * base.itemsize)
        if names == [b"FALSE", b"TRUE"]:
            return np.dtype(np.bool_), size
        raise NotImplementedError(f"h5: enum {names}")
    if cls == 9:                                    # variable-length
        decode_dtype(r)
        if b0 & 0x0F != 1:
            raise NotImplementedError("h5: variable-length sequences")
        return _VLEN_STR, size
    if cls == 3:                                    # fixed-length string
        return np.dtype("S" + str(size)), size
    raise NotImplementedError(f"h5: datatype class {cls}")


# ----------------------------------------------------------------------
# The in-memory objects


class AttributeManager:
    """A group's or dataset's attributes (h5py's ``.attrs``)."""

    def __init__(self, owner):
        self._owner = owner
        self._d: Dict[str, object] = {}

    def create(self, name, data, shape=None, dtype=None):
        if dtype is not None:
            data = np.asarray(data, dtype=dtype)
        self[name] = data

    def __setitem__(self, name, value):
        self._owner._file._check_writable()
        self._d[str(name)] = _attr_value(value)

    def __getitem__(self, name):
        v = self._d[name]
        return v.copy() if isinstance(v, np.ndarray) else v

    def get(self, name, default=None):
        return self[name] if name in self._d else default

    def __contains__(self, name):
        return name in self._d

    def __iter__(self):
        return iter(list(self._d))

    def __len__(self):
        return len(self._d)

    def keys(self):
        return list(self._d)

    def items(self):
        return [(k, self[k]) for k in self._d]


def _attr_value(value):
    """An attribute's value as h5py stores it: str a scalar string, a
    list of str a string array, bool / int / float numpy scalars."""
    if isinstance(value, bytes):
        value = value.decode()
    if isinstance(value, str):
        return value
    arr = np.asarray(value)
    if arr.dtype.kind in "US" or (arr.dtype.kind == "O" and all(
            isinstance(v, (str, bytes)) for v in arr.reshape(-1))):
        out = np.empty(arr.shape, dtype=_VLEN_STR)
        for i, v in enumerate(arr.reshape(-1)):
            out.reshape(-1)[i] = v.decode() if isinstance(v, bytes) else v
        return out
    encode_dtype(arr.dtype)             # refuse what the files never hold
    return arr[()] if arr.ndim == 0 else arr


class _Node:
    def __init__(self, file, name):
        self._file = file
        self.name = name
        self.attrs = AttributeManager(self)


class Group(_Node):
    """A group: children by name, and attributes."""

    def __init__(self, file, name):
        super().__init__(file, name)
        self._children: Dict[str, _Node] = {}

    def _resolve(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._children:
                raise KeyError(f"h5: no object {path!r} in {self.name!r}")
            node = node._children[part]
        return node

    def __getitem__(self, path):
        return self._resolve(path)

    def __contains__(self, path):
        try:
            self._resolve(path)
            return True
        except KeyError:
            return False

    def get(self, path, default=None):
        try:
            return self._resolve(path)
        except KeyError:
            return default

    def keys(self):
        return list(self._children)

    def _add(self, name: str, node):
        self._file._check_writable()
        if "/" in name:
            head, tail = name.rsplit("/", 1)
            return self._resolve(head)._add(tail, node)
        if name in self._children:
            raise ValueError(f"h5: {name!r} exists in {self.name!r}")
        self._children[name] = node
        return node

    def _path(self, name: str) -> str:
        return f"{self.name.rstrip('/')}/{name}"

    def create_group(self, name: str) -> "Group":
        return self._add(name, Group(self._file, self._path(name)))

    def require_group(self, name: str) -> "Group":
        """The group `name`, created if it is missing."""
        node = self.get(name)
        if node is None:
            return self.create_group(name)
        if not isinstance(node, Group):
            raise TypeError(f"h5: {name!r} in {self.name!r} is not a group")
        return node

    def __delitem__(self, path: str):
        """Unlink an object; its space in the file is not reclaimed."""
        self._file._check_writable()
        head, _, tail = path.rstrip("/").rpartition("/")
        parent = self._resolve(head) if head else self
        if not isinstance(parent, Group) or tail not in parent._children:
            raise KeyError(f"h5: no object {path!r} in {self.name!r}")
        del parent._children[tail]

    def create_dataset(self, name, shape=None, dtype=None, data=None,
                       maxshape=None, chunks=None,
                       compression=None) -> "Dataset":
        """A dataset, laid out by h5py's rule: chunked when `chunks`,
        `maxshape` or `compression` is given (`chunks` None or True then
        takes h5py's guess), contiguous otherwise.  `compression` is None
        or "gzip" (deflate at h5py's default level).  `data` fills it;
        a contiguous dataset takes no later write."""
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            if shape is not None and tuple(shape) != data.shape:
                raise ValueError(f"h5: shape {shape} is not the data's "
                                 f"{data.shape}")
            shape, dtype = data.shape, data.dtype
        dtype = np.dtype(dtype if dtype is not None else np.float32)
        encode_dtype(dtype)             # refuse what the files never hold
        shape = tuple(int(s) for s in shape)
        if compression not in (None, "gzip"):
            raise NotImplementedError(f"h5: compression {compression!r}")
        path = self._path(name)
        if chunks is None and maxshape is None and compression is None:
            ds = Dataset(self._file, path, shape, dtype, shape, None)
            ds._full = (np.zeros(shape, dtype) if data is None
                        else np.array(data))
            return self._add(name, ds)
        if not shape:
            raise TypeError("h5: a scalar dataset takes no chunks or filters")
        maxshape = shape if maxshape is None else tuple(
            UNLIMITED if m is None else int(m) for m in maxshape)
        if chunks is None or chunks is True:
            chunks = guess_chunk(shape, dtype.itemsize)
        filters = ((DEFLATE, FILTER_OPTIONAL, (GZIP_LEVEL,)),) \
            if compression else ()
        ds = self._add(name, Dataset(self._file, path, shape, dtype,
                                     maxshape, tuple(int(c) for c in chunks),
                                     filters=filters))
        if data is not None and data.size:
            ds[tuple(slice(None) for _ in shape)] = data
        return ds

    def copy(self, source, dest: "Group", name: Optional[str] = None):
        """Copy the object `source` (a path here, or an object) into the
        group `dest`, of this file or another, as `name` (by default its
        own): groups recursively, datasets with their layout, filters
        and attributes."""
        node = self._resolve(source) if isinstance(source, str) else source
        name = name or node.name.rstrip("/").rsplit("/", 1)[-1]
        if isinstance(node, Dataset):
            if any(f[0] != DEFLATE for f in node._filters):
                raise NotImplementedError(
                    f"h5: copying {node.name}, filtered by "
                    f"{[f[0] for f in node._filters]}")
            out = dest.create_dataset(
                name, data=node[()], chunks=node.chunks,
                maxshape=node.maxshape if node.chunks else None,
                compression="gzip" if node._filters else None)
        else:
            out = dest.create_group(name)
            for child in node.keys():
                node.copy(child, out)
        for k, v in node.attrs._d.items():
            out.attrs[k] = v
        return out


class Dataset(_Node):
    """A dataset.  A chunked one's chunks in the file are indexed by
    their offset; its columns (last axis) from `_flushed` on that are not
    in the file yet are an in-memory buffer.  Writes start at or after
    `_flushed`: an append of whole columns, as the H5 sink makes them,
    sends its whole chunk columns to the file at once; other writes (the
    rows of the small `errors` and `trigger` datasets) stay in the
    buffer until the file closes.  A dataset of a parsed file takes
    writes from the end of its last chunk column on.  A chunk's index
    entry is (address, bytes, filter mask); `_filters` is the filter
    pipeline, (id, flags, values) a filter, applied to each chunk in
    order when it is written and undone in reverse when it is read.  An
    unchunked dataset (h5py's contiguous or compact layout) takes no
    write once created; `_full` holds the data of a compact one and of
    one created here, `_layout` the layout message of one parsed."""

    def __init__(self, file, name, shape, dtype, maxshape, chunks,
                 index=None, filters=()):
        super().__init__(file, name)
        self._filters = tuple(filters)
        self._shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._maxshape = tuple(maxshape)
        self.chunks = None if chunks is None else tuple(chunks)
        self._cs = self.chunks or self._shape   # the chunk shape of the I/O
        self._index: Dict[Tuple[int, ...], Tuple[int, int]] = \
            dict(index or {})
        self._full = None
        self._layout = None
        # leading columns that are chunks: a parsed dataset's written edge
        self._flushed = max((k[-1] + self._cs[-1] for k in self._index),
                            default=0)
        self._hwm = self._end = self._flushed   # written from 0; any write
        self._buf = None                # columns [_flushed, ...) in memory

    @property
    def shape(self):
        return self._shape

    @property
    def maxshape(self):
        return tuple(None if m == UNLIMITED else m for m in self._maxshape)

    @property
    def compression(self):
        return "gzip" if any(f[0] == DEFLATE for f in self._filters) \
            else None

    @property
    def compression_opts(self):
        return next((f[2][0] for f in self._filters if f[0] == DEFLATE),
                    None)

    def _chunk(self, where) -> np.ndarray:
        """The chunk at `where` (its index entry), its filters undone."""
        addr, n, mask = where
        raw = self._file._read(addr, n)
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:           # this filter skipped this chunk
                continue
            fid = self._filters[i][0]
            if fid != DEFLATE:
                raise NotImplementedError(
                    f"h5: {self.name} has filter {fid} "
                    f"({FILTER_NAMES.get(fid, 'unknown')}); only deflate "
                    f"({DEFLATE}) is read")
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, self.dtype).reshape(self._cs)

    def __len__(self):
        return self._shape[0]

    def _check_chunked(self):
        self._file._check_writable()
        if self.chunks is None:
            raise NotImplementedError(
                f"h5: {self.name} is not chunked; only chunked datasets "
                "are written")

    def resize(self, shape):
        self._check_chunked()
        shape = tuple(int(s) for s in shape)
        for s, m in zip(shape, self._maxshape):
            if m != UNLIMITED and s > m:
                raise ValueError(f"h5: {shape} exceeds maxshape "
                                 f"{self.maxshape}")
        if shape[:-1] != self._shape[:-1] and \
                (self._flushed or self._buf is not None):
            if self._flushed:
                raise NotImplementedError(
                    "h5: resizing the leading axes of a streamed dataset")
            buf = np.zeros(shape[:-1] + self._buf.shape[-1:], self.dtype)
            common = tuple(slice(0, min(a, b)) for a, b in
                           zip(shape[:-1], self._shape[:-1]))
            buf[common] = self._buf[common]
            self._buf = buf
        if shape[-1] < self._flushed:
            # the chunks from the cut's chunk column on leave the index;
            # the columns kept of that column go back to the buffer
            edge = shape[-1] - shape[-1] % self._cs[-1]
            kept = self._region(tuple(slice(0, n) for n in self._shape[:-1])
                                + (slice(edge, shape[-1]),))
            self._index = {k: v for k, v in self._index.items()
                           if k[-1] < edge}
            self._flushed = self._hwm = self._end = edge
            self._buf = None
            if shape[-1] > edge:
                self._columns(shape[-1])[..., :shape[-1] - edge] = kept
                self._hwm = self._end = shape[-1]
        elif self._buf is not None:     # what is cut off reads as zeros
            self._buf[..., max(shape[-1] - self._flushed, 0):] = 0
        self._shape = shape
        self._hwm = min(self._hwm, shape[-1])
        self._end = min(self._end, shape[-1])

    def _columns(self, stop: int):
        """The buffer, grown to hold the columns before `stop`."""
        need = stop - self._flushed
        have = 0 if self._buf is None else self._buf.shape[-1]
        if need > have:
            grow = max(need, 2 * have)
            buf = np.zeros(self._shape[:-1] + (grow,), self.dtype)
            if have:
                buf[..., :have] = self._buf
            self._buf = buf
        return self._buf

    def __setitem__(self, key, value):
        self._check_chunked()
        sl = _write_slices(key, self._shape)
        a, b = sl[-1].start, sl[-1].stop
        if a < self._flushed:
            raise NotImplementedError(
                "h5: a write into chunks already in the file")
        value = np.broadcast_to(np.asarray(value, self.dtype),
                                tuple(x.stop - x.start for x in sl))
        full = all(x.start == 0 and x.stop == n
                   for x, n in zip(sl[:-1], self._shape[:-1]))
        if full and a == self._flushed and self._end <= a:
            # an append at the file's edge: whole chunk columns go
            # straight to the file, the rest to the buffer
            c = self._cs[-1]
            k = (b - a) // c * c
            if k:
                self._file._write_chunks(self, value[..., :k], a)
                self._flushed = a + k
                self._buf = None
            if b > a + k:
                self._columns(b)[..., :b - a - k] = value[..., k:]
            self._hwm = self._end = b
            return
        buf = self._columns(b)
        buf[sl[:-1] + (slice(a - self._flushed, b - self._flushed),)] = \
            value
        self._end = max(self._end, b)
        if full and a <= self._hwm:
            self._hwm = max(self._hwm, b)
            self._flush(self._hwm - self._hwm % self._cs[-1])

    def _flush(self, stop: int):
        """Write the buffered columns before `stop` (a multiple of the
        last chunk dimension) to the file as chunks."""
        if stop <= self._flushed:
            return
        n = stop - self._flushed
        self._file._write_chunks(self, self._buf[..., :n], self._flushed)
        self._buf = self._buf[..., n:].copy() if self._buf.shape[-1] > n \
            else None
        self._flushed = stop

    def _finish(self):
        """Write the buffered columns that were written, the last chunks
        padded.  Columns never written get no chunks: they read as zeros,
        as HDF5's chunks allocated on write do."""
        n = min(self._end, self._shape[-1] if self._shape else 0) - \
            self._flushed
        if self._buf is not None and n > 0:
            self._file._write_chunks(self, self._buf[..., :n], self._flushed)
            self._flushed += -(-n // self._cs[-1]) * self._cs[-1]
        self._buf = None

    def _region(self, box: Tuple[slice, ...]) -> np.ndarray:
        """The values in `box` (one slice of step 1 an axis), from the
        chunks that overlap it and the buffer."""
        if self._full is not None:
            return self._full[box].copy()
        out = np.zeros(tuple(s.stop - s.start for s in box), self.dtype)
        if not out.size:
            return out
        cs = self._cs
        grid = [range(s.start // c * c, s.stop, c) for s, c in zip(box, cs)]
        for off in np.ndindex(*(len(g) for g in grid)):
            off = tuple(g[i] for g, i in zip(grid, off))
            where = self._index.get(off)
            if where is None:
                continue
            blk = self._chunk(where)
            lo = [max(s.start, o) for s, o in zip(box, off)]
            hi = [min(s.stop, o + c) for s, o, c in zip(box, off, cs)]
            out[tuple(slice(a - s.start, b - s.start)
                      for a, b, s in zip(lo, hi, box))] = \
                blk[tuple(slice(a - o, b - o)
                          for a, b, o in zip(lo, hi, off))]
        if self._buf is not None:
            a = max(box[-1].start, self._flushed)
            b = min(box[-1].stop, self._flushed + self._buf.shape[-1])
            if b > a:
                out[..., a - box[-1].start:b - box[-1].start] = \
                    self._buf[box[:-1] + (slice(a - self._flushed,
                                                b - self._flushed),)]
        return out

    def __getitem__(self, key):
        """Reads only the chunks that the selection overlaps."""
        box, local = _read_box(key, self._shape)
        return self._region(box)[local]

    def __array__(self, dtype=None, copy=None):
        out = self._region(tuple(slice(0, n) for n in self._shape))
        return out if dtype is None else out.astype(dtype)


def _write_slices(key, shape) -> Tuple[slice, ...]:
    """A write's key as one slice a dimension (ints and slices of step
    1, as the sink writes them)."""
    if not isinstance(key, tuple):
        key = (key,)
    key = key + (slice(None),) * (len(shape) - len(key))
    out = []
    for k, n in zip(key, shape):
        if isinstance(k, (int, np.integer)):
            k = int(k) + (n if k < 0 else 0)
            out.append(slice(k, k + 1))
        elif isinstance(k, slice) and k.step in (None, 1):
            a, b, _ = k.indices(n)
            out.append(slice(a, max(a, b)))
        else:
            raise NotImplementedError(f"h5: write key {k!r}")
    return tuple(out)


def _read_box(key, shape):
    """(box, local): the smallest box (one slice of step 1 an axis) that
    holds a read's selection, and the key that selects it from the box.
    Ints, slices, Ellipsis and integer index arrays are bounded; any
    other key reads the whole dataset."""
    whole = tuple(slice(0, n) for n in shape)
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        i = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + \
            key[i + 1:]
    if len(key) > len(shape):
        return whole, key
    key = key + (slice(None),) * (len(shape) - len(key))
    box, local = [], []
    for k, n in zip(key, shape):
        if isinstance(k, (int, np.integer)):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"h5: index {k} out of range for {n}")
            box.append(slice(i, i + 1))
            local.append(0)
        elif isinstance(k, slice):
            r = range(*k.indices(n))
            if not r:
                box.append(slice(0, 0))
                local.append(slice(0, 0))
                continue
            lo = min(r[0], r[-1])
            box.append(slice(lo, max(r[0], r[-1]) + 1))
            local.append(slice(r[0] - lo, None if r.step < 0 else
                               r[-1] - lo + 1, r.step))
        else:
            idx = np.asarray(k)
            if idx.dtype.kind not in "iu" or not idx.size:
                return whole, key
            idx = np.where(idx < 0, idx + n, idx)
            if idx.min() < 0 or idx.max() >= n:
                raise IndexError(f"h5: index {k} out of range for {n}")
            box.append(slice(int(idx.min()), int(idx.max()) + 1))
            local.append(idx - int(idx.min()))
    return tuple(box), tuple(local)


# ----------------------------------------------------------------------
# Files


class _State:
    """What the handles to one file share: its objects, the OS file, and
    the end of the file, where new chunks and metadata go.  Every object
    of the file does its I/O through it."""

    def __init__(self, path: str, fh, writable: bool):
        self.path, self.fh, self.writable = path, fh, writable
        self.root: Optional[Group] = None
        self.eof, self.dirty, self.handles = 0, False, 0

    def _check_writable(self):
        if not self.writable:
            raise OSError(f"h5: {self.path} is open read-only")
        self.dirty = True

    def _read(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        return self.fh.read(n)

    def _append(self, data) -> int:
        addr = self.eof
        self.fh.seek(addr)
        self.fh.write(data)
        self.eof = addr + memoryview(data).nbytes
        return addr

    def _write_chunks(self, ds: "Dataset", cols: np.ndarray, col0: int):
        """Cut `cols` (every leading index; columns from col0, a multiple
        of the last chunk dimension) into chunks, the edge ones padded
        with zeros, append them in one write and index them."""
        cs = ds._cs
        grid = tuple(-(-n // c) for n, c in zip(cols.shape, cs))
        if not all(grid):
            return
        nd = len(cs)
        edge = any(n % c for n, c in zip(cols.shape, cs))
        blocks = (np.zeros if edge else np.empty)(grid + cs, ds.dtype)
        if nd == 2 and not cols.shape[1] % cs[1]:
            # rows of chunks: the whole ones, then the edge one
            (n0, _), (c0, c1) = cols.shape, cs
            g0, g1 = n0 // c0, grid[1]
            blocks[:g0] = cols[:g0 * c0].reshape(g0, c0, g1, c1).transpose(
                0, 2, 1, 3)
            if n0 % c0:
                blocks[g0, :, :n0 % c0] = cols[g0 * c0:].reshape(
                    n0 % c0, g1, c1).transpose(1, 0, 2)
        else:
            padded = np.zeros(tuple(g * c for g, c in zip(grid, cs)),
                              ds.dtype)
            padded[tuple(slice(0, n) for n in cols.shape)] = cols
            blocks[...] = padded.reshape(tuple(
                x for g, c in zip(grid, cs) for x in (g, c))).transpose(
                tuple(range(0, 2 * nd, 2)) + tuple(range(1, 2 * nd, 2)))
        offs = [tuple(i * c for i, c in zip(idx, cs))
                for idx in np.ndindex(*grid)]
        data = blocks.reshape(-1).view(np.uint8)
        sizes = [int(np.prod(cs)) * ds.dtype.itemsize] * len(offs)
        if ds._filters:                 # deflate each chunk on its own
            if [f[0] for f in ds._filters] != [DEFLATE]:
                raise NotImplementedError(
                    f"h5: writing {ds.name}, filtered by "
                    f"{[f[0] for f in ds._filters]}")
            packed = [zlib.compress(b.tobytes(), ds.compression_opts)
                      for b in blocks.reshape((-1,) + cs)]
            data, sizes = b"".join(packed), [len(b) for b in packed]
        at = self._append(data)
        for off, n in zip(offs, sizes):
            ds._index[off[:-1] + (off[-1] + col0,)] = (at, n, 0)
            at += n

    def close(self):
        try:
            if self.writable and self.dirty:
                _write_metadata(self)
        finally:
            self.fh.close()


_OPEN: Dict[str, _State] = {}


class File(Group):
    """An HDF5 file (h5py.File's interface): mode "r" reads, "w"
    creates, "a" reads and writes (creating it if missing), "r+" reads
    and writes."""

    def __init__(self, name, mode: str = "r"):
        path = os.path.realpath(os.fspath(name))
        self.filename = os.fspath(name)
        st = _OPEN.get(path)
        if st is not None:
            if mode == "w":
                raise OSError(f"h5: {name} is open")
            if mode != "r" and not st.writable:
                raise OSError(f"h5: {name} is open read-only")
        elif mode == "w" or (mode == "a" and not os.path.exists(path)):
            st = _State(path, open(path, "w+b"), True)
            st.root = Group(st, "/")
            st._append(b"\0" * SUPERBLOCK_BYTES)
            st.dirty = True
        elif mode in ("r", "a", "r+"):
            st = _State(path, open(path, "rb" if mode == "r" else "r+b"),
                        mode != "r")
            try:
                st.root, st.eof = _parse(st)
            except BaseException:
                st.fh.close()
                raise
        else:
            raise ValueError(f"h5: mode {mode!r}")
        st.handles += 1
        _OPEN[path] = st
        self._state = st
        self._file = st
        self.name = "/"
        self._children = st.root._children
        self.attrs = st.root.attrs

    def close(self):
        st = getattr(self, "_state", None)
        if st is None:
            return
        self._state = None
        st.handles -= 1
        if st.handles == 0:
            del _OPEN[st.path]
            st.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ----------------------------------------------------------------------
# Writing the metadata


class _Heap:
    """A global heap collection of variable-length strings."""

    def __init__(self):
        self.objects: List[bytes] = []

    def add(self, s: str) -> int:
        self.objects.append(s.encode())
        return len(self.objects)

    def encode(self) -> bytes:
        body = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(o)) + _pad8(o)
                        for i, o in enumerate(self.objects))
        size = max(4096, 16 + len(body) + 16)
        free = size - 16 - len(body)
        return (b"GCOL" + struct.pack("<B3xQ", 1, size) + body +
                struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16))


def _dataspace(shape, maxshape=None) -> bytes:
    out = struct.pack("<BBB5x", 1, len(shape), 1 if maxshape else 0)
    out += b"".join(struct.pack("<Q", int(n)) for n in shape)
    if maxshape:
        out += b"".join(struct.pack("<Q", int(m)) for m in maxshape)
    return out


def _message(kind: int, data: bytes) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", kind, len(data), 0) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _attribute(name: str, value, heap_addr_of) -> bytes:
    if isinstance(value, str):
        arr = np.empty((), dtype=_VLEN_STR)
        arr[()] = value
    else:
        arr = np.asarray(value)
        if arr.dtype.kind == "O":
            arr = arr.astype(_VLEN_STR)
    dt = encode_dtype(arr.dtype)
    ds = _dataspace(arr.shape)
    if arr.dtype.kind == "O":
        data = b"".join(heap_addr_of(str(v)) for v in arr.reshape(-1))
    else:
        data = np.ascontiguousarray(arr).astype(
            arr.dtype.newbyteorder("<")).tobytes()
    nm = name.encode() + b"\0"
    return _message(0x000C, struct.pack("<BBHHH", 1, 0, len(nm), len(dt),
                                        len(ds)) +
                    _pad8(nm) + _pad8(dt) + _pad8(ds) + data)


def _chunk_btree(file: _State, ds: Dataset) -> int:
    """Write the v1 B-tree of `ds`'s chunks; its root's address."""
    nd = len(ds._cs) + 1
    keys = sorted(k for k in ds._index
                  if all(o < n for o, n in zip(k, ds._shape)))
    if not keys:
        return UNDEF
    key_fmt = "<II" + "Q" * nd

    def key(off, nbytes, mask=0):
        return struct.pack(key_fmt, nbytes, mask, *off, 0)

    def right(off):
        return tuple(o + c for o, c in zip(off, ds._cs))

    width = 2 * CHUNK_K
    node_bytes = 24 + (width + 1) * struct.calcsize(key_fmt) + width * 8
    # level 0: (first offset, last offset's right key, address) per node
    level = []
    entries = [(k, ds._index[k]) for k in keys]
    for i in range(0, len(entries), width):
        part = entries[i:i + width]
        body = b"".join(key(off, nb, mask) + struct.pack("<Q", addr)
                        for off, (addr, nb, mask) in part)
        body += key(right(part[-1][0]), 0)
        level.append((part[0][0], right(part[-1][0]), part[0][1][1],
                      b"TREE" + struct.pack("<BBHQQ", 1, 0, len(part),
                                            UNDEF, UNDEF) + body))
    depth = 0
    while True:
        addrs = []
        for first, last, nb, raw in level:
            addrs.append((first, last, nb,
                          file._append(raw + b"\0" * (node_bytes -
                                                      len(raw)))))
        if len(addrs) == 1:
            return addrs[0][3]
        depth += 1
        nxt = []
        for i in range(0, len(addrs), width):
            part = addrs[i:i + width]
            body = b"".join(key(first, nb) + struct.pack("<Q", a)
                            for first, _l, nb, a in part)
            body += key(part[-1][1], 0)
            nxt.append((part[0][0], part[-1][1], part[0][2],
                        b"TREE" + struct.pack("<BBHQQ", 1, depth, len(part),
                                              UNDEF, UNDEF) + body))
        level = nxt


def _filter_pipeline(filters) -> bytes:
    """A version-1 filter pipeline message's data (no filter names)."""
    out = struct.pack("<BB6x", 1, len(filters))
    for fid, flags, values in filters:
        out += struct.pack("<HHHH", fid, 0, flags, len(values))
        out += b"".join(struct.pack("<I", v) for v in values)
        out += b"\0" * (4 * (len(values) % 2))
    return out


def _contiguous_layout(file: _State, ds: Dataset) -> bytes:
    """Append a contiguous dataset's data; its layout message."""
    raw = np.ascontiguousarray(ds._full).tobytes()
    addr = file._append(raw) if raw else UNDEF
    return _message(0x0008, struct.pack("<BBQQ", 3, 1, addr, len(raw)))


def _write_dataset(file: _State, ds: Dataset, heap) -> int:
    ds._finish()
    item = ds.dtype.itemsize
    if ds.chunks is not None:
        layout = _message(
            0x0008, struct.pack("<BBBQ", 3, 2, len(ds._cs) + 1,
                                _chunk_btree(file, ds)) +
            b"".join(struct.pack("<I", c) for c in ds._cs) +
            struct.pack("<I", item))
    else:
        layout = ds._layout or _contiguous_layout(file, ds)
    # fill value: allocated incrementally (chunked) or late (contiguous)
    alloc = 3 if ds.chunks is not None else 2
    msgs = [
        _message(0x0001, _dataspace(ds._shape, ds._maxshape)),
        _message(0x0003, encode_dtype(ds.dtype)),
        _message(0x0005, struct.pack("<BBBBI", 2, alloc, 2, 1, item) +
                 b"\0" * item),
    ] + ([_message(0x000B, _filter_pipeline(ds._filters))]
         if ds._filters else []) + [layout] + \
        [_attribute(k, v, heap) for k, v in ds.attrs._d.items()]
    return file._append(_object_header(msgs))


def _write_group(file: _State, g: Group, heap) -> Tuple[int, int, int]:
    """Write a group's children, then the group: (object header, B-tree,
    local heap) addresses."""
    names = sorted(g._children)             # symbol nodes keep name order
    children = {}
    for n in names:
        c = g._children[n]
        children[n] = (_write_dataset(file, c, heap)
                       if isinstance(c, Dataset)
                       else _write_group(file, c, heap)[0])
    seg, offs = bytearray(b"\0" * 8), {}
    for n in names:
        offs[n] = len(seg)
        seg += _pad8(n.encode() + b"\0")
    seg += struct.pack("<QQ", FREE_NULL, 16)      # one free block
    free_at = len(seg) - 16
    seg_addr = file._append(bytes(seg))
    local_heap = file._append(b"HEAP" + struct.pack(
        "<B3xQQQ", 0, len(seg), free_at, seg_addr))
    tree_addr = _group_btree(file, names, offs, children)
    msgs = [_message(0x0011, struct.pack("<QQ", tree_addr, local_heap))] + \
        [_attribute(k, v, heap) for k, v in g.attrs._d.items()]
    return file._append(_object_header(msgs)), tree_addr, local_heap


def _group_btree(file: _State, names, offs, children) -> int:
    """Write a group's symbol table nodes (up to 2 * LEAF_K names each,
    in name order) and the v1 B-tree over them; its root's address.  A
    child's keys bound its names: the heap offset of the last name
    before it (0, the empty name, for the first) and of its own last."""
    width = 2 * GROUP_K
    node_bytes = 24 + (width + 1) * 8 + width * 8

    def node(level, part):
        body = b"".join(struct.pack("<QQ", lo, addr)
                        for lo, _hi, addr in part)
        raw = b"TREE" + struct.pack("<BBHQQ", 0, level, len(part), UNDEF,
                                    UNDEF) + body
        if part:
            raw += struct.pack("<Q", part[-1][1])
        return file._append(raw + b"\0" * (node_bytes - len(raw)))

    level, lo = [], 0
    for i in range(0, len(names), 2 * LEAF_K):
        part = names[i:i + 2 * LEAF_K]
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + b"".join(
            struct.pack("<QQI4x16x", offs[n], children[n], 0) for n in part)
        snod += b"\0" * (8 + 2 * LEAF_K * 40 - len(snod))
        level.append((lo, offs[part[-1]], file._append(snod)))
        lo = offs[part[-1]]
    depth = 0
    while True:
        nodes = [(part[0][0], part[-1][1], node(depth, part))
                 for part in (level[i:i + width]
                              for i in range(0, len(level), width))] \
            or [(0, 0, node(0, []))]
        if len(nodes) == 1:
            return nodes[0][2]
        level, depth = nodes, depth + 1


def _write_metadata(st: _State) -> None:
    """Write the remaining data, every object's metadata and the global
    heap of the strings at the end of the file, then the superblock."""
    strings: List[str] = []

    def collect(node):
        for v in node.attrs._d.values():
            if isinstance(v, str):
                strings.append(v)
            elif isinstance(v, np.ndarray) and v.dtype.kind == "O":
                strings.extend(str(s) for s in v.reshape(-1))
        if isinstance(node, Group):
            for c in node._children.values():
                collect(c)
    collect(st.root)
    heap, heap_ids = _Heap(), {}
    for s in strings:
        if s not in heap_ids:
            heap_ids[s] = heap.add(s)
    heap_addr = st._append(heap.encode()) if strings else UNDEF

    def vlen(s: str) -> bytes:
        return struct.pack("<IQI", len(s.encode()), heap_addr, heap_ids[s])

    root_oh, tree, lheap = _write_group(st, st.root, vlen)
    eof = st.eof
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                 LEAF_K, GROUP_K, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
    sb += struct.pack("<QQI4xQQ", 0, root_oh, 1, tree, lheap)
    st.fh.seek(0)
    st.fh.write(sb)
    st.fh.flush()


# ----------------------------------------------------------------------
# Reading a file


def _parse(st: _State):
    """The root group of the file of `st` and its end address."""
    size = os.fstat(st.fh.fileno()).st_size
    if size < SUPERBLOCK_BYTES:
        raise OSError(f"h5: {st.path} is not an HDF5 file")
    with mmap.mmap(st.fh.fileno(), 0, access=mmap.ACCESS_READ) as buf:
        if buf[:8] != SIGNATURE:
            raise OSError(f"h5: {st.path} is not an HDF5 file")
        r = _Reader(buf, 8)
        version = r.take("B")
        if version not in (0, 1):
            raise NotImplementedError(f"h5: superblock version {version}")
        r.take("BBBB")
        if r.take("BB") != (8, 8):
            raise NotImplementedError("h5: offsets or lengths not 8 bytes")
        r.take("BHHI")
        if version == 1:
            r.take("H2x")
        _base, _free, eof, _drv = r.take("QQQQ")
        _name, root_addr = r.take("QQ")
        root = _read_object(buf, root_addr, Group(st, "/"), st, {})
    return root, max(eof, size)


def _messages(buf, addr: int):
    """(type, data offset, size) of each message of a v1 object header,
    continuation blocks followed."""
    r = _Reader(buf, addr)
    version, _res, n, _refs, size = r.take("BBHII")
    if version != 1:
        raise NotImplementedError(f"h5: object header version {version}")
    blocks = [(addr + 16, size)]
    out = []
    while blocks and len(out) < n:
        start, length = blocks.pop(0)
        pos = start
        while pos + 8 <= start + length and len(out) < n:
            kind, msize, _flags = struct.unpack_from("<HHB", buf, pos)
            out.append((kind, pos + 8, msize))
            if kind == 0x0010:
                caddr, clen = struct.unpack_from("<QQ", buf, pos + 8)
                blocks.append((caddr, clen))
            pos += 8 + msize
    return out


def _read_dataspace(r: _Reader):
    version, rank, flags = r.take("BBB")
    if version == 1:
        r.take("5x")
    elif version == 2:
        r.take("B")
    else:
        raise NotImplementedError(f"h5: dataspace version {version}")
    dims = tuple(r.take("Q") for _ in range(rank))
    maxd = tuple(r.take("Q") for _ in range(rank)) if flags & 1 else dims
    return dims, maxd


def _read_vlen(buf, n, r: _Reader, cache) -> List[str]:
    out = []
    for _ in range(n):
        length, coll, idx = r.take("IQI")
        if coll not in cache:
            cache[coll] = _global_heap(buf, coll)
        out.append(cache[coll].get(idx, b"")[:length].decode("utf-8"))
    return out


def _global_heap(buf, addr) -> Dict[int, bytes]:
    if buf[addr:addr + 4] != b"GCOL":
        raise OSError("h5: bad global heap")
    size = struct.unpack_from("<Q", buf, addr + 8)[0]
    pos, end, objs = addr + 16, addr + size, {}
    while pos + 16 <= end:
        idx, _ref, osize = struct.unpack_from("<HH4xQ", buf, pos)
        if idx == 0:
            break
        objs[idx] = bytes(buf[pos + 16:pos + 16 + osize])
        pos += 16 + osize + (-osize % 8)
    return objs


def _read_attribute(buf, off, cache):
    r = _Reader(buf, off)
    version = r.take("B")
    if version == 1:
        r.take("x")
        nsize, tsize, ssize = r.take("HHH")
        name = r.raw(nsize).rstrip(b"\0").decode()
        r.pos += -nsize % 8
        t0 = r.pos
        dt, esize = decode_dtype(r)
        r.pos = t0 + tsize + (-tsize % 8)
        s0 = r.pos
        dims, _ = _read_dataspace(r)
        r.pos = s0 + ssize + (-ssize % 8)
    elif version in (2, 3):
        r.take("B")
        nsize, tsize, ssize = r.take("HHH")
        if version == 3:
            r.take("B")
        name = r.raw(nsize).rstrip(b"\0").decode()
        t0 = r.pos
        dt, esize = decode_dtype(r)
        r.pos = t0 + tsize
        s0 = r.pos
        dims, _ = _read_dataspace(r)
        r.pos = s0 + ssize
    else:
        raise NotImplementedError(f"h5: attribute version {version}")
    n = int(np.prod(dims)) if dims else 1
    if dt.kind == "O":
        vals = _read_vlen(buf, n, r, cache)
        if not dims:
            return name, vals[0]
        arr = np.empty(n, dtype=_VLEN_STR)
        arr[:] = vals
        return name, arr.reshape(dims)
    arr = np.frombuffer(buf, dtype=dt.newbyteorder("<") if dt.kind != "b"
                        else np.bool_, count=n, offset=r.pos).astype(dt)
    return name, (arr.reshape(dims) if dims else arr[0])


def _read_object(buf, addr, node, file, cache):
    """Fill `node` (a Group) from the object header at `addr`; return
    it, or the Dataset the header describes."""
    msgs = _messages(buf, addr)
    kinds = {k for k, _o, _s in msgs}
    attrs = []
    for kind, off, _size in msgs:
        if kind == 0x000C:
            attrs.append(_read_attribute(buf, off, cache))
    if 0x0008 in kinds:                         # a dataset
        shape = maxshape = dt = None
        chunks, btree, layout = None, UNDEF, 2
        contiguous, compact, filters = (UNDEF, 0), b"", ()
        for kind, off, _size in msgs:
            r = _Reader(buf, off)
            if kind == 0x0001:
                shape, maxshape = _read_dataspace(r)
            elif kind == 0x0003:
                dt, _ = decode_dtype(r)
            elif kind == 0x000B:
                filters = _read_filters(r)
            elif kind == 0x0008:
                version, cls = r.take("BB")
                if version != 3:
                    raise NotImplementedError(f"h5: layout version {version}")
                layout = cls
                if cls == 2:                    # chunked
                    nd = r.take("B")
                    btree = r.take("Q")
                    chunks = tuple(r.take("I") for _ in range(nd))[:-1]
                elif cls == 1:                  # contiguous
                    contiguous = r.take("QQ")
                elif cls == 0:                  # compact
                    n = r.take("H")
                    compact = r.raw(n)
        index, full = {}, None
        if layout == 2 and btree != UNDEF:
            _read_chunk_tree(buf, btree, len(chunks) + 1, index)
        elif layout == 1 and shape and contiguous[0] != UNDEF:
            index[(0,) * len(shape)] = contiguous + (0,)    # one chunk
        elif layout != 2:
            n = int(np.prod(shape)) * dt.itemsize
            raw = (compact if layout == 0 else bytes(
                buf[contiguous[0]:contiguous[0] + n])
                if contiguous[0] != UNDEF else b"\0" * n)
            full = np.frombuffer(raw, dt.newbyteorder("<"),
                                 int(np.prod(shape))).astype(dt).reshape(
                                     shape)
        ds = Dataset(file, node.name, shape, dt, maxshape,
                     chunks if layout == 2 else None, index, filters)
        ds._full = full
        if layout != 2:                 # kept as it is when rewritten
            ds._layout = next(_message(0x0008, bytes(buf[o:o + n]))
                              for k, o, n in msgs if k == 0x0008)
        for k, v in attrs:
            ds.attrs._d[k] = v
        return ds
    for k, v in attrs:
        node.attrs._d[k] = v
    for kind, off, _size in msgs:
        if kind == 0x0011:
            tree, heap = struct.unpack_from("<QQ", buf, off)
            seg = _local_heap(buf, heap)
            for name, child_addr in _group_entries(buf, tree, seg):
                child = Group(file, f"{node.name.rstrip('/')}/{name}")
                node._children[name] = _read_object(buf, child_addr, child,
                                                    file, cache)
    return node


def _read_filters(r: _Reader):
    """The filters, (id, flags, client values) each, of a filter
    pipeline message of version 1 or 2."""
    version, n = r.take("BB")
    if version == 1:
        r.take("6x")
    elif version != 2:
        raise NotImplementedError(f"h5: filter pipeline version {version}")
    out = []
    for _ in range(n):
        fid = r.take("H")
        name_len = r.take("H") if version == 1 or fid >= 256 else 0
        flags, nvals = r.take("HH")
        r.raw(name_len + (-name_len % 8 if version == 1 else 0))
        vals = tuple(r.take("I") for _ in range(nvals))
        if version == 1 and nvals % 2:
            r.take("4x")
        out.append((fid, flags, vals))
    return tuple(out)


def _local_heap(buf, addr) -> bytes:
    if buf[addr:addr + 4] != b"HEAP":
        raise OSError("h5: bad local heap")
    size, _free, seg = struct.unpack_from("<QQQ", buf, addr + 8)
    return bytes(buf[seg:seg + size])


def _cstr(seg: bytes, off: int) -> str:
    return seg[off:seg.index(b"\0", off)].decode()


def _group_entries(buf, addr, seg):
    if buf[addr:addr + 4] != b"TREE":
        raise OSError("h5: bad group B-tree")
    _type, level, n = struct.unpack_from("<BBH", buf, addr + 4)
    pos = addr + 24
    for i in range(n):
        child = struct.unpack_from("<Q", buf, pos + 8)[0]
        pos += 16
        if level > 0:
            yield from _group_entries(buf, child, seg)
            continue
        if buf[child:child + 4] != b"SNOD":
            raise OSError("h5: bad symbol table node")
        count = struct.unpack_from("<H", buf, child + 6)[0]
        for j in range(count):
            name_off, oh = struct.unpack_from("<QQ", buf, child + 8 + 40 * j)
            yield _cstr(seg, name_off), oh


def _read_chunk_tree(buf, addr, nd, index):
    if buf[addr:addr + 4] != b"TREE":
        raise OSError("h5: bad chunk B-tree")
    _type, level, n = struct.unpack_from("<BBH", buf, addr + 4)
    ksize = 8 + 8 * nd
    pos = addr + 24
    for _ in range(n):
        vals = struct.unpack_from("<II" + "Q" * nd, buf, pos)
        child = struct.unpack_from("<Q", buf, pos + ksize)[0]
        pos += ksize + 8
        if level > 0:
            _read_chunk_tree(buf, child, nd, index)
        else:
            index[tuple(vals[2:2 + nd - 1])] = (child, vals[0], vals[1])

