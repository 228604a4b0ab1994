"""HDF5 measurement files, the reference-compatible schema (a copy of
gpu_sdr_tpu/client/files.py, on the port's params and sinks).

The file layer of the reference client (pyUSRP/USRP_files.py): the
``raw_data<N>/<antenna>`` group layout with every measurement parameter
as attributes, a resizable complex64 ``data`` dataset of shape
(n_channels, samples), an ``errors`` dataset, and the analysis groups
(``VNA_<N>``, ``Noise<N>``, ``Resonators``, ``delay_info``).  A file
written here reads the same through either package's readers, and
pyUSRP-style tooling opens it unchanged.  The HDF5 reading and writing
is client/h5.py's (h5py's interface, in numpy), so the port needs
neither h5py nor the HDF5 library.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from . import h5
from ..params import ANTENNA_NAMES, AntennaParams, AntMode, UsrpParams, WaveType
from ..engine.sinks import PacketMeta, Sink

H5PY_compression = "gzip"


def format_filename(filename: str) -> str:
    return os.path.splitext(filename)[0] + ".h5"


def bound_open(filename: str):
    """Open an H5 file read-only (reference bound_open,
    pyUSRP/USRP_files.py:50-59)."""
    return h5.File(format_filename(filename), "r")


def chk_multi_usrp(h5file) -> int:
    return sum(1 for k in h5file.keys() if k.startswith("raw_data"))


def get_receivers(group) -> List[str]:
    return [k for k in group.keys()
            if _attr_str(group[k].attrs.get("mode")) == "RX"]


def _attr_str(v):
    if isinstance(v, bytes):
        return v.decode()
    return v


# ----------------------------------------------------------------------
# Parameter <-> file attribute mirror
# ----------------------------------------------------------------------

_SCALAR_KEYS = ("mode", "rate", "rf", "gain", "bw", "samples", "delay",
                "burst_on", "burst_off", "buffer_len", "decim", "fft_tones",
                "pf_average", "tuning_mode", "data_mem_mult")
_LIST_KEYS = ("freq", "wave_type", "ampl", "chirp_f", "chirp_t", "swipe_s")


def _write_param_attrs(group, p: AntennaParams) -> None:
    """Write every parameter as a group attribute (Param_to_H5 writes the
    full parameter dict per antenna, pyUSRP/USRP_files.py:973-979)."""
    d = p.to_json_dict()
    for k in _SCALAR_KEYS:
        group.attrs.create(k, d[k])
    group.attrs.create("freq", np.asarray(d["freq"], dtype=np.int64))
    group.attrs.create("wave_type",
                       np.asarray(d["wave_type"], dtype=h5.string_dtype()))
    group.attrs.create("ampl", np.asarray(d["ampl"], dtype=np.float64))
    group.attrs.create("chirp_f", np.asarray(d["chirp_f"], dtype=np.int64))
    group.attrs.create("chirp_t", np.asarray(d["chirp_t"], dtype=np.float64))
    group.attrs.create("swipe_s", np.asarray(d["swipe_s"], dtype=np.int64))


def _read_param_attrs(group) -> AntennaParams:
    a = group.attrs
    wt = [_attr_str(w) for w in np.atleast_1d(a.get("wave_type", []))]
    return AntennaParams(
        mode=AntMode(_attr_str(a.get("mode", "OFF"))),
        rate=int(a.get("rate", 0) or 0),
        tone=int(a.get("rf", 0) or 0),
        gain=int(a.get("gain", 0) or 0),
        bw=int(a.get("bw", 0) or 0),
        samples=int(a.get("samples", 0) or 0),
        delay=float(a.get("delay", 0.0) or 0.0),
        burst_on=float(a.get("burst_on", 0.0) or 0.0),
        burst_off=float(a.get("burst_off", 0.0) or 0.0),
        buffer_len=int(a.get("buffer_len", 0) or 0),
        tuning_mode=int(a.get("tuning_mode", 1) or 0),
        decim=int(a.get("decim", 0) or 0),
        fft_tones=int(a.get("fft_tones", 0) or 0),
        pf_average=int(a.get("pf_average", 4) or 4),
        data_mem_mult=int(a.get("data_mem_mult", 1) or 1),
        freq=[int(x) for x in np.atleast_1d(a.get("freq", []))],
        wave_type=[WaveType(w) for w in wt if w in WaveType._value2member_map_],
        ampl=[float(x) for x in np.atleast_1d(a.get("ampl", []))],
        chirp_f=[int(x) for x in np.atleast_1d(a.get("chirp_f", []))],
        chirp_t=[float(x) for x in np.atleast_1d(a.get("chirp_t", []))],
        swipe_s=[int(x) for x in np.atleast_1d(a.get("swipe_s", []))],
    )


def expected_data_len(p: AntennaParams) -> int:
    """Forecast the per-channel dataset length (Param_to_H5 sizing rules,
    pyUSRP/USRP_files.py:985-1014 — note CHIRP uses swipe_s/decim)."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    if w == WaveType.TONES:
        return int(np.ceil(p.samples / (p.fft_tones * max(p.decim, 1))))
    if w == WaveType.CHIRP:
        if p.decim == 0:
            return int(p.samples)
        return int(p.swipe_s[0] // p.decim)
    if w == WaveType.NOISE:
        return int(np.ceil(p.samples / max(p.decim, 1)))
    if w == WaveType.DIRECT:
        return int(p.samples // max(p.decim, 1))
    return int(p.samples)


def params_to_h5(h5fp, params: UsrpParams, trigger=None, **tags) -> List[str]:
    """Create the raw_data<N> group structure for a measurement
    (reference Param_to_H5, pyUSRP/USRP_files.py:948-1035).

    Returns the list of RX antenna group names to be filled with data.
    """
    params.validate()
    usrp_group = h5fp.create_group(f"raw_data{int(params.usrp_number)}")
    for tag, value in tags.items():
        usrp_group.attrs.create(tag, value)

    rx_names = []
    for name, p in params.active_antennas():
        g = usrp_group.create_group(name)
        _write_param_attrs(g, p)
        if p.mode == AntMode.RX:
            rx_names.append(name)
            n_chan = p.n_channels()
            w0 = p.wave_type[0] if p.wave_type else None
            if w0 is not None and any(w != w0 for w in p.wave_type):
                # mixed-mode antenna: `data` carries the FIRST group's
                # channels; the others get mixed_<k> datasets (H5Sink)
                n_chan = sum(1 for w in p.wave_type if w == w0)
            data_len = 0 if trigger is not None else expected_data_len(p)
            g.create_dataset("data", (n_chan, data_len), dtype=np.complex64,
                             maxshape=(None, None), chunks=True)
            g.create_dataset("errors", (0, 0), dtype=np.int64,
                             maxshape=(None, None))
            if trigger is not None:
                tds = g.create_dataset("trigger", shape=(0,), dtype=np.int64,
                                       maxshape=(None,), chunks=True)
                tds.attrs.create("trigger_fcn",
                                 data=str(trigger.__class__.__name__))
                trigger.dataset_init(g)
    return rx_names


def retrieve_params_from_file(filename: str,
                              usrp_number: int = 0) -> UsrpParams:
    """Rebuild the parameter set from file attributes
    (reference global_parameter.retrive_prop_from_file,
    pyUSRP/USRP_files.py:806-909)."""
    with bound_open(filename) as f:
        group = f[f"raw_data{int(usrp_number)}"]
        kwargs = {"usrp_number": int(usrp_number)}
        for name in ANTENNA_NAMES:
            if name in group:
                kwargs[name] = _read_param_attrs(group[name])
        return UsrpParams(**kwargs)


def get_rx_info(filename: str, ant: Optional[str] = None) -> AntennaParams:
    params = retrieve_params_from_file(filename)
    if ant is None:
        for name, p in params.active_antennas(AntMode.RX):
            return p
        raise KeyError("no RX antenna in file")
    return params.antenna(ant)


def get_tx_info(filename: str, ant: Optional[str] = None) -> AntennaParams:
    params = retrieve_params_from_file(filename)
    if ant is None:
        for name, p in params.active_antennas(AntMode.TX):
            return p
        raise KeyError("no TX antenna in file")
    return params.antenna(ant)


def openH5file(filename: str, ch_list=None, start_sample=None,
               last_sample=None, usrp_number: int = 0,
               front_end: Optional[str] = None, error_coord: bool = False,
               big_file: bool = False, dataset: str = "data"):
    """Read raw demodulated data: returns data[channel][sample]
    (reference openH5file, pyUSRP/USRP_files.py:116-336; implements the
    "new mode" resizable-dataset layout this framework writes).

    `dataset` selects a mixed-mode sub-stream ("mixed_<k>"; see
    mixed_streams)."""
    f = bound_open(filename)
    group = f[f"raw_data{int(usrp_number)}"]
    recv = get_receivers(group)
    if not recv:
        f.close()
        raise KeyError("no RX data in file")
    sub = group[front_end if front_end is not None else recv[0]]

    if "data" not in sub and "dataset_1" in sub:
        # "old mode": one dataset per packet, as written by the reference
        # *server-side* H5 writer (cpp/USRP_file_writer.cpp:249-341;
        # read path openH5file old_mode, pyUSRP/USRP_files.py:244-300)
        pieces, err_index, errors, idx = [], [], 0, 1
        while f"dataset_{idx}" in sub:
            ds = sub[f"dataset_{idx}"]
            e = int(ds.attrs.get("errors", 0) or 0)
            if e:
                err_index.append((sum(p.shape[1] for p in pieces),
                                  sum(p.shape[1] for p in pieces)
                                  + ds.shape[1]))
                errors += e
            pieces.append(ds[:])
            idx += 1
        data = np.concatenate(pieces, axis=1)
        n_chan = data.shape[0]
        if ch_list is None:
            ch_list = list(range(n_chan))
        s0 = int(start_sample or 0)
        s1 = int(last_sample) if last_sample is not None else data.shape[1]
        data = data[ch_list, s0:s1]
        f.close()
        if error_coord:
            return data, np.asarray(err_index)
        return data

    n_chan = sub[dataset].shape[0]
    if ch_list is None:
        ch_list = list(range(n_chan))
    s0 = int(start_sample or 0)
    s1 = int(last_sample) if last_sample is not None \
        else sub[dataset].shape[1]
    if big_file:
        if error_coord:
            return f, sub[dataset], sub["errors"][:]
        return f, sub[dataset]
    data = sub[dataset][ch_list, s0:s1]
    errors = sub["errors"][:] if error_coord else None
    f.close()
    if error_coord:
        return data, errors
    return data


def mixed_streams(filename: str, usrp_number: int = 0,
                  front_end: Optional[str] = None):
    """List a mixed-mode antenna's sub-streams: [(dataset_name, attrs)]
    starting with ("data", {}).  Mixed modes exceed the reference (it
    rejects them, cpp/USRP_demodulator.cpp:36-39)."""
    with bound_open(filename) as f:
        group = f[f"raw_data{int(usrp_number)}"]
        sub = group[front_end if front_end is not None
                    else get_receivers(group)[0]]
        out = [("data", {})]
        k = 1
        while f"mixed_{k}" in sub:
            out.append((f"mixed_{k}", dict(sub[f"mixed_{k}"].attrs)))
            k += 1
        return out


# ----------------------------------------------------------------------
# Streaming H5 writer sink
# ----------------------------------------------------------------------

class H5Sink(Sink):
    """Engine sink writing the reference 'new mode' layout: one resizable
    (n_chan, samples) complex64 dataset per RX antenna, plus error
    coordinates — the roles of H5_file_writer (server side,
    cpp/USRP_file_writer.cpp) and Packets_to_file's write_ext_H5_packet
    (client side, pyUSRP/USRP_connections.py:89-347) combined.
    """

    def __init__(self, filename: str, params: UsrpParams,
                 ant_name: Optional[str] = None, trigger=None,
                 dataset: str = "data",
                 sub_params: Optional[AntennaParams] = None,
                 channel_index=None, **tags):
        self.filename = format_filename(filename)
        self.params = params
        self.trigger = trigger
        self.dataset = dataset
        if ant_name is None:
            rx = [n for n, _ in params.active_antennas(AntMode.RX)]
            ant_name = rx[0] if rx else "A_RX2"
        self.ant_name = ant_name
        self._fp = h5.File(self.filename, "a")
        grp_name = f"raw_data{int(params.usrp_number)}"
        if grp_name not in self._fp:
            self._rx_names = params_to_h5(self._fp, params, trigger=trigger,
                                          **tags)
        self._group = self._fp[grp_name][ant_name]
        if dataset != "data" and dataset not in self._group:
            # secondary sub-stream of a mixed-mode antenna: its own
            # resizable dataset annotated with its wave type + original
            # channel positions (mixed modes exceed the reference, which
            # rejects them — cpp/USRP_demodulator.cpp:36-39)
            assert sub_params is not None
            n_ch = len(sub_params.wave_type)
            exp = expected_data_len(sub_params)
            ds = self._group.create_dataset(
                dataset, (n_ch, exp), dtype=np.complex64,
                maxshape=(None, None), chunks=True)
            ds.attrs["wave_type"] = [w.value for w in sub_params.wave_type]
            if channel_index is not None:
                ds.attrs["channel_index"] = list(map(int, channel_index))
            ds.attrs["decim"] = int(sub_params.decim)
            ds.attrs["fft_tones"] = int(sub_params.fft_tones)
            ds.attrs["freq"] = list(map(float, sub_params.freq or []))
        self._written = 0
        # cap at the acquisition's expected length: the engine processes
        # whole blocks (static shapes), but the measurement contract is
        # `samples` raw samples (reference stops the UHD stream there)
        p = sub_params if sub_params is not None \
            else params.antenna(ant_name)
        cap = expected_data_len(p)
        w = p.wave_type[0] if p.wave_type else None
        if w == WaveType.CHIRP and int(p.decim) >= 1:
            # expected_data_len's CHIRP sizing (reference Param_to_H5:
            # swipe_s/decim) covers ONE sweep — the initial dataset
            # shape, not the acquisition total.  Capping there would
            # silently discard every iteration after the first
            # (Iterations>1 VNA scans); the iteration-aware total is
            # samples // ppt.
            from ..params import expected_samples_per_channel
            cap = expected_samples_per_channel(p)
        self._cap = None if trigger is not None else cap

    def on_packet(self, meta: PacketMeta, data: np.ndarray) -> None:
        """data: (rows, channels) complex64 -> stored as (channels, rows)."""
        if self.trigger is not None:
            # reference trigger contract: flat interleaved data
            # (ch0_t0, ch1_t0, ch0_t1, ...) + metadata dict
            md = {"channels": meta.channels, "length": int(data.size),
                  "packet_number": meta.packet_number}
            out, md = self.trigger.trigger(data.reshape(-1), md)
            out = np.asarray(out).reshape(-1)
            if md.get("length", 0) == 0 or out.size == 0:
                return
            data = out[:  (len(out) // meta.channels) * meta.channels
                       ].reshape(-1, meta.channels)
        ds = self._group[self.dataset]
        if data.shape[1] != ds.shape[0]:
            # NOISE full-spectrum mode: the file schema has
            # n_chan = len(wave_type) (usually 1) and the spectra stream is
            # stored flattened frame-major (reference Param_to_H5 sizing +
            # plot_pfb reshape, pyUSRP/USRP_full_spec.py:460-470)
            data = data.reshape(-1, ds.shape[0])
        rows = data.shape[0]
        if self._cap is not None:
            if self._written >= self._cap:
                return
            if self._written + rows > self._cap:
                rows = self._cap - self._written
                data = data[:rows]
        if self._written + rows > ds.shape[1]:
            ds.resize((ds.shape[0], self._written + rows))
        ds[:, self._written:self._written + rows] = data.T
        if meta.errors:
            eds = self._group["errors"]
            n = eds.shape[0]
            eds.resize((n + 1, 2))
            eds[n] = (self._written, self._written + rows)
        self._written += rows

    def on_end(self) -> None:
        try:
            ds = self._group[self.dataset]
            if self.trigger is None and self._written < ds.shape[1]:
                # under-delivered stream (e.g. ingest producer died): the
                # file ends SHORT instead of keeping fabricated zero rows
                # — the reference aborts rather than inventing samples
                # (cpp/USRP_hardware_manager.cpp:1546-1560)
                ds.resize((ds.shape[0], self._written))
            ds.attrs.create("samples", self._written)
            if self.trigger is not None and "trigger" in self._group:
                # persist trigger bookkeeping (the attrs the reference
                # stores for amplitude_trigger, USRP_files.py:1017-1027)
                tds = self._group["trigger"]
                for attr in ("bounds", "nglitch", "glitch_indices",
                             "samples_per_packet"):
                    val = getattr(self.trigger, attr, None)
                    if val is not None:
                        tds.attrs.create(attr, np.asarray(val))
                chans = getattr(self.trigger, "channels", None)
                if chans is not None:
                    tds.attrs.create("triggering_chs", np.asarray(chans))
        finally:
            self._fp.close()

    @property
    def samples_written(self) -> int:
        return self._written


# ----------------------------------------------------------------------
# Analysis-group accessors (VNA / noise / resonators)
# ----------------------------------------------------------------------

def is_VNA_analyzed(filename: str, usrp_number: int = 0) -> bool:
    with bound_open(filename) as f:
        try:
            grp = f[f"VNA_{int(usrp_number)}"]
            return grp["frequency"] is not None and grp["S21"] is not None
        except KeyError:
            return False


def get_VNA_data(filename: str, calibrated: bool = True,
                 usrp_number: int = 0):
    """(frequency, S21) from an analyzed VNA file
    (reference get_VNA_data, pyUSRP/USRP_files.py:1060-1084)."""
    if not is_VNA_analyzed(filename, usrp_number):
        raise ValueError(f"file {filename} has no analyzed VNA group")
    with bound_open(filename) as f:
        grp = f[f"VNA_{int(usrp_number)}"]
        freq = np.asarray(grp["frequency"])
        s21 = np.asarray(grp["S21"])
        if calibrated:
            s21 = s21 * grp.attrs.get("calibration")[0]
        return freq, s21


def get_noise(filename: str, usrp_number: int = 0,
              front_end: Optional[str] = None, channel_list=None):
    """(info, freq_axis, real, imag) from an analyzed noise file
    (reference get_noise, pyUSRP/USRP_files.py:340-396)."""
    with bound_open(filename) as f:
        ng = f[f"Noise{int(usrp_number)}"]
        ant = front_end if front_end is not None else list(ng.keys())[0]
        sub = ng[ant]
        info = {k: sub.attrs.get(k)
                for k in ("welch", "dbc", "rotate", "rate", "n_chan")}
        if channel_list is None:
            channel_list = list(range(int(info["n_chan"])))
        info["tones"] = []
        freq = np.asarray(sub["freq"])
        real, imag = [], []
        for i in channel_list:
            real.append(np.asarray(sub[f"real_{int(i)}"]))
            imag.append(np.asarray(sub[f"imag_{int(i)}"]))
            info["tones"].append(sub[f"imag_{int(i)}"].attrs.get("tone"))
        return info, freq, real, imag


def get_trigger_info(filename: str, ant: Optional[str] = None):
    """Trigger bookkeeping from a triggered measure: returns
    (trigger_fcn_name, attrs dict) (reference get_trigger_info stub,
    pyUSRP/USRP_files.py:398-408 — implemented here)."""
    with bound_open(filename) as f:
        group = f["raw_data0"]
        recv = get_receivers(group)
        sub = group[ant if ant is not None else recv[0]]
        if "trigger" not in sub:
            raise KeyError("measure was not triggered")
        tds = sub["trigger"]
        return (_attr_str(tds.attrs.get("trigger_fcn")),
                {k: np.asarray(v) for k, v in tds.attrs.items()
                 if k != "trigger_fcn"})


def get_init_peaks(filename: str) -> np.ndarray:
    with bound_open(filename) as f:
        try:
            return np.asarray(f["Resonators"].attrs.get("tones_init"))
        except (KeyError, ValueError):
            return np.asarray([])


USRP_power = -6.00  # dBm at 0 TX gain (reference USRP_low_level.py:48)
USRP_calibration = 0.317  # Vpp per float unit (reference USRP_low_level.py:54)


def get_readout_power(filename: str, channel: int,
                      front_end: Optional[str] = None,
                      usrp_number: int = 0) -> float:
    """gain + USRP_power + 20*log10(ampl) (reference get_readout_power,
    pyUSRP/USRP_files.py:410-432)."""
    params = retrieve_params_from_file(filename, usrp_number)
    if front_end is None:
        tx = [n for n, _ in params.active_antennas(AntMode.TX)]
        front_end = tx[0]
    p = params.antenna(front_end)
    return p.gain + USRP_power + 20.0 * np.log10(p.ampl[channel])
