"""Client-side trigger framework (a copy of gpu_sdr_tpu/client/triggers.py,
which mirrors pyUSRP/USRP_triggers.py).

Triggers are applied inside the streaming write path (the role of
Packets_to_file's trigger hook, pyUSRP/USRP_connections.py:89-347): each
packet's flat channel-interleaved data (ch0_t0, ch1_t0, ch0_t1, ...) passes
through ``trigger(data, metadata)`` which may suppress, truncate, or replace
the samples to be written.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class trigger_template:
    """Base trigger contract (reference trigger_template,
    USRP_triggers.py:14-63)."""

    def __init__(self):
        self.trigger_group = None

    def dataset_init(self, antenna_group) -> None:
        """Called once with the H5 antenna group so the trigger can create
        or bind bookkeeping datasets."""
        self.trigger_group = antenna_group.get("trigger")

    def write_trigger(self, data) -> None:
        if self.trigger_group is not None:
            n = len(self.trigger_group)
            self.trigger_group.resize((n + 1,))
            self.trigger_group[n] = data

    def trigger(self, data, metadata):
        """Return (possibly modified) (data, metadata).  Default is a
        passthrough."""
        return data, metadata


class deriv_test(trigger_template):
    """Gradient-threshold test trigger (reference deriv_test,
    USRP_triggers.py:66-103): accumulate 3 packets, pass them through only
    when any channel's |gradient| exceeds threshold x its mean."""

    def __init__(self, threshold: float = 1.1):
        super().__init__()
        self.stored_data = np.array([], dtype=np.complex64)
        self.threshold = threshold

    def trigger(self, data, metadata):
        n_chan = metadata["channels"]
        self.stored_data = np.concatenate((self.stored_data, data))
        if len(self.stored_data) >= 3 * metadata["length"]:
            spc = len(self.stored_data) // n_chan
            formatted = np.gradient(
                np.reshape(self.stored_data[:spc * n_chan],
                           (spc, n_chan)).T, axis=1)
            avg = np.abs(np.mean(formatted, 1))
            x = sum(int(np.sum(np.abs(formatted[i]) >
                               self.threshold * avg[i]))
                    for i in range(len(formatted)))
            if x > 1:
                ret = self.stored_data
                metadata["length"] = len(self.stored_data)
                self.stored_data = np.array([], dtype=np.complex64)
                return ret, metadata
            # rejected: clear the window like the reference
            # (USRP_triggers.py:93-99) — keeping it would both grow the
            # buffer without bound and replay rejected data on the next
            # accepted window
            self.stored_data = np.array([], dtype=np.complex64)
        metadata["length"] = 0
        return np.array([], dtype=np.complex64), metadata


class amplitude_trigger(trigger_template):
    """Amplitude/frequency-threshold glitch trigger (reference
    amplitude_trigger, USRP_triggers.py:107-248).

    Accumulates `accumulation_t` seconds of data, converts IQ to
    frequency/Qr streams via resonator fit parameters, thresholds the
    frequency stream at median +/- threshold*sigma per triggering channel,
    and keeps a window of `window_t` around each glitch plus two random
    noise windows.  Bookkeeps bounds / nglitch / glitch_indices.
    """

    def __init__(self, sample_rate, threshold, fit_params=None,
                 calibration: float = 1.0,
                 channels: Optional[Sequence[int]] = None,
                 vna: Optional[str] = None,
                 accumulation_t: float = 10.0, window_t: float = 0.002):
        super().__init__()
        self.rate = float(sample_rate)
        self.threshold = float(threshold)
        self.vna = vna
        if fit_params is None and vna is not None:
            from .fitting import get_fit_param
            fit_params = get_fit_param(vna)
            from . import h5
            with h5.File(vna if vna.endswith(".h5") else vna + ".h5",
                         "r") as f:
                calibration = float(
                    np.atleast_1d(f["VNA_0"].attrs["calibration"])[0])
        self.fit_params = fit_params
        self.cal = calibration
        self.channels = channels
        self.accum = float(accumulation_t)
        self.window = float(window_t)

        self.stored_data: List[np.ndarray] = []
        self.time_index = 0
        self.index = 0
        self.bounds: List = []
        self.nglitch: List[int] = []
        self.glitch_indices: List[int] = []
        self.samples_per_packet: List[int] = []

    def _to_frequency(self, reshaped):
        """IQ -> (df/f real, dQr imag) per channel using fit params."""
        if not self.fit_params:
            return reshaped
        out = np.array(reshaped, dtype=np.complex128)
        for n, p in enumerate(self.fit_params):
            if n >= len(out):
                break
            Qe = p["Qe"] if np.iscomplexobj(p["Qe"]) else complex(p["Qe"])
            A = p.get("A", 1.0) or 1.0
            phi = p.get("phi", 0.0) or 0.0
            s21 = out[n] * self.cal / (A * np.exp(2j * np.pi * phi))
            w = (p["Qr"] / Qe) / (1.0 - s21)
            y = (w - 1.0) / 2.0j
            out[n] = (np.real(y) / p["Qr"]) + 1j * (np.imag(y) / p["Qr"])
        return out

    def trigger(self, data, metadata):
        n_chan = metadata["channels"]
        self.time_index += metadata["length"] // n_chan
        self.stored_data.append(np.asarray(data))
        if self.time_index < self.accum * self.rate:
            metadata["length"] = 0
            return np.array([], dtype=np.complex64), metadata

        stored = np.concatenate(self.stored_data)
        n_samples = len(stored) // n_chan
        self.samples_per_packet.append(n_samples)
        reshaped = np.reshape(stored[:n_samples * n_chan],
                              (n_samples, n_chan)).T
        reshaped = self._to_frequency(reshaped)

        channels = (self.channels if self.channels is not None
                    else range(n_chan))
        hits = np.zeros(n_samples, dtype=bool)
        bounds = []
        for ch in channels:
            cur = reshaped[ch].real
            med, std = np.median(cur), np.std(cur)
            lo, hi = med - self.threshold * std, med + self.threshold * std
            bounds.append([lo, hi])
            hits |= (cur < lo) | (cur > hi)
        self.bounds.append(bounds)
        hit_idx = np.nonzero(hits)[0]
        # merge hits closer than 1 ms into one glitch
        if len(hit_idx) > 1:
            keep = [hit_idx[0]]
            for h in hit_idx[1:]:
                if h - keep[-1] >= 0.001 * self.rate:
                    keep.append(h)
            hit_idx = np.asarray(keep)
        num = int(self.rate * self.window)       # samples before glitch
        # count only STORABLE glitches: hits within window_t of the
        # accumulation edges are skipped below, and the persisted
        # nglitch attr must pair with the (2 noise + nglitch) stored
        # window layout (the reference decrements per skipped hit,
        # USRP_triggers.py:231-236)
        hit_idx = [int(i) for i in hit_idx
                   if num <= i < n_samples - 3 * num]
        self.nglitch.append(len(hit_idx))

        rng = np.random.default_rng(self.index)
        lo_r, hi_r = num, max(num + 1, n_samples - 3 * num)
        rand = rng.integers(lo_r, hi_r, size=2)
        hit_idx = np.concatenate((rand, np.asarray(hit_idx, dtype=int)))

        pieces = []
        for i in hit_idx:
            if num <= i < n_samples - 3 * num:
                pieces.append(reshaped[:, i - num:i + 3 * num])
                self.glitch_indices.append(int(i + self.index))
        self.stored_data = []
        self.time_index = 0
        self.index += n_samples
        if not pieces:
            metadata["length"] = 0
            return np.array([], dtype=np.complex64), metadata
        res = np.concatenate(pieces, axis=1)       # (n_chan, windows)
        flat = res.T.reshape(-1)                   # interleaved again
        metadata["length"] = len(flat)
        return flat.astype(np.complex64), metadata
