"""Measurement parameters: the port's copy of what it uses from
gpu_sdr_tpu/params.py (the reference's ``param`` / ``usrp_param``
structs, headers/USRP_server_settings.hpp:130-187, and the checks of
chk_param, cpp/USRP_JSON_interpreter.cpp:268-439).

``WaveType`` and ``AntMode`` are ``str`` enums, so their members compare
equal, and hash alike, to the JAX package's members of the same value:
either package's parameter structs drive the other's entry points.
The JSON wire protocol and the server settings are not copied: nothing
in the port reads them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

# transport block bounds (reference USRP_server_settings.hpp:82-102)
MAX_USEFULL_BUFFER = 6_000_000
MIN_USEFULL_BUFFER = 50_000
DEFAULT_BUFFER_LEN = 1_000_000


class WaveType(str, enum.Enum):
    """Signal generation/demodulation mode (reference w_type enum,
    USRP_server_settings.hpp:114)."""

    TONES = "TONES"    # multi-tone comb TX / PFB channelizer RX
    CHIRP = "CHIRP"    # swept chirp TX / chirp lock-in RX (VNA)
    NOISE = "NOISE"    # full-spectrum PFB RX (no tone selection)
    RAMP = "RAMP"      # diagnostic ramp (TX not implemented in reference)
    NODSP = "NODSP"    # raw IQ passthrough
    SWONLY = "SWONLY"  # software-only processing
    DIRECT = "DIRECT"  # per-tone direct down-conversion + FIR decimation RX


class AntMode(str, enum.Enum):
    """State of one antenna (reference ant_mode enum,
    USRP_server_settings.hpp:123)."""

    TX = "TX"
    RX = "RX"
    OFF = "OFF"


ANTENNA_NAMES = ("A_TXRX", "A_RX2", "B_TXRX", "B_RX2")


class ParamError(ValueError):
    """Raised when a parameter set fails physical validation."""


@dataclass
class AntennaParams:
    """Hardware + DSP parameters of one antenna, field for field the
    reference ``param`` struct (headers/USRP_server_settings.hpp:130-167)."""

    mode: AntMode = AntMode.OFF

    # hardware parameters
    rate: int = 0                   # sampling rate [samples/s]
    gain: int = 0                   # analog gain [dB]
    bw: int = 0                     # analog bandwidth [Hz] (0 = auto)
    tone: int = 0                   # LO frequency [Hz] ('rf' on the wire)

    # runtime parameters
    samples: int = 0                # total samples to acquire/generate
    delay: float = 0.0              # line delay correction [s]
    burst_on: float = 0.0           # burst length [s] (0 = continuous)
    burst_off: float = 0.0          # pause between bursts [s]
    buffer_len: int = 0             # transport block length (0 = default)
    tuning_mode: int = 1            # 0 integer-N, 1 fractional LO tuning

    # per-channel software signal parameters
    freq: List[int] = field(default_factory=list)        # baseband tones [Hz]
    wave_type: List[WaveType] = field(default_factory=list)
    ampl: List[float] = field(default_factory=list)
    decim: int = 0                  # decimation factor (shared by channels)
    chirp_t: List[float] = field(default_factory=list)   # chirp duration [s]
    chirp_f: List[int] = field(default_factory=list)     # chirp end freq [Hz]
    swipe_s: List[int] = field(default_factory=list)     # chirp freq steps

    data_mem_mult: int = 1          # output-memory multiplier

    # polyphase filter bank parameters
    fft_tones: int = 0              # number of PFB bins
    pf_average: int = 4             # PFB taps per bin / FIR taps per phase

    def is_pfb_active(self) -> bool:
        """True when any channel uses the PFB channelizer
        (reference cpp/USRP_JSON_interpreter.cpp:259-265)."""
        return any(w in (WaveType.TONES, WaveType.NOISE)
                   for w in self.wave_type)

    def validate(self, name: str = "antenna",
                 strict: bool = False) -> List[str]:
        """Physical-validity checks of ``chk_param``: PFB floors, buffer
        clamps, Nyquist checks.  Mutates self, like the reference, and
        returns the warnings; raises :class:`ParamError` on hard
        failures."""
        warnings: List[str] = []
        if self.mode == AntMode.OFF:
            return warnings

        if self.is_pfb_active():
            if self.pf_average <= 0:
                self.pf_average = 1
            if self.fft_tones <= 0:
                self.fft_tones = 2
                warnings.append(
                    f"number of fft bins in {name} is too low. Setting it "
                    "to 2.")

        if self.buffer_len == 0:
            self.buffer_len = DEFAULT_BUFFER_LEN
        if not (MIN_USEFULL_BUFFER <= self.buffer_len <= MAX_USEFULL_BUFFER):
            warnings.append(
                f"{name} buffer length {self.buffer_len} out of limits "
                f"[{MIN_USEFULL_BUFFER},{MAX_USEFULL_BUFFER}]; "
                f"reset to {DEFAULT_BUFFER_LEN}")
            self.buffer_len = DEFAULT_BUFFER_LEN

        for i, w in enumerate(self.wave_type):
            # freq descriptors are required only for CHIRP / TONES, as in
            # the reference (cpp/USRP_JSON_interpreter.cpp:289-300)
            if w in (WaveType.CHIRP, WaveType.TONES):
                if i >= len(self.freq):
                    raise ParamError(
                        f"Number of frequency descriptors does not match the "
                        f"number of signal mode descriptors in {name}")
                if abs(self.freq[i]) > self.rate:
                    raise ParamError(
                        f"frequency descriptor {i} in {name} is out of "
                        f"Nyquist range: {self.freq[i]} > {self.rate}")
            if w == WaveType.CHIRP:
                if i >= len(self.chirp_f):
                    raise ParamError(
                        f"Missing chirp_f descriptor {i} in {name}")
                if abs(self.chirp_f[i]) > self.rate:
                    raise ParamError(
                        f"second frequency descriptor {i} in {name} is out "
                        f"of Nyquist range: {self.chirp_f[i]} > {self.rate}")
        if strict and warnings:
            raise ParamError("; ".join(warnings))
        return warnings


@dataclass
class UsrpParams:
    """Parameters of one (virtual) USRP: four antennas (reference
    ``usrp_param`` struct, USRP_server_settings.hpp:171-187)."""

    usrp_number: int = 0
    A_TXRX: AntennaParams = field(default_factory=AntennaParams)
    A_RX2: AntennaParams = field(default_factory=AntennaParams)
    B_TXRX: AntennaParams = field(default_factory=AntennaParams)
    B_RX2: AntennaParams = field(default_factory=AntennaParams)

    def antenna(self, name: str) -> AntennaParams:
        if name not in ANTENNA_NAMES:
            raise KeyError(f"unknown antenna {name!r}")
        return getattr(self, name)

    def active_antennas(self, mode: Optional[AntMode] = None):
        for n in ANTENNA_NAMES:
            a = self.antenna(n)
            if a.mode == AntMode.OFF:
                continue
            if mode is None or a.mode == mode:
                yield n, a

    def validate(self, strict: bool = False) -> List[str]:
        warnings: List[str] = []
        for n in ANTENNA_NAMES:
            warnings += self.antenna(n).validate(name=n, strict=strict)
        return warnings


def chirp_steps_and_length(p: AntennaParams, ch: int = 0):
    """(num_steps, step_length) of a chirp, resolved as the reference
    demodulator's constructor does (cpp/USRP_demodulator.cpp:192-206)."""
    num_steps = p.swipe_s[ch] if ch < len(p.swipe_s) else 0
    if num_steps < 1:
        num_steps = int(p.chirp_t[ch] * p.rate)
    length = int(p.chirp_t[ch] * p.rate / num_steps)
    if length < 1:
        length = 1
    return num_steps, length


def expected_samples_per_channel(p: AntennaParams) -> int:
    """Output samples per channel of a finite acquisition (the client's
    HDF5 sizing, pyUSRP/USRP_files.py:948-1035)."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    if w == WaveType.NODSP:
        return int(p.samples)
    if w == WaveType.DIRECT:
        return int(p.samples // max(int(p.decim), 1))
    if w in (WaveType.TONES, WaveType.NOISE):
        n = int(p.samples // max(int(p.fft_tones), 1))
        if p.decim > 0:
            n //= p.decim
        return n
    if w == WaveType.CHIRP:
        if p.decim == 0:
            return int(p.samples)
        steps, length = chirp_steps_and_length(p)
        ppt = length * p.decim
        return int(p.samples // ppt)
    return int(p.samples)
