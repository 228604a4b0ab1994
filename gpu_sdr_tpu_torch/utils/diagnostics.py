"""Diagnostics: colored prints, timing, parameter pretty-printing.

The port's copy of gpu_sdr_tpu/utils/diagnostics.py, the equivalent of
the reference diagnostic layer (USRP_server_diagnostic.cpp +
USRP_server_console_print.cpp): ANSI print helpers, the stop_watch timing
class (:333-394), and the measurement-parameter pretty printer (:108-330).
"""

from __future__ import annotations

import time
from typing import List, Optional


def print_error(message) -> None:
    print(f"\033[1;31mERROR\033[0m: {message}.")


def print_warning(message) -> None:
    print(f"\033[40;33mWARNING\033[0m: {message}.")


def print_debug(message) -> None:
    print(f"\033[3;2;37m{message}\033[0m")


class StopWatch:
    """Accumulating timer (reference stop_watch,
    cpp/USRP_server_diagnostic.cpp:333-394): start/stop/store cycles and
    report the average."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._acc = 0.0
        self._store: List[float] = []

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self._acc += time.perf_counter() - self._t0
            self._t0 = None

    def get(self) -> float:
        running = (time.perf_counter() - self._t0) if self._t0 else 0.0
        return self._acc + running

    def store(self) -> None:
        self.stop()
        self._store.append(self._acc)
        self._acc = 0.0

    def cycle(self) -> None:
        """store() then immediately start() again."""
        self.store()
        self.start()

    def get_average(self) -> float:
        return sum(self._store) / len(self._store) if self._store else 0.0

    @property
    def history(self) -> List[float]:
        return list(self._store)


class ThroughputMeter:
    """Per-block throughput counter: feeds first-class metrics the
    reference lacked (SURVEY.md section 5, tracing/profiling)."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.samples = 0
        self.blocks = 0

    def add(self, n_samples: int) -> None:
        self.samples += int(n_samples)
        self.blocks += 1

    @property
    def msps(self) -> float:
        dt = time.perf_counter() - self._t0
        return self.samples / dt / 1e6 if dt > 0 else 0.0


def print_params(params) -> str:
    """Human-readable table of a UsrpParams set (the role of the reference
    ANSI-art parameter printer, cpp/USRP_server_diagnostic.cpp:108-330)."""
    from ..params import ANTENNA_NAMES
    lines = [f"device: {params.usrp_number}"]
    for name in ANTENNA_NAMES:
        p = params.antenna(name)
        if p.mode.value == "OFF":
            continue
        lines.append(f"-- {name} [{p.mode.value}] --")
        lines.append(f"   rate {p.rate}  rf {p.tone}  gain {p.gain}  "
                     f"bw {p.bw}  delay {p.delay}")
        lines.append(f"   samples {p.samples}  buffer {p.buffer_len}  "
                     f"decim {p.decim}  fft {p.fft_tones}  "
                     f"pfa {p.pf_average}")
        lines.append(f"   wave {[w.value for w in p.wave_type]}")
        lines.append(f"   freq {p.freq}")
        if p.chirp_t:
            lines.append(f"   chirp_f {p.chirp_f} chirp_t {p.chirp_t} "
                         f"steps {p.swipe_s}")
    text = "\n".join(lines)
    print(text)
    return text
