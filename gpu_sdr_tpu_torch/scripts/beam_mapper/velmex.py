"""XY-stage driver for beam mapping (the port's copy of
scripts/beam_mapper/velmex.py, after the reference's serial driver for
Velmex VXM stepper controllers).

Provides the same motion surface (home, move_to, position) over a serial
port when `pyserial` + hardware are present, plus a SimulatedStage used for
tests and dry runs.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple


class StageError(RuntimeError):
    pass


class SimulatedStage:
    """In-memory stage: same interface, instant (rate-limited) motion."""

    def __init__(self, steps_per_mm: float = 157.48,
                 settle_s: float = 0.0):
        self.steps_per_mm = steps_per_mm
        self.settle_s = settle_s
        self._pos = (0.0, 0.0)
        self.homed = False

    def home(self) -> None:
        self._pos = (0.0, 0.0)
        self.homed = True

    def move_to(self, x_mm: float, y_mm: float) -> None:
        if not self.homed:
            raise StageError("home() the stage before moving")
        self._pos = (float(x_mm), float(y_mm))
        if self.settle_s:
            time.sleep(self.settle_s)

    def position(self) -> Tuple[float, float]:
        return self._pos

    def close(self) -> None:
        pass


class VelmexStage:
    """Serial Velmex VXM driver (reference velmex.py command set: on-line
    mode 'F', clear 'C', run 'R', index moves 'I<motor>M<steps>',
    home 'I<motor>M-0')."""

    def __init__(self, port: str = "/dev/ttyUSB0", baud: int = 9600,
                 steps_per_mm: float = 157.48, timeout: float = 30.0):
        try:
            import serial
        except ImportError as e:  # pragma: no cover
            raise StageError(
                "pyserial is required for the hardware stage; use "
                "SimulatedStage for dry runs") from e
        self._ser = serial.Serial(port, baud, timeout=timeout)
        self.steps_per_mm = steps_per_mm
        self.homed = False
        self._pos = (0.0, 0.0)
        self._cmd("F", wait=False)   # on-line mode
        self._cmd("C", wait=False)   # clear program

    def _cmd(self, s: str, wait: bool = True) -> None:
        """Send one command.  The VXM emits '^' only when a RUN ('R')
        completes — setup commands like F/C never answer, so only run
        commands wait (the reference driver writes F/C blind,
        scripts/beam_mapper/velmex.py:62-63)."""
        self._ser.write((s + "\r").encode())
        if wait:
            t0 = time.monotonic()
            while True:
                b = self._ser.read(1)
                if b == b"^":
                    return
                if not b and time.monotonic() - t0 > self._ser.timeout:
                    raise StageError(f"stage timeout on command {s!r}")

    def home(self) -> None:
        self._cmd("C", wait=False)
        self._cmd("I1M-0,I2M-0,R")
        self._pos = (0.0, 0.0)
        self.homed = True

    def move_to(self, x_mm: float, y_mm: float) -> None:
        """Absolute positioning (reference moveTo's 'IA<m>M<dest>',
        scripts/beam_mapper/velmex.py:74-79): relative rounded steps
        would accumulate up to half a step of error per grid point over
        a raster."""
        if not self.homed:
            raise StageError("home() the stage before moving")
        sx = int(round(x_mm * self.steps_per_mm))
        sy = int(round(y_mm * self.steps_per_mm))
        self._cmd("C", wait=False)
        self._cmd(f"IA1M{sx},IA2M{sy},R")
        self._pos = (sx / self.steps_per_mm, sy / self.steps_per_mm)

    def position(self) -> Tuple[float, float]:
        return self._pos

    def close(self) -> None:
        self._ser.close()


def open_stage(port: Optional[str] = None, **kwargs):
    """Hardware stage when a port is given, simulated otherwise."""
    if port:
        return VelmexStage(port=port, **kwargs)
    return SimulatedStage(**kwargs)
