"""Device resolution, the precision contract and the optional trace of
a measurement.

Precision: the readout's bar is 90 dB SNR against the float64 oracles
of the JAX package, which the tests hold the port against.  TF32 keeps
10 mantissa bits (~60 dB per product), far under that bar, so every
float32 matmul and convolution of the port runs in full float32: both
TF32 switches are turned off here, once, before any work is placed on
a card.  The kernels of ``csrc/`` use FP32 FFMA and are not affected by
these switches.
"""

from __future__ import annotations

import os
import time

import torch


def configure_precision() -> None:
    """Keep float32 matmuls and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The device a measurement runs on, as the caller named it: a CUDA
    device without a card raises rather than running somewhere else,
    and there is no automatic choice."""
    configure_precision()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _profile_every_thread(activities):
    """A torch.profiler of `activities` that follows every thread, the
    feeder's among them, where this PyTorch can."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=activities)
    return torch.profiler.profile(activities=activities,
                                  experimental_config=cfg)


class maybe_profile:
    """Context manager: a ``torch.profiler`` trace of what it wraps when
    GPU_SDR_TPU_PROFILE names a directory, written on exit as a Chrome
    trace under ``<dir>/<tag>/`` (``self.path``), with the card's CUDA
    activity when `device` is a CUDA device and the ``sdr.*`` spans of
    every thread (spans.py); nothing when the variable is unset.  A
    trace that cannot start raises, naming the directory (the JAX
    package's swallows the failure and runs untraced)."""

    def __init__(self, tag: str = "run", device=None):
        self.dir = os.environ.get("GPU_SDR_TPU_PROFILE")
        self.tag = tag
        self.device = torch.device(device) if device is not None else None
        self.path = None
        self._prof = None

    def __enter__(self):
        if not self.dir:
            return self
        out = os.path.join(self.dir, self.tag)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(out, exist_ok=True)
            prof = _profile_every_thread(acts)
            prof.__enter__()
        except Exception as e:
            raise RuntimeError(f"GPU_SDR_TPU_PROFILE: cannot start a "
                               f"trace under {out!r}: {e}") from e
        self._prof = prof
        return self

    def __exit__(self, *exc):
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(*exc)
            self.path = os.path.join(
                self.dir, self.tag,
                f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(self.path)
        return False
