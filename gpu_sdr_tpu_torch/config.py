"""Device resolution and the precision contract.

Precision: the readout's bar is 90 dB SNR against the float64 oracles
of the JAX package, which the tests hold the port against.  TF32 keeps
10 mantissa bits (~60 dB per product), far under that bar, so every
float32 matmul and convolution of the port runs in full float32: both
TF32 switches are turned off here, once, before any work is placed on
a card.  The kernels of ``csrc/`` use FP32 FFMA and are not affected by
these switches.
"""

from __future__ import annotations

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
