"""gpu_sdr_tpu_torch — the PyTorch / CUDA port of gpu_sdr_tpu.

The same readout framework for frequency-multiplexed superconducting
resonators, written for an NVIDIA Hopper card: plain tensor code is
PyTorch on ``torch.complex64`` tensors, and every TPU kernel on the
ported path is a hand-written CUDA kernel (``csrc/*.cu``) built with
``nvcc`` at first use and bound with ``ctypes`` (``kernels/build.py``).

The layout mirrors the JAX package (``ops/``, ``engine/``,
``measure.py``, ``config.py``) so each module's counterpart is easy to
find.  The JAX package stays the reference; this package imports
neither jax nor any module of the JAX package: it keeps its own copies
of the parameter structs (``params.py``) and of the float64 helpers its
constants are built with (``golden.py``).

Ported slices of ``measure.run_measurement``, one front end, fused
loopback, host-fed pipeline and device-resident replay of a recording:
the TONES / NOISE PFB readout, the DIRECT readout (multi-tone DDC +
decimating FIR) and the CHIRP / VNA readout (integer-phase chirp +
lock-in).
Every other branch raises ``NotImplementedError`` naming the ROADMAP
item that will port it.
"""

__version__ = "0.1.0"
