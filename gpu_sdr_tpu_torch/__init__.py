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

What runs: ``measure.run_measurement`` on every path of the JAX
package (one front end or two in lock-step, fused loopback, the host-fed
pipeline through a channel model or a socket ingest, the device-resident
replay of a recording, each also sharded over a (time, channels) mesh
of devices driven by one process, ``parallel/``) for every wave type of
the reference (TONES / NOISE PFB, DIRECT DDC + decimating FIR, CHIRP /
VNA lock-in, NODSP raw, and mixed wave types on one antenna), with
checkpoints (``engine/checkpoint.py``) and the reference's HDF5 files
(``client/files.py``, written and read by ``client/h5.py``, with no
h5py); and the analysis client: line delay, VNA sweeps and analysis,
resonator fits, noise captures and their Welch PSDs (on the device,
``ops/spectral.py``, or with scipy), full-spectrum and raw captures,
triggers, the TCP client and the plotting (``client/``); the server
that answers the reference's TCP protocol on the card (``server/``:
``python -m gpu_sdr_tpu_torch.server.main``) and the ``pyusrp`` facade
(``pyusrp.py``) that users' scripts import.  What raises
``NotImplementedError`` is what the reference refuses too (two chirps on
one antenna, TX of a wave type other than TONES or CHIRP, NEF spectra).
"""

__version__ = "0.1.0"
