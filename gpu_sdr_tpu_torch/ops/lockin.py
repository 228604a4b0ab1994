"""Lock-in segment decimator (VNA averaging), plain PyTorch.

Port of gpu_sdr_tpu/ops/lockin.py.  The reference averages each
ppt-sample segment of the chirp-demodulated stream with a flat profile
that zeroes the first ppt//10 settling samples (cublas_decim,
cpp/kernels.cu:852-872; profile make_flat_window(ppt, ppt/10),
cpp/USRP_demodulator.cpp:246).  Blocks are whole segments (the
planner's stride is ppt), so no segment straddles two blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import golden


def lockin_profile(ppt: int) -> np.ndarray:
    """Flat float32 profile of length ppt with the first ppt//10 samples
    zeroed, unit sum."""
    return golden.make_flat_window(ppt, ppt // 10).astype(np.float32)


def lockin_decimate(profile: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Average segments: z (nseg*ppt,) -> (nseg,), out[s] = z_s . profile
    (complex by real, as the JAX package's matmul_cr)."""
    ppt = profile.shape[0]
    nseg = z.shape[0] // ppt
    seg = z[:nseg * ppt].reshape(nseg, ppt)
    return torch.complex(seg.real @ profile, seg.imag @ profile)
