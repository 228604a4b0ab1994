"""The operations and bytes the PFB kernels need for one call at the
shapes a cell runs: the pre-sum (#2 on a streamed block, #6 from a
resident recording) and the fused channelizer (#4 from a resident
recording).

Bytes: each input byte read once and each output byte written once,
the block, its (avg-1)*nfft halo samples, the float32 window and the
(frames, nfft) complex64 output.  Operations: the conventional count,
the same work whatever computes it: 4*avg a sample for the pre-sum (a
complex sample times a real tap, added), and 5*nfft*log2(nfft) a frame
for its DFT.  So a faster split of an awkward nfft shows as a higher
roofline share, not as a smaller count.
"""

from __future__ import annotations

import math

from roofline import COMPLEX64, bound_s  # noqa: F401 (the readers call bound_s)

FLOAT32 = 4


def pfb_shape(rx: dict) -> tuple:
    """(block samples, nfft, avg, frames) of a TONES receiver's block."""
    L, nfft, avg = int(rx["buffer_len"]), int(rx["fft_tones"]), \
        int(rx["pf_average"])
    return L, nfft, avg, L // nfft


def pfb_bytes(rx: dict) -> int:
    """The block, its halo, the window and the (frames, nfft) output."""
    L, nfft, avg, T = pfb_shape(rx)
    return COMPLEX64 * (L + (avg - 1) * nfft) + FLOAT32 * nfft * avg + \
        COMPLEX64 * T * nfft


def presum_counts(rx: dict) -> tuple:
    """(bytes, operations) of one pre-sum call (#2, #6)."""
    L, _, avg, T = pfb_shape(rx)
    return pfb_bytes(rx), 4 * avg * L


def channelizer_counts(rx: dict) -> tuple:
    """(bytes, operations) of one fused channelizer call (#4): the
    pre-sum's, and each frame's DFT."""
    _, nfft, _, T = pfb_shape(rx)
    n_bytes, flops = presum_counts(rx)
    return n_bytes, flops + 5.0 * nfft * math.log2(nfft) * T
