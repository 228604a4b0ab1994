"""The card's published peaks, and the operations and bytes a kernel
needs for one call at the shapes a cell runs.

Frozen here from the program's chip smoke test (``chip_smoke.py``'s
``bound``, ``ddc_flops`` and its lock-in counts), with the shapes of a
configuration's blocks.  A kernel's bound is the larger of its
operations at the FP32 peak and its bytes at the HBM rate, each input
byte read once and each output byte written once; its roofline share
is that bound over its measured device time a call.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense FP32 outside the tensor cores, and
# HBM3 bandwidth, both at the full 700 W power limit
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
COMPLEX64 = 8


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take for a call."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def ddc_counts(rx: dict) -> tuple:
    """(bytes, operations) of one DDC+FIR call (#7 streamed, #8 from a
    resident recording) on a block of a DIRECT receiver: the block and
    its (f-1)*M history samples, the modulated taps (f*M, C), the
    carrier ramp (rows, C), the int64 phases and the (rows, C) output;
    8 operations a complex tap a row and channel, then two complex
    rotations (12)."""
    L, M, f = int(rx["buffer_len"]), int(rx["decim"]), int(rx["pf_average"])
    C, rows = len(rx["freq"]), L // M
    n_bytes = COMPLEX64 * (L + (f - 1) * M + f * M * C + 2 * rows * C) + 8 * C
    return n_bytes, rows * C * (8 * f * M + 12)


def chirp_ppt(rx: dict) -> int:
    """Samples a lock-in point of a CHIRP receiver: the chirp step's
    length (the reference's swipe_s steps over chirp_t) times decim."""
    rate, t = int(rx["rate"]), float(rx["chirp_t"][0])
    steps = int(rx["swipe_s"][0]) if rx.get("swipe_s") else 0
    if steps < 1:
        steps = int(t * rate)
    return max(int(t * rate / steps), 1) * int(rx["decim"])


def lockin_table_counts(rx: dict) -> tuple:
    """(bytes, operations) of one table-mode lock-in call (#17) on a
    block of a CHIRP receiver: the block's rows and as many oscillator
    table rows, the float32 profile and one complex point a segment; a
    complex product and a weighted sum (10 operations) a sample."""
    L, ppt = int(rx["buffer_len"]), chirp_ppt(rx)
    return 2 * COMPLEX64 * L + 4 * ppt + COMPLEX64 * (L // ppt), 10 * L
