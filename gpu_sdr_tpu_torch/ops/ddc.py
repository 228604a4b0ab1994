"""Fused multi-tone direct down-conversion + decimating FIR (DIRECT mode):
the CUDA kernel (csrc/ddc.cu) and its plain PyTorch version.

Port of gpu_sdr_tpu/ops/ddc.py and gpu_sdr_tpu/ops/pallas_ddc.py
(``ddc_fused``).  The integer-phase oscillator is an exact exponential,
so the mix-down and the FIR fold into one correlation per block:

    Hmod[i, c] = h[i] * exp(-2j*pi*f_c*i/W)                    (f*M, C)
    y[n, c]    = rot_c * ramp[n, c] * sum_j E[n+j, :] @ Hmod[j*M:(j+1)*M, c]

with E = concat(hist, x) viewed as (nb+f-1, M) rows, ramp the
block-invariant carrier factor and rot_c = exp(-2j*pi*P_c/W) from an
exact integer phase P_c carried across blocks (int64 here; the JAX
package's int32 values convert exactly, see convert.ddc_state).

``direct_ddc_fir`` is the plain version (f complex matmuls); ``ddc_fused``
launches the kernel for CUDA tensors.  The kernel's second input mode (a
block of a resident recording, read by block index) serves
ops/replay_ddc.py.  The TPU kernel's bf16 hi/lo split, its 8-row halo
units and its fallback for untileable geometries have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels import build
from .cplx import advance_phase, from_np, phase_rotation
from .fir import fir_taps_direct

ROW_MODE_MAX_CHANNELS = 8   # csrc/ddc.cu kMaxRowChannels


def few_channels(n_channels: int) -> bool:
    """Whether the kernel can run one thread per output row (row mode)
    rather than lanes over channels (channel mode)."""
    return n_channels <= ROW_MODE_MAX_CHANNELS


@dataclasses.dataclass(frozen=True)
class DirectDDCConfig:
    """Static configuration of the fused DDC+FIR for one antenna.

    ``decim == 0`` is the pure mix-down (M = 1, f = 1, unit tap), the
    reference's undecimated DIRECT branch (cpp/USRP_demodulator.cpp:
    442-456)."""

    rate: int                 # W: wavetable length == sampling rate
    decim: int                # M: decimation factor (0 -> no filtering)
    pf_average: int           # f: taps per polyphase arm
    freqs: Tuple[int, ...]    # integer tone frequencies [Hz]
    phases: Tuple[int, ...]   # integer initial phases (reference zeroes them)

    @property
    def M(self) -> int:
        return max(int(self.decim), 1)

    @property
    def f(self) -> int:
        return int(self.pf_average) if self.decim > 0 else 1

    @property
    def n_channels(self) -> int:
        return len(self.freqs)

    def modulated_taps_np(self) -> np.ndarray:
        """Hmod[i, c] = h[i] * exp(-2j*pi*f_c*i/W), (f*M, C) float64, from
        exact integer phases."""
        M, f, W = self.M, self.f, self.rate
        h = (fir_taps_direct(self.decim, self.pf_average, dtype=np.float64)
             if self.decim > 0 else np.ones(1, dtype=np.float64))
        i = np.arange(f * M, dtype=np.int64)
        fr = np.asarray(self.freqs, dtype=np.int64)
        ph = (fr[None, :] * (i[:, None] % W)) % W
        return h[:, None] * np.exp(-2j * np.pi * (ph / float(W)))

    def modulated_taps(self, device) -> torch.Tensor:
        """`modulated_taps_np` as complex64 on `device`."""
        return from_np(self.modulated_taps_np(), device)

    def carrier_ramp_np(self, nb: int) -> np.ndarray:
        """R[n, c] = exp(-2j*pi*(f_c*n*M mod W)/W), (nb, C) float64."""
        W, M = self.rate, self.M
        n = np.arange(nb, dtype=np.int64)
        fr = np.asarray(self.freqs, dtype=np.int64)
        ph = (fr[None, :] * ((n[:, None] * M) % W)) % W
        return np.exp(-2j * np.pi * (ph / float(W)))

    def carrier_ramp(self, nb: int, device) -> torch.Tensor:
        """The block-invariant carrier factor, complex64 (nb, C)."""
        return from_np(self.carrier_ramp_np(nb), device)


def ddc_carrier_init(cfg: DirectDDCConfig, device) -> torch.Tensor:
    """Initial per-channel phase P_c = (p_c + f_c*abs0) mod W, int64, where
    abs0 = -(f-1)*M is the absolute index of the first history sample of
    block 0 (the reference's DIRECT_current_index bookkeeping,
    cpp/USRP_demodulator.cpp:437-440)."""
    abs0 = -((cfg.f - 1) * cfg.M)
    fr = np.asarray(cfg.freqs, dtype=np.int64)
    p = np.asarray(cfg.phases, dtype=np.int64)
    return torch.from_numpy((p + fr * abs0) % cfg.rate).to(device)


def ddc_carrier_step(cfg: DirectDDCConfig, block_len: int,
                     device) -> torch.Tensor:
    """Per-channel phase increment per block, (f_c*L) mod W, int64."""
    fr = np.asarray(cfg.freqs, dtype=np.int64)
    return torch.from_numpy((fr * block_len) % cfg.rate).to(device)


def ddc_rows_plain(hmod: torch.Tensor, ramp: torch.Tensor,
                   phase: torch.Tensor, W: int, M: int, f: int,
                   E: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch DDC+FIR over extended rows E (nb+f-1, M): f complex
    matmuls of (nb, M) x (M, C), then ramp and rotation.  (nb, C)."""
    nb = E.shape[0] - (f - 1)
    acc = E[0:nb] @ hmod[0:M]
    for j in range(1, f):
        acc = acc + E[j:j + nb] @ hmod[j * M:(j + 1) * M]
    return acc * ramp * phase_rotation(phase, W, -1.0)[None, :]


def _new_hist(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The last (f-1)*M samples of concat(hist, x)."""
    H, L = hist.shape[0], x.shape[0]
    if H == 0:
        return hist
    return x[L - H:] if H <= L else torch.cat([hist, x])[L:]


def direct_ddc_fir(hmod: torch.Tensor, ramp: torch.Tensor,
                   step: torch.Tensor, W: int, M: int, f: int,
                   phase: torch.Tensor, hist: torch.Tensor,
                   x: torch.Tensor):
    """One block of fused DDC+FIR in plain PyTorch (gpu_sdr_tpu/ops/ddc.
    direct_ddc_fir): (phase', hist', y) with y (L//M, C), sample-major."""
    L = x.shape[0]
    ze = torch.cat([hist, x]) if hist.shape[0] else x
    y = ddc_rows_plain(hmod, ramp, phase, W, M, f,
                       ze.reshape(L // M + f - 1, M))
    return advance_phase(phase, step, W), _new_hist(hist, x), y


def _check(hmod, ramp, phase, M, f, nb):
    C = hmod.shape[1] if hmod.ndim == 2 else -1
    if hmod.dtype != torch.complex64 or ramp.dtype != torch.complex64:
        raise TypeError("ddc wants complex64 hmod / ramp")
    if phase.dtype != torch.int64:
        raise TypeError("ddc wants an int64 phase")
    if tuple(hmod.shape) != (f * M, C) or tuple(ramp.shape) != (nb, C) or \
            tuple(phase.shape) != (C,):
        raise ValueError(f"ddc shapes: hmod {tuple(hmod.shape)}, ramp "
                         f"{tuple(ramp.shape)}, phase {tuple(phase.shape)} "
                         f"for M {M}, f {f}, nb {nb}")


def launch_ddc(x: torch.Tensor, hist, hmod: torch.Tensor,
               ramp: torch.Tensor, phase: torch.Tensor, W: int, M: int,
               f: int, nb: int, row_mode: bool, base: int = 0,
               valid: int = 1):
    """Launch csrc/ddc.cu on CUDA tensors: y (nb, C) complex64, one
    thread per output row (`row_mode`, at most 8 channels) or lanes over
    channels.

    Streamed block (`hist` a tensor of (f-1)*M samples): x holds the
    block.  Resident recording (`hist` None): x holds the recording, the
    block starts at row `base`, its history is the rows before it
    wrapped mod the recording, and zero unless `valid`."""
    _check(hmod, ramp, phase, M, f, nb)
    C = hmod.shape[1]
    tensors = (x, hmod, ramp, phase) + (() if hist is None else (hist,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("ddc operands on different devices")
    if x.device.type != "cuda":
        raise ValueError(f"ddc kernel: unsupported device {x.device}")
    if x.dtype != torch.complex64 or x.numel() % M or \
            (hist is not None and (hist.dtype != torch.complex64 or
                                   hist.numel() != (f - 1) * M)):
        raise ValueError("ddc kernel: x / hist must be complex64 rows of M")
    if row_mode and not few_channels(C):
        raise ValueError(f"ddc kernel: row mode takes at most "
                         f"{ROW_MODE_MAX_CHANNELS} channels, not {C}")
    x, hmod, ramp, phase = (t.contiguous() for t in (x, hmod, ramp, phase))
    hist = None if hist is None else hist.contiguous()
    out = torch.empty((nb, C), dtype=torch.complex64, device=x.device)
    rc = build.load().sdr_ddc(
        x.data_ptr(), None if hist is None else hist.data_ptr(),
        hmod.data_ptr(), ramp.data_ptr(), phase.data_ptr(), out.data_ptr(),
        x.numel() // M, base, nb, M, f, C, int(bool(valid)),
        float(np.float32(2.0 * np.pi / W)), int(row_mode),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "sdr_ddc")
    return out


def ddc_fused(hmod: torch.Tensor, ramp: torch.Tensor, step: torch.Tensor,
              W: int, M: int, f: int, phase: torch.Tensor,
              hist: torch.Tensor, x: torch.Tensor):
    """One block of DDC+FIR: the CUDA kernel for CUDA tensors, the plain
    version (direct_ddc_fir) for CPU tensors.  Same signature and result
    as direct_ddc_fir; counts its kernel launches in
    ``ddc_fused.launches``."""
    L = x.shape[0]
    if L % M or hist.shape[0] != (f - 1) * M:
        raise ValueError(f"ddc: block {L} / history {hist.shape[0]} do not "
                         f"fit M {M}, f {f}")
    if x.device.type == "cpu":
        return direct_ddc_fir(hmod, ramp, step, W, M, f, phase, hist, x)
    y = launch_ddc(x, hist, hmod, ramp, phase, W, M, f, L // M,
                   few_channels(hmod.shape[1]))
    ddc_fused.launches += 1
    return advance_phase(phase, step, W), _new_hist(hist, x), y


ddc_fused.launches = 0
