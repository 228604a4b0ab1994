"""The DIRECT-mode decimator taps and the streaming polyphase
decimating FIR (port of gpu_sdr_tpu/ops/fir.py, which imports JAX and
so cannot be shared).

The reference ``FIR`` class (cpp/fir.cu:15-88) reduces to a sliding
correlation with output stride M:

    y[n] = sum_{i=0}^{M*f-1} taps[i] * z[(n-f+1)*M + i]

(GoldenFIR in golden.py).  As in JAX, the last (f-1)*M *input* samples
are carried between blocks (the reference carries f-1 partial sums; the
two are the same), and a block's outputs are f real products over
shifted views of the block.  The DIRECT demodulator does not call this
op: it folds the FIR into the mix-down (ops/ddc.py), as the JAX package
does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import golden


def fir_taps_direct(decim: int, pf_average: int,
                    dtype=np.float32) -> np.ndarray:
    """Sinc window of length decim*pf_average with fc = 0.75/(2*decim)
    (reference cpp/USRP_demodulator.cpp:99)."""
    return golden.make_sinc_window(decim * pf_average,
                                   0.75 / (2.0 * decim)).astype(dtype)


def fir_init_state(n_channels: int, decim: int, pf_average: int,
                   device="cuda") -> torch.Tensor:
    """Zero history: (n_channels, (f-1)*M) carried complex64 input
    samples.  The reference's first-block history is an uninitialized
    device buffer (cpp/fir.cu:26 memsets the *pointer*); zeros only
    affect the first f-1 startup outputs."""
    return torch.zeros((n_channels, (pf_average - 1) * decim),
                       dtype=torch.complex64, device=device)


def streaming_fir(taps: torch.Tensor, state: torch.Tensor,
                  z: torch.Tensor):
    """Apply the streaming decimating FIR to one block.

    Args:
      taps:  (M*f,) real float32 taps.
      state: (C, (f-1)*M) complex64 history (from fir_init_state).
      z:     (C, L) complex64 block, L % M == 0.

    Returns (new_state, y) with y (C, L//M) complex64.
    """
    M_f = taps.shape[0]
    hist = state.shape[-1]
    M = M_f - hist if hist else M_f     # hist = (f-1)*M  =>  M = M_f - hist
    f = M_f // M
    n_ch, L = z.shape
    nb = L // M
    ze = torch.cat([state, z], dim=-1)  # (C, (nb+f-1)*M)
    X = torch.view_as_real(ze).reshape(n_ch, nb + f - 1, M, 2)
    tap_mat = taps.reshape(f, M)
    y = torch.zeros((n_ch, nb, 2), dtype=torch.float32, device=z.device)
    for j in range(f):                  # real taps on both components
        y = y + torch.einsum("cnmk,m->cnk", X[:, j:j + nb], tap_mat[j])
    new_state = ze[:, L:] if hist else state
    return new_state, torch.view_as_complex(y.contiguous())
