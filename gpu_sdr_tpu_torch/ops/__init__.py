"""DSP ops on ``torch.complex64`` tensors.

``pfb`` / ``windows`` (the window builders) / ``tonegen`` / ``fir`` / ``chirp`` / ``lockin``
/ ``spectral`` are plain PyTorch or numpy (``spectral``'s Welch PSD on
``torch.fft``); ``presum``, ``channelizer``, ``ddc``,
``replay_ddc``, ``fold``, ``chain``, ``lockin_table`` and ``lockin_at``
each hold hand-written CUDA kernel wrappers beside their plain PyTorch
versions (a wrapper takes the plain version only for CPU tensors)."""

from .fir import fir_taps_direct, streaming_fir, fir_init_state  # noqa: F401
from .spectral import batched_welch, hann_periodic, welch_psd  # noqa: F401
from .tonegen import tone_comb_wavetable  # noqa: F401
from .windows import sinc_window, hamming_window, flat_window  # noqa: F401
