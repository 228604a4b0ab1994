"""DSP ops on ``torch.complex64`` tensors.

``pfb`` / ``windows`` / ``tonegen`` / ``fir`` are plain PyTorch or
numpy; ``presum``, ``channelizer``, ``ddc``, ``replay_ddc`` and ``fold``
each hold hand-written CUDA kernel wrappers beside their plain PyTorch
versions (a wrapper takes the plain version only for CPU tensors)."""
