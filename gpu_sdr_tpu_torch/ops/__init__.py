"""DSP ops on ``torch.complex64`` tensors.

``pfb`` / ``windows`` / ``tonegen`` are plain PyTorch; ``presum`` and
``channelizer`` each hold a hand-written CUDA kernel beside its plain
PyTorch version (the wrapper takes the plain version only for CPU
tensors)."""
