"""DSP ops on ``torch.complex64`` tensors.

``pfb`` / ``windows`` / ``tonegen`` / ``fir`` / ``chirp`` / ``lockin``
are plain PyTorch or numpy; ``presum``, ``channelizer``, ``ddc``,
``replay_ddc``, ``fold``, ``chain``, ``lockin_table`` and ``lockin_at``
each hold hand-written CUDA kernel wrappers beside their plain PyTorch
versions (a wrapper takes the plain version only for CPU tensors)."""
