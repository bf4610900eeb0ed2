"""repro_torch: the PyTorch/CUDA port of the AccSS3D reproduction.

The host-side planners (AdMAC metadata, SOAR ordering, SPADE dataflow
selection, SSpNNA tile tables) are numpy, as in the JAX package; the
forward pass runs on PyTorch tensors, and the fused SSpNNA sparse conv is a
hand-written CUDA kernel (``kernels/csrc/sspnna_fused.cu``).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back to the CPU.
"""
