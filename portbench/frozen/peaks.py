"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit). A share of a peak is stated
against these, with the card's power limit printed beside it."""

BF16_FLOPS = 989e12
# an f32-accurate product on the tensor cores is three TF32 products (3xTF32),
# and TF32 runs at 495 TFLOP/s dense: the fastest f32-accurate rate the card
# gives
F32_3XTF32_FLOPS = 495e12 / 3
F32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
