"""Plain PyTorch oracle for the flash attention kernel (port of
``repro.kernels.flash.ref``), its mask, and random kernel inputs."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# Cases that hold the kernel against its plain version on the card:
# (b, sq, skv, hq, hkv, d, causal, window, softcap, dtype). Causal and not,
# sq < skv, windows, softcaps, D 32-256, f32 and bf16, GQA groups 1 and 2,
# lengths that are not multiples of the kernel's 64-row tiles, and sq > skv
# (rows before the first key see nothing and give 0); the ninth is the MoE
# LM's prefill (bf16, causal, D=128, GQA group 1, no softcap, no window).
# The rest are the edges of the bf16 tensor-core kernel: D=256 over many
# tiles with a softcap, a ragged Sq=129 (one row past a 128-row block), a
# window shorter than a tile with GQA group 2, sq > skv, and D=32 (its
# 64-byte swizzle). The last two take head dims the kernel is not built
# for, which the wrapper pads: H2O-Danube-3's D=120 (bf16, a window, GQA
# group 4) and D=96 (f32, a softcap). The last six are SeamlessM4T-medium's
# launches (D=64, 16/16 heads, no mask): its encoder (Sq = Skv = 384) and its
# cross attention over a source longer (Sq < Skv) and shorter (Sq > Skv,
# where every row still sees every key) than the prompt, f32 and bf16.
FLASH_CASES = [
    (2, 200, 200, 4, 4, 64, True, None, None, torch.float32),
    (1, 130, 333, 4, 2, 128, True, None, 50.0, torch.float32),
    (2, 256, 256, 8, 4, 256, True, 96, 50.0, torch.bfloat16),
    (1, 190, 190, 2, 2, 64, False, None, None, torch.bfloat16),
    (1, 300, 300, 4, 2, 256, True, 128, None, torch.float32),
    (2, 64, 64, 2, 1, 32, True, None, 30.0, torch.float32),
    (1, 100, 260, 2, 2, 128, False, 50, None, torch.bfloat16),
    (1, 80, 40, 2, 2, 64, True, None, None, torch.float32),
    (2, 200, 200, 4, 4, 128, True, None, None, torch.bfloat16),
    (1, 1000, 1000, 4, 2, 256, True, None, 50.0, torch.bfloat16),
    (2, 129, 129, 2, 2, 128, True, None, None, torch.bfloat16),
    (1, 200, 200, 4, 2, 64, True, 20, None, torch.bfloat16),
    (1, 150, 100, 2, 1, 128, True, None, None, torch.bfloat16),
    (2, 100, 100, 2, 1, 32, True, None, 30.0, torch.bfloat16),
    (2, 200, 200, 8, 2, 120, True, 64, None, torch.bfloat16),
    (1, 150, 150, 4, 4, 96, True, None, 30.0, torch.float32),
    (2, 384, 384, 16, 16, 64, False, None, None, torch.bfloat16),
    (2, 384, 384, 16, 16, 64, False, None, None, torch.float32),
    (2, 256, 384, 16, 16, 64, False, None, None, torch.bfloat16),
    (2, 256, 384, 16, 16, 64, False, None, None, torch.float32),
    (2, 384, 256, 16, 16, 64, False, None, None, torch.bfloat16),
    (2, 384, 256, 16, 16, 64, False, None, None, torch.float32),
]
# kernel vs plain version, max |got - want| / max(|want|, 1): f32 sums of D
# products and of a row's p*v terms in another order than the plain
# version's matmuls; bf16 rounds p and the output to bf16 (the tolerance of
# tests/test_kernels.py)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None):
    """q: (B, H, Sq, D); k/v: (B, H, Skv, D) -> (B, H, Sq, D).

    Sq positions are right-aligned on Skv (q token i sits at absolute
    position Skv - Sq + i), matching decode/prefill continuation semantics.
    """
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = scale if scale is not None else 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def random_qkv(rng: np.random.Generator, *, b: int, sq: int, skv: int,
               hq: int, hkv: int, d: int, dtype: torch.dtype = torch.float32):
    """Standard-normal numpy q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) as
    CPU tensors of ``dtype`` (the inputs of ``flash_attention``)."""
    shapes = ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(dtype) for s in shapes)


def attention_mask(sq: int, skv: int, *, causal: bool, window: int | None,
                   device) -> torch.Tensor:
    """(Sq, Skv) bool, True where query row i (at position Skv - Sq + i)
    may attend key position j."""
    q_pos = skv - sq + torch.arange(sq, device=device)
    k_pos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask
