"""Plain PyTorch reference of a dense decoder LM of the Llama kind
(Granite-8B-code: arXiv:2405.04324), in f32, one full forward over each
sequence: no cache, no kernels, no batching of the program's.

Per layer: RMSNorm (f32, times its weight), grouped-query attention with
rotary embeddings on split halves (base ``rope_theta``) and a causal mask
over every position (the engine's left pads are tokens it attends, as the
program's prefill does), a residual; RMSNorm, SwiGLU, a residual. A final
RMSNorm and the tied embedding as the output head.

Weights are the benchmark's (``families/decoder_lm.make_weights``), each
matrix (in, out); a layer's are cast to f32 as it runs, so only one layer
is held in f32 at a time.
"""
from __future__ import annotations

import torch

from portbench.reference.precision import exact_f32, matmul


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta):
    """x (B, S, H, D) f32 rotated by its positions (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits_at(weights: dict, shape: dict, tokens: torch.Tensor,
              positions: slice, precision: str = "f32") -> torch.Tensor:
    """Logits (B, len(positions), vocab) f32 of ``tokens`` (B, S) at the
    given positions."""
    b, s = tokens.shape
    h, hkv, d = shape["heads"], shape["kv_heads"], shape["head_dim"]
    eps = shape["norm_eps"]
    pos = torch.arange(s, device=tokens.device)
    causal = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    with exact_f32():
        x = weights["embed"][tokens.long()].float()
        for lp in weights["layers"]:
            a = lp["attn"]
            hn = rms_norm(x, lp["ln1"], eps)
            q = rope(matmul(hn, a["wq"], precision).view(b, s, h, d), pos,
                     shape["rope_theta"])
            k = rope(matmul(hn, a["wk"], precision).view(b, s, hkv, d), pos,
                     shape["rope_theta"])
            v = matmul(hn, a["wv"], precision).view(b, s, hkv, d)
            k = k.repeat_interleave(h // hkv, dim=2)
            v = v.repeat_interleave(h // hkv, dim=2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
            sc = sc.masked_fill(~causal, float("-inf")).softmax(-1)
            o = torch.einsum("bhqk,bkhd->bqhd", sc, v).reshape(b, s, h * d)
            x = x + matmul(o, a["wo"], precision)
            m = lp["mlp"]
            hn = rms_norm(x, lp["ln2"], eps)
            g = torch.nn.functional.silu(matmul(hn, m["w_gate"], precision))
            x = x + matmul(g * matmul(hn, m["w_up"], precision), m["w_down"],
                           precision)
        x = rms_norm(x[:, positions], weights["final_norm"], eps)
        return matmul(x, weights["embed"].T, precision)[..., :shape["vocab"]]
