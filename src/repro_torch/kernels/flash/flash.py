"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.flash.flash.flash_attention``. The kernel
(``kernels/csrc/flash_fwd.cu``) takes the model layout directly, q
``(B, Sq, Hq, D)`` and k/v ``(B, Skv, Hkv, D)``, and folds GQA by indexing
kv head ``h // (Hq // Hkv)``, so nothing is repeated in device memory.
bf16 runs on the tensor cores (``wgmma``, K/V tiles fed by ``cp.async``),
f32 on the CUDA cores (TF32 would keep ~3 digits). It
keeps the TPU kernel's semantics: f32 scores scaled by ``D**-0.5``, the
softcap before the mask, q right-aligned on the kv sequence, causal and
window masks at ``-1e30``, an f32 online max and sum, ``p`` rounded to v's
dtype before the PV product, and ``acc / max(l, 1e-30)``, so a fully
masked row gives 0. ``flash_attention_plain`` computes the same function
with plain PyTorch ops (``attention_ref`` semantics in f32, with the
kernel's zero for fully masked rows); the wrapper uses it only for tensors
that lie on the CPU.

The kernel is instantiated at the head dims of ``HEAD_DIMS``. A head dim
between them (H2O-Danube-3's 120) is zero-padded inside the wrapper to
the next one, and the kernel gets the real dim's scale: zero columns add
nothing to q k^T, and zero columns of v give outputs that are sliced
away, so the launch computes the kernel's function at the real head dim.
The CPU path takes any head dim, as the JAX package's attention does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash.ref import NEG_INF, attention_mask

KERNEL = "flash_fwd"
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# flash_fwd(q, k, v, out, dtype, b, sq, skv, hq, hkv, d, causal, window,
#           softcap, scale, stream) of csrc/flash_fwd.cu
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.flash_fwd.argtypes = ARGTYPES
    lib.flash_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only (the kernel has no backward "
            "yet): run under torch.no_grad()")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: all (Sq, Skv) scores at once,
    in f32 (the caller's memory must hold ``B*Hq*Sq*Skv`` f32 twice)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(b, sq, hkv, g, d),
                     k.float())
    s.mul_(1.0 / d ** 0.5)
    if softcap is not None:
        s.div_(softcap).tanh_().mul_(softcap)
    masked = ~attention_mask(sq, skv, causal=causal, window=window,
                             device=q.device)
    s.masked_fill_(masked, NEG_INF)
    p = s.sub_(s.amax(-1, keepdim=True)).exp_().masked_fill_(masked, 0.0)
    l = p.sum(-1, keepdim=True).clamp_(min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return (o / l.permute(0, 3, 1, 2, 4)).reshape(b, sq, hq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Attention forward -> (B, Sq, Hq, D) in q's dtype.

    q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) with Hq a multiple of Hkv;
    float32 or bfloat16; on the card D at most ``HEAD_DIMS[-1]`` (a D
    between instantiations is padded, see the module docstring). Query
    row i sits at position
    ``Skv - Sq + i``; ``window`` keeps keys with ``k_pos > q_pos - window``;
    ``softcap`` applies ``cap * tanh(s / cap)`` to the scaled scores.

    On CUDA tensors this launches the kernel (and counts the launch in
    ``flash_attention.launches``); on CPU tensors it runs
    ``flash_attention_plain``. Any other device raises.
    """
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k and v")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kd = next((h for h in HEAD_DIMS if h >= d), None)
    if kd is None:
        raise ValueError(f"head dim {d} is larger than the kernel's largest, "
                         f"{HEAD_DIMS[-1]}")
    if kd != d:   # zero columns: the kernel's function at the real d
        q, k, v = (torch.nn.functional.pad(x, (0, kd - d)) for x in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out[..., :d]
    fn = _library().flash_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, sq, skv, hq, hkv, kd, int(causal),
                 window or 0, softcap or 0.0, 1.0 / d ** 0.5, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out if kd == d else out[..., :d].contiguous()


flash_attention.launches = 0
