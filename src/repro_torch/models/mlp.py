"""Feed-forward blocks: SwiGLU, GeGLU and GELU-MLP, and the RWKV channel
mix (port of ``repro.models.mlp``).

``jax.nn.gelu`` defaults to the tanh approximation, so GeGLU and GELU use
``F.gelu(..., approximate="tanh")``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype, device: torch.device) -> dict:
    def w(shape):
        return dense_init(generator, shape, dtype, device)

    if act in ("swiglu", "geglu"):
        return {"w_gate": w((d_model, d_ff)), "w_up": w((d_model, d_ff)),
                "w_down": w((d_ff, d_model))}
    if act == "gelu":
        return {"w_up": w((d_model, d_ff)), "w_down": w((d_ff, d_model))}
    if act == "rwkv_cm":
        return {"w_k": w((d_model, d_ff)), "w_v": w((d_ff, d_model)),
                "w_r": w((d_model, d_model)),
                "mu_k": torch.zeros((d_model,), dtype=dtype, device=device),
                "mu_r": torch.zeros((d_model,), dtype=dtype, device=device)}
    raise ValueError(act)


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    if act == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * (x @ params["w_up"])
        return h @ params["w_down"]
    if act == "gelu":
        return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
    raise ValueError(act)


def apply_rwkv_channel_mix(params: dict, x: torch.Tensor,
                           x_prev: torch.Tensor) -> torch.Tensor:
    """RWKV channel mix with token shift. x, x_prev: (B, S, d), x_prev being
    x shifted right by one (x_{t-1})."""
    xk = x + (x_prev - x) * params["mu_k"]
    xr = x + (x_prev - x) * params["mu_r"]
    k = torch.square(F.relu(xk @ params["w_k"]))
    return torch.sigmoid(xr @ params["w_r"]) * (k @ params["w_v"])
