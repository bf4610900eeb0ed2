"""Feed-forward blocks: SwiGLU, GeGLU and GELU-MLP (port of
``repro.models.mlp``; the RWKV channel-mix comes with the RWKV slice).

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
