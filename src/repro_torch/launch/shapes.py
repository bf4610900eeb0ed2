"""Assigned input-shape sets and their spec builders per (arch, shape)
(port of ``repro.launch.shapes``).

Shapes (assignment):
    train_4k     seq 4,096   global_batch 256   (training)
    prefill_32k  seq 32,768  global_batch 32    (inference prefill)
    decode_32k   seq 32,768  global_batch 128   (decode: 1 new token, cache
                                                 holds seq_len)
    long_500k    seq 524,288 global_batch 1     (long-context decode;
                                                 sub-quadratic archs only)

A spec is a fake tensor made under a ``FakeTensorMode``: it has a shape,
a dtype and a device and holds no storage, so no full-size config is ever
allocated (the JAX package's ``ShapeDtypeStruct``). ``decode_specs`` runs
the port's ``init_decode_cache`` under that mode, as the JAX package runs
its own under ``eval_shape``. The cache's ``pos`` is the plain int the
port's cache holds, set to ``seq_len - 1``: the last prompt token sits at
the final slot, so the one-token step writes inside the buffer (the JAX
spec keeps ``seq_len`` and its ``dynamic_update_slice`` clamps the write
to the same slot; the port's cache update raises past the buffer).
Each builder takes the mode to make its specs in (``fake_mode``, default
a new one): specs that meet in one step must come from one mode.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: long_500k requires "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def _spec(mode: FakeTensorMode, shape, dtype, device) -> torch.Tensor:
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def _inputs(cfg, b, tokens_len, s, mode, device) -> dict:
    out = {"tokens": _spec(mode, (b, tokens_len), torch.int32, device)}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = _spec(
            mode, (b, cfg.n_frontend_tokens, cfg.d_model), cfg.torch_dtype,
            device)
    if cfg.is_encdec:
        out["enc_frames"] = _spec(mode, (b, s, cfg.d_model), cfg.torch_dtype,
                                  device)
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, *, fake_mode=None,
                device="cpu") -> dict:
    """Training batch specs (tokens carry the shifted target)."""
    b, s = shape.global_batch, shape.seq_len
    return _inputs(cfg, b, s + 1, s, fake_mode or FakeTensorMode(), device)


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec, *, fake_mode=None,
                  device="cpu") -> dict:
    b, s = shape.global_batch, shape.seq_len
    return _inputs(cfg, b, s, s, fake_mode or FakeTensorMode(), device)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, *, fake_mode=None,
                 device="cpu") -> dict:
    """token and cache specs: ``init_decode_cache`` under the fake mode."""
    from repro_torch.models.transformer import init_decode_cache

    mode = fake_mode or FakeTensorMode()
    b, s = shape.global_batch, shape.seq_len
    with mode:
        cache = init_decode_cache(cfg, b, s, src_len=s if cfg.is_encdec else 0,
                                  device=device)
    cache["pos"] = s - 1
    return {"token": _spec(mode, (b, 1), torch.int32, device), "cache": cache}


def input_specs(cfg: ModelConfig, shape_name, *, fake_mode=None,
                device="cpu") -> dict:
    """The cell's inputs: a shape's name in ``SHAPES``, or a ``ShapeSpec``
    of its own (a test's smaller cell)."""
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    kw = {"fake_mode": fake_mode, "device": device}
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, **kw)}
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape, **kw)
    return decode_specs(cfg, shape, **kw)
