"""SCN U-Net for 3D semantic segmentation (port of ``repro.models.scn``).

Submanifold 3^3 conv blocks at each level, 2^3 stride-2 convs down,
transposed convs back up with skip concatenation, and a linear classifier
over active voxels. ``SCNUNet``'s parameter tree mirrors the JAX package's
``init_unet``: ``stem``, ``levels[i].enc/down/up/dec`` and ``head``;
``params_from_jax`` carries a JAX parameter tree across, so both packages
compute the same function. Execution lives in ``repro_torch.engine``;
``segmentation_loss`` is what the trainer minimises, through autograd over
untiled plans (``reference`` convs), as the JAX package trains.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.core.sparse_conv import SparseConvParams
from repro_torch.device import require_device
from repro_torch.engine import api


@dataclass(frozen=True)
class UNetConfig:
    name: str = "scn_unet"
    in_channels: int = 4
    n_classes: int = 20
    widths: tuple[int, ...] = (16, 32, 48, 64)
    reps: int = 2
    resolution: int = 64
    capacity: int = 8192
    dtype: torch.dtype = torch.float32

    @property
    def n_levels(self) -> int:
        return len(self.widths)


class SparseConv(nn.Module):
    """Weights (K, C, N) and bias (N,) of one sparse conv."""

    def __init__(self, kernel_volume: int, c_in: int, c_out: int, *,
                 generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        fan_in = kernel_volume * c_in
        w = torch.randn((kernel_volume, c_in, c_out), generator=generator,
                        dtype=dtype) / np.sqrt(fan_in)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros((c_out,), dtype=dtype))

    @property
    def params(self) -> SparseConvParams:
        return SparseConvParams(self.weight, self.bias)


class ConvBlock(nn.Module):
    """Submanifold conv + masked BatchNorm + ReLU."""

    def __init__(self, c_in: int, c_out: int, *, generator, dtype):
        super().__init__()
        self.conv = SparseConv(27, c_in, c_out, generator=generator, dtype=dtype)
        self.bn_scale = nn.Parameter(torch.ones((c_out,), dtype=dtype))
        self.bn_offset = nn.Parameter(torch.zeros((c_out,), dtype=dtype))


class Level(nn.Module):
    """One U-Net level: encoder blocks, and (above the bottom) the down and
    up convs and the decoder blocks, the first of which sees the
    concatenated skip and upsampled features (2 * width channels)."""

    def __init__(self, cfg: UNetConfig, li: int, *, generator):
        super().__init__()
        w, dt = cfg.widths, cfg.dtype
        self.enc = nn.ModuleList(
            ConvBlock(w[li], w[li], generator=generator, dtype=dt)
            for _ in range(cfg.reps))
        self.down = self.up = None
        self.dec = nn.ModuleList()
        if li < cfg.n_levels - 1:
            self.down = SparseConv(8, w[li], w[li + 1], generator=generator,
                                   dtype=dt)
            self.up = SparseConv(8, w[li + 1], w[li], generator=generator,
                                 dtype=dt)
            self.dec = nn.ModuleList(
                ConvBlock(2 * w[li] if r == 0 else w[li], w[li],
                          generator=generator, dtype=dt)
                for r in range(cfg.reps))


class Head(nn.Module):
    def __init__(self, c_in: int, n_classes: int, *, generator, dtype):
        super().__init__()
        self.w = nn.Parameter(torch.randn((c_in, n_classes), generator=generator,
                                          dtype=dtype) / np.sqrt(c_in))
        self.b = nn.Parameter(torch.zeros((n_classes,), dtype=dtype))


class SCNUNet(nn.Module):
    """The SCN U-Net's parameters; ``forward`` is ``engine.apply_unet``.

    Weights are drawn on the CPU from ``generator`` (seed 0 when omitted),
    so one seed gives the same model on every device, then moved to
    ``device``.
    """

    def __init__(self, cfg: UNetConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = require_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.stem = SparseConv(27, cfg.in_channels, cfg.widths[0], generator=g,
                               dtype=cfg.dtype)
        self.levels = nn.ModuleList(
            Level(cfg, li, generator=g) for li in range(cfg.n_levels))
        self.head = Head(cfg.widths[0], cfg.n_classes, generator=g,
                         dtype=cfg.dtype)
        self.to(dev)

    def forward(self, feats, plan, **kw) -> torch.Tensor:
        return api.apply_unet(self, feats, plan, **kw)


def params_from_jax(tree: dict, cfg: UNetConfig, *,
                    device: str | torch.device = "cuda") -> SCNUNet:
    """An ``SCNUNet`` holding the JAX package's ``init_unet`` parameters.

    ``tree`` is that parameter tree with numpy leaves (each sparse conv a
    ``(weight, bias)`` pair); every shape is checked against ``cfg``.
    """
    model = SCNUNet(cfg, device=device)

    def put(param: nn.Parameter, value):
        value = torch.as_tensor(np.array(value), dtype=param.dtype)
        if value.shape != param.shape:
            raise ValueError(f"JAX parameter of shape {tuple(value.shape)} "
                             f"where {tuple(param.shape)} was expected")
        with torch.no_grad():
            param.copy_(value)

    def put_conv(conv: SparseConv, value):
        weight, bias = value
        put(conv.weight, weight)
        put(conv.bias, bias)

    def put_block(block: ConvBlock, value: dict):
        put_conv(block.conv, value["conv"])
        put(block.bn_scale, value["bn_scale"])
        put(block.bn_offset, value["bn_offset"])

    put_conv(model.stem, tree["stem"])
    if len(tree["levels"]) != cfg.n_levels:
        raise ValueError(f"{len(tree['levels'])} JAX levels for "
                         f"{cfg.n_levels} configured")
    for level, lt in zip(model.levels, tree["levels"]):
        for names, mods in (("enc", level.enc), ("dec", level.dec)):
            blocks = lt.get(names, [])
            if len(blocks) != len(mods):
                raise ValueError(f"{len(blocks)} JAX {names} blocks for "
                                 f"{len(mods)} configured")
            for block, bt in zip(mods, blocks):
                put_block(block, bt)
        if level.down is not None:
            put_conv(level.down, lt["down"])
            put_conv(level.up, lt["up"])
    put(model.head.w, tree["head"]["w"])
    put(model.head.b, tree["head"]["b"])
    return model


def segmentation_loss(logits: torch.Tensor, labels, mask
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross-entropy over active voxels, in f32, and the
    accuracy there: logits (V, n_classes), labels (V,) ints, mask (V,)
    bool -> (loss, acc), both 0-dim f32."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    m = torch.as_tensor(mask, device=logits.device).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[:, None])[:, 0]
    n = m.sum().clamp(min=1.0)
    loss = -(ll * m).sum() / n
    acc = ((logits.argmax(-1) == labels).float() * m).sum() / n
    return loss, acc


def miou(pred: np.ndarray, labels: np.ndarray, mask: np.ndarray,
         n_classes: int) -> float:
    """Mean intersection-over-union over the classes present in either the
    prediction or the labels, on active voxels."""
    pred, labels = np.asarray(pred)[mask], np.asarray(labels)[mask]
    ious = []
    for c in range(n_classes):
        inter = np.sum((pred == c) & (labels == c))
        union = np.sum((pred == c) | (labels == c))
        if union:
            ious.append(inter / union)
    return float(np.mean(ious)) if ious else 0.0
