"""Production and host meshes (port of ``repro.launch.mesh``).

Functions, not module constants, so that importing touches no process
group. Single pod: (16, 16) = 256 ranks, dims ``("data", "model")``;
multi-pod: (2, 16, 16) = 512 ranks, dims ``("pod", "data", "model")``. A
world of that size comes from a launcher, or from the ``fake`` backend for
a dry run on one process.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.dist.compat import make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{math.prod(shape)} ranks, not {world}")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model: int = 1, *, device: str | torch.device = "cuda"):
    """``("data", "model")`` over every rank of the default process group
    (tests and local runs)."""
    n = dist.get_world_size()
    if model < 1 or n % model != 0:
        raise ValueError(
            f"model={model} must be a positive divisor of the device count "
            f"({n}); a silent 0-sized data axis helps nobody")
    return make_mesh((n // model, model), ("data", "model"), device=device)
