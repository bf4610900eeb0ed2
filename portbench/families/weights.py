"""Weights made on the run's device from its seed, in a few large draws:
one ``torch.Generator`` on the device, seeded from the run's seed, draws
the tensors in the order given."""
from __future__ import annotations

import math

import torch

from portbench.frozen.traffic import seed_sequence


def generator(seed: int, tag: int, device: torch.device) -> torch.Generator:
    state = int(seed_sequence(seed, tag).generate_state(1, dtype="uint64")[0])
    return torch.Generator(device=device).manual_seed(state & (2**63 - 1))


def normal(g: torch.Generator, shape, std: float, dtype, device,
           mean: float = 0.0) -> torch.Tensor:
    """N(mean, std^2) in ``dtype``, drawn in one call and scaled in place."""
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    t.mul_(std)
    if mean:
        t.add_(mean)
    return t


def fan_in_std(shape) -> float:
    """1/sqrt(fan in) of a (..., K, C, N) or (..., C, N) weight."""
    fan = math.prod(shape[-3:-1]) if len(shape) >= 3 else shape[0]
    return 1.0 / math.sqrt(fan)
