"""Shared small utilities (counterpart of ``nbdistributed_tpu/utils``)."""

from __future__ import annotations

import math

import torch

__all__ = ["fan_in_normal"]


def fan_in_normal(generator: torch.Generator, shape, fan_in, dtype,
                  device=None) -> torch.Tensor:
    """Gaussian init scaled by 1/sqrt(fan_in), drawn in float32 from
    ``generator`` and cast to ``dtype`` — the one initializer every
    model family uses.  ``device`` defaults to the generator's."""
    device = generator.device if device is None else device
    x = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32)
    return (x / math.sqrt(fan_in)).to(dtype)
