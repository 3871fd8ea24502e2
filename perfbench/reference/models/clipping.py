"""Gradient clipping pass-through (port of the JAX package's
``models/clipping.py``): identity forward; the backward sets NaN entries and
entries with |g| > 0.01 of the incoming gradient to 0."""

from __future__ import annotations

import torch

GRAD_CLIP = 0.01


class GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return torch.where(g.abs() > GRAD_CLIP, torch.zeros_like(g), g)


def grad_clip(x: torch.Tensor) -> torch.Tensor:
    return GradClip.apply(x)
