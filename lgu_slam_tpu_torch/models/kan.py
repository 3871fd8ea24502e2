"""Kolmogorov-Arnold (B-spline) linear layer (port of the JAX package's
``models/kan.py``; its ``update_grid`` and regularisation loss, which the
train step does not use, come with slice 5 of the port).

Output = silu(x) @ base_weight^T + B(x) . (spline_weight * spline_scaler),
with Cox-de-Boor bases over a fixed uniform per-feature grid.  Parameters
use the reference torch layout (``base_weight [O, I]``, ``spline_weight
[O, I, G+K]``, ``spline_scaler [O, I]``) and the grid is a buffer, so a
reference state dict loads as it is.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def bspline_bases(x: torch.Tensor, grid: torch.Tensor,
                  spline_order: int) -> torch.Tensor:
    """x: [B, I]; grid: [I, G + 2*order + 1].  Returns [B, I, G + order]."""
    x = x[..., None]
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - grid[:, : -(k + 1)]) / (grid[:, k:-1] - grid[:, : -(k + 1)])
        right = (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


class KANLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 grid_size: int = 3, spline_order: int = 3,
                 grid_range=(-1.0, 1.0)):
        super().__init__()
        I, O, G, K = in_features, out_features, grid_size, spline_order
        self.spline_order = K
        h = (grid_range[1] - grid_range[0]) / G
        grid = torch.arange(-K, G + K + 1, dtype=torch.float64) * h \
            + grid_range[0]
        self.register_buffer("grid", grid.float().expand(I, -1).contiguous())
        self.base_weight = nn.Parameter(torch.zeros(O, I))
        self.spline_weight = nn.Parameter(torch.zeros(O, I, G + K))
        self.spline_scaler = nn.Parameter(torch.zeros(O, I))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        base_out = F.silu(x2) @ self.base_weight.t()
        bases = bspline_bases(x2, self.grid, self.spline_order)
        scaled = self.spline_weight * self.spline_scaler[..., None]
        spline_out = torch.einsum("big,oig->bo", bases, scaled)
        out = base_out + spline_out
        return out.reshape(shape[:-1] + (out.shape[-1],))
