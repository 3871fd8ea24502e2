"""Kolmogorov-Arnold (B-spline) linear layer (port of the JAX package's
``models/kan.py``), with its offline grid refit (``update_grid``) and
spline regulariser (``kan_regularization_loss``), which the train step does
not call.

Output = silu(x) @ base_weight^T + B(x) . (spline_weight * spline_scaler),
with Cox-de-Boor bases over a per-feature grid (uniform at init).
Parameters use the reference torch layout (``base_weight [O, I]``,
``spline_weight [O, I, G+K]``, ``spline_scaler [O, I]``) and the grid is a
buffer, read by every forward: a reference state dict loads as it is, an
adapted grid included.
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


def curve2coeff(x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor,
                spline_order: int) -> torch.Tensor:
    """Least-squares spline coefficients of the curve y(x), by the normal
    equations with a 1e-8 ridge, as the JAX package solves them.
    x [B, I], y [B, I, O], grid [I, G + 2*order + 1] -> [O, I, G + order]."""
    A = bspline_bases(x, grid, spline_order).transpose(0, 1)  # [I, B, G+K]
    Y = y.transpose(0, 1)  # [I, B, O]
    AtA = torch.einsum("ibk,ibl->ikl", A, A)
    AtY = torch.einsum("ibk,ibo->iko", A, Y)
    ridge = 1e-8 * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA + ridge, AtY).permute(2, 0, 1)


def update_grid(x: torch.Tensor, grid: torch.Tensor,
                spline_weight: torch.Tensor, spline_scaler: torch.Tensor,
                spline_order: int, margin: float = 0.01,
                grid_eps: float = 0.02):
    """Refit the per-feature grid to the distribution of ``x`` [B, I] (a
    blend of its quantiles and a uniform grid over its range, extended by
    ``spline_order`` knots each side) and refit the spline weights so that
    the scaled spline reproduces the learned curve on ``x``.  Returns
    (grid [I, G+2K+1], spline_weight [O, I, G+K])."""
    B = x.shape[0]
    K = spline_order
    G = spline_weight.shape[-1] - K
    scaled = spline_weight * spline_scaler[..., None]  # [O, I, G+K]
    y = torch.einsum("big,oig->bio", bspline_bases(x, grid, K), scaled)

    x_sorted = torch.sort(x, dim=0).values
    idx = torch.linspace(0, B - 1, G + 1).to(torch.int64)
    grid_adaptive = x_sorted[idx]  # [G+1, I]
    step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / G
    ar = torch.arange(G + 1, dtype=x.dtype, device=x.device)[:, None]
    grid_uniform = ar * step + x_sorted[0] - margin
    core = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive
    k = torch.arange(1, K + 1, dtype=x.dtype, device=x.device)[:, None]
    below = core[:1] - step * k.flip(0)
    above = core[-1:] + step * k
    new_grid = torch.cat([below, core, above], 0).T.contiguous()

    new_weight = curve2coeff(x, y, new_grid, K)
    # the scaler multiplies the stored weight in the forward: divide it out
    scaler = spline_scaler[..., None]
    new_weight = new_weight / torch.where(scaler.abs() < 1e-12,
                                          torch.ones_like(scaler), scaler)
    return new_grid, new_weight


def kan_regularization_loss(spline_weight: torch.Tensor,
                            regularize_activation: float = 1.0,
                            regularize_entropy: float = 1.0) -> torch.Tensor:
    """L1 + entropy regulariser of the spline weights [O, I, G+K]."""
    l1 = torch.mean(torch.abs(spline_weight), dim=-1)  # [O, I]
    act = torch.sum(l1)
    p = l1 / torch.clamp(act, min=1e-12)
    ent = -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)))
    return regularize_activation * act + regularize_entropy * ent


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

    @torch.no_grad()
    def update_grid(self, x: torch.Tensor, margin: float = 0.01,
                    grid_eps: float = 0.02):
        """Refit the grid buffer and the spline weights in place to the
        inputs ``x`` [..., I] (:func:`update_grid`)."""
        grid, weight = update_grid(x.reshape(-1, x.shape[-1]), self.grid,
                                   self.spline_weight, self.spline_scaler,
                                   self.spline_order, margin, grid_eps)
        self.grid.copy_(grid)
        self.spline_weight.copy_(weight)

    def regularization_loss(self, regularize_activation: float = 1.0,
                            regularize_entropy: float = 1.0):
        return kan_regularization_loss(self.spline_weight,
                                       regularize_activation,
                                       regularize_entropy)
