"""Plain correlation-volume sampling (port of the gather formulation in
the JAX package's ``ops/sampler.py``).

Boundary rule of the reference CUDA samplers: a bilinear tap is exactly 0
unless its floor corner lies inside the level; a +1 corner that falls
outside reads 0.  These functions are the plain PyTorch versions that the
kernels of ``masked_corr.py``, ``pyramid_lookup.py``, ``window_lookup.py``
and ``k2_parts.py`` are held against, and, through autograd, the training
forward's differentiable lookup (``models/corr.py``).
"""

from __future__ import annotations

import torch


def window_deltas(radius: int, device=None):
    """Tap deltas (dx, dy) [K] in the reference channel order
    ``i * rd + j`` with i indexing x and j indexing y."""
    rd = 2 * radius + 1
    di = torch.arange(rd, dtype=torch.float32, device=device) - radius
    return di.repeat_interleave(rd), di.repeat(rd)


def _gather_volume(vol: torch.Tensor, iy, ix, H2: int, W2: int):
    """vol [B, P1, H2*W2] at integer (iy, ix) [B, P1, K], zero outside."""
    ok = (iy >= 0) & (iy < H2) & (ix >= 0) & (ix < W2)
    idx = torch.where(ok, iy * W2 + ix, torch.zeros_like(ix))
    vals = torch.gather(vol, -1, idx).float()
    return torch.where(ok, vals, torch.zeros_like(vals))


def sample_taps_flat(vol: torch.Tensor, H2: int, W2: int, px: torch.Tensor,
                     py: torch.Tensor) -> torch.Tensor:
    """Bilinear taps from a flat level vol [B, P1, H2*W2] (any float dtype,
    read in fp32) at px/py [B, P1, K].  Returns [B, P1, K] fp32."""
    x1 = torch.floor(px)
    y1 = torch.floor(py)
    dx = px - x1
    dy = py - y1
    base_ok = (x1 >= 0) & (x1 < W2) & (y1 >= 0) & (y1 < H2)
    # out-of-range floors (and NaN) are masked below; clamp keeps the
    # integer conversion defined
    xi = torch.clamp(x1, -1, W2).long()
    yi = torch.clamp(y1, -1, H2).long()
    v11 = _gather_volume(vol, yi, xi, H2, W2)
    v21 = _gather_volume(vol, yi, xi + 1, H2, W2)
    v12 = _gather_volume(vol, yi + 1, xi, H2, W2)
    v22 = _gather_volume(vol, yi + 1, xi + 1, H2, W2)
    out = (v11 * (1.0 - dy) * (1.0 - dx) + v21 * (1.0 - dy) * dx
           + v12 * dy * (1.0 - dx) + v22 * dy * dx)
    return torch.where(base_ok, out, torch.zeros_like(out))


def gaussian_window_mask(volume: torch.Tensor, mean: torch.Tensor,
                         cov: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Windowed Gaussian re-weighting of a volume [B, H1, W1, H2, W2]:
    ``3 exp(-0.5 (dx^2/c1 + dy^2/c2)) * volume`` inside the (2r+1)^2 window
    around ``floor(mean)``, 0 outside.  mean/cov [B, H1, W1, 2]."""
    H2, W2 = volume.shape[-2:]
    mx = mean[..., 0][..., None, None]
    my = mean[..., 1][..., None, None]
    c1 = cov[..., 0][..., None, None]
    c2 = cov[..., 1][..., None, None]
    x2 = torch.arange(W2, dtype=volume.dtype, device=volume.device)
    y2 = torch.arange(H2, dtype=volume.dtype, device=volume.device)[:, None]
    ddx = x2 - mx
    ddy = y2 - my
    in_win = ((torch.abs(x2 - torch.floor(mx)) <= radius)
              & (torch.abs(y2 - torch.floor(my)) <= radius))
    g = 3.0 * torch.exp(-0.5 * (ddx * ddx / c1 + ddy * ddy / c2))
    return torch.where(in_win, volume * g, torch.zeros_like(volume))
