"""Learned 2-D Gaussian uncertainty parameters over the correlation volume
(port of ``GaussianMask.predict`` in the JAX package's
``models/gaussian_mask.py``).

From the concatenated feature pair (256 channels) a small MLP predicts a
per-pixel mean offset and a diagonal covariance.  The windowed re-weighting
itself is fused into the level-0 correlation kernel (ops/masked_corr.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

TWO_PI = 6.28  # the reference uses the literal 6.28 (gaussianMask_cuda.py:85)


def _map_normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Whole-map normalisation per batch element over (HW, 2), biased."""
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.var(x, dim=(1, 2), keepdim=True, unbiased=False) + eps
    return (x - mean) / torch.sqrt(var)


class GaussianMask(nn.Module):
    radius = 4

    def __init__(self):
        super().__init__()
        self.map = nn.Linear(256, 16)
        self.meanMap = nn.Linear(16, 2)
        self.covMap = nn.Linear(16, 2)

    def predict(self, x: torch.Tensor):
        """x [B,H,W,256] -> (mean [B,H,W,2], cov [B,H,W,2], det [B,H,W])."""
        b, h, w, _ = x.shape
        tt = torch.tanh(self.map(x))
        mean_ofs = self.meanMap(tt)
        c = self.covMap(tt).reshape(b, h * w, 2)
        c = torch.sigmoid(_map_normalize(c)) * 5.0 + 0.05
        det = (c[..., 0] * c[..., 1]).reshape(b, h, w)
        cov = c.reshape(b, h, w, 2)
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=x.dtype, device=x.device),
            torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
        mean = torch.stack([xs, ys], dim=-1)[None] + mean_ofs
        return mean, cov, det
