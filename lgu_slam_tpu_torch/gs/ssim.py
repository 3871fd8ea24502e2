"""SSIM for the mapping loss (port of the JAX package's ``gs/ssim.py``;
reference: to3DGS/utils/slam_external.py ``calc_ssim`` -- 11x11 Gaussian
window, C1/C2 for [0,1] images)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lgu_slam_tpu_torch.utils.device import full_fp32_convs


def _gaussian_window(size=11, sigma=1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


_WIN = _gaussian_window()


def _filter(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 11x11 filter on [H, W, C] with zero ("SAME") padding."""
    win = torch.as_tensor(_WIN, device=x.device)[None, None]
    y = F.conv2d(x.permute(2, 0, 1)[:, None], win, padding=5)
    return y[:, 0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """img [H, W, C] in [0, 1].  Returns mean SSIM scalar.  The filter
    runs in full fp32 (no TF32 on the card); a caller that differentiates
    through it runs its backward under ``full_fp32_convs`` too."""
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    with full_fp32_convs():
        mu1 = _filter(img1)
        mu2 = _filter(img2)
        mu1_sq = mu1 * mu1
        mu2_sq = mu2 * mu2
        mu12 = mu1 * mu2
        s1 = _filter(img1 * img1) - mu1_sq
        s2 = _filter(img2 * img2) - mu2_sq
        s12 = _filter(img1 * img2) - mu12
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    )
    return torch.mean(m)
