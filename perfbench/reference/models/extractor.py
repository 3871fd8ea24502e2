"""RAFT-style feature/context encoders (port of
the JAX package's ``models/extractor.py``).

NHWC throughout.  ``instance`` is the affine-free per-sample, per-channel
normalisation (biased variance, ``nn.InstanceNorm2d(affine=False)``);
``none`` is the identity.  Convolutions run in the compute dtype while the
normalisation statistics stay fp32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.models.conv import Conv

DIM = 32


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.var(x, dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "instance":
        return instance_norm(x)
    if kind == "none":
        return x
    raise ValueError(kind)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = Conv(in_planes, planes, 3, stride, 1, dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, dtype)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride, 0, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_norm(self.conv1(x).float(), self.norm_fn))
        y = F.relu(_norm(self.conv2(y).float(), self.norm_fn))
        if self.downsample is not None:
            x = _norm(self.downsample(x).float(), self.norm_fn)
        return F.relu(x.float() + y)


class BasicEncoder(nn.Module):
    """7x7 stride-2 stem + 3 residual stages -> 1/8 resolution features.
    Input [B, H, W, 3] normalised RGB; output [B, H/8, W/8, output_dim]."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = Conv(3, DIM, 7, 2, 3, dtype)
        cin = DIM
        for stage, (dim, stride) in enumerate(
                [(DIM, 1), (2 * DIM, 2), (4 * DIM, 2)]):
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride, dtype),
                ResidualBlock(dim, dim, norm_fn, 1, dtype),
            ))
            cin = dim
        self.conv2 = Conv(4 * DIM, output_dim, 1, 1, 0, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_norm(self.conv1(x).float(), self.norm_fn))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x).float()
