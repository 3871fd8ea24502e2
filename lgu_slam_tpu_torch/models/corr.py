"""Correlation pyramid, volume path (port of the JAX package's
``models/corr.py`` :97-327): FPN offset heads, the Gaussian-masked level-0
volume (kernel K1), 2x2 average-pooled levels 1-3, and the deformable
lookup (kernel K2).

The per-lookup level-1 gate is the JAX package's documented deviation from
the reference (which compounds the gate in place) and is the spec here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from lgu_slam_tpu_torch.ops.masked_corr import masked_corr_level0
from lgu_slam_tpu_torch.ops.pyramid_lookup import (
    NUM_LEVELS,
    RD,
    fused_pyramid_lookup,
    level_dims,
)


class CorrPyramid(NamedTuple):
    """Per-edge correlation state, leading with the edge axis.  Level l is
    stored flat as [E, H*W, h_l*w_l] in the volume dtype."""

    levels: tuple
    offsets: tuple  # (off0, off1) [E, H, W, 7, 7, 2]
    mean: torch.Tensor  # [E, H, W, 2]
    theta: torch.Tensor  # [E, H, W] 2 * det


def _map_normalize_nhwc(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalisation over (H, W, C) per batch element (biased variance)."""
    mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    var = torch.var(x, dim=(1, 2, 3), keepdim=True, unbiased=False) + eps
    return (x - mean) / torch.sqrt(var)


def fpn_offsets(ofs_map, ofs_residual, t: torch.Tensor):
    """FPN offset fields for levels 0/1 from t [E, H, W, 256] (the feature
    pair).  Returns (off0, off1) [E, H, W, 7, 7, 2]."""
    e, h, w, c = t.shape
    o0 = ofs_map(t)
    t1 = t[:, : h // 2 * 2, : w // 2 * 2].reshape(
        e, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    o1 = ofs_residual(t1)
    # jax.image.resize(..., "nearest") samples at half-pixel centres
    o1 = F.interpolate(o1.permute(0, 3, 1, 2), size=(h, w),
                       mode="nearest-exact").permute(0, 2, 3, 1)
    o0 = torch.tanh(_map_normalize_nhwc(o0)) * 4.0
    o1 = (torch.tanh(_map_normalize_nhwc(o1)) * 4.0 + o0) / 2.0
    return o0.reshape(e, h, w, RD, RD, 2), o1.reshape(e, h, w, RD, RD, 2)


def build_corr_pyramid(ga_predict, ofs_map, ofs_residual, fmap1, fmap2,
                       volume_dtype=torch.float32) -> CorrPyramid:
    """fmap1/fmap2: [E, H, W, 128] fp32 per-edge features."""
    E, H, W, _ = fmap1.shape
    P = H * W
    t = torch.cat([fmap1, fmap2], dim=-1)
    off0, off1 = fpn_offsets(ofs_map, ofs_residual, t)
    mean, cov, det = ga_predict(t)

    lvl0 = masked_corr_level0(fmap1.contiguous(), fmap2.contiguous(),
                              mean.contiguous(), cov.contiguous(),
                              out_dtype=volume_dtype)
    levels = [lvl0]
    v = lvl0
    for (h2, w2), (ho, wo) in zip(level_dims(H, W)[:-1],
                                  level_dims(H, W)[1:]):
        # pixels as channels: one 2x2 pool per level, odd extents floored
        v = F.avg_pool2d(v.reshape(E, P, h2, w2), 2).reshape(E, P, ho * wo)
        levels.append(v)
    return CorrPyramid(tuple(levels), (off0, off1), mean, 2.0 * det)


def corr_lookup(pyr: CorrPyramid, coords: torch.Tensor) -> torch.Tensor:
    """coords [E, H, W, 2] (x, y) at 1/8 resolution -> [E, H, W, 196]."""
    E, H, W, _ = coords.shape
    P1 = H * W
    off0 = pyr.offsets[0].reshape(E, P1, RD, RD, 2).contiguous()
    off1 = pyr.offsets[1].reshape(E, P1, RD, RD, 2).contiguous()
    feats = fused_pyramid_lookup(
        pyr.levels, coords.reshape(E, P1, 2).float().contiguous(), off0,
        off1, H, W)
    return feats.reshape(E, H, W, NUM_LEVELS * RD * RD)
