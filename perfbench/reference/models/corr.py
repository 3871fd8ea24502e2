"""Correlation: a frozen plain copy of the port's ``models/corr.py``.

- Volume path (the frontend): FPN offset heads, the Gaussian-masked level-0
  volume, 2x2 average-pooled levels 1-3, and the deformable lookup, all in
  their plain formulation, the levels rounded to the volume dtype.
- Low-memory path (the backend): a pooled feature pyramid per keyframe and
  the correlation computed on the fly as fused bilinear feature dots per
  tap.  This path has no Gaussian mask.
- The training forward takes the volume path in float32 (``differentiable``)
  and autograd differentiates it.

The per-lookup level-1 gate is the JAX package's documented deviation from
the original model (which compounds the gate in place) and is the spec here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from perfbench.reference.ops.plain import (
    NUM_LEVELS,
    RADIUS,
    RD,
    fused_pyramid_lookup_plain,
    level_dims,
    masked_corr_level0_plain,
)
from perfbench.reference.ops.sampler import window_deltas
from perfbench.reference.precision import rnd


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
                       volume_dtype=torch.float32,
                       differentiable: bool = False) -> CorrPyramid:
    """fmap1/fmap2: [E, H, W, 128] per-edge features.  The offset heads and
    ``ga_predict`` take them in float32; every level is rounded to
    ``volume_dtype`` unless ``differentiable`` (the training forward)."""
    E, H, W, _ = fmap1.shape
    P = H * W
    t = torch.cat([fmap1.float(), fmap2.float()], dim=-1)
    off0, off1 = fpn_offsets(ofs_map, ofs_residual, t)
    mean, cov, det = ga_predict(t)
    dt = torch.float32 if differentiable else volume_dtype
    lvl0 = rnd(masked_corr_level0_plain(fmap1, fmap2, mean, cov), dt)
    levels = [lvl0]
    v = lvl0
    for (h2, w2), (ho, wo) in zip(level_dims(H, W)[:-1],
                                  level_dims(H, W)[1:]):
        # pixels as channels: one 2x2 pool per level, odd extents floored
        v = rnd(F.avg_pool2d(v.reshape(E, P, h2, w2), 2), dt)
        v = v.reshape(E, P, ho * wo)
        levels.append(v)
    return CorrPyramid(tuple(levels), (off0, off1), mean, 2.0 * det)


def corr_lookup(pyr: CorrPyramid, coords: torch.Tensor) -> torch.Tensor:
    """coords [E, H, W, 2] (x, y) at 1/8 resolution -> [E, H, W, 196]."""
    E, H, W, _ = coords.shape
    P1 = H * W
    off0 = pyr.offsets[0].reshape(E, P1, RD, RD, 2)
    off1 = pyr.offsets[1].reshape(E, P1, RD, RD, 2)
    cflat = coords.reshape(E, P1, 2).float()
    feats = fused_pyramid_lookup_plain(pyr.levels, cflat, off0, off1, H, W)
    return feats.reshape(E, H, W, NUM_LEVELS * RD * RD)


# -- low-memory path (backend) ----------------------------------------------

def build_fmap_pyramid(fmaps: torch.Tensor):
    """Average-pool pyramid of feature maps [N, H, W, C] -> 4 levels
    [N, H/2^l, W/2^l, C] (odd extents floored), pre-scaled by 1/4 and
    pooled in the stored dtype."""
    levels = [fmaps / 4.0]
    x = levels[0]
    for _ in range(NUM_LEVELS - 1):
        n, h, w, c = x.shape
        x = x[:, : h // 2 * 2, : w // 2 * 2].reshape(
            n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
        levels.append(x)
    return tuple(levels)


def _fused_tap_dot(f1, f2, px, py):
    """<f1[e, y, x], bilinear(f2[e])(px, py)> with the reference boundary
    rule.  f1 [E, H1, W1, C]; f2 [E, H2, W2, C]; px/py [E, H1, W1]."""
    e, h2, w2, c = f2.shape
    x1 = torch.floor(px)
    y1 = torch.floor(py)
    dx = (px - x1)[..., None]
    dy = (py - y1)[..., None]
    base_ok = (x1 >= 0) & (x1 < w2) & (y1 >= 0) & (y1 < h2)
    # out-of-range floors are masked; clamp keeps the integer cast defined
    xi = torch.clamp(x1, -1, w2).long()
    yi = torch.clamp(y1, -1, h2).long()
    f2f = f2.reshape(e, h2 * w2, c)
    rows = torch.arange(e, device=f2.device)[:, None]

    def corner(iy, ix):
        ok = (iy >= 0) & (iy < h2) & (ix >= 0) & (ix < w2)
        idx = torch.where(ok, iy * w2 + ix, torch.zeros_like(ix))
        g = f2f[rows, idx.reshape(e, -1)].reshape(f1.shape)
        return g * ok[..., None]

    v = (corner(yi, xi) * (1 - dy) * (1 - dx)
         + corner(yi, xi + 1) * (1 - dy) * dx
         + corner(yi + 1, xi) * dy * (1 - dx)
         + corner(yi + 1, xi + 1) * dy * dx)
    out = torch.sum(f1 * v, dim=-1)
    return torch.where(base_ok, out, torch.zeros_like(out))


def alt_corr_level(f1, f2_lvl, coords_lvl, offsets, radius: int = RADIUS):
    """Deformable correlation at one pyramid level by fused tap dots.
    f1 [E, H1, W1, C] (level-0 features / 4); f2_lvl [E, H2, W2, C];
    coords_lvl [E, H1, W1, 2] in level pixels; offsets [E, H1, W1, rd, rd,
    2] (the centre tap's is zeroed).  Returns [E, H1, W1, rd*rd]."""
    rd = 2 * radius + 1
    offsets = offsets.clone()
    offsets[..., radius, radius, :] = 0.0
    offs = offsets.reshape(offsets.shape[:3] + (rd * rd, 2))
    dx, dy = (d.tolist() for d in window_deltas(radius))
    taps = [_fused_tap_dot(f1, f2_lvl,
                           coords_lvl[..., 0] + offs[..., k, 0] + dx[k],
                           coords_lvl[..., 1] + offs[..., k, 1] + dy[k])
            for k in range(rd * rd)]
    return torch.stack(taps, dim=-1)


def alt_corr_lookup(fmap_pyr, ii, jj, coords, ofs_map, ofs_residual):
    """Backend correlation features computed on the fly by fused tap dots.
    fmap_pyr: the 4 levels of :func:`build_fmap_pyramid`; ii/jj [E] feature
    indices (rig-expanded by the caller); coords [E, H, W, 2].  Returns
    [E, H, W, 196] fp32."""
    f1 = fmap_pyr[0][ii]
    # offsets from the unscaled feature pair: the /4 pyramid times 4
    t = torch.cat([f1 * 4.0, fmap_pyr[0][jj] * 4.0], dim=-1)
    off0, off1 = fpn_offsets(ofs_map, ofs_residual, t)

    # level-1 variance gate from a plain radius-1 window at coords / 2
    zeros9 = coords.new_zeros(coords.shape[:3] + (3, 3, 2))
    probe = alt_corr_level(f1, fmap_pyr[1][jj], coords / 2.0, zeros9,
                           radius=1)
    gate = torch.sigmoid(torch.var(probe, dim=-1))[..., None, None, None]

    offs = (off0, off1 * gate, torch.zeros_like(off0), torch.zeros_like(off0))
    return torch.cat([alt_corr_level(f1, fmap_pyr[lvl][jj],
                                     coords / 2.0 ** lvl, offs[lvl])
                      for lvl in range(NUM_LEVELS)], dim=-1)
