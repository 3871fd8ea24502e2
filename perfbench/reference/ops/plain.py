"""Plain versions of the two correlation kernels: the Gaussian-masked
level-0 volume and the fused deformable pyramid lookup (frozen copies of
the formulas in ``ops/masked_corr.py`` and ``ops/pyramid_lookup.py`` of the
port, which its kernels are held to)."""

from __future__ import annotations

import torch

from perfbench.reference.ops.sampler import (
    gaussian_window_mask,
    sample_taps_flat,
    window_deltas,
)

TWO_PI = 6.28  # the reference's literal (gaussianMask_cuda.py:85)
EDGE_CHUNK = 8  # edges per step (bounds the fp32 transients)
NUM_LEVELS = 4
RADIUS = 3
RD = 2 * RADIUS + 1


def window_epilogue(corr, mean, cov, radius: int):
    """The Gaussian re-weighting of corr [n, H, W, H, W] inside each source
    pixel's window (mean/cov [n, H, W, 2])."""
    masked = gaussian_window_mask(corr, mean, cov, radius)
    denom = TWO_PI * torch.sqrt(cov[..., 0] * cov[..., 1])[..., None, None]
    return masked / denom + corr


def masked_corr_level0_plain(fmap1, fmap2, mean, cov, radius: int = 4):
    """fmap1/fmap2 [E, H, W, C], mean/cov [E, H, W, 2] -> float32 [E, P, P]:
    corr = <f1, f2> / 16, re-weighted inside the 9 x 9 window."""
    E, H, W, C = fmap1.shape
    P = H * W
    out = torch.empty(E, P, P, dtype=torch.float32, device=fmap1.device)
    for lo in range(0, E, EDGE_CHUNK):
        sl = slice(lo, lo + EDGE_CHUNK)
        n = fmap1[sl].shape[0]
        a = fmap1[sl].reshape(n, P, C).float() / 4.0
        b = fmap2[sl].reshape(n, P, C).float() / 4.0
        corr = torch.bmm(a, b.transpose(1, 2)).reshape(n, H, W, H, W)
        out[sl] = window_epilogue(corr, mean[sl].float(), cov[sl].float(),
                                  radius).reshape(n, P, P)
    return out


def level_dims(H: int, W: int):
    """(h_l, w_l) of the 4 levels: 2x2 pools that floor odd extents."""
    dims = []
    for _ in range(NUM_LEVELS):
        dims.append((H, W))
        H, W = H // 2, W // 2
    return dims


def tap_positions(base, offset, radius: int):
    """Tap positions (px, py) [E, P1, K] from base coords [E, P1, 2] and
    per-tap offsets [E, P1, rd, rd, 2] (None for a plain window); the
    centre tap's offset is zeroed (straight-through) and offsets are
    clipped to +-4."""
    rd = 2 * radius + 1
    dx, dy = window_deltas(radius, base.device)
    if offset is None:
        return base[..., 0:1] + dx, base[..., 1:2] + dy
    off = offset.reshape(offset.shape[:2] + (rd * rd, 2))
    centre = torch.arange(rd * rd, device=off.device) == radius * rd + radius
    off = torch.where(centre[:, None], off - off.detach(), off)
    off = torch.clamp(off, -4.0, 4.0)
    return base[..., 0:1] + off[..., 0] + dx, base[..., 1:2] + off[..., 1] + dy


def fused_pyramid_lookup_plain(levels, cflat, off0, off1, H: int, W: int):
    """levels: 4 flat levels [E, P1, h_l*w_l]; cflat [E, P1, 2]; off0/off1
    [E, P1, 7, 7, 2] -> [E, P1, 196]: a radius-1 probe of level 1 gates
    level 1's offsets, then 4 levels x 49 bilinear taps."""
    dims = level_dims(H, W)
    h1, w1 = dims[1]
    ppx, ppy = tap_positions(cflat / 2.0, None, 1)
    probe = sample_taps_flat(levels[1], h1, w1, ppx, ppy)
    gate = torch.sigmoid(torch.var(probe, dim=-1))[..., None, None, None]
    offs = (off0, off1 * gate, None, None)
    out = []
    for lvl, (hh, ww) in enumerate(dims):
        base = cflat / (2.0 ** lvl)
        px, py = tap_positions(base, offs[lvl], RADIUS)
        out.append(sample_taps_flat(levels[lvl], hh, ww, px, py))
    return torch.cat(out, dim=-1)
