"""Frame distance metric (port of the JAX package's ``geom/distance.py``).

The distance between frames (i, j) is a beta-blend of the mean induced-flow
magnitude under (a) the full relative SE(3) transform and (b) a
translation-only transform, with pixels behind the camera excluded; if
fewer than 75% of (weighted) pixels are valid the distance saturates to
1000.
"""

from __future__ import annotations

import torch

from perfbench.reference.geom.projective import MIN_DEPTH, coords_grid, iproj
from perfbench.reference.lie import se3_act4, se3_rel


def _flow_magnitude(disps_i, intr, Gij, translation_only: bool):
    """(accum, valid, total) per edge for one direction."""
    E, ht, wd = disps_i.shape
    X = iproj(disps_i, intr)  # [E, H, W, 4]
    if translation_only:
        Xj3 = X[..., :3] + X[..., 3:4] * Gij[:, None, None, :3]
    else:
        Xj3 = se3_act4(Gij[:, None, None, :], X)[..., :3]

    fx, fy, cx, cy = intr[:, None, None, :].unbind(-1)
    grid = coords_grid(ht, wd, dtype=disps_i.dtype, device=disps_i.device)
    z = Xj3[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = fx * Xj3[..., 0] / zsafe + cx
    v = fy * Xj3[..., 1] / zsafe + cy
    d = torch.sqrt((u - grid[..., 0]) ** 2 + (v - grid[..., 1]) ** 2)

    ok = (z > MIN_DEPTH).to(d.dtype)
    accum = torch.sum(ok * d, dim=(1, 2))
    valid = torch.sum(ok, dim=(1, 2))
    total = torch.full((E,), float(ht * wd), dtype=d.dtype, device=d.device)
    return accum, valid, total


def frame_distance(poses, disps, intrinsics, ii, jj, beta: float = 0.3):
    """One-directional distance d(ii -> jj); poses [N,7], disps [N,h,w],
    intrinsics [4] shared.  Returns [E]."""
    intr = intrinsics.expand(ii.shape[0], 4)
    Gij = se3_rel(poses[ii], poses[jj])
    disps_i = disps[ii]

    a1, v1, t1 = _flow_magnitude(disps_i, intr, Gij, translation_only=False)
    a2, v2, t2 = _flow_magnitude(disps_i, intr, Gij, translation_only=True)

    accum = beta * a1 + (1.0 - beta) * a2
    valid = beta * v1 + (1.0 - beta) * v2
    total = beta * t1 + (1.0 - beta) * t2

    frac = valid / (total + 1e-8)
    far = torch.full_like(accum, 1000.0)
    return torch.where(frac < 0.75, far, accum / torch.clamp(valid, min=1e-8))


def frame_distance_bidirectional(poses, disps, intrinsics, ii, jj,
                                 beta: float = 0.3):
    """0.5 * (d(i->j) + d(j->i))."""
    d1 = frame_distance(poses, disps, intrinsics, ii, jj, beta)
    d2 = frame_distance(poses, disps, intrinsics, jj, ii, beta)
    return 0.5 * (d1 + d2)
