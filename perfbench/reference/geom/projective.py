"""Pinhole projective geometry with analytic Jacobians.

Port of the JAX package's ``geom/projective.py``.  Shapes are edge-batched:
poses ``[N, 7]`` over frames, ``ii/jj [E]`` edge index tensors, disps
``[N, H, W]`` inverse depth at 1/8 resolution, intrinsics ``[N, 4]`` =
(fx, fy, cx, cy).  Points and coordinates keep their components last.
"""

from __future__ import annotations

import torch

from perfbench.reference.lie import se3_act4, se3_adjT_apply, se3_rel

MIN_DEPTH = 0.2

# fixed stereo baseline used for ii == jj (stereo) edges
STEREO_TIJ = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def coords_grid(ht: int, wd: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Pixel coordinate grid [H, W, 2] = (x, y)."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=dtype, device=device),
        torch.arange(wd, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def iproj(disps: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Inverse projection to homogeneous-depth points (X, Y, 1, d).

    disps: [..., H, W]; intrinsics: [..., 4].  Returns [..., H, W, 4].
    """
    ht, wd = disps.shape[-2:]
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    X = ((grid[..., 0] - cx) / fx).expand(disps.shape)
    Y = ((grid[..., 1] - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs: torch.Tensor, intrinsics: torch.Tensor, jacobian: bool = False,
         return_depth: bool = False):
    """Pinhole projection of homogeneous-depth points [..., H, W, 4].

    Returns coords [..., H, W, 2] (3 with depth) and, when ``jacobian``,
    the 2x4 projection Jacobian [..., H, W, 2, 4].
    """
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z

    x = fx * X * d + cx
    y = fy * Y * d + cy
    comps = [x, y, D * d] if return_depth else [x, y]
    coords = torch.stack(comps, dim=-1)
    if not jacobian:
        return coords, None

    o = torch.zeros_like(d)
    fxb = fx.expand_as(d)
    fyb = fy.expand_as(d)
    Jp = torch.stack(
        [
            torch.stack([fxb * d, o, -fxb * X * d * d, o], dim=-1),
            torch.stack([o, fyb * d, -fyb * Y * d * d, o], dim=-1),
        ],
        dim=-2,
    )
    return coords, Jp


def _act_jacobian(X1: torch.Tensor) -> torch.Tensor:
    """Jacobian of the SE(3) action wrt a left-multiplied twist, evaluated
    at X1 = (X, Y, Z, d): [..., 4, 6], columns (vx, vy, vz, wx, wy, wz)."""
    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    r0 = torch.stack([d, o, o, o, Z, -Y], dim=-1)
    r1 = torch.stack([o, d, o, -Z, o, X], dim=-1)
    r2 = torch.stack([o, o, d, Y, -X, o], dim=-1)
    r3 = torch.stack([o, o, o, o, o, o], dim=-1)
    return torch.stack([r0, r1, r2, r3], dim=-2)


def projective_transform(poses, disps, intrinsics, ii, jj,
                         jacobian: bool = False, return_depth: bool = False):
    """Map pixels of frames ii into frames jj.

    Returns (coords [E, H, W, 2(|3)], valid [E, H, W, 1]) and, when
    ``jacobian``, the tuple (Ji, Jj, Jz) with shapes
    ([E, H, W, 2, 6], [E, H, W, 2, 6], [E, H, W, 2, 1]).
    """
    X0 = iproj(disps[ii], intrinsics[ii])  # [E, H, W, 4]
    Gij = se3_rel(poses[ii], poses[jj])  # [E, 7]
    base = torch.tensor(STEREO_TIJ, dtype=Gij.dtype, device=Gij.device)
    Gij = torch.where((ii == jj)[:, None], base, Gij)

    X1 = se3_act4(Gij[:, None, None, :], X0)
    x1, Jp = proj(X1, intrinsics[jj], jacobian=jacobian,
                  return_depth=return_depth)

    valid = ((X1[..., 2:3] > MIN_DEPTH)
             & (X0[..., 2:3] > MIN_DEPTH)).to(disps.dtype)
    if not jacobian:
        return x1, valid

    Ja = _act_jacobian(X1)
    Jj = Jp @ Ja  # [E, H, W, 2, 6]
    Ji = -se3_adjT_apply(Gij[:, None, None, None, :], Jj)

    tij = Gij[..., :3]
    Jz_dir = torch.cat([tij, torch.ones_like(tij[..., :1])], dim=-1)
    Jz = (Jp @ Jz_dir[:, None, None, :, None])  # [E, H, W, 2, 1]
    return x1, valid, (Ji, Jj, Jz)


def projective_transform_batch(poses, disps, intrinsics, ii, jj):
    """:func:`projective_transform` over a leading batch axis (poses
    [B, N, 7], disps [B, N, H, W], intrinsics [B, N, 4]): (coords
    [B, E, H, W, 2], valid [B, E, H, W, 1])."""
    outs = [projective_transform(poses[b], disps[b], intrinsics[b], ii, jj)
            for b in range(poses.shape[0])]
    return (torch.stack([c for c, _ in outs]),
            torch.stack([v for _, v in outs]))


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow induced by camera motion."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid
