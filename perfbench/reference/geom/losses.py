"""Training losses (port of the JAX package's ``geom/losses.py``): the
geodesic pose loss with gamma decay and an optional scale fit, the residual
loss, and the induced optical-flow loss with its EPE metrics.  Metrics stay
0-dim tensors on the device."""

from __future__ import annotations

import math

import torch

from perfbench.reference import lie
from perfbench.reference.geom.projective import projective_transform_batch

GAMMA = 0.9  # weight decay of earlier unroll steps


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm whose gradient is 0, not NaN, at exactly 0 (an estimated
    relative pose equal to the ground truth, as between the two BA-fixed
    poses, lands there)."""
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim), min=1e-24))


def _adjacent_edges(N: int, device):
    pairs = [(i, j) for i in range(N) for j in (i - 1, i + 1) if 0 <= j < N]
    ii, jj = zip(*pairs)
    return (torch.tensor(ii, device=device), torch.tensor(jj, device=device))


def fit_scale(dP: torch.Tensor, dG: torch.Tensor) -> torch.Tensor:
    """Least-squares translation scale [B] of dG [B, E, 7] onto dP."""
    t1 = dP[..., :3].reshape(dP.shape[0], -1)
    t2 = dG[..., :3].reshape(dG.shape[0], -1)
    return torch.sum(t1 * t2, -1) / (torch.sum(t2 * t2, -1) + 1e-8)


def geodesic_loss(Ps, Gs_list, ii, jj, do_scale: bool = True):
    """Ps [B, N, 7] ground truth; Gs_list: the [B, N, 7] poses of every
    unroll step.  Returns (loss, metrics); the metrics read the last step."""
    dP = lie.se3_rel(Ps[:, ii], Ps[:, jj])
    n = len(Gs_list)
    total = 0.0
    for i, Gs in enumerate(Gs_list):
        dG = lie.se3_rel(Gs[:, ii], Gs[:, jj])
        if do_scale:
            s = fit_scale(dP, dG)[:, None, None]
            dG = torch.cat([dG[..., :3] * s, dG[..., 3:]], dim=-1)
        d = lie.se3_log(lie.se3_mul(dG, lie.se3_inv(dP)))
        total = total + GAMMA ** (n - i - 1) * (
            torch.mean(safe_norm(d[..., :3])) + torch.mean(safe_norm(d[..., 3:6])))

    dE = lie.se3_mul(dG, lie.se3_inv(dP))
    r_err = (180.0 / math.pi) * torch.linalg.norm(lie.so3_log(dE[..., 3:7]),
                                                  dim=-1)
    t_err = torch.linalg.norm(dE[..., :3], dim=-1)
    metrics = {
        "rot_error": torch.mean(r_err),
        "tr_error": torch.mean(t_err),
        "bad_rot": torch.mean((r_err < 0.1).float()),
        "bad_tr": torch.mean((t_err < 0.01).float()),
    }
    return total, metrics


def residual_loss(residuals):
    n = len(residuals)
    total = 0.0
    for i, r in enumerate(residuals):
        total = total + GAMMA ** (n - i - 1) * torch.mean(torch.abs(r))
    return total, {"residual": total}


def flow_loss(Ps, disps, poses_est, disps_est, intrinsics):
    """Induced-flow EPE against the ground truth over adjacent frames.
    disps/disps_est full resolution [B, N, H, W]; intrinsics full
    resolution [B, N, 4]."""
    ii, jj = _adjacent_edges(Ps.shape[1], Ps.device)
    coords0, val0 = projective_transform_batch(Ps, disps, intrinsics, ii, jj)
    val0 = val0 * (disps[:, ii, :, :, None] > 0).to(val0.dtype)

    n = len(poses_est)
    total = 0.0
    for i in range(n):
        coords1, val1 = projective_transform_batch(poses_est[i], disps_est[i],
                                                   intrinsics, ii, jj)
        v = (val0 * val1)[..., 0]
        epe = v * safe_norm(coords1 - coords0)
        total = total + GAMMA ** (n - i - 1) * torch.mean(epe)

    denom = torch.clamp(torch.sum(v), min=1.0)
    f_error = torch.sum(epe) / denom
    px1 = torch.sum((epe < 1.0).float() * v) / denom
    return total, {"f_error": f_error, "1px": px1}
