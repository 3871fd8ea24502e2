"""Differentiable dense bundle adjustment of the training forward (port of
the JAX package's ``geom/ba.py``).

One Schur-complement Gauss-Newton step over the poses above ``fixedp`` and
the inverse depths of all N frames: per-edge Hessian blocks from the
analytic Jacobians (observations weighted by ``WEIGHT_SCALE * weight``),
scattered with ``index_add`` into the dense pose-pose and pose-depth
blocks, where a block whose pose index falls outside the system (a fixed
pose) is scattered as zero; depths eliminated, poses solved
(:mod:`.chol`), retraction.  A non-finite update becomes 0.  Everything is
out of place, so autograd differentiates the step.  Shapes: poses
[B, N, 7], disps [B, N, H, W], intrinsics [B, N, 4], target/weight
[B, E, H, W, 2], eta [B, N, H, W], ii/jj [E] long tensors.
"""

from __future__ import annotations

import torch

from perfbench.reference.geom import projective as pops
from perfbench.reference.geom.chol import block_solve, schur_solve
from perfbench.reference.lie import se3_retr

WEIGHT_SCALE = 0.001
D = 6


def _scatter_mat(A, ii, jj, n: int, m: int):
    """Per-edge blocks A [B, E, ...] summed into [B, n*m, ...] at
    ii * m + jj; blocks with an index outside [0, n) x [0, m) add 0."""
    valid = (ii >= 0) & (jj >= 0) & (ii < n) & (jj < m)
    idx = torch.where(valid, ii * m + jj, torch.zeros_like(ii))
    A = torch.where(valid.reshape((1, -1) + (1,) * (A.dim() - 2)), A,
                    torch.zeros_like(A))
    out = A.new_zeros((A.shape[0], n * m) + A.shape[2:])
    return out.index_add(1, idx, A)


def _scatter_vec(b, ii, n: int):
    return _scatter_mat(b, ii, torch.zeros_like(ii), n, 1)


def _edge_blocks(poses, disps, intrinsics, target, weight, ii, jj,
                 depth: bool):
    """Per batch element: the weighted Jacobian products of every edge.
    Returns (Hii, Hij, Hji, Hjj, vi, vj) and, with ``depth``, (Ei, Ej, wk,
    Ck), each stacked over the batch."""
    E = ii.shape[0]
    out = []
    for b in range(poses.shape[0]):
        coords, valid, (Ji, Jj, Jz) = pops.projective_transform(
            poses[b], disps[b], intrinsics[b], ii, jj, jacobian=True)
        r = (target[b] - coords).reshape(E, -1, 1)  # [E, HW*2, 1]
        w = WEIGHT_SCALE * (valid * weight[b]).reshape(E, -1, 1)
        Ji = Ji.reshape(E, -1, D)
        Jj = Jj.reshape(E, -1, D)
        wJiT = (w * Ji).transpose(1, 2)  # [E, D, HW*2]
        wJjT = (w * Jj).transpose(1, 2)
        blocks = [wJiT @ Ji, wJiT @ Jj, wJjT @ Ji, wJjT @ Jj,
                  (wJiT @ r)[..., 0], (wJjT @ r)[..., 0]]
        if depth:
            HW = Jz.shape[1] * Jz.shape[2]
            Jz = Jz.reshape(E, HW, 2)
            w2 = w.reshape(E, HW, 2)
            blocks += [
                torch.sum(wJiT.reshape(E, D, HW, 2) * Jz[:, None], dim=-1),
                torch.sum(wJjT.reshape(E, D, HW, 2) * Jz[:, None], dim=-1),
                torch.sum(w2 * r.reshape(E, HW, 2) * Jz, dim=-1),
                torch.sum(w2 * Jz * Jz, dim=-1),
            ]
        out.append(blocks)
    return [torch.stack(x) for x in zip(*out)]


def _pose_system(blocks, ii, jj, fixedp: int, N: int):
    Hii, Hij, Hji, Hjj, vi, vj = blocks
    B = Hii.shape[0]
    P = N - fixedp
    iip, jjp = ii - fixedp, jj - fixedp
    H = (_scatter_mat(Hii, iip, iip, P, P) + _scatter_mat(Hij, iip, jjp, P, P)
         + _scatter_mat(Hji, jjp, iip, P, P)
         + _scatter_mat(Hjj, jjp, jjp, P, P)).reshape(B, P, P, D, D)
    v = _scatter_vec(vi, iip, P) + _scatter_vec(vj, jjp, P)
    return H, v


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _retract(poses, dx, fixedp: int):
    B, N = poses.shape[:2]
    dx_full = torch.cat([dx.new_zeros(B, fixedp, D), dx], dim=1)
    return se3_retr(poses, dx_full)


def ba(target, weight, eta, poses, disps, intrinsics, ii, jj,
       fixedp: int = 1):
    """One full-BA Gauss-Newton step.  Returns updated (poses, disps)."""
    B, N, ht, wd = disps.shape
    HW = ht * wd
    blocks = _edge_blocks(poses, disps, intrinsics, target, weight, ii, jj,
                          depth=True)
    H, v = _pose_system(blocks[:6], ii, jj, fixedp, N)
    Ei, Ej, wk, Ck = blocks[6:]
    P = N - fixedp
    iip, jjp = ii - fixedp, jj - fixedp
    Em = (_scatter_mat(Ei, iip, ii, P, N)
          + _scatter_mat(Ej, jjp, ii, P, N)).reshape(B, P, N, D, HW)
    C = _scatter_vec(Ck, ii, N) + eta.reshape(B, N, HW) + 1e-7
    w = _scatter_vec(wk, ii, N)

    dx, dz = schur_solve(H, Em, C, v, w)
    poses = _retract(poses, _finite(dx), fixedp)
    disps = disps + _finite(dz).reshape(B, N, ht, wd)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    return poses, torch.maximum(disps, torch.zeros_like(disps))


def moba(target, weight, poses, disps, intrinsics, ii, jj, fixedp: int = 1):
    """Motion-only BA step: the poses above ``fixedp`` at fixed depths."""
    blocks = _edge_blocks(poses, disps, intrinsics, target, weight, ii, jj,
                          depth=False)
    H, v = _pose_system(blocks, ii, jj, fixedp, poses.shape[1])
    return _retract(poses, _finite(block_solve(H, v)), fixedp)
