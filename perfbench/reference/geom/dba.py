"""Inference-time dense bundle adjustment (port of
the JAX package's ``geom/dba.py``).

Gauss-Newton over the poses in a window ``[t0, t1)`` and the inverse depths
of every source frame of the edge list:

- per-edge Hessian blocks from the analytic Jacobians, observations weighted
  by ``WEIGHT_SCALE * weight``; stereo edges (ii == jj) contribute depth
  information only;
- an RGB-D depth prior of strength ``DEPTH_PRIOR_ALPHA`` where a sensed
  disparity exists, the per-frame damping ``eta`` elsewhere;
- the Schur complement over the depth slots, assembled into the dense
  ``[6P, 6P]`` pose system with ``index_add_``;
- a damped ``ep + lm * diag`` Cholesky solve whose non-finite result turns
  into a zero update, retraction, back-substitution and the disparity clamp
  at 1e-3.

The readable formulation of the JAX package (``_build_linear_system_ref``)
is followed; its lane-friendly slabs and one-hot assembly are TPU layout and
are not ported.  The topology plan (:class:`DbaPlan`) is host numpy, built
once per edge list and reused across iterations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.geom import projective as pops
from perfbench.reference.lie import se3_retr

WEIGHT_SCALE = 0.001
DEPTH_PRIOR_ALPHA = 0.05


@dataclass
class DbaPlan:
    """Host-planned topology of one DBA problem, moved to the device once.

    Row space: rows [0, K) are per-slot "self" rows (Eii summed over the
    edges whose source frame is ``kf_ids[k]``; pose ``kf_ids[k]``), rows
    [K, K+E) are per-edge Eij rows (pose ``jj[e]``, depth slot
    ``edge_slot[e]``).
    """

    ii: torch.Tensor  # [E] long
    jj: torch.Tensor  # [E] long
    kf_ids: torch.Tensor  # [K] unique source frames
    edge_slot: torch.Tensor  # [E] slot of ii[e]
    t0: int
    t1: int
    pose_rows: torch.Tensor  # [E] ii - t0 for pose-block assembly
    pose_cols: torch.Tensor  # [E] jj - t0
    row_slot: torch.Tensor  # [K+E]
    rp: torch.Tensor  # [K+E] row pose - t0
    schur_rows: torch.Tensor  # rows inside the window (Schur rhs)
    bsub_rows: torch.Tensor  # rows used by the back-substitution
    rows_of_slot: torch.Tensor  # [K, D] row ids, 0 where padded
    rows_ok: torch.Tensor  # [K, D] float, 1 for a row inside the window
    pair_sel: torch.Tensor  # flat (k, d, e) ids of Schur block pairs
    pair_dst: torch.Tensor  # their destination p_d * P + p_e

    @property
    def P(self) -> int:
        return self.t1 - self.t0

    @staticmethod
    def build(ii, jj, t0: int, t1: int, device,
              strict_t0_quirk: bool = False) -> "DbaPlan":
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        E = ii.shape[0]
        P = t1 - t0
        kf, edge_slot = np.unique(ii, return_inverse=True)
        K = kf.shape[0]

        row_pose = np.concatenate([kf, jj])
        row_slot = np.concatenate([np.arange(K), edge_slot])
        rp = row_pose - t0
        in_win = (rp >= 0) & (rp < P)
        # the reference's back-substitution also skips pose t0
        # (droid_kernels.cu:1105-1106); opt-in, as in the JAX package
        bsub = in_win & (rp >= (1 if strict_t0_quirk else 0))

        groups = [[k] for k in range(K)]
        for e in range(E):
            groups[edge_slot[e]].append(K + e)
        D = max(len(g) for g in groups) if K else 1
        rows = np.zeros((K, D), np.int64)
        ok = np.zeros((K, D), bool)
        for k, g in enumerate(groups):
            rows[k, : len(g)] = g
            ok[k, : len(g)] = in_win[g]
        pd = np.where(ok, rp[rows], 0)
        pair_ok = ok[:, :, None] & ok[:, None, :]
        pair_sel = np.nonzero(pair_ok.reshape(-1))[0]
        pair_dst = (pd[:, :, None] * P + pd[:, None, :]).reshape(-1)[pair_sel]

        def t(a):
            return torch.as_tensor(a, device=device)

        return DbaPlan(
            ii=t(ii), jj=t(jj), kf_ids=t(kf), edge_slot=t(edge_slot),
            t0=int(t0), t1=int(t1),
            pose_rows=t(ii - t0), pose_cols=t(jj - t0),
            row_slot=t(row_slot), rp=t(rp),
            schur_rows=t(np.nonzero(in_win)[0]),
            bsub_rows=t(np.nonzero(bsub)[0]),
            rows_of_slot=t(rows), rows_ok=t(ok.astype(np.float32)),
            pair_sel=t(pair_sel), pair_dst=t(pair_dst),
        )


def build_linear_system(poses, disps, intrinsics, target, weight, ii, jj):
    """Per-edge blocks: He [E,12,12], ve [E,12], Eii/Eij [E,6,HW],
    Cii/bz [E,HW] (intrinsics [N, 4])."""
    E = ii.shape[0]
    HW = disps.shape[-2] * disps.shape[-1]
    coords, valid, (Ji, Jj, Jz) = pops.projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True
    )
    r = target - coords  # [E,H,W,2]
    w_d = WEIGHT_SCALE * weight * valid
    w_p = w_d * (ii != jj).to(w_d.dtype)[:, None, None, None]

    X = torch.cat([Ji, Jj], dim=-1)  # [E,H,W,2,12]
    wX = w_p[..., None] * X
    He = torch.einsum("ehwca,ehwcb->eab", wX, X)
    ve = torch.einsum("ehwca,ehwc->ea", wX, r)

    Jz0 = Jz[..., 0]  # [E,H,W,2]
    wJz_p = w_p * Jz0
    Eii = torch.einsum("ehwc,ehwca->eahw", wJz_p, Ji).reshape(E, 6, HW)
    Eij = torch.einsum("ehwc,ehwca->eahw", wJz_p, Jj).reshape(E, 6, HW)
    Cii = torch.sum(w_d * Jz0 * Jz0, dim=-1).reshape(E, HW)
    bz = torch.sum(w_d * r * Jz0, dim=-1).reshape(E, HW)
    return He, ve, Eii, Eij, Cii, bz


def _pose_system(He, ve, plan: DbaPlan):
    """Dense pose-pose system A [6P, 6P], b [6P] from the edge blocks."""
    P = plan.P
    A = He.new_zeros(P * P, 6, 6)
    b = ve.new_zeros(P, 6)
    ir, jr = plan.pose_rows, plan.pose_cols
    for rows, cols, blk in ((ir, ir, He[:, :6, :6]), (ir, jr, He[:, :6, 6:]),
                            (jr, ir, He[:, 6:, :6]), (jr, jr, He[:, 6:, 6:])):
        ok = (rows >= 0) & (rows < P) & (cols >= 0) & (cols < P)
        A.index_add_(0, (rows * P + cols)[ok], blk[ok])
    for rows, vec in ((ir, ve[:, :6]), (jr, ve[:, 6:])):
        ok = (rows >= 0) & (rows < P)
        b.index_add_(0, rows[ok], vec[ok])
    A = A.reshape(P, P, 6, 6).permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    return A, b.reshape(P * 6)


def _solve_damped(A, b, lm: float, ep: float):
    """Damped Cholesky solve; a failed factorisation or a non-finite
    solution gives a zero update."""
    n = A.shape[0]
    A = A + torch.diag(ep + lm * torch.diagonal(A))
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).all()
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L = torch.where(ok, L, eye)
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    ok = ok & torch.isfinite(dx).all()
    return torch.where(ok, dx, torch.zeros_like(dx))


def edge_rows(Eii, Eij, plan: DbaPlan):
    """The E-matrix rows [K+E, 6, HW]: one self row per source frame (Eii
    summed over its edges), then one row per edge (Eij)."""
    K, HW = plan.kf_ids.shape[0], Eii.shape[-1]
    E_self = Eii.new_zeros(K, 6, HW).index_add_(0, plan.edge_slot, Eii)
    return torch.cat([E_self, Eij], dim=0)


def schur_system(E_rows, Qs, plan: DbaPlan):
    """The Schur complement of the depth slots in the pose system [6P, 6P]:
    per slot k, the blocks E_d diag(Q_k) E_e^T of its rows inside the
    window, summed into their pose pairs."""
    P, K = plan.P, plan.kf_ids.shape[0]
    HW = E_rows.shape[-1]
    D = plan.rows_of_slot.shape[1]
    Eg = E_rows[plan.rows_of_slot] * plan.rows_ok[..., None, None]
    EgQ = (Eg * Qs[:, None, None, :]).reshape(K, D * 6, HW)
    B = torch.bmm(EgQ, Eg.reshape(K, D * 6, HW).transpose(1, 2))
    B = B.reshape(K, D, 6, D, 6).permute(0, 1, 3, 2, 4)
    S = E_rows.new_zeros(P * P, 6, 6)
    S.index_add_(0, plan.pair_dst, B.reshape(K * D * D, 6, 6)[plan.pair_sel])
    return S.reshape(P, P, 6, 6).permute(0, 2, 1, 3).reshape(P * 6, P * 6)


def schur_rhs(E_rows, Qws, plan: DbaPlan):
    """The Schur right-hand side [6P]: v[pose(r)] += E_r (Q w)[slot(r)] over
    the rows inside the window (``Qws`` [K, HW] per slot)."""
    v_rows = torch.einsum("rah,rh->ra", E_rows, Qws[plan.row_slot])
    sr = plan.schur_rows
    vs = E_rows.new_zeros(plan.P, 6).index_add_(0, plan.rp[sr], v_rows[sr])
    return vs.reshape(-1)


def back_substitute(E_rows, dx, plan: DbaPlan):
    """sum over the rows r of each slot of E_r^T dx[pose(r)] -> [K, HW]."""
    br = plan.bsub_rows
    dw_rows = torch.einsum("rah,ra->rh", E_rows[br], dx[plan.rp[br]])
    K, HW = plan.kf_ids.shape[0], E_rows.shape[-1]
    return E_rows.new_zeros(K, HW).index_add_(0, plan.row_slot[br], dw_rows)


def retract_window(poses, dx, plan: DbaPlan):
    poses = poses.clone()
    poses[plan.t0:plan.t1] = se3_retr(poses[plan.t0:plan.t1], dx)
    return poses


def dba_step(poses, disps, intrinsics, disps_sens, target, weight, eta,
             plan: DbaPlan, iters: int = 2, lm: float = 1e-4,
             ep: float = 0.1, motion_only: bool = False,
             alpha: float = DEPTH_PRIOR_ALPHA):
    """Run ``iters`` Gauss-Newton iterations of the dense BA.

    poses [N,7], disps/disps_sens/eta [N,H,W], intrinsics [4] (1/8 scale,
    shared), target/weight [E,H,W,2] in the order of ``plan.ii/jj``.
    Returns new (poses, disps); the inputs are not modified.
    """
    N, ht, wd = disps.shape
    HW = ht * wd
    P = plan.P
    intr_n = intrinsics.expand(N, 4)
    K = plan.kf_ids.shape[0]
    kf = plan.kf_ids

    m_s = (disps_sens[kf] > 0).to(disps.dtype).reshape(K, HW)
    sens_s = disps_sens[kf].reshape(K, HW)
    eta_s = eta[kf].reshape(K, HW)

    for _ in range(iters):
        He, ve, Eii, Eij, Cii, bz = build_linear_system(
            poses, disps, intr_n, target, weight, plan.ii, plan.jj
        )
        A, b = _pose_system(He, ve, plan)
        if motion_only:
            dx = _solve_damped(A, b, lm, ep).reshape(P, 6)
            poses = retract_window(poses, dx, plan)
            continue

        disps_s = disps.reshape(N, HW)[kf]
        Cs = Cii.new_zeros(K, HW).index_add_(0, plan.edge_slot, Cii)
        Cs = Cs + m_s * alpha + (1.0 - m_s) * eta_s
        ws = bz.new_zeros(K, HW).index_add_(0, plan.edge_slot, bz)
        ws = ws - m_s * alpha * (disps_s - sens_s)
        Qs = 1.0 / Cs

        E_rows = edge_rows(Eii, Eij, plan)
        S = schur_system(E_rows, Qs, plan)
        vs = schur_rhs(E_rows, Qs * ws, plan)
        dx = _solve_damped(A - S, b - vs, lm, ep).reshape(P, 6)

        dz = Qs * (ws - back_substitute(E_rows, dx, plan))
        dz = torch.where(torch.isfinite(dz), dz, torch.zeros_like(dz))

        poses = retract_window(poses, dx, plan)
        disps = disps.index_add(0, kf, dz.reshape(K, ht, wd))

    if not motion_only:
        disps = torch.clamp(disps, min=0.001)
    return poses, disps
