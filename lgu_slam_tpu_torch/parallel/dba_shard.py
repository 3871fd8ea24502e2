"""Dense bundle adjustment over a process group (port of the JAX package's
``parallel/dba_shard.py`` to ``torch.distributed``).

The edges are partitioned by source frame ``ii``: each rank owns a
contiguous range of frames, balanced by edge count, and holds every edge
whose source frame it owns.  So every E-matrix row of a depth frame (its
self row and all its edge rows) lives on one rank:

- each rank builds the blocks of its own edges (``geom/dba.py``'s
  ``build_linear_system``, ``_pose_system`` and the Schur pieces);
- the partial pose systems, the depth diagonals and right-hand sides, the
  Schur complements and the back-substitution are summed with
  ``all_reduce`` (SUM), where the JAX package sums with ``psum``;
- the reduced pose solve (``_solve_damped``) runs the same on every rank,
  so poses and disparities come out replicated.

The collective backend follows the device: NCCL for CUDA tensors, gloo for
CPU tensors; any other pairing raises.  The port keeps the plan's
partition and drops its static shape buckets (TPU layout).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from lgu_slam_tpu_torch.geom.dba import (
    DEPTH_PRIOR_ALPHA,
    DbaPlan,
    _pose_system,
    _solve_damped,
    back_substitute,
    build_linear_system,
    edge_rows,
    retract_window,
    schur_rhs,
    schur_system,
)

_BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}


def check_group(group, device) -> int:
    """The group's world size, after checking that its backend is the one
    for ``device`` (NCCL on CUDA, gloo on the CPU)."""
    want = _BACKEND_OF_DEVICE.get(torch.device(device).type)
    have = str(dist.get_backend(group)).lower()
    if want is None or have != want:
        raise RuntimeError(
            f"a {have} process group cannot reduce {device} tensors "
            f"(use {want or 'nccl on cuda or gloo on cpu'})")
    return dist.get_world_size(group)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def frame_ranges(ii, num_frames: int, n_shards: int) -> np.ndarray:
    """Owner rank of every frame: contiguous frame ranges, each closed once
    it holds ``ceil(E / n_shards)`` source edges (the JAX package's rule).
    Returns ``owned`` [n_shards, num_frames] bool."""
    counts = np.bincount(ii, minlength=num_frames)
    target = max(1, int(np.ceil(len(ii) / n_shards)))
    bounds, acc = [0], 0
    for f in range(num_frames):
        acc += counts[f]
        if acc >= target and len(bounds) < n_shards:
            bounds.append(f + 1)
            acc = 0
    while len(bounds) < n_shards:
        bounds.append(num_frames)
    bounds.append(num_frames)
    owned = np.zeros((n_shards, num_frames), bool)
    for s in range(n_shards):
        owned[s, bounds[s]:bounds[s + 1]] = True
    return owned


@dataclass
class ShardedDbaPlan:
    """Which rank owns which frames, and which edges each rank holds."""

    owned: np.ndarray  # [D, N] exclusive frame ownership
    perm: list  # per rank: the global edge ids it holds, in edge order

    @property
    def n_shards(self) -> int:
        return self.owned.shape[0]

    @staticmethod
    def build(ii, jj, num_frames: int, n_shards: int) -> "ShardedDbaPlan":
        ii = np.asarray(ii, np.int64).reshape(-1)
        owned = frame_ranges(ii, num_frames, n_shards)
        shard_of_edge = np.argmax(owned, axis=0)[ii]
        perm = [np.nonzero(shard_of_edge == s)[0] for s in range(n_shards)]
        return ShardedDbaPlan(owned, perm)


def sharded_dba_iters(group, poses, disps, intrinsics, disps_sens, eta,
                      t0: int, t1: int, target, weight, ii, jj,
                      iters: int = 2, lm: float = 1e-4, ep: float = 0.1,
                      motion_only: bool = False,
                      alpha: float = DEPTH_PRIOR_ALPHA,
                      strict_t0_quirk: bool = False):
    """``iters`` Gauss-Newton iterations over the rank's own edges (``ii``,
    ``jj`` numpy, ``target``/``weight`` [E_local, H, W, 2]), every sum
    over edges completed by ``all_reduce`` on ``group``.  poses [N, 7],
    disps/disps_sens/eta [N, H, W] and intrinsics [4] are the same on every
    rank, and so are the returned (poses, disps).  Frames updated: those in
    ``[t0, t1)`` and those with edges, as in the JAX package."""
    N, ht, wd = disps.shape
    HW = ht * wd
    dev = disps.device
    plan = DbaPlan.build(ii, jj, t0, t1, dev,
                         strict_t0_quirk=strict_t0_quirk)
    P, kf = plan.P, plan.kf_ids
    local = len(ii) > 0
    intr_n = intrinsics.expand(N, 4)

    frames = torch.arange(N, device=dev)
    has_edge = all_sum(torch.zeros(N, device=dev).index_add_(
        0, plan.ii, torch.ones(len(ii), device=dev)), group) > 0
    frame_active = (((frames >= t0) & (frames < t1)) | has_edge).to(
        disps.dtype)
    m = (disps_sens > 0).to(disps.dtype).reshape(N, HW)
    eta = eta.reshape(N, HW)

    for _ in range(iters):
        if local:
            He, ve, Eii, Eij, Cii, bz = build_linear_system(
                poses, disps, intr_n, target, weight, plan.ii, plan.jj)
            A, b = _pose_system(He, ve, plan)
        else:
            A = disps.new_zeros(P * 6, P * 6)
            b = disps.new_zeros(P * 6)
        A, b = all_sum(A, group), all_sum(b, group)
        if motion_only:
            dx = _solve_damped(A, b, lm, ep).reshape(P, 6)
            poses = retract_window(poses, dx, plan)
            continue

        C = disps.new_zeros(N, HW)
        w = disps.new_zeros(N, HW)
        if local:
            C.index_add_(0, plan.ii, Cii)
            w.index_add_(0, plan.ii, bz)
        C = all_sum(C, group) + m * alpha + (1.0 - m) * eta
        w = all_sum(w, group) - m * alpha * (disps - disps_sens).reshape(
            N, HW)
        Q = 1.0 / C

        if local:
            E_rows = edge_rows(Eii, Eij, plan)
            S = schur_system(E_rows, Q[kf], plan)
            vs = schur_rhs(E_rows, (Q * w)[kf], plan)
        else:
            S, vs = torch.zeros_like(A), torch.zeros_like(b)
        S, vs = all_sum(S, group), all_sum(vs, group)
        dx = _solve_damped(A - S, b - vs, lm, ep).reshape(P, 6)

        dw = disps.new_zeros(N, HW)
        if local:
            dw.index_add_(0, kf, back_substitute(E_rows, dx, plan))
        dw = all_sum(dw, group)
        dz = Q * (w - dw)
        dz = torch.where(torch.isfinite(dz), dz, torch.zeros_like(dz))
        dz = dz * frame_active[:, None]

        poses = retract_window(poses, dx, plan)
        disps = disps + dz.reshape(N, ht, wd)

    if not motion_only:
        disps = torch.clamp(disps, min=0.001)
    return poses, disps


def dba_step_sharded(group, poses, disps, intrinsics, disps_sens, target,
                     weight, eta, ii, jj, t0: int, t1: int,
                     iters: int = 2, lm: float = 1e-4, ep: float = 0.1,
                     motion_only: bool = False,
                     alpha: float = DEPTH_PRIOR_ALPHA,
                     strict_t0_quirk: bool = False):
    """The dense BA of the whole edge list (``ii``/``jj`` numpy [E],
    ``target``/``weight`` [E, H, W, 2], the same on every rank) over the
    ranks of ``group``: each rank keeps the edges of the frames it owns
    (:class:`ShardedDbaPlan`) and runs :func:`sharded_dba_iters`."""
    D = check_group(group, disps.device)
    rank = dist.get_rank(group)
    ii = np.asarray(ii, np.int64).reshape(-1)
    jj = np.asarray(jj, np.int64).reshape(-1)
    plan = ShardedDbaPlan.build(ii, jj, disps.shape[0], D)
    sel = plan.perm[rank]
    idx = torch.as_tensor(sel, device=target.device)
    return sharded_dba_iters(
        group, poses, disps, intrinsics, disps_sens, eta, t0, t1,
        target[idx], weight[idx], ii[sel], jj[sel], iters=iters, lm=lm,
        ep=ep, motion_only=motion_only, alpha=alpha,
        strict_t0_quirk=strict_t0_quirk)
