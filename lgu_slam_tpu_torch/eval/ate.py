"""Trajectory metrics in NumPy (the port's own copy of the JAX package's
``eval/ate.py``, identical in every function): Umeyama / Horn alignment
and the absolute trajectory error, the relative pose error, KITTI segment
errors, the TartanAir protocol, TUM / EuRoC trajectory IO and timestamp
association.

Reference parity:
- ATE with Horn alignment + optional scale:
  evaluation/evaluate_ate_scale.py (Horn closed form) and
  evaluation/evaluator_base.py:28-55; also the evo APE
  ``align=True, correct_scale=True`` protocol used by test_tum.py:119-120
  and test_euroc.py:141-142 (Umeyama Sim(3) alignment on translations).
- RPE: evaluation/evaluate_rpe.py (relative pose error over a fixed frame
  delta).
- KITTI-style per-length segment errors: evaluation/evaluate_kitti.py.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning x -> y (both [N, 3]).

    Returns (s, R, t) with y ≈ s R x + t.
    """
    mu_x = x.mean(0)
    mu_y = y.mean(0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / x.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / x.shape[0]
    s = float(np.trace(np.diag(d) @ S) / var_x) if with_scale else 1.0
    t = mu_y - s * R @ mu_x
    return s, R, t


def ate_rmse(gt_xyz: np.ndarray, est_xyz: np.ndarray,
             correct_scale: bool = True):
    """Absolute trajectory error after Sim(3)/SE(3) alignment.

    Returns (rmse, aligned_est, (s, R, t)).
    """
    s, R, t = umeyama_alignment(est_xyz, gt_xyz, with_scale=correct_scale)
    aligned = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    return float(np.sqrt((err ** 2).mean())), aligned, (s, R, t)


def _pose_to_matrix(p):
    """(t, q) 7-vec -> 4x4 (q = x, y, z, w)."""
    t, q = p[:3], p[3:7]
    x, y, z, w = q
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def rpe(gt_poses: np.ndarray, est_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame pairs (i, i+delta); poses [N, 7]
    camera-to-world.  Returns (trans_rmse, rot_rmse_deg)."""
    N = min(len(gt_poses), len(est_poses))
    terrs, rerrs = [], []
    for i in range(N - delta):
        Tg0 = _pose_to_matrix(gt_poses[i])
        Tg1 = _pose_to_matrix(gt_poses[i + delta])
        Te0 = _pose_to_matrix(est_poses[i])
        Te1 = _pose_to_matrix(est_poses[i + delta])
        dg = np.linalg.inv(Tg0) @ Tg1
        de = np.linalg.inv(Te0) @ Te1
        err = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(err[:3, 3]))
        ang = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.degrees(np.arccos(ang)))
    return (
        float(np.sqrt(np.mean(np.square(terrs)))),
        float(np.sqrt(np.mean(np.square(rerrs)))),
    )


def kitti_metrics(gt_poses: np.ndarray, est_poses: np.ndarray,
                  lengths=(100, 200, 300, 400, 500, 600, 700, 800)):
    """KITTI per-length translation (%) / rotation (deg/m) errors."""
    def traj_distances(poses):
        d = [0.0]
        for i in range(1, len(poses)):
            d.append(d[-1] + np.linalg.norm(poses[i, :3] - poses[i - 1, :3]))
        return np.asarray(d)

    dist = traj_distances(gt_poses)
    t_errs, r_errs = [], []
    for first in range(0, len(gt_poses), 10):
        for L in lengths:
            idx = np.searchsorted(dist, dist[first] + L)
            if idx >= len(gt_poses):
                continue
            Tg = np.linalg.inv(_pose_to_matrix(gt_poses[first])) @ \
                _pose_to_matrix(gt_poses[idx])
            Te = np.linalg.inv(_pose_to_matrix(est_poses[first])) @ \
                _pose_to_matrix(est_poses[idx])
            err = np.linalg.inv(Tg) @ Te
            t_errs.append(np.linalg.norm(err[:3, 3]) / L)
            ang = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
            r_errs.append(np.degrees(np.arccos(ang)) / L)
    if not t_errs:
        return {"t_rel": float("nan"), "r_rel": float("nan")}
    return {
        "t_rel": float(np.mean(t_errs) * 100.0),
        "r_rel": float(np.mean(r_errs)),
    }


# -- TartanAir benchmark protocol (evaluation/tartanair_evaluator.py) --------

def _poses_to_matrices(poses: np.ndarray) -> np.ndarray:
    """[N, 7] (t, q=xyzw) -> [N, 4, 4]."""
    return np.stack([_pose_to_matrix(p) for p in poses])


def horn_ate(gt_xyz: np.ndarray, est_xyz: np.ndarray,
             calc_scale: bool = False):
    """ATE via Horn's closed form, reference flavor
    (evaluation/evaluate_ate_scale.py:50-101): the rotation maps gt into
    the est frame, the scale ``s = Σ|gt_zc|² / Σ est_zc·(R gt_zc)`` is
    applied to the *estimate* ("scale the est to the gt"), and the error
    is ``(R gt + t) − s est``.  Returns (rmse, s).
    """
    model = np.asarray(gt_xyz, np.float64).T  # [3, N]
    data = np.asarray(est_xyz, np.float64).T
    mzc = model - model.mean(1, keepdims=True)
    dzc = data - data.mean(1, keepdims=True)
    W = mzc @ dzc.T
    U, d, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    if calc_scale:
        dots = np.sum(dzc * (rot @ mzc))
        norms = np.sum(mzc ** 2)
        s = float(norms / dots)
    else:
        s = 1.0
    trans = s * data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = (rot @ model + trans) - s * data
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=0)))), s


def rpe_all_pairs(gt_mats: np.ndarray, est_mats: np.ndarray):
    """Relative pose error over ALL frame pairs (i, j).

    Deterministic equivalent of the reference protocol
    (evaluation/evaluate_rpe.py:83-140 with ``param_max_pairs=0``; the
    shipped default draws 10k random *unseeded* pairs — same estimator,
    nondeterministic).  Returns (rot_mean_rad, trans_mean): the mean over
    pairs of the rotation angle / translation norm of
    ``inv(inv(est_j) est_i) (inv(gt_j) gt_i)``.
    """
    N = len(gt_mats)
    Rg = gt_mats[:, :3, :3]
    tg = gt_mats[:, :3, 3]
    Re = est_mats[:, :3, :3]
    te = est_mats[:, :3, 3]
    t_sum = 0.0
    r_sum = 0.0
    for j in range(N):
        # rel_e[i] = inv(est_j) @ est_i ; err = inv(rel_e) @ rel_g
        Reji = np.einsum("ab,nbc->nac", Re[j].T, Re)
        teji = (te - te[j]) @ Re[j]
        Rgji = np.einsum("ab,nbc->nac", Rg[j].T, Rg)
        tgji = (tg - tg[j]) @ Rg[j]
        Rerr = np.einsum("nab,nac->nbc", Reji, Rgji)  # RejiT @ Rgji
        terr = np.einsum("nab,na->nb", Reji, tgji - teji)
        t_sum += np.linalg.norm(terr, axis=1).sum()
        tr = np.clip((np.trace(Rerr, axis1=1, axis2=2) - 1) / 2, -1, 1)
        r_sum += np.arccos(tr).sum()
    return r_sum / N ** 2, t_sum / N ** 2


def kitti_rel_errors(gt_mats: np.ndarray, est_mats: np.ndarray,
                     lengths=(5, 10, 15, 20, 25, 30, 35, 40)):
    """KITTI segment errors, reference flavor (evaluation/evaluate_kitti.py:
    step 1, per-length averaging, then the mean over lengths).

    Returns (rot_deg_per_m, trans_frac_per_m).
    """
    dist = np.concatenate([
        [0.0],
        np.cumsum(np.linalg.norm(np.diff(gt_mats[:, :3, 3], axis=0), axis=1)),
    ])
    per_len_rot = {L: [] for L in lengths}
    per_len_tra = {L: [] for L in lengths}
    for first in range(len(gt_mats)):
        for L in lengths:
            # first frame strictly past dist[first] + L (reference
            # last_frame_from_segment_length semantics)
            nxt = np.searchsorted(dist, dist[first] + L, side="right")
            if nxt >= len(gt_mats):
                continue
            dg = np.linalg.inv(gt_mats[first]) @ gt_mats[nxt]
            de = np.linalg.inv(est_mats[first]) @ est_mats[nxt]
            err = np.linalg.inv(de) @ dg
            ang = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
            per_len_rot[L].append(np.arccos(ang) / L)
            per_len_tra[L].append(np.linalg.norm(err[:3, 3]) / L)
    rot = [np.mean(per_len_rot[L]) for L in lengths if per_len_rot[L]]
    tra = [np.mean(per_len_tra[L]) for L in lengths if per_len_tra[L]]
    if not rot:
        return float("nan"), float("nan")
    return float(np.degrees(np.mean(rot))), float(np.mean(tra))


def tartanair_evaluate(gt_traj: np.ndarray, est_traj: np.ndarray,
                       scale: bool = False) -> dict:
    """Full TartanAir scoring chain (tartanair_evaluator.py:48-77):
    Sim(3)/SE(3)-aligned ATE, then RPE + KITTI errors on the aligned
    trajectories.  ``scale=True`` for monocular, ``False`` for stereo.

    The global alignment rotation/translation cancels in all relative
    metrics, so only the fitted scale is applied before RPE/KITTI
    (evaluator_base.py:41-52 builds the aligned trajectory explicitly;
    the relative errors are identical).
    """
    gt_traj = np.asarray(gt_traj, np.float64)
    est_traj = np.asarray(est_traj, np.float64)
    ate, s = horn_ate(gt_traj[:, :3], est_traj[:, :3], calc_scale=scale)
    est_scaled = est_traj.copy()
    est_scaled[:, :3] *= s
    gt_mats = _poses_to_matrices(gt_traj)
    est_mats = _poses_to_matrices(est_scaled)
    rpe_score = rpe_all_pairs(gt_mats, est_mats)
    kitti_score = kitti_rel_errors(gt_mats, est_mats)
    return {
        "ate_score": ate,
        "rpe_score": rpe_score,
        "kitti_score": kitti_score,
        "scale": s,
    }


# -- trajectory file IO (TUM format: t tx ty tz qx qy qz qw) ----------------

def save_tum_trajectory(path, tstamps, poses):
    with open(path, "w") as f:
        for t, p in zip(tstamps, poses):
            f.write(
                f"{t} " + " ".join(f"{v:.6f}" for v in p[:7]) + "\n"
            )


def load_tum_trajectory(path):
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:8]


def load_euroc_gt_txt(path):
    """EuRoC ground-truth .txt (the files vendored by the reference at
    data/euroc_groundtruth/*.txt): ``t[ns] px py pz qw qx qy qz`` with a
    ``#`` header.  Returns (t_seconds [N], poses [N, 7] with q = xyzw).
    """
    data = np.loadtxt(path)
    t = data[:, 0] / 1e9
    poses = np.concatenate(
        [data[:, 1:4], data[:, [5, 6, 7, 4]]], axis=1
    )
    return t, poses


def associate(stamps_a, stamps_b, max_dt=0.08, offset=0.0):
    """Greedy nearest-timestamp association
    (data_readers/rgbd_utils.py:16-88 TUM protocol)."""
    pairs = []
    used_b = set()
    for ia, ta in enumerate(stamps_a):
        diffs = np.abs(stamps_b + offset - ta)
        ib = int(np.argmin(diffs))
        if diffs[ib] < max_dt and ib not in used_b:
            pairs.append((ia, ib))
            used_b.add(ib)
    return pairs
