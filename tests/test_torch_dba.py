"""Port parity: lgu_slam_tpu_torch.geom.dba.dba_step against the JAX
package's dba_step on the problems of tests/test_dba.py -- the synthetic
scene from identity poses, an RGB-D prior, a stereo edge with a window that
leaves edges outside it, motion-only, the back-substitution quirk, NaN
targets and the zero-weight graph.

Both sides run fp32; the JAX side pads edges and poses to its buckets.  A
Gauss-Newton step solves a damped 6P x 6P system whose conditioning scales
fp32 rounding, so poses and inverse depths agree to ~1e-4 after 2 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import close, t, torch_single_thread  # noqa: F401

from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.geom import dba as jdba
from lgu_slam_tpu.geom import projective as jpops
from lgu_slam_tpu_torch.geom import dba as tdba

ATOL = 2e-4


def make_scene(rng, N=5, H=12, W=16):
    """tests/test_dba.py's scene: ground truth, edges, exact targets."""
    xi = np.cumsum(rng.normal(size=(N, 6)) * 0.03, axis=0).astype(np.float32)
    poses = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    disps = (0.6 + 0.2 * rng.random((N, H, W))).astype(np.float32)
    intr = np.asarray([20.0, 20.0, W / 2, H / 2], np.float32)
    ii = np.array([0, 1, 2, 3, 0, 1, 2, 4, 3, 4], np.int64)
    jj = np.array([1, 2, 3, 4, 2, 3, 4, 2, 1, 0], np.int64)
    target, _ = jpops.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps),
        jnp.broadcast_to(jnp.asarray(intr), (N, 4)), jnp.asarray(ii),
        jnp.asarray(jj))
    return poses, disps, intr, ii, jj, np.asarray(target)


def run_both(poses, disps, intr, sens, target, weight, eta, ii, jj, t0, t1,
             iters=2, motion_only=False, quirk=False):
    N = disps.shape[0]
    E = len(ii)
    bucket = E + 3  # padded edges must not change the JAX result
    pad = bucket - E
    plan = jdba.DbaPlan.build(ii, jj, N, edge_bucket=bucket)
    p_j, d_j = jdba.dba_step(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(sens),
        jnp.asarray(np.concatenate([target, np.zeros((pad,) + target.shape[1:],
                                                     np.float32)])),
        jnp.asarray(np.concatenate([weight, np.zeros((pad,) + weight.shape[1:],
                                                     np.float32)])),
        jnp.asarray(eta), *plan.jax_arrays(), jnp.int32(t0), jnp.int32(t1),
        P=t1 - t0 + 2, iters=iters, motion_only=motion_only,
        strict_t0_quirk=quirk)
    tplan = tdba.DbaPlan.build(ii, jj, t0, t1, "cpu", strict_t0_quirk=quirk)
    p_t, d_t = tdba.dba_step(t(poses), t(disps), t(intr), t(sens), t(target),
                             t(weight), t(eta), tplan, iters=iters,
                             motion_only=motion_only)
    return (p_t, d_t), (np.asarray(p_j), np.asarray(d_j))


def test_dba_converges_like_jax(rng):
    """From identity poses and flat depth: 4 calls of 2 iterations."""
    poses_gt, disps_gt, intr, ii, jj, target = make_scene(rng)
    N, H, W = disps_gt.shape
    poses = np.tile(np.asarray(jl.se3_identity()), (N, 1))
    poses[0] = poses_gt[0]
    disps = np.full((N, H, W), 0.7, np.float32)
    weight = np.ones_like(target)
    eta = np.full((N, H, W), 1e-4, np.float32)
    sens = np.zeros((N, H, W), np.float32)
    p_t, d_t, p_j, d_j = t(poses), t(disps), poses, disps
    for _ in range(4):
        (p_t, d_t), (p_j, d_j) = run_both(
            p_j, d_j, intr, sens, target, weight, eta, ii, jj, 1, N)
        close(p_t, p_j, atol=ATOL)
        close(d_t, d_j, atol=ATOL, rtol=1e-4)
    assert np.abs(p_j[1:] - poses_gt[1:]).max() < 0.05  # it did converge


@pytest.mark.parametrize("case", ["rgbd", "stereo_window", "motion_only",
                                  "t0_quirk"])
def test_dba_cases_match_jax(rng, case):
    poses_gt, disps_gt, intr, ii, jj, target = make_scene(rng)
    N, H, W = disps_gt.shape
    poses = np.asarray(jl.se3_retr(
        jnp.asarray(poses_gt),
        jnp.asarray(rng.normal(size=(N, 6)).astype(np.float32) * 0.01)))
    disps = (disps_gt * (1 + 0.1 * rng.normal(size=disps_gt.shape))).astype(
        np.float32)
    weight = rng.random(target.shape).astype(np.float32)
    eta = (1e-3 * rng.random((N, H, W))).astype(np.float32)
    sens = np.zeros((N, H, W), np.float32)
    t0, t1, kw = 1, N, {}
    if case == "rgbd":  # sensed depth on two frames, holes included
        sens[[1, 3]] = disps_gt[[1, 3]] * (rng.random((2, H, W)) > 0.2)
    elif case == "stereo_window":  # a (3, 3) stereo edge; poses 0-1 fixed
        ii = np.concatenate([ii, [3]])
        jj = np.concatenate([jj, [3]])
        target = np.concatenate([target, target[3:4] - 1.5])
        weight = np.concatenate([weight, weight[:1]])
        t0 = 2
    elif case == "motion_only":
        kw = dict(motion_only=True)
    else:
        kw = dict(quirk=True)
    (p_t, d_t), (p_j, d_j) = run_both(poses, disps, intr, sens, target,
                                      weight, eta, ii, jj, t0, t1, **kw)
    close(p_t, p_j, atol=ATOL)
    close(d_t, d_j, atol=ATOL, rtol=1e-4)
    if case == "motion_only":
        assert torch.equal(d_t, t(disps))
    if case == "stereo_window":
        assert torch.equal(p_t[:2], t(poses[:2]))


def test_dba_nan_target_like_jax(rng):
    """tests/test_dba.py:205: non-finite targets give a zero update (the
    failed-solve fallback); the state stays finite and clamped."""
    poses_gt, disps_gt, intr, ii, jj, target = make_scene(rng)
    N, H, W = disps_gt.shape
    bad = target.copy()
    bad[0] = np.nan
    bad[3, 2, 2, 0] = np.inf
    eta = np.full((N, H, W), 1e-3, np.float32)
    sens = np.zeros((N, H, W), np.float32)
    (p_t, d_t), (p_j, d_j) = run_both(poses_gt, disps_gt, intr, sens, bad,
                                      np.ones_like(bad), eta, ii, jj, 1, N)
    assert bool(torch.isfinite(p_t).all()) and bool(torch.isfinite(d_t).all())
    assert float(d_t.min()) >= 1e-3
    close(p_t, p_j, atol=ATOL)
    close(d_t, d_j, atol=ATOL)


def test_dba_zero_weight_graph_like_jax(rng):
    """tests/test_dba.py:224: with every observation rejected only the
    damping holds the system; the state stays (nearly) unchanged."""
    poses_gt, disps_gt, intr, ii, jj, target = make_scene(rng)
    N, H, W = disps_gt.shape
    eta = np.full((N, H, W), 1e-3, np.float32)
    sens = np.zeros((N, H, W), np.float32)
    (p_t, d_t), (p_j, d_j) = run_both(poses_gt, disps_gt, intr, sens, target,
                                      np.zeros_like(target), eta, ii, jj, 1,
                                      N)
    close(p_t, p_j, atol=1e-6)
    close(d_t, d_j, atol=1e-6)
    close(p_t, poses_gt, atol=1e-5)
    close(d_t, disps_gt, atol=1e-4)


def test_linear_system_matches_jax_reference(rng):
    """Per-edge blocks against the JAX package's readable formulation
    (_build_linear_system_ref), stereo edge included."""
    poses_gt, disps_gt, intr, ii, jj, target = make_scene(rng)
    ii = np.concatenate([ii, [2]])
    jj = np.concatenate([jj, [2]])
    target = np.concatenate([target, target[:1]])
    N = disps_gt.shape[0]
    weight = rng.random(target.shape).astype(np.float32)
    intr_n = np.tile(intr, (N, 1))
    ref = jdba._build_linear_system_ref(
        jnp.asarray(poses_gt), jnp.asarray(disps_gt), jnp.asarray(intr_n),
        jnp.asarray(target), jnp.asarray(weight), jnp.asarray(ii),
        jnp.asarray(jj), jnp.ones(len(ii), jnp.float32))
    out = tdba.build_linear_system(t(poses_gt), t(disps_gt), t(intr_n),
                                   t(target), t(weight), t(ii), t(jj))
    for a, b, name in zip(out, ref, ("He", "ve", "Eii", "Eij", "Cii", "bz")):
        scale = max(float(np.abs(np.asarray(b)).max()), 1.0)
        close(a, b, atol=2e-5 * scale, msg=name)
