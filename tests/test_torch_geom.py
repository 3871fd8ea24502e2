"""Port parity: lgu_slam_tpu_torch.geom.{projective, distance} against the
JAX package on random poses/depths, including a stereo (ii == jj) edge and
pixels with invalid depth.  fp32 both sides; coordinates are O(10) pixels,
so atol 1e-4 is a few ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port import close, t, torch_single_thread  # noqa: F401

from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.geom import distance as jd
from lgu_slam_tpu.geom import projective as jp
from lgu_slam_tpu_torch.geom import distance as td
from lgu_slam_tpu_torch.geom import projective as tp


def problem(rng, n=4, ht=6, wd=8):
    xi = (rng.normal(size=(n, 6)) * 0.1).astype(np.float32)
    poses = np.array(jl.se3_exp(jnp.asarray(xi)))
    poses[2, :3] = [0.0, 0.0, 5.0]  # edge (2, 0) lands behind the camera
    disps = (0.5 + 0.3 * rng.random((n, ht, wd))).astype(np.float32)
    intr = np.tile(np.array([10.0, 11.0, wd / 2, ht / 2], np.float32), (n, 1))
    ii = np.array([0, 1, 2, 3, 2], np.int64)
    jj = np.array([1, 2, 0, 3, 3], np.int64)  # (3, 3): stereo edge
    return poses, disps, intr, ii, jj


def test_iproj_proj_coords_grid(rng):
    poses, disps, intr, _, _ = problem(rng)
    close(tp.coords_grid(6, 8), jp.coords_grid(6, 8), atol=0)
    X_t = tp.iproj(t(disps), t(intr))
    X_j = jp.iproj(jnp.asarray(disps), jnp.asarray(intr))
    close(X_t, X_j, atol=1e-6)
    c_t, J_t = tp.proj(X_t, t(intr), jacobian=True, return_depth=True)
    c_j, J_j = jp.proj(X_j, jnp.asarray(intr), jacobian=True,
                       return_depth=True)
    close(c_t, c_j, atol=1e-4)
    close(J_t, J_j, atol=1e-4)


@pytest.mark.parametrize("jacobian", [False, True])
def test_projective_transform(rng, jacobian):
    poses, disps, intr, ii, jj = problem(rng)
    out_t = tp.projective_transform(t(poses), t(disps), t(intr), t(ii),
                                    t(jj), jacobian=jacobian)
    out_j = jp.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(ii), jnp.asarray(jj), jacobian=jacobian)
    close(out_t[0], out_j[0], atol=1e-4)
    close(out_t[1], out_j[1], atol=0)
    assert float(out_t[1].min()) == 0.0  # the invalid pixels are masked
    if jacobian:
        for a, b, name in zip(out_t[2], out_j[2], ("Ji", "Jj", "Jz")):
            close(a, b, atol=2e-4, rtol=1e-5, msg=name)


def test_induced_flow(rng):
    poses, disps, intr, ii, jj = problem(rng)
    f_t, v_t = tp.induced_flow(t(poses), t(disps), t(intr), t(ii), t(jj))
    f_j, v_j = jp.induced_flow(jnp.asarray(poses), jnp.asarray(disps),
                               jnp.asarray(intr), jnp.asarray(ii),
                               jnp.asarray(jj))
    close(f_t, f_j, atol=1e-4)
    close(v_t, v_j, atol=0)


@pytest.mark.parametrize("beta", [0.3, 1.0])
def test_frame_distance(rng, beta):
    poses, disps, intr, ii, jj = problem(rng, n=5, ht=12, wd=16)
    ii = np.array([0, 1, 2, 3, 4, 0], np.int64)
    jj = np.array([1, 2, 3, 4, 0, 4], np.int64)
    poses[4, :3] = [0.0, 0.0, -5.0]  # frame 4 far behind: saturates at 1000
    args_t = (t(poses), t(disps), t(intr[0]), t(ii), t(jj), beta)
    args_j = (jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr[0]),
              jnp.asarray(ii), jnp.asarray(jj), beta)
    one_t = td.frame_distance(*args_t)
    close(one_t, jd.frame_distance(*args_j), atol=1e-3, rtol=1e-5)
    close(td.frame_distance_bidirectional(*args_t),
          jd.frame_distance_bidirectional(*args_j), atol=1e-3, rtol=1e-5)
    assert float(one_t.max()) == 1000.0
