"""Port parity of the training leftovers and the evaluation code on the CPU:
Sim(3) (tests/test_lie.py::test_sim3_roundtrip), the KAN grid refit and
regulariser (tests/test_kan_grid.py), the trajectory metrics
(tests/test_eval_and_losses.py), each against the JAX package on the same
seeded inputs; and a tiny run of the training script's holdout, whose ATE
is finite and repeatable."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kan_grid import G, I, K, O, _uniform_grid
from test_lie import random_se3
from torch_port import close, t, torch_single_thread  # noqa: F401

from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.eval import ate as jate
from lgu_slam_tpu.models import kan as jkan
from lgu_slam_tpu_torch import lie as tl
from lgu_slam_tpu_torch.eval import ate as tate
from lgu_slam_tpu_torch.models import kan as tkan
from lgu_slam_tpu_torch.models.net import init_state_dict
from lgu_slam_tpu_torch.utils.config import SLAMConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- Sim(3) -------------------------------------------------------------------

def sim3_pair(rng):
    g = np.asarray(random_se3(rng))
    s = np.abs(rng.normal(size=(8, 1))).astype(np.float32) + 0.5
    return np.concatenate([g, s], -1)


def test_sim3_roundtrip(rng):
    """As the JAX test: act then inverse-act, and g g^-1 = identity."""
    G3 = t(sim3_pair(rng))
    x = t(rng.normal(size=(8, 3)).astype(np.float32))
    x2 = tl.sim3_act(tl.sim3_inv(G3), tl.sim3_act(G3, x))
    close(x2, x.numpy(), atol=1e-4)
    e = tl.sim3_mul(G3, tl.sim3_inv(G3))
    close(e[:, :3], np.zeros((8, 3)), atol=1e-5)
    close(e[:, 7], np.ones(8), atol=1e-5)


def test_sim3_ops_match_jax(rng):
    """Every Sim(3) op against the JAX package's on the same inputs."""
    a, b = sim3_pair(rng), sim3_pair(rng)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    xi = (rng.normal(size=(8, 7)) * 0.3).astype(np.float32)
    s = (np.abs(rng.normal(size=8)) + 0.5).astype(np.float32)
    J, T = jnp.asarray, t
    close(tl.sim3_mul(T(a), T(b)), jl.sim3_mul(J(a), J(b)), atol=1e-6)
    close(tl.sim3_inv(T(a)), jl.sim3_inv(J(a)), atol=1e-6)
    close(tl.sim3_act(T(a), T(x)), jl.sim3_act(J(a), J(x)), atol=1e-5)
    close(tl.sim3_exp(T(xi)), jl.sim3_exp(J(xi)), atol=1e-6)
    close(tl.sim3_log(T(a)), jl.sim3_log(J(a)), atol=1e-5)
    close(tl.sim3_scale(T(a), T(s)), jl.sim3_scale(J(a), J(s)), atol=0)
    close(tl.sim3_from_se3(T(a[:, :7]), T(s)),
          jl.sim3_from_se3(J(a[:, :7]), J(s)), atol=0)
    close(tl.sim3_identity((3,)), jl.sim3_identity((3,)), atol=0)


# -- KAN grid refit -----------------------------------------------------------

def to_port(w):
    """JAX spline layout [I, G+K, O] -> the port's [O, I, G+K]."""
    return t(np.transpose(np.asarray(w), (2, 0, 1)))


def test_curve2coeff_matches_jax_and_numpy_lstsq(rng):
    grid = _uniform_grid()
    x = rng.uniform(-0.9, 0.9, size=(64, I)).astype(np.float32)
    y = rng.normal(size=(64, I, O)).astype(np.float32)
    coeff = tkan.curve2coeff(t(x), t(y), t(grid), K)
    # fp32 normal equations in both packages: agree to 1e-5 relative
    close(coeff, to_port(jkan.curve2coeff(jnp.asarray(x), jnp.asarray(y),
                                          grid, K)), atol=1e-4, rtol=1e-4)
    A = np.asarray(jkan.bspline_bases(jnp.asarray(x), grid, K))
    for i in range(I):
        sol, *_ = np.linalg.lstsq(A[:, i], y[:, i], rcond=None)
        close(coeff[:, i].T, sol, atol=5e-3)


def test_update_grid_matches_jax_and_preserves_curve(rng):
    """Same grid and weights as the JAX package's refit, and the scaled
    spline curve kept on the data (2e-2, as the JAX test) through a
    KANLinear whose forward reads the refit grid buffer."""
    grid = _uniform_grid()
    x = rng.uniform(-0.8, 0.8, size=(128, I)).astype(np.float32)
    spline_w = (rng.normal(size=(I, G + K, O)) * 0.3).astype(np.float32)
    scaler = (1.0 + 0.1 * rng.normal(size=(I, O))).astype(np.float32)
    jg, jw = jkan.update_grid(jnp.asarray(x), grid, jnp.asarray(spline_w),
                              jnp.asarray(scaler), G, K)
    tg, tw = tkan.update_grid(t(x), t(grid), to_port(spline_w),
                              t(scaler.T), K)
    close(tg, jg, atol=1e-6)
    close(tw, to_port(jw), atol=1e-3, rtol=1e-3)

    layer = tkan.KANLinear(I, O, grid_size=G, spline_order=K)
    with torch.no_grad():
        layer.spline_weight.copy_(to_port(spline_w))
        layer.spline_scaler.copy_(t(scaler.T))
        before = layer(t(x))
        layer.update_grid(t(x))
        after = layer(t(x))
    close(layer.grid, jg, atol=1e-6)
    close(after, before.numpy(), atol=2e-2)


def test_update_grid_adapts_to_distribution(rng):
    """A skewed input distribution pulls the interior knots toward its
    mass, as in the JAX package."""
    x = np.clip(rng.normal(0.5, 0.1, size=(256, I)), -1, 1).astype(
        np.float32)
    layer = tkan.KANLinear(I, O, grid_size=G, spline_order=K)
    with torch.no_grad():
        layer.spline_scaler.fill_(1.0)
    layer.update_grid(t(x))
    jg, _ = jkan.update_grid(jnp.asarray(x), _uniform_grid(),
                             jnp.zeros((I, G + K, O)), jnp.ones((I, O)), G, K)
    close(layer.grid, jg, atol=1e-6)
    assert float(layer.grid[:, K:-K].mean()) > 0.2


def test_kan_regularization_loss_matches_jax(rng):
    w = (rng.normal(size=(I, G + K, O)) * 0.3).astype(np.float32)
    for act, ent in ((1.0, 1.0), (0.5, 2.0)):
        ref = jkan.kan_regularization_loss(jnp.asarray(w), act, ent)
        close(tkan.kan_regularization_loss(to_port(w), act, ent), ref,
              atol=1e-5, rtol=1e-6)
    layer = tkan.KANLinear(I, O, grid_size=G, spline_order=K)
    with torch.no_grad():
        layer.spline_weight.copy_(to_port(w))
    close(layer.regularization_loss(), jkan.kan_regularization_loss(
        jnp.asarray(w)), atol=1e-5, rtol=1e-6)


# -- trajectory metrics -------------------------------------------------------

def trajectories(rng, n=40):
    xi = np.cumsum(rng.normal(size=(n, 6)) * 0.05, 0)
    gt = np.asarray(jl.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)
    est = gt.copy()
    est[:, :3] = 1.7 * gt[:, :3] + rng.normal(size=(n, 3)) * 0.02 + 0.3
    return gt, est


def same(a, b, what):
    """Equal nested results (dicts, tuples, arrays, floats) to 1e-9."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for k, (u, v) in enumerate(zip(a, b)):
            same(u, v, f"{what}[{k}]")
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=1e-9,
                                   err_msg=what)


def test_ate_functions_match_jax(rng, tmp_path):
    """Umeyama, ATE, Horn ATE, RPE (one delta and all pairs), KITTI
    segments, the TartanAir protocol, TUM and EuRoC IO, and association:
    the port's copy returns what the JAX package's does."""
    gt, est = trajectories(rng)
    x, y = est[:, :3], gt[:, :3]
    mats = (tate._poses_to_matrices(gt), tate._poses_to_matrices(est))
    for fn, args, kw in (
            ("umeyama_alignment", (x, y), {}),
            ("umeyama_alignment", (x, y), {"with_scale": False}),
            ("ate_rmse", (y, x), {}),
            ("ate_rmse", (y, x), {"correct_scale": False}),
            ("horn_ate", (y, x), {"calc_scale": True}),
            ("rpe", (gt, est), {"delta": 2}),
            ("rpe_all_pairs", mats, {}),
            ("kitti_rel_errors", mats, {}),
            ("kitti_metrics", (gt, est), {}),
            ("tartanair_evaluate", (gt, est), {"scale": True})):
        same(getattr(tate, fn)(*args, **kw), getattr(jate, fn)(*args, **kw),
             fn)
    stamps = np.arange(len(gt)) * 0.1
    tate.save_tum_trajectory(tmp_path / "t.txt", stamps, est)
    same(tate.load_tum_trajectory(tmp_path / "t.txt"),
         jate.load_tum_trajectory(tmp_path / "t.txt"), "tum")
    np.testing.assert_allclose(tate.load_tum_trajectory(
        tmp_path / "t.txt")[1], est, atol=1e-6)
    rows = np.concatenate([stamps[:, None] * 1e9, gt[:, :3],
                           gt[:, [6, 3, 4, 5]]], 1)
    np.savetxt(tmp_path / "e.txt", rows, header="t p q")
    same(tate.load_euroc_gt_txt(tmp_path / "e.txt"),
         jate.load_euroc_gt_txt(tmp_path / "e.txt"), "euroc")
    b = stamps + rng.normal(size=len(stamps)) * 0.03
    assert tate.associate(stamps, b) == jate.associate(stamps, b)


def test_ate_zero_for_aligned_and_detects_error(rng):
    """tests/test_eval_and_losses.py's ATE, RPE and association cases."""
    g = rng.normal(size=(30, 3))
    assert tate.ate_rmse(g, 0.5 * g + 1.0, correct_scale=True)[0] < 1e-6
    rmse = tate.ate_rmse(g, g + rng.normal(size=(30, 3)) * 0.1)[0]
    assert 0.01 < rmse < 0.3
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (10, 1))
    poses[:, 0] = np.arange(10)
    t_err, r_err = tate.rpe(poses, poses, delta=1)
    assert t_err < 1e-9 and r_err < 1e-6
    pairs = tate.associate(np.array([0.0, 1.0, 2.0, 3.0]),
                           np.array([0.01, 1.02, 2.9, 5.0]), max_dt=0.08)
    assert (0, 0) in pairs and (1, 1) in pairs
    assert all(ib != 3 for _, ib in pairs)


# -- the training script's holdout --------------------------------------------

@pytest.fixture(scope="module")
def train_script():
    spec = importlib.util.spec_from_file_location(
        "train_synthetic_torch",
        os.path.join(REPO, "scripts", "train_synthetic_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_holdout_ate_is_finite_and_repeatable(train_script):
    """The holdout of ``--holdout`` at 64 x 96 over 10 frames of the
    held-out clip, tracked twice with the same random weights in fp32 on
    the CPU: each ATE is finite and positive, and the two are equal."""
    sd = init_state_dict(SLAMConfig(), seed=0)
    ate = train_script.run_holdout({"first": sd, "second": sd}, (64, 96), 10,
                                   "cpu")
    assert np.isfinite(ate["first"]) and ate["first"] > 0
    assert ate["first"] == ate["second"]
