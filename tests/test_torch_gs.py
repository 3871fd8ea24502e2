"""The port's 3DGS stage (lgu_slam_tpu_torch/gs/) against the JAX
package's gs/ on the CPU, plus the JAX package's own tests of the stage
(tests/test_gs.py) run against the port.

Inputs are made with numpy from a seeded generator and handed to both
packages.  Tolerances are stated where they are used.  One mechanism
recurs: for the isotropic Gaussians that ``render_rgbd`` renders, the
rotation does not change the covariance, so the loss's gradient with
respect to ``unnorm_rotations`` is zero in exact arithmetic and each
package's is its own rounding noise; Adam divides that noise by its own
size, so the rotations after n steps are held only to Adam's step bound
(below), not to the other groups' tolerance.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import close, torch_single_thread  # noqa: F401

from lgu_slam_tpu.gs import mapping as jmapping
from lgu_slam_tpu.gs import params as jparams
from lgu_slam_tpu.gs import render as jrender
from lgu_slam_tpu.gs import ssim as jssim
from lgu_slam_tpu.gs import tsdf as jtsdf
from lgu_slam_tpu_torch.gs.mapping import (
    GaussianMapper,
    GSConfig,
    adam_init,
    make_mapping_step,
    mapping_loss,
)
from lgu_slam_tpu_torch.gs.params import (
    PARAM_KEYS,
    GaussianMap,
    pointcloud_from_depth,
)
from lgu_slam_tpu_torch.gs.render import (
    project_gaussians,
    render_gaussians,
    render_rgbd,
)
from lgu_slam_tpu_torch.gs.ssim import ssim
from lgu_slam_tpu_torch.gs.tsdf import TSDFVolume
from lgu_slam_tpu_torch.utils.device import full_fp32_convs
from lgu_slam_tpu_torch.utils.weights import (
    gaussian_map_from_numpy,
    gaussian_map_to_numpy,
)

REPO = Path(__file__).resolve().parent.parent
H, W = 40, 56
INTR = np.float32([40.0, 42.0, 28.0, 20.0])
# renders: image, alpha and depth agree to 1e-5 (measured: <= 6e-7)
RENDER_ATOL = 1e-5
# Adam's bias-corrected step |m_hat / sqrt(v_hat)| stays below 1.01 over
# the first five steps (Cauchy-Schwarz over the moments' weights), so two
# packages whose gradients are noise part by at most 2 x 1.01 lr per step
ADAM_STEP_BOUND = 1.01


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def camera(angle=0.1):
    R = np.float32([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                    [-np.sin(angle), 0, np.cos(angle)]])
    return R, np.float32([0.1, -0.05, 0.2])


def gaussians(rng, n, channels=3):
    """Raw renderer inputs for n Gaussians in front of ``camera()``, about
    one in ten dead."""
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(1.5, 4, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.15, (n, 3)).astype(np.float32)
    ops = rng.uniform(0.1, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, channels)).astype(np.float32)
    alive = rng.random(n) > 0.1
    return means, quats, scales, ops, cols, alive


def map_params(rng, n, cap):
    """A GaussianMap's parameters: n random Gaussians in the prefix of a
    capacity-``cap`` map whose other slots hold GaussianMap.create's
    values; alive [cap]."""
    p = {k: np.array(v) for k, v in jparams.GaussianMap.create(cap)
         .params.items()}
    means, quats, scales, ops, cols, alive = gaussians(rng, n)
    p["means3D"][:n] = means
    p["rgb_colors"][:n] = cols
    p["unnorm_rotations"][:n] = quats
    p["logit_opacities"][:n] = rng.normal(size=(n, 1))
    p["log_scales"][:n] = np.log(scales[:, :1])
    alive_cap = np.zeros(cap, bool)
    alive_cap[:n] = alive
    return p, alive_cap


def frame(rng):
    """A target frame: image, depth (some pixels without depth), camera."""
    im = rng.random((H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.5, 4, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0
    R, tr = camera()
    return im, depth, R, tr, INTR


def jax_loss(cfg, img_size):
    """The JAX package's mapping loss (lgu_slam_tpu/gs/mapping.py:270-288,
    a closure of make_mapping_step there), written out."""
    def loss_fn(params, xy_probe, alive, frame):
        im_gt, depth_gt, w2c_rot, w2c_trans, intr = frame
        img, depth, sil, _ = jrender.render_rgbd(
            params, alive, w2c_rot, w2c_trans, intr, img_size,
            span=cfg.span, k_max=cfg.k_max, xy_offset=xy_probe)
        mask = jax.lax.stop_gradient((depth_gt > 0) & (sil > cfg.sil_thres))
        depth_l1 = jnp.sum(jnp.abs(depth_gt - depth) * mask) / jnp.maximum(
            jnp.sum(mask), 1.0)
        im_l1 = jnp.mean(jnp.abs(img - im_gt))
        im_ssim = 1.0 - jssim.ssim(img, im_gt)
        return (cfg.loss_depth * depth_l1 + cfg.loss_im_l1 * im_l1
                + cfg.loss_im_ssim * im_ssim)
    return loss_fn


def adam_moments(state, key):
    """(count, mu, nu) of one parameter group in optax's multi_transform
    state (make_optimizer of the JAX package)."""
    adam = state.inner_states[key].inner_state[0]
    return int(adam.count), np.asarray(adam.mu[key]), np.asarray(adam.nu[key])


# -- parity with the JAX package ---------------------------------------------

def test_project_gaussians_matches_jax():
    """EWA projection: positions, depths and conics to float32 rounding;
    the integer radius ceil(3 sqrt(lam)) equal, so no Gaussian lands on
    the other side of an integer (which would change its tile
    footprint)."""
    rng = np.random.default_rng(1)
    means, quats, scales, *_ = gaussians(rng, 400)
    R, tr = camera()
    cam = means @ R.T + tr
    ref = jrender.project_gaussians(jnp.asarray(cam), jnp.asarray(quats),
                                    jnp.asarray(scales), jnp.asarray(INTR),
                                    (H, W))
    got = project_gaussians(t(cam), t(quats), t(scales), t(INTR))
    for name, a, b, tol in zip(("xy", "depth", "conic", "radius"), got, ref,
                               (1e-4, 1e-6, 2e-4, 0.0)):
        close(a, b, atol=tol, rtol=1e-5 if tol else 0.0, msg=name)


def test_render_gaussians_matches_jax():
    """Image, alpha, depth and the drop telemetry of one render with dead
    Gaussians, anisotropic covariances and more Gaussians per tile than
    k_max (so the depth order inside a tile decides what is kept).  The
    JAX package composites 4 tiles per pass here, the port all at once."""
    rng = np.random.default_rng(2)
    args = gaussians(rng, 300, channels=4)
    R, tr = camera()
    kw = dict(img_size=(H, W), span=4, k_max=32, with_stats=True)
    ref = jrender.render_gaussians(
        *(jnp.asarray(a) for a in args), jnp.asarray(R), jnp.asarray(tr),
        jnp.asarray(INTR), tile_chunk=4, channels=4, **kw)
    got = render_gaussians(*(t(a, None) for a in args), t(R), t(tr),
                           t(INTR), **kw)
    assert int(ref[3]["dropped_pairs_kmax"]) > 0
    for name, a, b in zip(("image", "alpha", "depth"), got, ref):
        assert a.shape == b.shape
        close(a, b, atol=RENDER_ATOL, msg=name)
    assert {k: int(v) for k, v in got[3].items()} == \
        {k: int(v) for k, v in ref[3].items()}


def test_render_rgbd_matches_jax():
    """The 5-channel RGB + depth + depth^2 pass over a map's parameters,
    and its telemetry."""
    rng = np.random.default_rng(3)
    p, alive = map_params(rng, 350, 400)
    R, tr = camera()
    kw = dict(span=4, k_max=48, with_stats=True)
    ref = jrender.render_rgbd({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(alive), jnp.asarray(R),
                              jnp.asarray(tr), jnp.asarray(INTR), (H, W), **kw)
    got = render_rgbd({k: t(v) for k, v in p.items()}, t(alive, torch.bool),
                      t(R), t(tr), t(INTR), (H, W), **kw)
    for name, a, b in zip(("image", "depth", "silhouette", "depth^2"), got,
                          ref):
        close(a, b, atol=RENDER_ATOL * 4, msg=name)
    assert {k: int(v) for k, v in got[4].items()} == \
        {k: int(v) for k, v in ref[4].items()}


def test_render_gradients_match_jax():
    """Gradients of a weighted image through render_gaussians with
    anisotropic Gaussians (rotations matter here) with respect to every
    input and to xy_offset: within 1e-4 of each input's largest gradient
    (measured: <= 2e-6)."""
    rng = np.random.default_rng(4)
    args = gaussians(rng, 250)
    R, tr = camera()
    wts = rng.normal(size=(H, W, 3)).astype(np.float32)
    kw = dict(img_size=(H, W), span=4, k_max=64)

    def jloss(means, quats, scales, ops, cols, xy):
        img, acc, dep = jrender.render_gaussians(
            means, quats, scales, ops, cols, jnp.asarray(args[5]),
            jnp.asarray(R), jnp.asarray(tr), jnp.asarray(INTR),
            xy_offset=xy, **kw)
        return jnp.sum(img * wts) + jnp.sum(acc) + 0.1 * jnp.sum(dep)

    xy0 = np.zeros((len(args[0]), 2), np.float32)
    ref = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args[:5]), jnp.asarray(xy0))
    leaves = [t(a).requires_grad_() for a in (*args[:5], xy0)]
    img, acc, dep = render_gaussians(*leaves[:5], t(args[5], torch.bool),
                                     t(R), t(tr), t(INTR),
                                     xy_offset=leaves[5], **kw)
    loss = (img * t(wts)).sum() + acc.sum() + 0.1 * dep.sum()
    got = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(("means", "quats", "scales", "opacities",
                           "colors", "xy_offset"), got, ref):
        scale = float(np.abs(np.asarray(b)).max())
        assert scale > 0, name
        close(a, b, atol=1e-4 * scale, msg=name)


def test_mapping_loss_gradients_match_jax():
    """The mapping loss (depth L1 under the silhouette mask, L1 and SSIM)
    and its gradients with respect to every parameter group and to the xy
    probe: within 1e-4 of each group's largest gradient (measured: <=
    1e-6).  The rotations' gradients are noise in both packages (see the
    module docstring): below 1e-6 of the means' largest."""
    rng = np.random.default_rng(5)
    p, alive = map_params(rng, 300, 300)
    fr = frame(rng)
    cfg = GSConfig(capacity=300, span=4, k_max=48)
    xy0 = np.zeros((300, 2), np.float32)
    ref_loss, ref = jax.value_and_grad(
        jax_loss(cfg, (H, W)), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xy0),
        jnp.asarray(alive), tuple(jnp.asarray(x) for x in fr))
    leaves = {k: t(v).requires_grad_() for k, v in p.items()}
    probe = t(xy0).requires_grad_()
    with full_fp32_convs():
        loss, _ = mapping_loss(cfg, (H, W))(
            leaves, probe, t(alive, torch.bool), tuple(t(x) for x in fr))
        got = torch.autograd.grad(loss, [leaves[k] for k in PARAM_KEYS]
                                  + [probe])
    close(loss, ref_loss, atol=1e-5)
    means_scale = float(np.abs(np.asarray(ref[0]["means3D"])).max())
    for name, a, b in zip(PARAM_KEYS + ("xy_probe",), got,
                          [ref[0][k] for k in PARAM_KEYS] + [ref[1]]):
        scale = float(np.abs(np.asarray(b)).max())
        if name == "unnorm_rotations":
            assert scale < 1e-6 * means_scale
            assert float(a.abs().max()) < 1e-6 * means_scale
            continue
        assert scale > 0, name
        close(a, b, atol=1e-4 * scale, msg=name)


@pytest.mark.parametrize("count,bucket", [(300, 300), (300, 512)])
def test_mapping_steps_match_jax(count, bucket):
    """Five mapping steps (render, loss, backward, Adam) from the same
    parameters.  The JAX package steps a capacity bucket of ``bucket``
    slots; the port steps the ``count`` slots of the live prefix only.
    Where the bucket holds more (the second case), the JAX package's
    extra slots keep their parameters and zero moments, and the prefix
    takes the same steps.  Losses to 1e-5; moments within 1e-4 of each
    group's largest; parameters to 1e-6 (measured: <= 2.4e-7), the
    rotations to Adam's step bound."""
    rng = np.random.default_rng(6)
    p, alive = map_params(rng, count, bucket)
    fr = frame(rng)
    cfg = GSConfig(capacity=bucket, span=4, k_max=32)
    tx, jstep = jmapping.make_mapping_step(cfg, (H, W))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = tx.init(jp)
    jfr = tuple(jnp.asarray(x) for x in fr)
    step = make_mapping_step(cfg, (H, W))
    tp = {k: t(v[:count]) for k, v in p.items()}
    ts = adam_init(tp)
    talive = t(alive[:count], torch.bool)
    tfr = tuple(t(x) for x in fr)
    n_steps = 5
    for _ in range(n_steps):
        jp, js, jl, jaux, jg2d = jstep(jp, js, jnp.asarray(alive), jfr)
        tp, ts, tl, taux, tg2d = step(tp, ts, talive, tfr)
        close(tl, jl, atol=1e-5)
        close(torch.stack(taux), np.stack(jaux), atol=1e-5)
        close(tg2d, np.asarray(jg2d)[:count],
              atol=1e-4 * float(np.abs(np.asarray(jg2d)).max()))
    assert ts["count"] == n_steps
    for k in PARAM_KEYS:
        jcount, mu, nu = adam_moments(js, k)
        assert jcount == n_steps
        got = np.asarray(jp[k])
        np.testing.assert_array_equal(got[count:], p[k][count:])
        assert not mu[count:].any() and not nu[count:].any()
        if k == "unnorm_rotations":
            # noise in both packages: far below the other groups' moments
            for a in (mu, ts["mu"][k].numpy()):
                assert np.abs(a).max() < 1e-6
            atol = 2 * ADAM_STEP_BOUND * cfg.lr_rots * n_steps
        else:
            close(ts["mu"][k], mu[:count], atol=1e-4 * np.abs(mu).max(),
                  msg=k)
            close(ts["nu"][k], nu[:count], atol=1e-4 * np.abs(nu).max(),
                  msg=k)
            atol = 1e-6
        close(tp[k], got[:count], atol=atol, msg=k)


def planes_frame(shift: float):
    """A 32 x 48 RGB-D frame of two fronto-parallel planes (z = 2 on the
    left, z = 4 on the right) under a camera moved ``shift`` along x;
    focal 20, so the back-projected scales are 0.1 and 0.2 (the big-
    Gaussian pruning threshold of the first frame is 0.133)."""
    h, w = 32, 48
    rng = np.random.default_rng(7)
    im = rng.random((h, w, 3)).astype(np.float32)
    depth = np.full((h, w), 2.0, np.float32)
    depth[:, w // 2:] = 4.0
    intr = np.float32([20.0, 20.0, w / 2, h / 2])
    return im, depth, np.eye(3, dtype=np.float32), \
        np.float32([shift, 0, 0]), intr


def test_gaussian_mapper_matches_jax():
    """GaussianMapper over three frames (add Gaussians where the
    silhouette is low, then map with opacity and big-Gaussian pruning):
    the same count and alive flags after each frame, the same losses, and
    the same parameters (1e-5; the rotations to Adam's step bound over
    the iterations since the last reset of the moments)."""
    iters = 6
    kw = dict(capacity=6000, mapping_iters=iters, prune_every=3,
              prune_big_after=1, span=4, k_max=96)
    jm = jmapping.GaussianMapper(jmapping.GSConfig(**kw), (32, 48))
    tm = GaussianMapper(GSConfig(**kw), (32, 48), device="cpu")
    window_j, window_t = [], []
    for i in range(3):
        im, depth, R, tr, intr = planes_frame(0.05 * i)
        jm.add_frame_gaussians(im, depth, jnp.asarray(R), jnp.asarray(tr),
                               intr, i)
        tm.add_frame_gaussians(im, depth, R, tr, intr, i)
        window_j.append(tuple(jnp.asarray(x) for x in (im, depth, R, tr,
                                                       intr)))
        window_t.append(tm.frame_tensors(im, depth, R, tr, intr))
        lj = jm.map_frame(window_j)
        lt = tm.map_frame(window_t)
        np.testing.assert_allclose(lt, lj, atol=1e-5)
        assert tm.map.count == jm.map.count
        np.testing.assert_array_equal(tm.map.alive, jm.map.alive)
        np.testing.assert_array_equal(tm.map.timestep, jm.map.timestep)
    n = tm.map.count
    assert 0 < int(tm.map.alive.sum()) < n  # pruning removed some
    for k in PARAM_KEYS:
        atol = (2 * ADAM_STEP_BOUND * tm.cfg.lr_rots * iters
                if k == "unnorm_rotations" else 1e-5)
        close(tm.map.params[k][:n], np.asarray(jm.map.params[k])[:n],
              atol=atol, msg=k)
    assert tm.truncation_stats(window_t[-1]) == \
        jm.truncation_stats(window_j[-1])


def test_ssim_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.random((37, 45, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    close(ssim(t(a), t(b)), jssim.ssim(jnp.asarray(a), jnp.asarray(b)),
          atol=1e-6)


def test_tsdf_integrate_and_mesh_match_jax():
    """Two RGB-D frames of a tilted wall fused into a TSDF: the grids to
    float32 rounding, then the mesh's vertex and triangle counts equal and
    its vertices and colours within 1e-5."""
    rng = np.random.default_rng(9)
    h, w = 48, 64
    intr = np.float32([50.0, 50.0, 32.0, 24.0])
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = (1.4 + 0.004 * xs + 0.002 * ys).astype(np.float32)
    color = rng.random((h, w, 3)).astype(np.float32)
    bounds = ([-0.9, -0.7, 0.9], [0.9, 0.7, 2.2])
    jv = jtsdf.TSDFVolume(*bounds, voxel_size=0.04)
    tv = TSDFVolume(*bounds, voxel_size=0.04, device="cpu")
    for shift in (0.0, 0.03):
        R = np.eye(3, dtype=np.float32)
        tr = np.float32([shift, 0, 0])
        jv.integrate(depth, color, intr, R, tr)
        tv.integrate(depth, color, intr, R, tr)
    assert tv.dims == jv.dims
    close(tv.weight, jv.weight, atol=0.0)
    close(tv.tsdf, jv.tsdf, atol=1e-5)
    close(tv.color, jv.color, atol=1e-5)
    V, C, T = tv.extract_mesh()
    Vj, Cj, Tj = jv.extract_mesh()
    assert len(V) > 100 and V.shape == Vj.shape and T.shape == Tj.shape
    np.testing.assert_array_equal(T, Tj)
    np.testing.assert_allclose(V, Vj, atol=1e-5)
    np.testing.assert_allclose(C, Cj, atol=1e-5)


def test_gaussian_map_converter_roundtrip():
    """A JAX GaussianMap (points added, some pruned, densified) crosses to
    the port and back unchanged, and both render it alike."""
    rng = np.random.default_rng(10)
    jm = jparams.GaussianMap.create(512)
    im, depth, R, tr = (rng.random((12, 16, 3)), rng.uniform(
        1.5, 3, (12, 16)), np.eye(3), np.zeros(3))
    pts, cols, msq = jparams.pointcloud_from_depth(im, depth, (14, 14, 8, 6),
                                                   R, tr)
    jm.add_points(pts, cols, msq, 3)
    jm.prune(rng.random(512) < 0.2)
    grads = np.zeros(512, np.float32)
    grads[:20] = 1.0
    jm.densify(grads, scene_radius=1.0, grad_thresh=0.5)
    tm = gaussian_map_from_numpy(jax.device_get(jm.params), jm.alive,
                                 jm.count, jm.timestep, "cpu")
    assert isinstance(tm, GaussianMap) and tm.capacity == 512
    params, alive, count, timestep = gaussian_map_to_numpy(tm)
    assert count == jm.count
    np.testing.assert_array_equal(alive, jm.alive)
    np.testing.assert_array_equal(timestep, jm.timestep)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(params[k], np.asarray(jm.params[k]))
    Rc, trc = camera(0.0)
    ref = jrender.render_rgbd(jm.params, jm.alive_device(), jnp.asarray(Rc),
                              jnp.asarray(trc), jnp.asarray(INTR), (H, W),
                              span=4, k_max=64)
    got = render_rgbd(tm.params, tm.alive_device(), t(Rc), t(trc), t(INTR),
                      (H, W), span=4, k_max=64)
    for a, b in zip(got, ref):
        close(a, b, atol=RENDER_ATOL * 4)
    # and back: the port's map as the JAX package's
    back = jparams.GaussianMap({k: jnp.asarray(v) for k, v in params.items()},
                               alive, count, 512, timestep)
    ref2 = jrender.render_rgbd(back.params, back.alive_device(),
                               jnp.asarray(Rc), jnp.asarray(trc),
                               jnp.asarray(INTR), (H, W), span=4, k_max=64)
    for a, b in zip(ref2, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gs_modules_import_no_jax():
    """No module of the port's gs/, nor the export path, imports JAX, flax
    or the JAX package (their source names none, and they import with
    those made unimportable)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|lgu_slam_tpu\b"
                     r"|lgu_native)", re.M)
    gs_dir = REPO / "lgu_slam_tpu_torch" / "gs"
    files = sorted(gs_dir.glob("*.py")) + [
        REPO / "lgu_slam_tpu_torch" / "geom" / "depth_filter.py",
        REPO / "lgu_slam_tpu_torch" / "slam" / "visualization.py"]
    assert len(files) >= 11
    for f in files:
        assert not pat.search(f.read_text()), f
    code = ("import sys, importlib, pkgutil\n"
            "for m in ('jax', 'flax', 'optax', 'lgu_slam_tpu', "
            "'lgu_native'):\n"
            "    sys.modules[m] = None\n"
            "import lgu_slam_tpu_torch.gs as g\n"
            "mods = [m.name for m in pkgutil.walk_packages(g.__path__, "
            "'lgu_slam_tpu_torch.gs.')]\n"
            "mods += ['lgu_slam_tpu_torch.geom.depth_filter', "
            "'lgu_slam_tpu_torch.slam.visualization']\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == 10


# -- the JAX package's tests/test_gs.py, against the port ---------------------

def _identity_cam():
    return torch.eye(3), torch.zeros(3)


def test_single_gaussian_renders_centered_blob():
    H, W = 32, 32
    intr = (30.0, 30.0, W / 2, H / 2)
    means = torch.tensor([[0.0, 0.0, 2.0]])
    quats = torch.tensor([[1.0, 0, 0, 0]])
    scales = torch.full((1, 3), 0.2)
    ops = torch.tensor([0.9])
    cols = torch.tensor([[1.0, 0.0, 0.0]])
    alive = torch.tensor([True])
    R, tr = _identity_cam()
    img, acc, dep = render_gaussians(
        means, quats, scales, ops, cols, alive, R, tr, intr,
        img_size=(H, W), span=4, k_max=8,
    )
    img = img.numpy()
    cy, cx = np.unravel_index(np.argmax(img[..., 0]), (H, W))
    assert abs(cy - H / 2) <= 1 and abs(cx - W / 2) <= 1
    assert img[..., 1].max() < 1e-6  # red only
    assert 0.8 < float(acc.max()) <= 1.0
    # depth at the blob center equals the gaussian depth
    assert abs(float(dep[cy, cx] / acc[cy, cx]) - 2.0) < 0.05


def test_front_gaussian_occludes_back():
    H, W = 32, 32
    intr = (30.0, 30.0, W / 2, H / 2)
    means = torch.tensor([[0.0, 0.0, 4.0], [0.0, 0.0, 2.0]])  # back, front
    quats = torch.tensor([[1.0, 0, 0, 0]]).repeat(2, 1)
    scales = torch.full((2, 3), 0.3)
    ops = torch.tensor([0.99, 0.99])
    cols = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    alive = torch.ones(2, dtype=torch.bool)
    R, tr = _identity_cam()
    img, acc, _ = render_gaussians(
        means, quats, scales, ops, cols, alive, R, tr, intr,
        img_size=(H, W), span=4, k_max=8,
    )
    center = img[H // 2, W // 2].numpy()
    assert center[0] > 0.9  # front red wins
    assert center[1] < 0.1


def test_dead_gaussians_invisible():
    H, W = 16, 16
    intr = (15.0, 15.0, 8.0, 8.0)
    means = torch.tensor([[0.0, 0.0, 2.0]])
    img, acc, _ = render_gaussians(
        means, torch.tensor([[1.0, 0, 0, 0]]), torch.full((1, 3), 0.3),
        torch.tensor([0.99]), torch.tensor([[1.0, 1.0, 1.0]]),
        torch.tensor([False]), *_identity_cam(), intr,
        img_size=(H, W), span=4, k_max=8,
    )
    assert float(img.abs().max()) == 0.0


def test_render_gradients_flow():
    H, W = 16, 16
    intr = (15.0, 15.0, 8.0, 8.0)
    R, tr = _identity_cam()
    target = torch.ones((H, W, 3)) * 0.5
    means = torch.tensor([[0.1, 0.1, 2.0]], requires_grad=True)
    img, _, _ = render_gaussians(
        means, torch.tensor([[1.0, 0, 0, 0]]), torch.full((1, 3), 0.5),
        torch.tensor([0.9]), torch.tensor([[1.0, 1.0, 1.0]]),
        torch.tensor([True]), R, tr, intr,
        img_size=(H, W), span=4, k_max=8,
    )
    (g,) = torch.autograd.grad(torch.sum((img - target) ** 2), means)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0


def test_mapping_step_reduces_loss():
    """Fit colors of a fixed Gaussian cloud to a synthetic RGB-D frame."""
    H, W = 32, 32
    intr = np.asarray([30.0, 30.0, W / 2, H / 2])
    depth = np.full((H, W), 2.0, np.float32)
    im = np.zeros((H, W, 3), np.float32)
    im[:, : W // 2] = (1.0, 0.2, 0.1)
    im[:, W // 2:] = (0.1, 0.3, 1.0)

    # k_max must cover the per-tile gaussian count (one per pixel here)
    cfg = GSConfig(capacity=4096, mapping_iters=0, span=4, k_max=256,
                   prune_every=1000)
    mapper = GaussianMapper(cfg, (H, W), device="cpu")
    R = np.eye(3)
    tr = np.zeros(3)
    mapper.add_frame_gaussians(im, depth, R, tr, intr, 0)
    assert mapper.map.count > 100

    frame = mapper.frame_tensors(im, depth, R, tr, intr)
    im_l1 = []
    alive = mapper.map.alive_device()
    for _ in range(12):
        mapper.map.params, mapper.opt_state, loss, aux, _ = mapper.step(
            mapper.map.params, mapper.opt_state, alive, frame
        )
        im_l1.append(float(aux[0]))
    assert im_l1[-1] < im_l1[0] * 0.6, (im_l1[0], im_l1[-1])


def test_ssim_identity(rng):
    x = torch.from_numpy(rng.random((32, 32, 3)).astype(np.float32))
    assert float(ssim(x, x)) > 0.999
    y = torch.from_numpy(rng.random((32, 32, 3)).astype(np.float32))
    assert float(ssim(x, y)) < 0.5


def test_tsdf_sphere_mesh():
    """Fuse depth maps of a wall; mesh must lie near the wall plane."""
    H, W = 48, 48
    intr = np.asarray([40.0, 40.0, 24.0, 24.0])
    depth = np.full((H, W), 1.5, np.float32)
    color = np.full((H, W, 3), 0.5, np.float32)
    vol = TSDFVolume([-1.2, -1.2, 0.5], [1.2, 1.2, 2.5], voxel_size=0.05,
                     device="cpu")
    R = np.eye(3)
    tr = np.zeros(3)
    vol.integrate(depth, color, intr, R, tr)
    V, C, T = vol.extract_mesh()
    assert len(V) > 100
    assert len(T) == len(V) // 3
    # the surface is the z=1.5 plane (in the observed frustum)
    assert abs(np.median(V[:, 2]) - 1.5) < 0.05


def test_pointcloud_from_depth_roundtrip():
    H, W = 8, 8
    intr = (10.0, 10.0, 4.0, 4.0)
    depth = np.full((H, W), 2.0, np.float32)
    color = np.zeros((H, W, 3), np.float32)
    pts, cols, msq = pointcloud_from_depth(
        color, depth, intr, np.eye(3), np.zeros(3)
    )
    assert pts.shape == (64, 3)
    np.testing.assert_allclose(pts[:, 2], 2.0)
    # center pixel maps near the optical axis
    assert np.abs(pts[:, :2]).max() < 1.0


def test_densify_clone_split_unit():
    """gs_external.py:191-233 semantics on the fixed-capacity map: small
    high-gradient Gaussians clone, big ones split into n children with
    shrunk scales and the original removed."""
    m = GaussianMap.create(64, "cpu")
    pts = np.asarray([[0, 0, 1], [0, 0, 2], [0, 0, 3]], np.float32)
    cols = np.zeros((3, 3), np.float32)
    msq = np.asarray([1e-6, 1.0, 1e-6])  # scale = sqrt(msq)
    m.add_points(pts, cols, msq, 0)

    grads = np.zeros(64, np.float32)
    grads[0] = 1.0  # small -> clone
    grads[1] = 1.0  # big (scale 1.0 > 0.01 * radius) -> split
    added = m.densify(grads, scene_radius=1.0, grad_thresh=0.5,
                      num_to_split_into=2)
    assert added == 3  # 1 clone + 2 split children
    assert m.count == 6
    assert not m.alive[1]  # split original removed
    assert m.alive[[0, 2, 3, 4, 5]].all()
    # clone is an exact copy
    np.testing.assert_allclose(m.params["means3D"][3].numpy(), pts[0])
    # split children: scales shrunk by 1/(0.8 n), means near the original
    child_scale = float(torch.exp(m.params["log_scales"][4, 0]))
    np.testing.assert_allclose(child_scale, 1.0 / 1.6, rtol=1e-5)
    d = m.params["means3D"][4:6].numpy() - pts[1]
    assert np.all(np.abs(d) < 5.0)  # sampled from the ellipsoid


def test_mapping_densify_integration(rng):
    """A mapping run with densify enabled stays finite and the g2d probe
    produces a usable signal."""
    H, W = 32, 32
    intr = np.asarray([30.0, 30.0, W / 2, H / 2], np.float32)
    depth = np.full((H, W), 2.0, np.float32)
    im = rng.random((H, W, 3)).astype(np.float32)
    cfg = GSConfig(capacity=4096, mapping_iters=0, span=4, k_max=128,
                   prune_every=1000, densify_every=4,
                   densify_grad_thresh=1e-6)
    mapper = GaussianMapper(cfg, (H, W), device="cpu")
    R, tr = np.eye(3), np.zeros(3)
    mapper.add_frame_gaussians(im, depth, R, tr, intr, 0)
    n0 = int(mapper.map.alive.sum())
    mapper.map_frame([mapper.frame_tensors(im, depth, R, tr, intr)],
                     iters=8)
    assert torch.isfinite(mapper.map.params["means3D"]).all()
    # with a tiny threshold the densify pass must have fired and appended
    assert int(mapper.map.count) > n0


def _brute_force_composite(means, scales, ops, cols, R, tr, intr, H, W):
    """Exact per-pixel front-to-back compositor over ALL Gaussians
    (identity rotations), mirroring the renderer's conic math."""
    fx, fy, cx, cy = intr
    mc = np.asarray(means) @ np.asarray(R).T + np.asarray(tr)
    z = mc[:, 2]
    x2 = fx * mc[:, 0] / z + cx
    y2 = fy * mc[:, 1] / z + cy
    # isotropic cov: J S^2 J^T with S = diag(s); diagonal entries
    s = np.asarray(scales)[:, 0]
    cov = (fx * s / z) ** 2 + 0.3  # same low-pass dilation
    order = np.argsort(z, kind="stable")
    img = np.zeros((H, W, 3))
    T = np.ones((H, W))
    px, py = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    for g in order:
        power = -0.5 * ((px - x2[g]) ** 2 + (py - y2[g]) ** 2) / cov[g]
        a = np.minimum(float(ops[g]) * np.exp(np.minimum(power, 0.0)), 0.99)
        a = np.where(a >= 1.0 / 255.0, a, 0.0)
        img += (T * a)[..., None] * np.asarray(cols)[g]
        T = T * (1.0 - a)
    return img


def test_dense_tile_kmax_truncation_detected_and_bounded():
    """>k_max Gaussians landing on one tile must (a) fire the drop counter
    and (b) match a brute-force compositor once k_max covers the load
    (reference rasterizer_impl.cu bins every duplicate key -- it is exact;
    the top-K is a documented cap)."""
    rng = np.random.default_rng(0)
    H, W = 32, 32
    N = 150
    intr = (30.0, 30.0, W / 2, H / 2)
    # all Gaussians project into the central tile area
    means = np.stack(
        [
            rng.uniform(-0.15, 0.15, N),
            rng.uniform(-0.15, 0.15, N),
            rng.uniform(1.5, 4.0, N),
        ],
        axis=1,
    )
    quats = np.tile(np.asarray([[1.0, 0, 0, 0]]), (N, 1))
    scales = np.full((N, 3), 0.04)
    ops = np.full(N, 0.35)
    cols = rng.uniform(0, 1, (N, 3))
    alive = np.ones(N, bool)
    R, tr = _identity_cam()

    args = (t(means), t(quats), t(scales), t(ops), t(cols),
            t(alive, torch.bool), R, tr, intr)
    img96, _, _, stats96 = render_gaussians(
        *args, img_size=(H, W), span=4, k_max=96,
        with_stats=True,
    )
    # (a) the cap is exceeded and the telemetry says so
    assert int(stats96["max_tile_load"]) > 96
    assert int(stats96["dropped_pairs_kmax"]) > 0

    ref = _brute_force_composite(means, scales, ops, cols, R.numpy(),
                                 tr.numpy(), intr, H, W)

    img_full, _, _, stats_full = render_gaussians(
        *args, img_size=(H, W), span=4, k_max=256,
        with_stats=True,
    )
    assert int(stats_full["dropped_pairs_kmax"]) == 0
    # (b) un-truncated renderer matches the exact compositor
    np.testing.assert_allclose(img_full.numpy(), ref, atol=5e-3)
    # and the k_max=96 truncation error is visible but bounded
    err96 = np.abs(img96.numpy() - ref).max()
    assert err96 > 1e-4  # truncation is material on this scene
