"""The JAX package's geometry-only convergence through the real factor
graph (tests/test_geom_e2e.py) on the port: ``add_factors`` ->
``rm_factors(store=True)`` (4 edges into the inactive pool) -> DBA over the
active edges and the selected inactive ones.  In the port that DBA runs
inside ``update_n(..., use_inactive=True)``, so the ground-truth oracle of
tests/torch_oracle.py gives it the ground-truth targets and unit weights.
Poses and depths converge to the ground truth within the JAX test's bounds,
and the JAX test's own path reaches the same bounds on the same inputs."""

import jax.numpy as jnp
import numpy as np
import torch
from torch_oracle import OracleNet
from torch_port import torch_single_thread  # noqa: F401

import lgu_slam_tpu_torch.slam.factor_graph as tfg
from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.geom import projective as jproj
from lgu_slam_tpu.slam.factor_graph import FactorGraph as JGraph
from lgu_slam_tpu.slam.state import Video as JVideo
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch import lie
from lgu_slam_tpu_torch.geom.projective import projective_transform
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.utils.config import SLAMConfig

T = 8
KW = dict(image_size=(64, 96), buffer=T, warmup=4, max_factors=64,
          edge_bucket=64, inactive_bucket=16, pose_bucket=T,
          backend_edge_cap=64, backend_chunk=8)


def scene(seed=0):
    """tests/test_geom_e2e.py's draws: ground-truth twists and disparities,
    the pose noise (frame 0, the gauge anchor, unperturbed) and the
    disparity noise; the intrinsics and the edges |i - j| in {1, 2}."""
    rng = np.random.default_rng(seed)
    cfg = SLAMConfig(**KW)
    h, w = cfg.ht8, cfg.wd8
    xi_gt = np.cumsum(rng.normal(size=(T, 6)) * 0.03, 0).astype(np.float32)
    disps_gt = (0.6 + 0.2 * rng.random((T, h, w)).astype(np.float32))
    noise = rng.normal(size=(T, 6)).astype(np.float32) * 0.01
    noise[0] = 0.0
    dnoise = 1.0 + 0.05 * rng.normal(size=(T, h, w)).astype(np.float32)
    intr = np.asarray([w * 2.0, w * 2.0, w / 2, h / 2], np.float32)
    ii, jj = zip(*[(i, j) for i in range(T) for j in range(T)
                   if 0 < abs(i - j) <= 2])
    return dict(xi_gt=xi_gt, disps_gt=disps_gt, noise=noise, dnoise=dnoise,
                intr=intr, ii=np.asarray(ii), jj=np.asarray(jj))


def pose_err(p, gt):
    d = lie.se3_mul(p, lie.se3_inv(gt))
    return float(torch.linalg.norm(lie.se3_log(d)[1:], dim=-1).mean())


def port_run(s, plans):
    """The port: the staged video, the graph, 4 edges stored inactive with
    ground-truth targets and unit weights, then 6 iterations of update_n
    (each a GRU update, here the oracle's, and a 2-iteration DBA)."""
    cfg = SLAMConfig(**KW)
    poses_gt = lie.se3_exp(torch.from_numpy(s["xi_gt"]))
    disps_gt = torch.from_numpy(s["disps_gt"])
    intr = torch.from_numpy(s["intr"]).expand(T, 4)
    video = Video(cfg, "cpu")
    video.counter = T
    video.poses[:T] = lie.se3_mul(lie.se3_exp(torch.from_numpy(s["noise"])),
                                  poses_gt)
    video.disps[:T] = disps_gt * torch.from_numpy(s["dnoise"])
    video.intrinsics[:T] = intr
    video.fmaps[:T, 0, :, :, 0] = torch.arange(T, dtype=torch.float32)[
        :, None, None]  # the frame ids the oracle decodes
    video.damping[:] = 1e-4  # near-zero damping: trust the exact targets
    oracle = OracleNet(poses_gt, disps_gt, intr, "cpu")

    graph = FactorGraph(oracle, video, cfg, max_factors=64, edge_bucket=64,
                        inactive_bucket=16)
    graph.add_factors(s["ii"], s["jj"])
    drop = np.zeros(graph.n_edges, bool)
    drop[-4:] = True
    kept = graph.n_edges - 4
    graph.rm_factors(drop, store=True)
    assert graph.n_edges == kept and len(graph.ii_inac) == 4
    gt, _ = projective_transform(
        poses_gt, disps_gt, intr, torch.from_numpy(graph.ii_inac),
        torch.from_numpy(graph.jj_inac))
    graph.target_inac, graph.weight_inac = gt, torch.ones_like(gt)

    err0 = pose_err(video.poses[:T], poses_gt)
    derr0 = float((video.disps[:T] - disps_gt).abs().mean())
    graph.update_n(6, t0=1, t1=T, itrs=2, use_inactive=True)
    plans.append((graph.ii_inac.copy(), graph.jj_inac.copy()))
    err1 = pose_err(video.poses[:T], poses_gt)
    derr1 = float((video.disps[:T] - disps_gt).abs().mean())
    now, _ = projective_transform(video.poses, video.disps,
                                  video.intrinsics,
                                  torch.from_numpy(graph.ii),
                                  torch.from_numpy(graph.jj))
    resid = float((now - graph.target).abs().mean())
    return err0, err1, derr0, derr1, resid


def jax_run(s):
    """tests/test_geom_e2e.py's path on the same draws: ``_run_dba`` with
    ``use_inactive=True``, 6 times, the damping reset to 1e-4 before each."""
    cfg = JConfig(**KW)
    poses_gt = jl.se3_exp(jnp.asarray(s["xi_gt"]))
    disps_gt = jnp.asarray(s["disps_gt"])
    intr = jnp.asarray(s["intr"])
    net, params = init_params(cfg, seed=0)
    video = JVideo(cfg)
    video.counter = T
    video.state = video.state._replace(
        poses=video.state.poses.at[:T].set(
            jl.se3_mul(jl.se3_exp(jnp.asarray(s["noise"])), poses_gt)),
        disps=video.state.disps.at[:T].set(disps_gt * s["dnoise"]),
        intrinsics=video.state.intrinsics.at[:T].set(intr))
    graph = JGraph(net, params, video, cfg, max_factors=64, edge_bucket=64,
                   inactive_bucket=16)
    graph.add_factors(s["ii"].astype(np.int32), s["jj"].astype(np.int32))
    drop = np.zeros(graph.n_edges, bool)
    drop[-4:] = True
    graph.rm_factors(drop, store=True)
    intr_n = jnp.broadcast_to(intr, (T, 4))

    def gt_target(ii, jj):
        return jproj.projective_transform(poses_gt, disps_gt, intr_n,
                                          jnp.asarray(ii), jnp.asarray(jj))[0]

    graph.target = graph.target.at[:graph.n_edges].set(
        gt_target(graph.ii, graph.jj))
    graph.weight = graph.weight.at[:graph.n_edges].set(1.0)
    graph.target_inac = graph.target_inac.at[:4].set(
        gt_target(graph.ii_inac, graph.jj_inac))
    graph.weight_inac = graph.weight_inac.at[:4].set(1.0)

    def damp():
        video.state = video.state._replace(
            damping=jnp.full_like(video.state.damping, 1e-4))

    def err(p):
        d = jl.se3_mul(p, jl.se3_inv(poses_gt))
        return float(jnp.linalg.norm(jl.se3_log(d)[1:], axis=-1).mean())

    damp()
    err0 = err(video.state.poses[:T])
    derr0 = float(jnp.abs(video.state.disps[:T] - disps_gt).mean())
    for _ in range(6):
        graph._run_dba(t0=1, t1=T, itrs=2, use_inactive=True, EP=1e-7,
                       motion_only=False)
        damp()
    err1 = err(video.state.poses[:T])
    derr1 = float(jnp.abs(video.state.disps[:T] - disps_gt).mean())
    now, _ = jproj.projective_transform(
        video.state.poses, video.state.disps, video.state.intrinsics,
        jnp.asarray(graph.ii), jnp.asarray(graph.jj))
    resid = float(jnp.abs(now - graph.target[:graph.n_edges]).mean())
    return err0, err1, derr0, derr1, resid


def within_bounds(err0, err1, derr0, derr1, resid):
    """tests/test_geom_e2e.py's bounds."""
    assert np.isfinite(err1) and np.isfinite(derr1)
    assert err1 < 0.1 * err0, (err0, err1)
    assert derr1 < 0.2 * derr0, (derr0, derr1)
    assert err1 < 2e-3, err1
    assert resid < 0.02, resid


def test_update_n_dba_converges_to_ground_truth(monkeypatch):
    s = scene()
    built, plans = [], []
    real_build = tfg.DbaPlan.build

    def build(ii, jj, *args, **kw):
        built.append((np.asarray(ii).copy(), np.asarray(jj).copy()))
        return real_build(ii, jj, *args, **kw)

    monkeypatch.setattr(tfg.DbaPlan, "build", staticmethod(build))
    got = port_run(s, plans)
    # the inactive edges entered the DBA's plan, after the active ones
    (ii, jj), = built
    ii_inac, jj_inac = plans[0]
    assert len(ii) == len(s["ii"])
    assert ii[-4:].tolist() == ii_inac.tolist()
    assert jj[-4:].tolist() == jj_inac.tolist()
    within_bounds(*got)
    within_bounds(*jax_run(s))
