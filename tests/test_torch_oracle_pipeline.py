"""The JAX package's oracle pipeline (tests/test_oracle_pipeline.py) on the
port: the same scene and configuration drive the port's real Frontend
(init, proximity planning, the fused update + DBA, keyframe cull, inactive
store) and then ``Backend(steps=6)``, with the learned update replaced by
the ground-truth oracle of tests/torch_oracle.py.  As in the JAX test, at
least 10 keyframes stay, the cull fires, and the Sim(3)-aligned ATE is
below 1 % of the trajectory's extent; the port also keeps the keyframes
(count and timestamps) that the JAX pipeline keeps on the same scene, run
in the same test: on one process against one device, and through
``Backend(group=)`` on two gloo ranks against the JAX backend sharded over
two devices."""

import numpy as np
import pytest
from test_oracle_pipeline import OracleNet as JOracle
from test_torch_parallel import finish_ranks, start_ranks
from torch_oracle import ORACLE_CONFIG, make_scene, run_pipeline, scene_ate
from torch_port import torch_single_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.slam.backend import Backend as JBackend
from lgu_slam_tpu.slam.frontend import Frontend as JFrontend
from lgu_slam_tpu.slam.state import Video as JVideo
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.utils.config import SLAMConfig

T = 14


def jax_pipeline(devices: int | None):
    """tests/test_oracle_pipeline.py ``_run_pipeline`` on the port's scene
    (the same arrays): keyframe timestamps, ATE and extent."""
    cfg = JConfig(**ORACLE_CONFIG)
    h, w = cfg.ht8, cfg.wd8
    gt_poses, gt_disps, gt_intr = make_scene(T, h, w)
    oracle = JOracle(gt_poses, gt_disps, gt_intr)
    video = JVideo(cfg)
    frontend = JFrontend(oracle, None, video, cfg)
    img = jnp.zeros((*cfg.image_size, 3), jnp.uint8)
    zeros_hw = jnp.zeros((h, w), jnp.float32)
    feat = jnp.zeros((h, w, 128), video.state.nets.dtype)
    for t in range(T):
        idx = video.counter
        fmap = jnp.zeros((1, h, w, 128), video.state.fmaps.dtype)
        fmap = fmap.at[0, :, :, 0].set(float(t))
        if idx == 0:
            pose, disp = jl.se3_identity(), jnp.ones((h, w), jnp.float32)
        else:
            pose, disp = video.state.poses[idx], video.state.disps[idx]
        video.append(jnp.float32(t), img, pose, disp, zeros_hw,
                     jnp.asarray(gt_intr[0]), fmap, feat, feat)
        frontend()
    mesh = None if devices is None else Mesh(
        np.asarray(jax.devices()[:devices]), ("kf",))
    JBackend(oracle, None, video, cfg, mesh=mesh)(steps=6)
    k = video.counter
    tstamps = np.asarray(video.state.tstamp[:k]).astype(int)
    rmse, extent = scene_ate(gt_poses, tstamps,
                             np.asarray(video.state.poses[:k]))
    return tstamps.tolist(), rmse, extent


def held_to_jax(got, want):
    tstamps, rmse, extent = want
    assert rmse < 0.01 * extent, (rmse, extent)  # the JAX pipeline's own
    assert got["culled"], "cull path never fired"
    assert got["keyframes"] >= 10
    assert got["ate"] < 0.01 * got["extent"], (got["ate"], got["extent"])
    assert got["extent"] == pytest.approx(extent, rel=1e-5)
    assert got["keyframes"] == len(tstamps)
    assert got["tstamps"] == tstamps


@pytest.mark.filterwarnings("ignore:backend edge budget truncated")
def test_oracle_pipeline_single_process():
    got = run_pipeline(SLAMConfig(**ORACLE_CONFIG), T, "cpu")
    held_to_jax(got, jax_pipeline(None))


@pytest.mark.filterwarnings("ignore:backend edge budget truncated")
def test_oracle_pipeline_two_gloo_ranks(tmp_path):
    """Each rank runs the frontend; the backend pass runs sharded over the
    two ranks (tests/torch_dist_worker.py ``oracle``), which end with the
    same poses."""
    started = start_ranks("oracle", 2, {"config": ORACLE_CONFIG, "T": T},
                          tmp_path)
    want = jax_pipeline(2)
    held_to_jax(finish_ranks(started), want)
