"""The JAX package's ``upsample=True`` end-to-end checks
(tests/test_upsample_e2e.py) on the port: ``track()`` on the same
configuration and stream fills ``disps_up`` through the frontend's
``update_n``, and ``backend(steps=2)`` then fills it through
``update_lowmem``: full-resolution, finite, written, non-negative and below
100.  Also: every GRU + DBA iteration of the JAX frontend, replayed by the
port from the JAX state just before it in the same configuration in fp32
and on the same bridged weights, leaves the same ``disps_up`` within
update_n's tolerance (tests/test_torch_track.py: 2e-3)."""

import jax
import numpy as np
import pytest
import torch
from test_slam_e2e import synthetic_stream
from test_torch_track import bridged_net, graph_from_jax, seeded_pairs
from torch_port import (  # noqa: F401
    close, tiny_config_kwargs, torch_single_thread)

from lgu_slam_tpu.slam.system import LGUSlam as JSlam
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.weights import state_dict_from_jax_params

# tests/test_upsample_e2e.py's configuration (its dtypes are the defaults)
KW = dict(image_size=(64, 96), buffer=24, warmup=5, filter_thresh=0.0,
          keyframe_thresh=0.0, frontend_window=8, frontend_iters1=2,
          frontend_iters2=1, max_factors=24, edge_bucket=32,
          inactive_bucket=32, pose_bucket=24, backend_edge_cap=64,
          backend_chunk=32, upsample=True)
FP32 = dict(volume_dtype="float32", feat_dtype="float32",
            compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_init():
    net_def, params = init_params(JConfig(**KW), seed=0)
    return net_def, jax.device_get(params)


@pytest.fixture(scope="module")
def upsample_run(jax_init):
    _, params = jax_init
    cfg = SLAMConfig(**KW)
    slam = LGUSlam(state_dict_from_jax_params(params), cfg, device="cpu")
    for t, img, intr in synthetic_stream(n_frames=10):
        slam.track(float(t), img, intrinsics=intr)
    return slam, cfg


def test_frontend_populates_disps_up(upsample_run):
    slam, cfg = upsample_run
    t = slam.video.counter
    H, W = cfg.image_size
    du = slam.video.disps_up.numpy()
    assert du.shape == (cfg.buffer, H, W)
    assert np.isfinite(du[:t]).all()
    assert (np.abs(du[:t]) > 0).any(), "disps_up never written"


def test_backend_lowmem_populates_disps_up(upsample_run):
    slam, cfg = upsample_run
    t = slam.video.counter
    slam.backend(steps=2)
    du = slam.video.disps_up[:t].numpy()
    assert np.isfinite(du).all()
    written = np.abs(du.reshape(t, -1)).max(axis=1) > 0
    assert written.any()
    assert du.min() >= -1e-6
    assert du.max() < 100.0


def test_frontend_disps_up_matches_jax_stepwise(jax_init):
    """Each iteration starts the port from the JAX state before it (as
    tests/test_torch_track.py's stepwise test does); the frames whose
    edges include a newly seeded keyframe's pair (coordinates on the
    lookup's integer grid, where the two packages may flip a tap) are held
    finite only."""
    net_def, params = jax_init
    kw = dict(KW, **FP32)
    cfg = SLAMConfig(**kw)
    net = bridged_net(params, cfg)
    js = JSlam(params, JConfig(**kw), net_def=net_def)
    jg = js.frontend.graph
    run_jax = jg.update_n
    held = []

    def stepwise(n, t0=None, t1=None, itrs=2, use_inactive=False, EP=1e-7,
                 motion_only=False):
        for _ in range(n):
            tg = graph_from_jax(jg, net, cfg)
            skip = seeded_pairs(jg)
            run_jax(1, t0, t1, itrs, use_inactive, EP, motion_only)
            tg.update_n(1, t0, t1, itrs, use_inactive, EP, motion_only)
            ref = np.asarray(jg.video.state.disps_up)
            got = tg.video.disps_up
            assert bool(torch.isfinite(got).all())
            frames = sorted(set(tg.ii.tolist()) - set(tg.ii[skip].tolist()))
            close(got[frames], ref[frames], atol=2e-3, rtol=2e-3,
                  msg=f"iteration {len(held)} disps_up")
            held.append(len(frames))

    jg.update_n = stepwise
    for k, img, intr in synthetic_stream(n_frames=10):
        js.track(float(k), img, intrinsics=intr)
    assert len(held) > 0 and min(held) > 0
    assert np.abs(np.asarray(jg.video.state.disps_up)).max() > 0
