"""Port parity of LGUSlam.track in the stereo and RGB-D modes, on the
stream and configuration of tests/test_slam_modes.py (fp32 dtypes, six
frames: warm-up, initialise, two keyframe updates).

Stereo exercises the rig feature slots, the stereo self-edges (ii == jj)
with the fixed baseline in the projection and the DBA, and the right
camera's features in their pyramids.  RGB-D exercises the subsampled
sensed disparity, its adoption by the frontend and the DBA's depth prior.
Tolerances: fp32 on both sides, differences grown through 2-3 frontend
updates of random-weight tracking.
"""

import dataclasses

import jax
import numpy as np
import pytest
from test_slam_modes import make_cfg, synthetic_frames
from torch_port import close, torch_single_thread  # noqa: F401

from lgu_slam_tpu.slam.system import LGUSlam as JSlam
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.weights import state_dict_from_jax_params

FP32 = dict(volume_dtype="float32", feat_dtype="float32",
            compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_init():
    net_def, params = init_params(make_cfg().replace(**FP32), seed=0)
    return net_def, jax.device_get(params)


@pytest.mark.parametrize("mode", ["stereo", "rgbd"])
def test_track_mode_matches_jax(jax_init, mode):
    net_def, params = jax_init
    jcfg = make_cfg(stereo=mode == "stereo").replace(**FP32)
    js = JSlam(params, jcfg, net_def=net_def)
    ts = LGUSlam(state_dict_from_jax_params(params),
                 SLAMConfig(**dataclasses.asdict(jcfg)), device="cpu")
    H, W = jcfg.image_size
    for k, left, right, intr in synthetic_frames(n=6):
        if mode == "stereo":
            args, kw = (np.stack([left, right]),), {}
        else:
            args = (left,)
            kw = dict(depth=np.full((H, W), 2.0 + 0.1 * k, np.float32))
        js.track(float(k), *args, intrinsics=intr, **kw)
        ts.track(float(k), *args, intrinsics=intr, **kw)
    n = js.video.counter
    assert ts.video.counter == n == 6
    jg, tg = js.frontend.graph, ts.frontend.graph
    assert tg.ii.tolist() == jg.ii.tolist()
    assert tg.jj.tolist() == jg.jj.tolist()
    if mode == "stereo":
        assert (tg.ii == tg.jj).any()  # stereo self-edges took part
        close(ts.video.fmaps[:n], js.video.state.fmaps[:n], atol=2e-4,
              rtol=1e-4)
    else:
        close(ts.video.disps_sens[:n], js.video.state.disps_sens[:n],
              atol=1e-6)
    close(ts.video.poses[:n], js.video.state.poses[:n], atol=5e-3)
    close(ts.video.disps[:n], js.video.state.disps[:n], atol=5e-2)
