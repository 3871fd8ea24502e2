"""Port parity of ``terminate()`` against the JAX package, on the CPU:
the trajectory filler (SE(3) interpolation between the bracketing
keyframes, 16-frame batches of motion-only BA in scratch slots, the
one-off widening of a full buffer) and ``LGUSlam.track`` + ``terminate``
end to end on tests/test_slam_e2e.py's stream.

Everything runs in fp32 (tests/test_trajectory_filler.py's geometry uses
the default bf16 dtypes; here they are fp32, so that the comparison is of
the algorithm).  The JAX package's ``LGUSlam`` shards its backend over the
8 virtual CPU devices of this process; the port has one device, so its
end-to-end run is held against the JAX package's single-device backend.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_slam_e2e import synthetic_stream
from test_torch_track import jax_init, weights  # noqa: F401
from torch_port import (  # noqa: F401
    close, tiny_config_kwargs, torch_single_thread, video_from_jax)

from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.slam.state import Video as JVideo
from lgu_slam_tpu.slam.system import LGUSlam as JSlam
from lgu_slam_tpu.slam.trajectory_filler import (
    TrajectoryFiller as JFiller,
)
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.models.net import LGUNet
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.slam.trajectory_filler import TrajectoryFiller
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.weights import state_dict_from_jax_params

def line_video(kw, T, seed=1):
    """tests/test_trajectory_filler.py's keyframes: T slots of a straight
    line (0.05 per keyframe along x), random features, in both packages."""
    jc = JConfig(**kw)
    jv = JVideo(jc)
    h, w = jc.ht8, jc.wd8
    rng = np.random.default_rng(seed)
    s = jv.state
    for k in range(T):
        s = s._replace(
            tstamp=s.tstamp.at[k].set(float(k)),
            poses=s.poses.at[k].set(jl.se3_exp(jnp.asarray(
                [0.05 * k, 0, 0, 0, 0, 0], jnp.float32))),
            intrinsics=s.intrinsics.at[k].set(
                jnp.asarray([10.0, 10.0, w / 2, h / 2])),
            fmaps=s.fmaps.at[k].set(rng.normal(size=(1, h, w, 128))),
            nets=s.nets.at[k].set(np.tanh(rng.normal(size=(h, w, 128)))),
            inps=s.inps.at[k].set(rng.normal(size=(h, w, 128))))
    jv.state = s
    jv.counter = T
    return jv, video_from_jax(jv, SLAMConfig(**kw))


def frames(kw, tstamps, seed=2):
    H, W = kw["image_size"]
    rng = np.random.default_rng(seed)
    intr = np.asarray([80.0, 80.0, W / 2, H / 2], np.float32)
    return [(t, rng.integers(0, 255, size=(H, W, 3)).astype(np.uint8), intr)
            for t in tstamps]


def fill_both(weights, kw, T, tstamps):
    net_def, params, sd = weights
    jv, tv = line_video(kw, T)
    net = LGUNet.from_config(SLAMConfig(**kw), device="cpu")
    net.load_state_dict(sd, strict=True)
    stream = frames(kw, tstamps)
    ref = JFiller(net_def, params, jv, JConfig(**kw))(iter(stream))
    out = TrajectoryFiller(net.eval(), tv, SLAMConfig(**kw))(iter(stream))
    return jv, tv, out, ref


def test_filler_matches_jax(weights):
    """20 frames (a batch of 16 and one of 4, padded) between, before
    the first and past the last of 6 keyframes in a 24-slot buffer.
    Interpolation is exact up to fp32; 6 motion-only iterations of ~20
    convs, K1's and K2's plain versions and a Gauss-Newton solve: 2e-4."""
    kw = dict(tiny_config_kwargs(), buffer=24)
    tstamps = [-0.5 + 0.35 * k for k in range(20)]
    jv, tv, out, ref = fill_both(weights, kw, 6, tstamps)
    assert out.shape == (20, 7) and np.isfinite(out).all()
    close(torch.from_numpy(out), ref, atol=2e-4)
    assert tv.counter == jv.counter == 6
    # scratch slots past the keyframes hold the last batch
    close(tv.poses[6:22], jv.state.poses[6:22], atol=2e-4)


def test_filler_widens_a_full_buffer(weights):
    """tests/test_trajectory_filler.py's case: all 8 slots are keyframes,
    so the buffers are widened once for the fill and restored after it."""
    kw = dict(tiny_config_kwargs(), buffer=8)
    jv, tv, out, ref = fill_both(weights, kw, 8,
                                 [0.5 + k for k in range(5)])
    assert out.shape == (5, 7) and np.isfinite(out).all()
    close(torch.from_numpy(out), ref, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(out[:, 3:], axis=-1), 1.0,
                               atol=1e-3)
    assert np.all(out[:, 0] > -0.6) and np.all(out[:, 0] < 0.1)
    assert tv.counter == 8 and tv.poses.shape[0] == 8
    for name in tv._FIELDS:
        assert getattr(tv, name).shape[0] in (8, 1), name


def test_track_and_terminate_match_jax(jax_init):
    """tests/test_slam_e2e.py's stream tracked by both packages from the
    JAX package's own init, then ``terminate(stream)`` with two backend
    passes (2 and 1 steps; the 16*t edge budget is capped at 64 with a
    warning) and the trajectory filled for all 14 frames.  A third run
    takes the port's ``terminate`` from the JAX package's tracked state.

    Free-running tracking keeps the same keyframes, edges and inactive
    edges; its poses are held to the JAX package update by update in
    tests/test_torch_track.py (``test_track_updates_match_jax_stepwise``),
    because free-running random-weight tracking is chaotic on this stream
    (``test_tracking_self_perturbation``), so the free-running run's
    trajectory is checked for shape, finite values and unit quaternions.
    From the same tracked state the backends agree to 1e-4.  The filler's
    motion-only BA amplifies any difference: moving the keyframe
    translations by 1e-6 moves the port's own filled poses by up to 1.2e-2
    (a tap crossing a plane's low edge switches the lookup's boundary
    rule), so the trajectories from the same start are held to 3e-2."""
    net_def, params = jax_init
    kw = tiny_config_kwargs()
    cfg = SLAMConfig(**kw)
    sd = state_dict_from_jax_params(params)
    js = JSlam(params, JConfig(**kw), net_def=net_def)
    js.backend.mesh = None  # the single-device backend
    ts = LGUSlam(sd, cfg, device="cpu")
    for k, img, intr in synthetic_stream():
        js.track(float(k), img, intrinsics=intr)
        ts.track(float(k), img, intrinsics=intr)
    n = js.video.counter
    assert ts.video.counter == n == 14
    jg, tg = js.frontend.graph, ts.frontend.graph
    assert tg.ii.tolist() == jg.ii.tolist()
    assert tg.jj.tolist() == jg.jj.tolist()
    assert tg.ii_inac.tolist() == jg.ii_inac.tolist()
    assert tg.jj_inac.tolist() == jg.jj_inac.tolist()
    tf = LGUSlam(sd, cfg, device="cpu")
    video_from_jax(js.video, cfg, tf.video)

    def terminate(slam):
        with pytest.warns(UserWarning, match="backend edge budget"):
            return slam.terminate(stream=synthetic_stream(),
                                  backend_steps=(2, 1))

    ref, out, out_f = (terminate(slam) for slam in (js, ts, tf))
    assert not hasattr(ts, "frontend")
    for traj in (out, out_f):
        assert traj.shape == ref.shape == (14, 7)
        assert np.isfinite(traj).all()
        np.testing.assert_allclose(np.linalg.norm(traj[:, 3:], axis=-1),
                                   1.0, atol=1e-3)
    assert bool(torch.isfinite(ts.video.poses[:n]).all())
    close(torch.from_numpy(out_f), ref, atol=3e-2)
    kf = js.video.state.poses[:n]
    close(tf.video.poses[:n], kf, atol=1e-4, msg="backend, same start")
