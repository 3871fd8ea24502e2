"""Port parity of the tracking path: FactorGraph.update_n on a staged
video with forced edges, the proximity planner, keyframe removal, and
LGUSlam.track end to end on tests/test_slam_e2e.py's synthetic stream and
tiny configuration in fp32.  Also: the port imports nothing of JAX, and an
entry point given no device needs CUDA.

The JAX package's frontend pads the GraphAgg frame slots to
``frame_bucket`` with frame id 0, and the duplicate-index scatter that
writes the per-frame damping then lets a padded slot restore frame 0's old
damping over its new one.  The port reproduces that (frame 0 keeps its
damping while any slot is padded), and the tests hold it to the JAX package
as it is: the update_n test has frame 0 among its source frames.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_slam_e2e import synthetic_stream
from torch_port import (  # noqa: F401
    close, t, tiny_config_kwargs, torch_single_thread)

import lgu_slam_tpu.slam.factor_graph as jfg
from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.slam.state import Video as JVideo
from lgu_slam_tpu.slam.system import LGUSlam as JSlam
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.models.net import LGUNet, init_state_dict
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.weights import state_dict_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's random init of the tiny configuration."""
    net_def, params = init_params(JConfig(**tiny_config_kwargs()), seed=0)
    return net_def, jax.device_get(params)


@pytest.fixture(scope="module")
def weights(jax_init):
    """The init with N(0, 0.02) noise on every leaf (so the zero-initialised
    offset heads act), and its bridged state dict."""
    net_def, params = jax_init
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape))
        .astype(np.float32), params)
    return net_def, params, state_dict_from_jax_params(params)


def staged_videos(kw, T, seed):
    """The same T keyframes in a JAX Video and in a port Video."""
    rng = np.random.default_rng(seed)
    jc, tc = JConfig(**kw), SLAMConfig(**kw)
    h, w = tc.ht8, tc.wd8
    fmaps = rng.normal(size=(T, 1, h, w, 128)).astype(np.float32)
    nets = np.tanh(rng.normal(size=(T, h, w, 128))).astype(np.float32)
    inps = np.maximum(rng.normal(size=(T, h, w, 128)), 0).astype(np.float32)
    poses = np.asarray(jl.se3_exp(jnp.asarray(
        np.cumsum(rng.normal(size=(T, 6)) * 0.02, 0), jnp.float32)))
    disps = (0.5 + 0.3 * rng.random((T, h, w))).astype(np.float32)
    intr = np.asarray([w * 4.0, w * 4.0, w / 2, h / 2], np.float32)

    jv = JVideo(jc)
    s = jv.state
    jv.state = s._replace(
        fmaps=s.fmaps.at[:T].set(fmaps), nets=s.nets.at[:T].set(nets),
        inps=s.inps.at[:T].set(inps), poses=s.poses.at[:T].set(poses),
        disps=s.disps.at[:T].set(disps),
        intrinsics=s.intrinsics.at[:T].set(intr))
    jv.counter = T
    tv = Video(tc, "cpu")
    tv.fmaps[:T], tv.nets[:T], tv.inps[:T] = t(fmaps), t(nets), t(inps)
    tv.poses[:T], tv.disps[:T], tv.intrinsics[:T] = t(poses), t(disps), \
        t(intr)
    tv.counter = T
    return jv, tv


def graphs(weights, kw, T=8, seed=7):
    net_def, params, sd = weights
    jv, tv = staged_videos(kw, T, seed)
    jc, tc = JConfig(**kw), SLAMConfig(**kw)
    jg = jfg.FactorGraph(net_def, params, jv, jc, corr_impl="volume",
                         max_factors=jc.max_factors)
    net = LGUNet.from_config(tc, device="cpu")
    net.load_state_dict(sd, strict=True)
    tg = FactorGraph(net.eval(), tv, tc, max_factors=tc.max_factors)
    return jg, tg


def same_state(jg, tg, atol, what=""):
    n = jg.n_edges
    assert tg.ii.tolist() == jg.ii.tolist() and tg.jj.tolist() == \
        jg.jj.tolist(), what
    assert tg.ii_inac.tolist() == jg.ii_inac.tolist(), what
    assert tg.age.tolist() == jg.age.tolist(), what
    s, v = jg.video.state, tg.video
    close(v.poses, s.poses, atol=atol, msg=what + " poses")
    close(v.disps, s.disps, atol=atol, rtol=atol, msg=what + " disps")
    close(v.damping, s.damping, atol=atol, rtol=atol, msg=what + " damping")
    close(tg.target, jg.target[:n], atol=10 * atol, msg=what + " target")
    close(tg.weight, jg.weight[:n], atol=atol, msg=what + " weight")
    close(tg.hidden, jg.net[:n], atol=atol, msg=what + " hidden")
    ni = len(jg.ii_inac)
    close(tg.target_inac, jg.target_inac[:ni], atol=10 * atol,
          msg=what + " inactive targets")


def test_update_n_matches_jax(weights):
    """Forced edges (frame 0 a source frame too, so its damping follows the
    JAX package's padded-slot scatter), two bursts of GRU + DBA iterations
    with stored inactive edges in between.  fp32; 4 iterations of ~20
    convs, the lookup and a Gauss-Newton solve: 2e-3 (targets are in
    pixels: 2e-2)."""
    two_bursts(weights, dict(tiny_config_kwargs(), buffer=16,
                             inactive_bucket=8))


def test_update_n_writes_frame_0_without_padded_slots(weights):
    """As above with ``frame_bucket`` 8: the first burst's 8 source frames
    fill every slot, so frame 0's damping is written in both packages; the
    second burst's 7 leave one slot padded."""
    two_bursts(weights, dict(tiny_config_kwargs(), buffer=16,
                             inactive_bucket=8, frame_bucket=8))


def two_bursts(weights, kw):
    """The lookup's boundary rule jumps where a tap crosses a plane's low
    edge, so a pose difference of 1e-5 can flip one tap there: these edges
    keep every tap clear of such a crossing."""
    jg, tg = graphs(weights, kw)
    ii = np.array([1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 1, 3, 0])
    jj = np.array([0, 1, 3, 2, 4, 3, 5, 4, 6, 5, 7, 6, 2, 1, 2])
    for g in (jg, tg):
        g.add_factors(ii, jj)
        g.update_n(2, use_inactive=True)
    same_state(jg, tg, 2e-3, "first burst")
    drop = np.zeros(len(ii), bool)
    drop[[0, 5, 12]] = True
    for g in (jg, tg):
        g.rm_factors(drop, store=True)
        g.add_factors(np.array([7, 4]), np.array([4, 7]))
        g.update_n(2, t0=2, use_inactive=True)
    same_state(jg, tg, 2e-3, "second burst")


def test_proximity_and_rm_keyframe_match_jax(weights):
    """The planner picks the same edges from the same distances (JAX:
    its native planner where built, else its Python one), and removing a
    keyframe re-indexes both graphs and videos alike."""
    jg, tg = graphs(weights, dict(tiny_config_kwargs(), buffer=16), T=10,
                    seed=11)
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 4, r=2)
        g.add_proximity_factors(2, 0, rad=1, nms=1, thresh=50.0, beta=0.3,
                                remove=True)
    assert tg.ii.tolist() == jg.ii.tolist()
    assert tg.jj.tolist() == jg.jj.tolist()
    drop = np.asarray(tg.ii) % 3 == 0
    for g in (jg, tg):
        g.rm_factors(drop, store=True)
        g.rm_keyframe(5)
    assert tg.video.counter == jg.video.counter == 9
    same_state(jg, tg, 1e-6, "after rm_keyframe")
    close(tg.video.fmaps[:9], jg.video.state.fmaps[:9], atol=0)


def test_jax_damping_scatter_keeps_frame_0():
    """Pins the JAX package's fault described in the module docstring:
    with frame 0 in slot 0 and padded slots (frame id 0, slot_mask False),
    frame 0 keeps its old damping; the live frame 2 is updated."""
    damping = jnp.full((4, 2, 3), 1e-6, jnp.float32)
    eta = jnp.full((3, 2, 3), 0.5, jnp.float32)
    out = np.asarray(jfg._update_damping(
        damping, eta, jnp.asarray([0, 2, 0]),
        jnp.asarray([True, True, False])))
    assert (out[0] == np.float32(1e-6)).all()  # reference: 0.5
    assert (out[2] == 0.5).all()


def test_track_matches_jax(jax_init):
    """14 frames of tests/test_slam_e2e.py's stream with the JAX package's
    own init: warm-up, initialise, 9 keyframe updates.  Same keyframes and
    edge lists; keyframe poses within 1e-2 and inverse depths (up to ~8)
    within 0.1.  The bound is loose by design: random-weight tracking
    amplifies fp32 rounding from update to update, so a perturbation of
    the port's own weights in their last digits moves its poses on the
    order of 1e-3 over these frames, as the op-order differences between
    the two packages do."""
    net_def, params = jax_init
    kw = tiny_config_kwargs()
    js = JSlam(params, JConfig(**kw), net_def=net_def)
    ts = LGUSlam(state_dict_from_jax_params(params), SLAMConfig(**kw),
                 device="cpu")
    for k, img, intr in synthetic_stream():
        js.track(float(k), img, intrinsics=intr)
        ts.track(float(k), img, intrinsics=intr)
    n = js.video.counter
    assert ts.video.counter == n == 14
    jg, tg = js.frontend.graph, ts.frontend.graph
    assert tg.ii.tolist() == jg.ii.tolist()
    assert tg.jj.tolist() == jg.jj.tolist()
    assert tg.ii_inac.tolist() == jg.ii_inac.tolist()
    close(ts.video.poses[:n], js.video.state.poses[:n], atol=1e-2)
    close(ts.video.disps[:n], js.video.state.disps[:n], atol=0.1)
    assert bool(torch.isfinite(ts.video.poses[:n]).all())


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's scripts
    (scripts/*_torch*.py) import with JAX, flax, the JAX package and its
    native extension made unimportable."""
    code = (
        "import sys, glob, importlib, importlib.util, pkgutil\n"
        "for m in ('jax', 'flax', 'lgu_slam_tpu', 'lgu_native'):\n"
        "    sys.modules[m] = None\n"
        "import lgu_slam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'lgu_slam_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "for path in sorted(glob.glob('scripts/*_torch*.py')):\n"
        "    spec = importlib.util.spec_from_file_location('s', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    mods.append(path)\n"
        "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 47
    assert {"lgu_slam_tpu_torch.slam.backend",
            "lgu_slam_tpu_torch.slam.trajectory_filler",
            "lgu_slam_tpu_torch.ops.window_lookup",
            "lgu_slam_tpu_torch.ops.row_gather",
            "lgu_slam_tpu_torch.ops.k2_parts",
            "lgu_slam_tpu_torch.geom.ba",
            "lgu_slam_tpu_torch.geom.chol",
            "lgu_slam_tpu_torch.geom.losses",
            "lgu_slam_tpu_torch.models.clipping",
            "lgu_slam_tpu_torch.data.synthetic",
            "lgu_slam_tpu_torch.parallel.train_dp",
            "lgu_slam_tpu_torch.utils.checkpoint",
            "scripts/train_synthetic_torch.py",
            "scripts/profile_torch_k2_parts.py",
            "scripts/profile_torch_k1_parts.py",
            "scripts/ab_k1_torch.py", "scripts/ab_k2_torch.py"} <= mods


def test_entry_points_need_cuda_without_device(monkeypatch):
    cfg = SLAMConfig(**tiny_config_kwargs())
    sd = init_state_dict(cfg, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LGUSlam(sd, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LGUNet.from_config(cfg)
    LGUSlam(sd, cfg, device="cpu")  # an explicit device is taken as given
