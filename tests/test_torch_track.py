"""Port parity of the tracking path: FactorGraph.update_n and update on a
staged video with forced edges, the proximity planner, keyframe removal, and
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
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_slam_e2e import synthetic_stream
from torch_port import (  # noqa: F401
    close, t, tiny_config_kwargs, torch_single_thread, video_from_jax)

import lgu_slam_tpu.slam.factor_graph as jfg
from lgu_slam_tpu import lie as jl
from lgu_slam_tpu.geom.projective import projective_transform as jproj
from lgu_slam_tpu.models.net import LGUNet as JNet
from lgu_slam_tpu.slam.state import Video as JVideo
from lgu_slam_tpu.slam.system import LGUSlam as JSlam
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.geom.projective import (
    coords_grid, projective_transform)
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


def test_update_matches_jax(weights):
    """``FactorGraph.update``, one GRU + DBA update (``update_n(1, ...)``),
    from the same state as the JAX method: the forced edges of the bursts
    above, then the default window and a given one with inactive edges
    stored; update_n's tolerance."""
    jg, tg = graphs(weights, dict(tiny_config_kwargs(), buffer=16,
                                  inactive_bucket=8))
    ii = np.array([1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 1, 3, 0])
    jj = np.array([0, 1, 3, 2, 4, 3, 5, 4, 6, 5, 7, 6, 2, 1, 2])
    drop = np.zeros(len(ii), bool)
    drop[[0, 5, 12]] = True
    for g in (jg, tg):
        g.add_factors(ii, jj)
        g.update()
    same_state(jg, tg, 2e-3, "update()")
    for g in (jg, tg):
        g.rm_factors(drop, store=True)
        g.update(t0=2, t1=8, itrs=3, use_inactive=True)
    same_state(jg, tg, 2e-3, "update(t0=2, t1=8, itrs=3, use_inactive)")


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


def bridged_net(params, cfg):
    net = LGUNet.from_config(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return net.eval()


def graph_from_jax(jg, net, cfg):
    """A port frontend graph on a port Video holding the JAX package's
    graph ``jg`` as it stands: video buffers, active and inactive edges,
    ages, GRU hidden states, stored targets and weights."""
    tg = FactorGraph(net, video_from_jax(jg.video, cfg), cfg,
                     max_factors=jg.max_factors)
    for name in ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad",
                 "jj_bad"):
        setattr(tg, name, np.asarray(getattr(jg, name), np.int64).copy())
    n, ni = jg.n_edges, len(jg.ii_inac)
    tg.target, tg.weight = t(jg.target[:n]), t(jg.weight[:n])
    tg.hidden = t(jg.net[:n])
    tg.target_inac, tg.weight_inac = t(jg.target_inac[:ni]), \
        t(jg.weight_inac[:ni])
    return tg


def seeded_pairs(jg):
    """Edges between a keyframe whose pose is still its seed (equal to its
    predecessor's, as the frontend leaves a new keyframe) and that
    predecessor.  Warm-up keyframes at the identity are left out: there the
    relative pose is exact, and so are the coordinates."""
    poses = np.asarray(jg.video.state.poses)
    identity = np.asarray([0, 0, 0, 0, 0, 0, 1], poses.dtype)
    seeded = {f for f in range(1, jg.video.counter)
              if np.array_equal(poses[f], poses[f - 1])
              and not np.array_equal(poses[f], identity)}
    return np.asarray([max(i, j) in seeded and abs(i - j) == 1
                       for i, j in zip(jg.ii.tolist(), jg.jj.tolist())])


def test_track_matches_jax(jax_init):
    """14 frames of tests/test_slam_e2e.py's stream with the JAX package's
    own init, each package running free: warm-up, initialise, 9 keyframe
    updates.  Same keyframes, edge lists and inactive lists; finite poses.
    The poses are held to the JAX package update by update in
    ``test_track_updates_match_jax_stepwise``: free-running random-weight
    tracking is chaotic here, and weights changed in their last digit move
    the port from itself by more than 1e-2
    (``test_tracking_self_perturbation``)."""
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
    assert tg.jj_inac.tolist() == jg.jj_inac.tolist()
    assert bool(torch.isfinite(ts.video.poses[:n]).all())
    assert bool(torch.isfinite(ts.video.disps[:n]).all())


def test_track_updates_match_jax_stepwise(jax_init):
    """Every GRU + DBA iteration of the JAX package's tracking of the stream
    (43, over 20 ``update_n`` calls) starts the port from the JAX state just
    before it, and both are held to test_update_n_matches_jax's tolerance:
    poses, disparities, damping and every edge's hidden state and weight
    within 2e-3, targets within 2e-2.

    One pair of edges per keyframe update is held otherwise: in the first
    iteration after a keyframe is added, its pose is its predecessor's, so
    the edges between the two map every pixel onto the integer grid, where
    the lookup's boundary rule jumps (a tap whose floor corner leaves the
    plane reads 0; ``test_seeded_pair_taps_sit_on_the_boundary_rule``).
    The JAX package's fused update program rounds those coordinates a few
    ulp differently from its own eager ops (depending on the host), which
    flips such taps.  On each such edge the test shows that this is all:
    the port's coordinates equal the JAX package's eager
    ``projective_transform`` bit for bit (on the grid or within 1e-6 of
    it), and the JAX package's own lookup and update operator, run on its
    pyramid and its state before the iteration at those coordinates, give
    the port's hidden state, target and weight to the tolerance above;
    the JAX package's fused run moves those hidden states by more.  Every
    other edge agrees to ~1e-5."""
    net_def, params = jax_init
    kw = tiny_config_kwargs()
    cfg = SLAMConfig(**kw)
    net = bridged_net(params, cfg)
    js = JSlam(params, JConfig(**kw), net_def=net_def)
    jg = js.frontend.graph
    run_jax = jg.update_n
    steps, on_boundary, moved = [], [], []

    @partial(jax.jit, static_argnames="F")
    def gru_at(pyr, coords, hidden, inp, target, edge_slot, mask, F):
        # the body of the JAX package's _update_op from given coordinates
        h, w = coords.shape[1:3]
        corr = net_def.apply({"params": params}, pyr, coords,
                             method=JNet.lookup)
        motn = jnp.clip(jnp.concatenate(
            [coords - jfg.coords_grid(h, w), target - coords], axis=-1),
            -64.0, 64.0)
        h2, delta, weight, *_ = net_def.apply(
            {"params": params}, hidden[None], inp[None], corr[None],
            motn[None], edge_slot, F, mask, method=JNet.update_step)
        return h2[0], coords + delta[0], weight[0]

    def stepwise(n, t0=None, t1=None, itrs=2, use_inactive=False, EP=1e-7,
                 motion_only=False):
        for _ in range(n):
            tg = graph_from_jax(jg, net, cfg)
            skip = seeded_pairs(jg)
            on_grid = np.nonzero(skip)[0]
            if len(on_grid):
                tv = tg.video
                coords, _ = projective_transform(
                    tv.poses, tv.disps, tv.intrinsics, torch.from_numpy(
                        tg.ii), torch.from_numpy(tg.jj))
                js = jg.video.state
                eager, _ = jproj(js.poses, js.disps, js.intrinsics,
                                 jnp.asarray(tg.ii[on_grid]),
                                 jnp.asarray(tg.jj[on_grid]))
                np.testing.assert_array_equal(coords[on_grid].numpy(),
                                              np.asarray(eager))
                grid = coords_grid(*coords.shape[1:3])
                close(coords[on_grid], grid.expand_as(coords[on_grid]),
                      atol=1e-6)
                # copies: the update donates these buffers
                before = (np.asarray(jg.net), np.asarray(jg.target))
            run_jax(1, t0, t1, itrs, use_inactive, EP, motion_only)
            tg.update_n(1, t0, t1, itrs, use_inactive, EP, motion_only)
            what = f"iteration {len(steps)}"
            if len(on_grid):
                ii_d, _, mask, _, edge_slot, F = jg._plan[:6]
                c = np.zeros((jg.E,) + coords.shape[1:], np.float32)
                c[:len(coords)] = coords.numpy()
                at_grid = [np.asarray(x)[on_grid] for x in gru_at(
                    jg.pyramid, jnp.asarray(c), jnp.asarray(before[0]),
                    jg.video.state.inps[ii_d].astype(jnp.float32),
                    jnp.asarray(before[1]), edge_slot, mask, F=F)]
                for name, x, ref, atol in zip(
                        ("hidden", "target", "weight"),
                        (tg.hidden, tg.target, tg.weight), at_grid,
                        (2e-3, 2e-2, 2e-3)):
                    close(x[on_grid], ref, atol=atol,
                          msg=f"{what} on the grid: {name}")
                moved.append(float(np.abs(np.asarray(jg.net)[on_grid]
                                          - at_grid[0]).max()))
            assert tg.age.tolist() == jg.age.tolist(), what
            s, v, keep = jg.video.state, tg.video, np.nonzero(~skip)[0]
            close(v.poses, s.poses, atol=2e-3, msg=what + " poses")
            close(v.disps, s.disps, atol=2e-3, rtol=2e-3,
                  msg=what + " disps")
            close(v.damping, s.damping, atol=2e-3, rtol=2e-3,
                  msg=what + " damping")
            close(tg.target[keep], jg.target[keep], atol=2e-2,
                  msg=what + " target")
            close(tg.weight[keep], jg.weight[keep], atol=2e-3,
                  msg=what + " weight")
            close(tg.hidden[keep], jg.net[keep], atol=2e-3,
                  msg=what + " hidden")
            for x in (tg.target, tg.weight, tg.hidden):
                assert bool(torch.isfinite(x).all()), what
            steps.append(what)
            on_boundary.append(int(skip.sum()))

    jg.update_n = stepwise
    for k, img, intr in synthetic_stream():
        js.track(float(k), img, intrinsics=intr)
    assert js.video.counter == 14 and len(steps) == 43
    # the newest keyframe's first iteration, once per keyframe update
    assert sum(on_boundary) == 18 and max(on_boundary) == 2
    # and there the JAX package's own coordinates did flip taps
    assert len(moved) == 9 and max(moved) > 2e-3


def test_tracking_self_perturbation(jax_init):
    """The measurement behind the stepwise test: the port tracks the stream
    twice, once with every weight multiplied by 1 +- 2^-23 (its last
    digit).  Both keep the same keyframes and edges and stay finite, and
    the perturbation moves the poses.  How far is the host's: whether a
    last-digit change flips a tap on the lookup's boundary rule depends on
    the host's rounding (measured: 0.003 on one CPU host, 0.053 on
    another, against the 1e-2 that the free-running comparison with the
    JAX package used to hold), so the size of the gap is not asserted and
    a free-running pose bound is no parity check.  The mechanism, a tap
    one ulp below the grid leaving the plane, is pinned by construction in
    test_seeded_pair_taps_sit_on_the_boundary_rule."""
    net_def, params = jax_init
    cfg = SLAMConfig(**tiny_config_kwargs())
    sd = state_dict_from_jax_params(params)
    gen = torch.Generator().manual_seed(1)

    def last_digit(v):
        if not v.is_floating_point():
            return v
        sign = torch.randint(0, 2, v.shape, generator=gen) * 2 - 1
        return v * (1 + 2.0 ** -23 * sign)

    runs = [LGUSlam(sd, cfg, device="cpu"),
            LGUSlam({k: last_digit(v) for k, v in sd.items()}, cfg,
                    device="cpu")]
    gap = 0.0
    for k, img, intr in synthetic_stream():
        for slam in runs:
            slam.track(float(k), img, intrinsics=intr)
        n = runs[0].video.counter
        gap = max(gap, float((runs[0].video.poses[:n]
                              - runs[1].video.poses[:n]).abs().max()))
    a, b = (slam.frontend.graph for slam in runs)
    assert runs[1].video.counter == runs[0].video.counter == 14
    assert a.ii.tolist() == b.ii.tolist() and a.jj.tolist() == b.jj.tolist()
    for slam in runs:
        assert bool(torch.isfinite(slam.video.poses[:14]).all())
    assert gap > 0.0


def test_seeded_pair_taps_sit_on_the_boundary_rule(jax_init):
    """A keyframe seeded with its predecessor's pose: the edges between the
    two map every pixel onto the integer grid in both packages alike, and
    the lookups there agree; coordinates one ulp below the grid flip the
    taps at the planes' low edges to 0 (the floor corner leaves the plane),
    in both packages alike, moving the lookup by O(1).  The JAX package's
    own init, as the stream tests use it: its offset heads are zero, so
    every tap lies on the grid."""
    net_def, params = jax_init
    weights = net_def, params, state_dict_from_jax_params(params)
    jg, tg = graphs(weights, dict(tiny_config_kwargs(), buffer=16), T=4,
                    seed=3)
    jv, tv = jg.video, tg.video
    jv.state = jv.state._replace(poses=jv.state.poses.at[3].set(
        jv.state.poses[2]))
    tv.poses[3] = tv.poses[2]
    for g in (jg, tg):
        g.add_factors(np.array([3, 2]), np.array([2, 3]))
    jc, _ = jproj(jv.state.poses, jv.state.disps, jv.state.intrinsics,
                  jnp.asarray([3, 2]), jnp.asarray([2, 3]))
    tc, _ = projective_transform(tv.poses, tv.disps, tv.intrinsics,
                                 torch.tensor([3, 2]), torch.tensor([2, 3]))
    grid = coords_grid(*tc.shape[1:3])
    close(tc, grid.expand_as(tc), atol=1e-5)
    close(tc, jc, atol=1e-5)
    jg._ensure_pyramid()
    tg._build_pyramid()
    lookup = jax.jit(lambda p, c: net_def.apply(
        {"params": params}, p, c, method=JNet.lookup))
    jpyr = jax.tree_util.tree_map(lambda a: a[:2], jg.pyramid)
    grid2 = np.broadcast_to(grid.numpy(), tc.shape).copy()
    # one ulp below the grid; below 0 the smallest normal step, as XLA on
    # the CPU flushes denormals to zero
    below = np.where(grid2 == 0, np.float32(-2.0 ** -24),
                     np.nextafter(grid2, np.float32(-1.0)))
    on = [np.asarray(lookup(jpyr, jnp.asarray(c))) for c in (grid2, below)]
    ton = [tg.net.lookup(tg.pyramid, torch.from_numpy(c)) for c in
           (grid2, below)]
    for j, p in zip(on, ton):
        close(p, j, atol=1e-4)
    assert np.abs(on[0] - on[1]).max() > 1.0


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py, the oracle it loads
    (tests/torch_oracle.py) and the port's scripts (scripts/*_torch*.py)
    import with JAX, flax, the JAX package, its native extension and the
    image libraries the card machine lacks (OpenCV, PIL, imageio,
    torchvision) made unimportable."""
    code = (
        "import sys, glob, importlib, importlib.util, pkgutil\n"
        "for m in ('jax', 'flax', 'lgu_slam_tpu', 'lgu_native', 'cv2', "
        "'PIL', 'imageio', 'torchvision'):\n"
        "    sys.modules[m] = None\n"
        "import lgu_slam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'lgu_slam_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.load_oracle()\n"
        "mods.append('tests/torch_oracle.py')\n"
        "for path in sorted(glob.glob('scripts/*_torch*.py')):\n"
        "    spec = importlib.util.spec_from_file_location('s', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    mods.append(path)\n"
        "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 83
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
            "lgu_slam_tpu_torch.parallel.dba_shard",
            "lgu_slam_tpu_torch.parallel.backend_shard",
            "lgu_slam_tpu_torch.lie.sim3",
            "lgu_slam_tpu_torch.eval.ate",
            "lgu_slam_tpu_torch.utils.checkpoint",
            "scripts/train_synthetic_torch.py",
            "scripts/profile_torch_k2_parts.py",
            "scripts/profile_torch_k1_parts.py",
            "scripts/ab_k1_torch.py", "scripts/ab_k2_torch.py",
            "lgu_slam_tpu_torch.data.image_io",
            "lgu_slam_tpu_torch.data.tiff",
            "lgu_slam_tpu_torch.data.pnm",
            "lgu_slam_tpu_torch.data.imgproc",
            "lgu_slam_tpu_torch.data.streams",
            "lgu_slam_tpu_torch.data.rgbd_datasets",
            "lgu_slam_tpu_torch.data.replica",
            "lgu_slam_tpu_torch.data.base",
            "lgu_slam_tpu_torch.data.augmentation",
            "lgu_slam_tpu_torch.data.tartan",
            "lgu_slam_tpu_torch.data.fixtures",
            "lgu_slam_tpu_torch.geom.graph_utils",
            "lgu_slam_tpu_torch.utils.logger",
            "lgu_slam_tpu_torch.utils.profiling",
            "lgu_slam_tpu_torch.utils.native",
            "lgu_slam_tpu_torch.slam.live_viewer",
            "scripts/view_reconstruction_torch.py",
            "scripts/demo_torch.py", "scripts/synthetic_demo_torch.py",
            "scripts/evaluate_tum_torch.py",
            "scripts/evaluate_euroc_torch.py",
            "scripts/evaluate_eth3d_torch.py",
            "scripts/validate_tartanair_torch.py",
            "scripts/export_poses_torch.py",
            "scripts/train_torch.py", "tests/torch_oracle.py"} <= mods


def test_entry_points_need_cuda_without_device(monkeypatch):
    cfg = SLAMConfig(**tiny_config_kwargs())
    sd = init_state_dict(cfg, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LGUSlam(sd, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LGUNet.from_config(cfg)
    LGUSlam(sd, cfg, device="cpu")  # an explicit device is taken as given
