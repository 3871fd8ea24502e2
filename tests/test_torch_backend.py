"""Port parity of the backend path (the global pass of ``terminate()``)
against the JAX package, on the CPU with seeded numpy inputs:
``Video.normalize``, the pooled feature pyramid, both strategies of the
low-memory correlation, ``FactorGraph.update_lowmem`` on the staged graph
of tests/test_lowmem.py, and ``Backend`` with its edge-cap warning.

The weights are the JAX package's init with N(0, 0.02) noise on every leaf
(tests/test_torch_track.py), so the offset heads act.  The JAX package's
``LGUSlam`` shards its backend when the process has several devices (this
one has 8 virtual CPU devices); the port's backend runs on one device and
is held against the JAX backend with no mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_lowmem import build_graph as j_lowmem_graph
from test_lowmem import make_cfg as j_lowmem_cfg
from test_lowmem import stage_video as j_stage_video
from test_torch_track import jax_init, weights  # noqa: F401
from torch_port import (  # noqa: F401
    close, t, torch_single_thread, video_from_jax)

from lgu_slam_tpu.models import corr as jcorr
from lgu_slam_tpu.models.net import LGUNet as JNet
from lgu_slam_tpu.slam.backend import Backend as JBackend
from lgu_slam_tpu.slam.state import video_normalize
from lgu_slam_tpu_torch.models import corr as tcorr
from lgu_slam_tpu_torch.models.net import LGUNet
from lgu_slam_tpu_torch.slam.backend import Backend
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.utils.config import SLAMConfig

# tests/test_lowmem.py's configuration: 8 keyframes, 26 edges in chunks
# of 8, fp32 compute and hidden state, bf16 stored features
LOWMEM_KW = dict(
    image_size=(64, 96), buffer=16, warmup=4, max_factors=24,
    edge_bucket=32, inactive_bucket=8, pose_bucket=8, backend_edge_cap=32,
    backend_chunk=8, compute_dtype="float32",
    backend_hidden_dtype="float32")


def port_net(sd, kw):
    net = LGUNet.from_config(SLAMConfig(**kw), device="cpu")
    net.load_state_dict(sd, strict=True)
    return net.eval()


def same_video(jv, tv, atol, what):
    T = jv.counter
    s = jv.state
    close(tv.poses[:T], s.poses[:T], atol=atol, msg=what + " poses")
    close(tv.disps[:T], s.disps[:T], atol=atol, rtol=atol,
          msg=what + " disps")
    close(tv.damping[:T], s.damping[:T], atol=atol, rtol=atol,
          msg=what + " damping")


def test_video_normalize():
    """Mean disparity of the first ``counter`` keyframes to 1, their
    translations scaled to match; the other slots untouched."""
    jv = j_stage_video(j_lowmem_cfg(), seed=3)
    tv = video_from_jax(jv, SLAMConfig(**LOWMEM_KW))
    tv.disps[:4] *= 3.0  # a mean away from 1
    jv = video_normalize(jv.state._replace(
        disps=jv.state.disps.at[:4].multiply(3.0)), jnp.int32(8))
    tv.normalize()
    close(tv.poses, jv.poses, atol=1e-6)
    close(tv.disps, jv.disps, atol=1e-6, rtol=1e-6)
    assert abs(float(tv.disps[:8].mean()) - 1.0) < 1e-5
    assert tv.dirty[:8].all() and not tv.dirty[8:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_fmap_pyramid(rng, dtype):
    """2x2 pools of the 1/4-scaled maps in the stored dtype, odd extents
    floored (9 x 13 -> 4 x 6 -> 2 x 3 -> 1 x 1).  bf16: both round each
    level's fp32 mean once, so they agree to one bf16 step."""
    f = rng.normal(size=(3, 9, 13, 128)).astype(np.float32)
    ref = jcorr.build_fmap_pyramid(jnp.asarray(f).astype(dtype))
    out = tcorr.build_fmap_pyramid(t(f).to(getattr(torch, dtype)))
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    for lvl, (a, b) in enumerate(zip(out, ref)):
        assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
        close(a, np.asarray(b.astype(jnp.float32)), atol=tol, rtol=tol,
              msg=f"level {lvl}")


def alt_problem(rng, T, E, H, W):
    fm = rng.normal(size=(T, H, W, 128)).astype(np.float32)
    ii = rng.integers(0, T, size=E)
    jj = (ii + 1 + rng.integers(0, T - 1, size=E)) % T
    coords = (rng.uniform(-0.2, 1.2, size=(E, H, W, 2))
              * np.array([W, H])).astype(np.float32)
    return fm, ii, jj, coords


def j_alt(params, fn, pyr, ii, jj, coords, **kw):
    """A JAX low-memory correlation function with the bound offset
    heads."""
    return JNet().apply(
        {"params": params},
        method=lambda m: fn(pyr, jnp.asarray(ii), jnp.asarray(jj),
                            jnp.asarray(coords), m.ofs_map, m.ofs_residual,
                            **kw))


@pytest.mark.parametrize("hw", [(8, 12), (9, 13)])
def test_alt_corr_fused_taps(weights, rng, hw):
    """The CPU strategy (fused bilinear feature dots per tap) against the
    JAX package's ``alt_corr_lookup(use_volume=False)``, fp32, with
    coordinates up to 20 % outside the plane.  Correlations are O(1);
    2e-4 is fp32 rounding of 128-channel dot products."""
    _, params, sd = weights
    fm, ii, jj, coords = alt_problem(rng, 4, 5, *hw)
    ref = j_alt(params, jcorr.alt_corr_lookup,
                jcorr.build_fmap_pyramid(jnp.asarray(fm)), ii, jj, coords,
                use_volume=False)
    net = port_net(sd, dict(image_size=(64, 96)))
    with torch.no_grad():
        out = tcorr.alt_corr_lookup(
            tcorr.build_fmap_pyramid(t(fm)), torch.as_tensor(ii),
            torch.as_tensor(jj), t(coords), net.ofsMap, net.ofs_residual,
            use_volume=False)
    assert out.shape == (5, *hw, 196)
    close(out, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("E, sub_chunk", [(4, 2), (6, 4)])
def test_alt_corr_volume_strategy(weights, rng, E, sub_chunk):
    """The card's strategy (per sub-chunk of edges one matmul per level
    against the pooled bf16 features, bf16 planes, then K2), run here with
    K2's plain version, against the JAX package's
    ``_alt_corr_lookup_volume(..., interpret=True)`` (the Pallas lookup in
    interpret mode).  A sub-chunk of 4 that does not divide 6 edges is
    halved, as in the JAX package.  Both round the same fp32 products to
    bf16; where the two sums straddle a rounding boundary a plane value
    (up to ~2 here) differs by one bf16 step, 2^-7, hence atol 1e-2."""
    _, params, sd = weights
    fm, ii, jj, coords = alt_problem(rng, 4, E, 8, 12)
    fm_b = jnp.asarray(fm).astype(jnp.bfloat16)
    ref = j_alt(params, jcorr._alt_corr_lookup_volume,
                jcorr.build_fmap_pyramid(fm_b), ii, jj, coords,
                sub_chunk=sub_chunk, interpret=True)
    net = port_net(sd, dict(image_size=(64, 96)))
    pyr = tcorr.build_fmap_pyramid(
        t(np.asarray(fm_b.astype(jnp.float32))).to(torch.bfloat16))
    with torch.no_grad():
        out = tcorr.alt_corr_lookup(
            pyr, torch.as_tensor(ii), torch.as_tensor(jj), t(coords),
            net.ofsMap, net.ofs_residual, use_volume=True,
            sub_chunk=sub_chunk)
    assert out.shape == (E, 8, 12, 196) and out.dtype == torch.float32
    close(out, ref, atol=1e-2)
    assert np.median(np.abs(out.numpy() - np.asarray(ref))) < 1e-6


def lowmem_graphs(weights, seed=7):
    """tests/test_lowmem.py's staged graph in both packages."""
    net_def, params, sd = weights
    jg = j_lowmem_graph(j_lowmem_cfg(), net_def, params, seed=seed)
    tv = video_from_jax(jg.video, SLAMConfig(**LOWMEM_KW))
    tc = SLAMConfig(**LOWMEM_KW)
    tg = FactorGraph(port_net(sd, LOWMEM_KW), tv, tc, corr_impl="alt",
                     max_factors=tc.max_factors,
                     edge_bucket=tc.backend_edge_cap, inactive_bucket=8)
    tg.add_factors(jg.ii, jg.jj)
    return jg, tg


def test_update_lowmem_matches_jax(weights):
    """Two steps of {4 chunks of GRU updates with correlation on the fly,
    one global DBA}.  Frame 0 is a source frame of the first chunk, whose
    frame slots are padded: in both packages it keeps its damping (the JAX
    package's padded-slot scatter, ROADMAP C).  fp32; 8 GRU updates and 2
    Gauss-Newton solves: 2e-4 (targets are in pixels: 2e-3)."""
    jg, tg = lowmem_graphs(weights)
    n = jg.n_edges
    assert tg.n_edges == n == 26 > 3 * tg.cfg.backend_chunk
    jg.update_lowmem(steps=2)
    tg.update_lowmem(steps=2)
    same_video(jg.video, tg.video, 2e-4, "update_lowmem")
    close(tg.target, jg.target[:n], atol=2e-3, msg="target")
    close(tg.weight, jg.weight[:n], atol=2e-4, msg="weight")
    close(tg.hidden, jg.net[:n], atol=2e-4, msg="hidden")
    assert (tg.video.damping[0] == np.float32(1e-6)).all()
    assert not (tg.video.damping[1:8] == np.float32(1e-6)).any()
    assert tg.hidden.dtype == torch.float32


def test_update_lowmem_stores_hidden_in_its_dtype(weights):
    """With the default bf16 ``backend_hidden_dtype`` the per-edge hidden
    state is stored in bf16 and re-cast after every chunk, as in the JAX
    package; one step, one bf16 step of a tanh-bounded state: 1e-2."""
    net_def, params, sd = weights
    kw = dict(LOWMEM_KW, backend_hidden_dtype="bfloat16")
    jg = j_lowmem_graph(j_lowmem_cfg().replace(
        backend_hidden_dtype="bfloat16"), net_def, params, seed=5)
    tv = video_from_jax(jg.video, SLAMConfig(**kw))
    tc = SLAMConfig(**kw)
    tg = FactorGraph(port_net(sd, kw), tv, tc, corr_impl="alt",
                     edge_bucket=tc.backend_edge_cap, inactive_bucket=8)
    tg.add_factors(jg.ii, jg.jj)
    jg.update_lowmem(steps=1)
    tg.update_lowmem(steps=1)
    assert tg.hidden.dtype == torch.bfloat16
    close(tg.hidden, np.asarray(jg.net[:jg.n_edges].astype(jnp.float32)),
          atol=1e-2)
    same_video(jg.video, tv, 2e-4, "bf16 hidden")


def test_update_lowmem_upsamples_per_chunk(weights):
    """With ``cfg.upsample`` every chunk's GRU update writes the convex
    8x upsampled disparity of its source frames (frame 0 excepted while its
    chunk's slots are padded, as for the damping); one step: 2e-4."""
    net_def, params, sd = weights
    kw = dict(LOWMEM_KW, upsample=True)
    jg = j_lowmem_graph(j_lowmem_cfg().replace(upsample=True), net_def,
                        params, seed=9)
    tv = video_from_jax(jg.video, SLAMConfig(**kw))
    tc = SLAMConfig(**kw)
    tg = FactorGraph(port_net(sd, kw), tv, tc, corr_impl="alt",
                     edge_bucket=tc.backend_edge_cap, inactive_bucket=8)
    tg.add_factors(jg.ii, jg.jj)
    jg.update_lowmem(steps=1)
    tg.update_lowmem(steps=1)
    T = jg.video.counter
    assert tv.disps_up.shape == (16, 64, 96)
    close(tv.disps_up[:T], jg.video.state.disps_up[:T], atol=2e-4,
          rtol=2e-4)
    assert (tv.disps_up[0] == 0).all() and (tv.disps_up[1:T] > 0).all()


def test_backend_matches_jax(weights):
    """``Backend(2)`` on the staged video: scale normalisation, proximity
    planning of up to 16 edges per keyframe capped (with a warning) at
    ``backend_edge_cap`` = 32, two low-memory steps, edges cleared.  The
    same warning in both packages; poses and depths as in the update_lowmem
    test."""
    net_def, params, sd = weights
    jv = j_stage_video(j_lowmem_cfg(), seed=11)
    tv = video_from_jax(jv, SLAMConfig(**LOWMEM_KW))
    jb = JBackend(net_def, params, jv, j_lowmem_cfg(), mesh=None)
    tb = Backend(port_net(sd, LOWMEM_KW), tv, SLAMConfig(**LOWMEM_KW))
    msg = "backend edge budget truncated: 16\\*t=128 > backend_edge_cap=32"
    with pytest.warns(UserWarning, match=msg):
        jb(2)
    with pytest.warns(UserWarning, match=msg):
        tb(2)
    same_video(jv, tv, 2e-4, "backend")
    assert tv.dirty[:8].all()
