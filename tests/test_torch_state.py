"""The port's last frame-graph helpers against the JAX package's on one
staged state (tests/test_torch_track.py's staged keyframes):
``Video.reproject`` (pixel coordinates within 1e-4 px, validity equal),
``Video.distance_matrix`` (within 1e-4 relative, as the frame graphs of
tests/test_torch_datasets.py), and ``FactorGraph.filter_edges`` (the same
edges dropped and remembered as bad, the same stored targets kept), which
the proximity planner then suppresses around."""

import numpy as np
import pytest
from test_torch_track import staged_videos
from torch_port import (  # noqa: F401
    close, tiny_config_kwargs, torch_single_thread)

import lgu_slam_tpu.slam.factor_graph as jfg
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.models.net import LGUNet
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.utils.config import SLAMConfig

KW = dict(tiny_config_kwargs(), buffer=16)
T = 10


@pytest.fixture(scope="module")
def staged():
    """Both packages' videos of 10 staged keyframes, and a frame graph on
    each holding the same 30 edges."""
    jv, tv = staged_videos(KW, T, seed=3)
    jc, tc = JConfig(**KW), SLAMConfig(**KW)
    net_def, params = init_params(jc, seed=0)
    jg = jfg.FactorGraph(net_def, params, jv, jc, corr_impl="volume",
                         max_factors=jc.max_factors)
    tg = FactorGraph(LGUNet.from_config(tc, device="cpu").eval(), tv, tc,
                     max_factors=tc.max_factors)
    rng = np.random.default_rng(4)
    pairs = {(int(i), int(j)) for i, j in rng.integers(0, T, (60, 2))
             if i != j}
    ii, jj = (np.asarray(a, np.int32) for a in zip(*sorted(pairs)[:30]))
    for g in (jg, tg):
        g.add_factors(ii, jj)
    assert tg.ii.tolist() == jg.ii.tolist() and tg.n_edges == 30
    return jv, tv, jg, tg


def test_reproject_matches_jax(staged):
    jv, tv, _, _ = staged
    ii = np.asarray([0, 3, 9, 4, 4], np.int32)
    jj = np.asarray([1, 2, 0, 4, 8], np.int32)  # (4, 4): the stereo rule
    coords, valid = tv.reproject(ii, jj)
    ref_coords, ref_valid = jv.reproject(ii, jj)
    assert coords.shape == (5, *tv.disps.shape[1:], 2)
    close(coords, ref_coords, atol=1e-4, rtol=1e-5)
    close(valid, ref_valid, atol=0)


def test_distance_matrix_matches_jax(staged):
    jv, tv, _, _ = staged
    for beta in (0.3, 0.7):
        got = tv.distance_matrix(beta=beta)
        want = jv.distance_matrix(beta=beta)
        assert got.shape == want.shape == (T, T)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        assert (np.diag(got) < 1e-3).all()


def test_filter_edges_matches_jax(staged):
    """Weights set so that some edges of each kind (short and long range,
    above and below the 1e-3 mean confidence) exist; then the planner's
    suppression reads the bad edges in both packages alike."""
    _, _, jg, tg = staged
    n, (h, w) = tg.n_edges, tg.video.disps.shape[1:]
    rng = np.random.default_rng(6)
    scale = np.where(rng.random(n) < 0.5, 1e-4, 0.5).astype(np.float32)
    weight = (rng.random((n, h, w, 2)) * scale[:, None, None, None] * 2
              ).astype(np.float32)
    jg.weight = jg.weight.at[:n].set(weight)
    tg.weight = tg.weight.new_tensor(weight)
    far = np.abs(tg.ii - tg.jj) > 2
    assert (far & (scale < 1e-3)).any() and (~far & (scale < 1e-3)).any()
    for g in (jg, tg):
        g.filter_edges()
    assert tg.ii.tolist() == jg.ii.tolist()
    assert tg.jj.tolist() == jg.jj.tolist()
    assert tg.ii_bad.tolist() == jg.ii_bad.tolist()
    assert tg.jj_bad.tolist() == jg.jj_bad.tolist()
    assert len(tg.ii_bad) == (far & (scale < 1e-3)).sum() > 0
    close(tg.target, jg.target[:tg.n_edges], atol=1e-3)
    close(tg.weight, jg.weight[:tg.n_edges], atol=0)
    for g in (jg, tg):
        g.add_proximity_factors(0, 0, rad=1, nms=2, thresh=100.0, beta=0.3)
    assert tg.ii.tolist() == jg.ii.tolist()
    assert tg.jj.tolist() == jg.jj.tolist()
