"""The port's host planner in C (lgu_slam_tpu_torch/utils/native.py,
csrc/host/proximity_plan.c) against its Python version, the JAX package's
native extension (the root ``lgu_native`` module) and the JAX test's
transcription of the reference planner: the same edges in the same order
on seeded candidate grids, mono and stereo, with the ``max_factors`` cap
hit and not hit; the DBA row grouping likewise; and on a tracked
``FactorGraph``, ``add_proximity_factors`` plans the same edges with either
planner."""

import numpy as np
import pytest
from test_native import python_proximity_plan
from test_slam_e2e import synthetic_stream
from torch_port import tiny_config_kwargs, torch_single_thread  # noqa: F401

from lgu_slam_tpu.utils import native as jnative
from lgu_slam_tpu_torch.models.net import init_state_dict
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.utils import native
from lgu_slam_tpu_torch.utils.config import SLAMConfig


def _grid(seed, t, t0, t1, n_existing):
    """Candidates of [t0, t) x [t1, t) with distances uniform in [0, 30)
    (a tenth of them above 100 or tied), and random existing edges."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(t0, t), np.arange(t1, t), indexing="ij")
    ii, jj = ii.reshape(-1).astype(np.int32), jj.reshape(-1).astype(np.int32)
    d = (rng.random(len(ii)) * 30).astype(np.float32)
    d[rng.random(len(d)) < 0.05] = 150.0
    d[rng.random(len(d)) < 0.05] = 7.5  # ties rank in index order
    e = rng.integers(0, t, (n_existing, 2)).astype(np.int32)
    return d, ii, jj, e[:, 0], e[:, 1]


CASES = [(24, 3, 0, 3, 48), (24, 3, 0, 3, 100_000), (64, 0, 0, 40, 200),
         (64, 10, 5, 12, 100_000)]


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("seed", [0, 1])
def test_planner_matches_python_and_jax_native(seed, case, stereo):
    """t = 24 (tests/test_native.py's grid) and 64, caps of 48 and 200
    edges (hit) and 100000 (not hit); rad 2, nms 2 and 3, threshold 16."""
    t, t0, t1, n_existing, max_factors = CASES[case]
    d, ii, jj, eii, ejj = _grid(seed, t, t0, t1, n_existing)
    assert jnative.HAVE_NATIVE
    for rad, nms in ((2, 2), (1, 3)):
        args = (d, ii, jj, eii, ejj, t0, t1, t, rad, nms, 16.0,
                max_factors, stereo)
        got = native.proximity_plan(*args)
        assert got.dtype == np.int64 and got.shape[1] == 2
        plain = native.proximity_plan_plain(*args)
        ref = np.asarray(jnative.proximity_plan(*args), np.int64)
        ref_py = python_proximity_plan(
            d, ii, jj, list(zip(eii.tolist(), ejj.tolist())), t0, t1, t,
            rad, nms, 16.0, max_factors, stereo)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, np.asarray(ref_py, np.int64))
        if max_factors < 1000:
            assert len(got) > max_factors  # the cap stopped the selection


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dba_group_rows_matches_jax_native(seed):
    """Random source frames (some outside [0, num_frames)): the same rows
    as the JAX package's extension; a frame of too many edges raises."""
    rng = np.random.default_rng(seed)
    ii = rng.integers(-2, 14, 40).astype(np.int32)
    got = native.dba_group_rows(ii, 12, 12)
    np.testing.assert_array_equal(got, native.dba_group_rows_plain(ii, 12,
                                                                   12))
    np.testing.assert_array_equal(got, jnative.dba_group_rows(ii, 12, 12))
    for fn in (native.dba_group_rows, native.dba_group_rows_plain):
        with pytest.raises(ValueError, match="exceeds dmax"):
            fn(np.zeros(5, np.int32), 3, 4)
    ii = np.asarray([0, 0, 1, 3, 3, 3], np.int32)  # tests/test_native.py
    np.testing.assert_array_equal(native.dba_group_rows(ii, 5, 8),
                                  jnative.dba_group_rows(ii, 5, 8))


def test_add_proximity_factors_either_planner(monkeypatch):
    """14 frames of tests/test_slam_e2e.py's stream tracked by the port
    (tiny fp32 configuration, CPU): from the frontend's graph, the
    backend's full-grid plan (t0 = t1 = 0, rad 2, nms 3, threshold 22) and
    the frontend's window plan are the same edge lists with the C planner
    and the Python one, and the C planner's edges join the graph."""
    cfg = SLAMConfig(**tiny_config_kwargs())
    slam = LGUSlam(init_state_dict(cfg, seed=0), cfg, device="cpu")
    for k, img, intr in synthetic_stream():
        slam.track(float(k), img, intrinsics=intr)
    g = slam.frontend.graph
    t = g.video.counter
    c_planner = native.proximity_plan
    assert t >= 10 and g.n_edges > 0
    g.ii_bad, g.jj_bad = np.asarray([t - 1]), np.asarray([t - 5])
    planned = []
    add = g.add_factors
    monkeypatch.setattr(g, "add_factors", lambda ii, jj, remove=False:
                        planned.append((ii.tolist(), jj.tolist())))
    for kw in (dict(t0=0, t1=0, rad=2, nms=3, thresh=22.0, beta=0.25),
               dict(t0=t - 4, t1=max(t - 8, 0), rad=1, nms=1, thresh=16.0,
                    beta=0.3)):
        for planner in (native.proximity_plan_plain, c_planner):
            monkeypatch.setattr(native, "proximity_plan", planner)
            g.add_proximity_factors(**kw)
        assert planned[-1] == planned[-2] and len(planned[-1][0]) > 0
    monkeypatch.setattr(g, "add_factors", add)
    before = set(zip(g.ii.tolist(), g.jj.tolist()))
    g.add_proximity_factors(t - 4, max(t - 8, 0), rad=1, nms=1, thresh=16.0,
                            beta=0.3)
    after = set(zip(g.ii.tolist(), g.jj.tolist()))
    assert after - before <= set(zip(*planned[-1]))
