"""The port's reconstruction export (lgu_slam_tpu_torch/geom/depth_filter.py,
slam/visualization.py) against the JAX package's on the CPU, plus the JAX
package's tests/test_visualization.py run against the port.

The parity scene is geometrically consistent: a tilted plane seen from six
cameras a few centimetres apart, its inverse depth rendered exactly into
each keyframe (1/8 resolution) with a little noise, so that the
multi-view filter finds agreement in some neighbours and not in others.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch
from torch_port import (  # noqa: F401
    read_ply_points,
    torch_single_thread,
    video_from_jax,
)

from lgu_slam_tpu import lie as jlie
from lgu_slam_tpu.geom.depth_filter import depth_filter as jdepth_filter
from lgu_slam_tpu.slam import visualization as jvis
from lgu_slam_tpu.slam.state import Video as JVideo
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.geom.depth_filter import depth_filter
from lgu_slam_tpu_torch.slam.visualization import (
    IncrementalReconstruction,
    backproject_points,
    export_reconstruction,
    write_ply,
)
from lgu_slam_tpu_torch.utils.config import SLAMConfig

from tests.test_lowmem import stage_video

N, H, W = 6, 64, 96


def quat_to_mat(q):
    x, y, z, w = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def plane_scene(seed=0, noise=0.004):
    """(poses [N,7] w2c, disps [N,h,w], intrinsics [4] at 1/8, images
    [N,H,W,3] uint8) of the plane z = 2 + 0.3 x seen by N cameras."""
    rng = np.random.default_rng(seed)
    h, w = H // 8, W // 8
    intr = np.float32([w * 0.9, w * 0.9, w / 2, h / 2])
    xi = np.cumsum(rng.normal(size=(N, 6)) * [0.02, 0.02, 0.02, 0.01,
                                               0.01, 0.01], 0)
    poses = np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rays = np.stack([(xs - intr[2]) / intr[0], (ys - intr[3]) / intr[1],
                     np.ones((h, w))], -1)
    disps = np.zeros((N, h, w), np.float32)
    for i, g in enumerate(poses.astype(np.float64)):
        R = quat_to_mat(g[3:7]).T  # camera-to-world rotation
        o = -R @ g[:3]
        d = rays @ R.T
        # o + lam d on the plane z - 0.3 x = 2
        lam = (2.0 - o[2] + 0.3 * o[0]) / (d[..., 2] - 0.3 * d[..., 0])
        disps[i] = 1.0 / lam
    disps *= 1 + noise * rng.normal(size=disps.shape)
    images = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    return poses, disps.astype(np.float32), intr, images


def test_depth_filter_matches_jax():
    """The multi-view counts, every frame against its six neighbours,
    equal the JAX package's; some pixels agree in all neighbours that
    exist and some in none."""
    poses, disps, intr, _ = plane_scene()
    inds = np.arange(N)
    thresh = 0.005 * disps.mean(axis=(1, 2))
    ref = np.asarray(jdepth_filter(jnp.asarray(poses), jnp.asarray(disps),
                                   jnp.asarray(intr), jnp.asarray(inds),
                                   jnp.asarray(thresh)))
    got = depth_filter(torch.from_numpy(poses), torch.from_numpy(disps),
                       torch.from_numpy(intr), torch.from_numpy(inds),
                       torch.from_numpy(thresh))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.min() == 0 and ref.max() >= 3


def test_backproject_points_matches_jax():
    """Filtered world points: the same pixels kept, the points within
    1e-5 (float32 rounding of a few metres), the colours equal."""
    poses, disps, intr, images = plane_scene()
    ref_pts, ref_cols = jvis.backproject_points(poses, disps, intr,
                                                images=images)
    pts, cols = backproject_points(poses, disps, intr, images=images,
                                   device="cpu")
    assert 0 < len(pts) == len(ref_pts) < disps.size
    np.testing.assert_allclose(pts, np.asarray(ref_pts), atol=1e-5)
    np.testing.assert_array_equal(cols, ref_cols)


def scene_videos():
    """The parity scene in a JAX package Video and the port's (CPU)."""
    kw = dict(image_size=(H, W), buffer=16)
    jv = JVideo(JConfig(**kw))
    poses, disps, intr, images = plane_scene()
    jv.state = jv.state._replace(
        poses=jv.state.poses.at[:N].set(poses),
        disps=jv.state.disps.at[:N].set(disps),
        intrinsics=jv.state.intrinsics.at[:N].set(intr),
        images=jv.state.images.at[:N].set(images))
    jv.counter = N
    return jv, video_from_jax(jv, SLAMConfig(**kw))


def test_incremental_export_matches_jax(tmp_path):
    """IncrementalReconstruction over the same video in both packages,
    its dirty frames consumed in two rounds: the exported points within
    1e-5, their colours and count equal, the camera frusta within 1e-6."""
    jv, tv = scene_videos()
    jinc = jvis.IncrementalReconstruction(jv)
    tinc = IncrementalReconstruction(tv)
    for rounds in (slice(0, 4), slice(4, N)):
        jv.dirty[rounds] = True
        tv.dirty[rounds] = True
        assert tinc.update() == jinc.update() == rounds.stop - rounds.start
    assert sorted(tinc.points) == sorted(jinc.points) == list(range(N))
    for name, fn in (("pts", "export_ply"), ("cams", "export_frusta")):
        n_t = getattr(tinc, fn)(str(tmp_path / f"t_{name}.ply"))
        n_j = getattr(jinc, fn)(str(tmp_path / f"j_{name}.ply"))
        assert n_t == n_j > 0
    got, got_c = read_ply_points(tmp_path / "t_pts.ply")
    ref, ref_c = read_ply_points(tmp_path / "j_pts.ply")
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_array_equal(got_c, ref_c)
    cams_t = open(tmp_path / "t_cams.ply", "rb").read()
    cams_j = open(tmp_path / "j_cams.ply", "rb").read()
    head_t, body_t = cams_t.split(b"end_header\n", 1)
    head_j, body_j = cams_j.split(b"end_header\n", 1)
    assert head_t == head_j
    nv = 5 * N
    np.testing.assert_allclose(
        np.frombuffer(body_t, "<f4", 3 * nv),
        np.frombuffer(body_j, "<f4", 3 * nv), atol=1e-6)
    assert body_t[12 * nv:] == body_j[12 * nv:]  # the edges


def test_export_reconstruction_matches_jax(tmp_path):
    """The one-shot export of a whole video: the same point count, points
    within 1e-5, colours equal."""
    jv, tv = scene_videos()
    n_j = jvis.export_reconstruction(jv.state, jv.counter,
                                     str(tmp_path / "j.ply"))
    n_t = export_reconstruction(tv, str(tmp_path / "t.ply"))
    assert n_t == n_j > 0
    got, got_c = read_ply_points(tmp_path / "t.ply")
    ref, ref_c = read_ply_points(tmp_path / "j.ply")
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_array_equal(got_c, ref_c)


def test_write_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3), dtype=np.uint8)
    for c in (None, cols):
        write_ply(str(tmp_path / "t.ply"), pts, c)
        jvis.write_ply(str(tmp_path / "j.ply"), pts, c)
        assert open(tmp_path / "t.ply", "rb").read() == \
            open(tmp_path / "j.ply", "rb").read()


# -- the JAX package's tests/test_visualization.py, against the port ----------

def test_incremental_export_consumes_dirty(tmp_path, rng):
    kw = dict(image_size=(64, 96), buffer=16)
    video = video_from_jax(stage_video(JConfig(**kw), T=6, seed=1),
                           SLAMConfig(**kw))
    T = video.counter
    # plausible scene depth so the filter keeps points
    video.disps[:T] = 0.5

    inc = IncrementalReconstruction(video, filter_thresh=10.0,
                                    filter_count=1)
    video.dirty[:4] = True
    n = inc.update()
    assert n == 4
    assert not video.dirty[:T].any()  # flags consumed
    assert set(inc.points) == {0, 1, 2, 3}

    # no dirty frames -> no work
    assert inc.update() == 0

    # frames 4,5 become dirty later; caches grow, 0-3 untouched
    before = {k: v[0].shape for k, v in inc.points.items()}
    video.dirty[4:6] = True
    assert inc.update() == 2
    assert set(inc.points) == set(range(6))
    for k, shp in before.items():
        assert inc.points[k][0].shape == shp

    ply = tmp_path / "pts.ply"
    fru = tmp_path / "cams.ply"
    npts = inc.export_ply(str(ply))
    ncams = inc.export_frusta(str(fru))
    assert ncams == 6
    assert os.path.getsize(str(fru)) > 100
    header = open(ply, "rb").read(200).decode(errors="ignore")
    assert f"element vertex {npts}" in header
