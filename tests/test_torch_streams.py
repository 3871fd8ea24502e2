"""The port's streams (lgu_slam_tpu_torch/data/streams.py) against the JAX
package's on the same on-disk fixtures: timestamps equal, intrinsics
within 1e-6, images within 0 levels (the port's decoder, resize, remap and
undistort equal OpenCV's here: tests/test_torch_image_io.py,
tests/test_torch_imgproc.py), depth exact."""

import os

import numpy as np
import pytest
from torch_port import torch_single_thread  # noqa: F401

from lgu_slam_tpu.data import streams as jstreams
from lgu_slam_tpu_torch.data import fixtures
from lgu_slam_tpu_torch.data import streams as tstreams
from lgu_slam_tpu_torch.data.image_io import imwrite

IMAGE_TOL = 0  # levels


def _held(port, ref):
    """Two streams' items, element by element."""
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert len(p) == len(r)
        assert p[0] == r[0]  # timestamp
        for a, b in zip(p[1:], r[1:]):
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.uint8:  # images
                assert np.abs(a.astype(int) - b.astype(int)).max() \
                    <= IMAGE_TOL
            elif a.ndim == 1:  # intrinsics
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            else:  # depth
                np.testing.assert_array_equal(a, b)
    return port


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Colour frames and 16-bit depth of a synthetic clip at 60 x 80."""
    root = tmp_path_factory.mktemp("folder")
    images, depths, _, _ = fixtures.render_sequence(
        5, 5, 60, 80, (70.0, 70.0, 40.0, 30.0), t_step=0.05, r_step=0.01)
    for sub in ("rgb", "depth"):
        os.makedirs(root / sub)
    for k in range(len(images)):
        imwrite(str(root / "rgb" / f"{k:03d}.png"), images[k])
        imwrite(str(root / "depth" / f"{k:03d}.png"),
                (depths[k] * 1000).astype(np.uint16))
    (root / "calib.txt").write_text("70.0 70.0 40.0 30.0\n")
    (root / "calib_dist.txt").write_text(
        "70.0 70.0 40.0 30.0 0.2624 -0.9531 -0.0054 0.0026 1.1633\n")
    return root


@pytest.mark.parametrize("calib", ["calib.txt", "calib_dist.txt"])
def test_image_stream_matches_jax(folder, calib):
    """Resized to ~3000 pixels (40 x 56), with and without distortion."""
    args = (str(folder / "rgb"), str(folder / calib))
    kw = dict(stride=2, t0=1, target_pixels=3000)
    items = _held(tstreams.image_stream(*args, **kw),
                  jstreams.image_stream(*args, **kw))
    assert items[0][1].shape == (40, 56, 3)


@pytest.mark.parametrize("source", ["cv2", "port"])
def test_jpeg_image_stream_matches_jax(tmp_path, source):
    """A directory of JPEG frames, written by cv2.imwrite or by the port's
    encoder (fixtures.write_jpeg_imagedir), read as the JAX image_stream
    reads it (cv2.imread): the same frames, resized to ~3000 pixels."""
    imagedir, calib = fixtures.write_jpeg_imagedir(
        str(tmp_path), n_frames=4, H=60, W=80, seed=6)
    if source == "cv2":
        import cv2

        for name in os.listdir(imagedir):
            path = os.path.join(imagedir, name)
            cv2.imwrite(path, cv2.imread(path), [cv2.IMWRITE_JPEG_QUALITY,
                                                 90])
    kw = dict(stride=1, target_pixels=3000)
    items = _held(tstreams.image_stream(imagedir, calib, **kw),
                  jstreams.image_stream(imagedir, calib, **kw))
    assert len(items) == 4 and items[0][1].shape == (40, 56, 3)


def test_rgbd_stream_matches_jax(folder):
    args = (str(folder / "rgb"), str(folder / "depth"),
            str(folder / "calib_dist.txt"))
    kw = dict(stride=1, target_pixels=3000)
    items = _held(tstreams.rgbd_stream(*args, **kw),
                  jstreams.rgbd_stream(*args, **kw))
    assert len(items) == 5 and items[0][2].dtype == np.float32


def test_tum_rgbd_stream_matches_jax(tmp_path):
    """fr1 (undistorted) and fr3 (no distortion) at 480 x 640, cropped and
    halved to 240 x 320, depth associated 10 ms after colour."""
    for name in ("rgbd_dataset_freiburg1_desk", "rgbd_dataset_freiburg3_x"):
        root = fixtures.write_tum_sequence(str(tmp_path / name), n_frames=3)
        for stride in (1, 2):
            items = _held(tstreams.tum_rgbd_stream(root, stride=stride),
                          jstreams.tum_rgbd_stream(root, stride=stride))
            assert items[0][1].shape == (240, 320, 3)
            assert len(items) == (3 if stride == 1 else 2)


def test_euroc_stereo_stream_matches_jax(tmp_path):
    """Gray 752 x 480 pairs, rectified with the factory maps and resized to
    320 x 512; a left frame without its right one is skipped."""
    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=3)
    right = os.path.join(root, "mav0", "cam1", "data")
    os.remove(os.path.join(right, sorted(os.listdir(right))[1]))
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 2 and items[0][1].shape == (2, 320, 512, 3)


def test_euroc_stream_skips_unreadable_left_image(tmp_path):
    """A left file that cv2.imread cannot read (non-image bytes) drops its
    pair, as the JAX stream drops it: 3 of 4 frames, the same ones."""
    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=4)
    left = os.path.join(root, "mav0", "cam0", "data")
    bad = sorted(os.listdir(left))[2]
    with open(os.path.join(left, bad), "wb") as fh:
        fh.write(b"not an image\n" * 8)
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 3
    assert float(bad.split(".")[0]) / 1e9 not in [it[0] for it in items]
