"""The port's image operations (lgu_slam_tpu_torch/data/imgproc.py) against
the OpenCV functions the JAX package's data layer calls.  Tolerances: the
EuRoC rectification maps within 1e-3 px of ``cv2.initUndistortRectifyMap``;
resize, remap and undistort exact (0 levels: the port follows OpenCV's
fixed-point and float arithmetic, measured equal on every case here)."""

import cv2
import numpy as np
import pytest
from torch_port import torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data import imgproc
from lgu_slam_tpu_torch.data.streams import EUROC_LEFT, EUROC_RIGHT

TUM_FR1_K = np.asarray([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]])
TUM_FR1_DIST = np.asarray([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])


def _texture(rng, H, W, C=3):
    im = rng.integers(0, 256, (H, W, C)).astype(np.uint8)
    im = cv2.GaussianBlur(im, (5, 5), 1.5).reshape(H, W, C)
    return im if C > 1 else im[..., 0]


@pytest.mark.parametrize("src", [(480, 640), (37, 53), (752, 480),
                                 (100, 90)])
def test_resize_matches_cv2(src):
    """Linear (uint8, 3 channels and 1) and nearest (float32 depth, uint16)
    to sizes that shrink, enlarge, halve exactly (OpenCV's INTER_AREA
    switch), keep the size, and change one axis only."""
    rng = np.random.default_rng(sum(src))
    H, W = src
    dsts = [(384, 512), (240, 320), (24, 32), (320, 512), (50, 45),
            (2 * H, 2 * W), (H // 2, W // 2), (H, W), (H, W + 1), (17, 13)]
    for C in (3, 1):
        im = _texture(rng, H, W, C)
        for h, w in dsts:
            np.testing.assert_array_equal(imgproc.resize(im, (w, h)),
                                          cv2.resize(im, (w, h)))
    depth = rng.random((H, W)).astype(np.float32)
    raw = rng.integers(0, 65535, (H, W)).astype(np.uint16)
    for h, w in dsts:
        for d in (depth, raw):
            np.testing.assert_array_equal(
                imgproc.resize(d, (w, h), imgproc.NEAREST),
                cv2.resize(d, (w, h), interpolation=cv2.INTER_NEAREST))


def test_euroc_rectification_maps_match_cv2():
    """Both EuRoC cameras' factory rectification (752 x 480): within
    1e-3 px of cv2.initUndistortRectifyMap."""
    for cam in (EUROC_LEFT, EUROC_RIGHT):
        ref = cv2.initUndistortRectifyMap(cam["K"], cam["dist"], cam["R"],
                                          cam["P"][:3, :3], (752, 480),
                                          cv2.CV_32F)
        got = imgproc.init_undistort_rectify_map(
            cam["K"], cam["dist"], cam["R"], cam["P"], (752, 480))
        for g, r in zip(got, ref):
            assert g.dtype == np.float32 and g.shape == (480, 752)
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-3)


def test_remap_matches_cv2():
    """Bilinear remap with the default constant border 0: the EuRoC maps on
    3-channel and gray frames, and random maps reaching past every border,
    with positions on exact halves and 1/64ths."""
    rng = np.random.default_rng(4)
    cam = EUROC_LEFT
    maps = cv2.initUndistortRectifyMap(cam["K"], cam["dist"], cam["R"],
                                       cam["P"][:3, :3], (752, 480),
                                       cv2.CV_32F)
    for C in (3, 1):
        im = _texture(rng, 480, 752, C)
        np.testing.assert_array_equal(
            imgproc.remap(im, *maps),
            cv2.remap(im, maps[0], maps[1], cv2.INTER_LINEAR))
    im = _texture(rng, 61, 47)
    mx = rng.uniform(-3, 50, (40, 30)).astype(np.float32)
    my = rng.uniform(-3, 64, (40, 30)).astype(np.float32)
    mx[0, :6] = [0.5, 1.015625, -0.5, 46.5, -1.0, 45.984375]
    my[0, :6] = [60.5, 0.5, 2.0, -0.015625, 59.5, 3.5]
    np.testing.assert_array_equal(imgproc.remap(im, mx, my),
                                  cv2.remap(im, mx, my, cv2.INTER_LINEAR))


@pytest.mark.parametrize("size", [(480, 640), (45, 61)])
def test_undistort_matches_cv2(size):
    """TUM fr1's distortion at the sequence's 480 x 640 and at an odd size
    (its own camera matrix), 3-channel and gray."""
    rng = np.random.default_rng(size[0])
    H, W = size
    K = TUM_FR1_K if size == (480, 640) else np.asarray(
        [[40.0, 0, 30.5], [0, 41.0, 20.2], [0, 0, 1]])
    for C in (3, 1):
        im = _texture(rng, H, W, C)
        ref = cv2.undistort(im, K, TUM_FR1_DIST)
        np.testing.assert_array_equal(
            imgproc.undistort(im, K, TUM_FR1_DIST), ref)
        maps = imgproc.undistort_maps(K, TUM_FR1_DIST, (W, H))
        np.testing.assert_array_equal(maps(im), ref)
