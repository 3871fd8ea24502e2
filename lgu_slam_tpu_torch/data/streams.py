"""Streaming image readers for inference (port of the JAX package's
``data/streams.py``), on the port's own image decoders and image
operations (``data/image_io.py``, ``data/imgproc.py``) in place of OpenCV.
A frame ``cv2.imread`` returns None for (``ValueError``) is skipped where
the JAX stream skips it; one the port cannot read yet raises
``NotImplementedError``.

All streams yield numpy arrays shaped for :meth:`LGUSlam.track`:
``(t, image[H,W,3] BGR uint8, intrinsics[4])`` -- with an extra ``depth``
element for RGB-D and a stacked ``[2,H,W,3]`` image for stereo.  Images are
resized to multiples of 8 near a target pixel count.  A camera's
undistortion maps are built once per stream (``cv2.undistort`` builds the
same maps for every frame).
"""

from __future__ import annotations

import os

import numpy as np

from lgu_slam_tpu_torch.data.image_io import imread
from lgu_slam_tpu_torch.data.imgproc import (
    NEAREST,
    FloatRemap,
    init_undistort_rectify_map,
    resize,
    undistort_maps,
)
from lgu_slam_tpu_torch.eval.ate import associate


def _target_size(h0, w0, target_pixels=384 * 512):
    """Scale to ~target pixel count, each side a multiple of 8."""
    s = np.sqrt(target_pixels / (h0 * w0))
    h1 = int(h0 * s)
    w1 = int(w0 * s)
    h1 -= h1 % 8
    w1 -= w1 % 8
    return h1, w1


def load_calib(calib_file):
    """``fx fy cx cy [k1 k2 p1 p2 k3]``."""
    calib = np.loadtxt(calib_file, delimiter=" ").reshape(-1)
    K = np.eye(3)
    K[0, 0], K[1, 1] = calib[0], calib[1]
    K[0, 2], K[1, 2] = calib[2], calib[3]
    return calib, K


class _Undistorter:
    """``cv2.undistort(image, K, dist)`` with the maps built at the first
    frame of each size."""

    def __init__(self, K, dist):
        self.K, self.dist, self.maps = K, dist, {}

    def __call__(self, image):
        h, w = image.shape[:2]
        if (w, h) not in self.maps:
            self.maps[w, h] = undistort_maps(self.K, self.dist, (w, h))
        return self.maps[w, h](image)


def image_stream(imagedir, calib, stride=1, t0=0, target_pixels=384 * 512):
    """Monocular directory stream."""
    calib, K = load_calib(calib) if isinstance(calib, str) else (
        np.asarray(calib), None
    )
    if K is None:
        K = np.eye(3)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = calib[:4]
    fx, fy, cx, cy = calib[:4]
    undist = _Undistorter(K, calib[4:]) if len(calib) > 4 else None

    files = sorted(os.listdir(imagedir))[::stride]
    for t, name in enumerate(files):
        if t < t0:
            continue
        image = imread(os.path.join(imagedir, name))
        if undist is not None:
            image = undist(image)
        h0, w0 = image.shape[:2]
        h1, w1 = _target_size(h0, w0, target_pixels)
        image = resize(image, (w1, h1))
        intr = np.asarray(
            [fx * w1 / w0, fy * h1 / h0, cx * w1 / w0, cy * h1 / h0],
            np.float32,
        )
        yield t, image, intr


def rgbd_stream(imagedir, depthdir, calib, stride=1, depth_scale=1000.0,
                target_pixels=384 * 512):
    """Aligned RGB-D stream: depth in units of 1/depth_scale meters."""
    calib, K = load_calib(calib)
    fx, fy, cx, cy = calib[:4]
    undist = _Undistorter(K, calib[4:]) if len(calib) > 4 else None
    images = sorted(os.listdir(imagedir))[::stride]
    depths = sorted(os.listdir(depthdir))[::stride]
    for t, (iname, dname) in enumerate(zip(images, depths)):
        image = imread(os.path.join(imagedir, iname))
        depth = imread(os.path.join(depthdir, dname), anydepth=True
                       ).astype(np.float32) / depth_scale
        if undist is not None:
            image = undist(image)
        h0, w0 = image.shape[:2]
        h1, w1 = _target_size(h0, w0, target_pixels)
        image = resize(image, (w1, h1))
        depth = resize(depth, (w1, h1), NEAREST)
        intr = np.asarray(
            [fx * w1 / w0, fy * h1 / h0, cx * w1 / w0, cy * h1 / h0],
            np.float32,
        )
        yield t, image, depth, intr


# EuRoC MAV factory rectification (the reference's test_euroc.py)
EUROC_SIZE = (752, 480)
EUROC_LEFT = dict(
    K=np.array([458.654, 0.0, 367.215, 0, 457.296, 248.375, 0, 0, 1]
               ).reshape(3, 3),
    dist=np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05,
                   0.0]),
    R=np.array([
        0.999966347530033, -0.001422739138722922, 0.008079580483432283,
        0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
        -0.008089410156878961, -0.007044357138835809, 0.9999424675829176,
    ]).reshape(3, 3),
    P=np.array([435.2046959714599, 0, 367.4517211914062, 0,
                0, 435.2046959714599, 252.2008514404297, 0,
                0, 0, 1, 0]).reshape(3, 4))
EUROC_RIGHT = dict(
    K=np.array([457.587, 0.0, 379.999, 0, 456.134, 255.238, 0, 0, 1]
               ).reshape(3, 3),
    dist=np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05,
                   0.0]),
    R=np.array([
        0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
        0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
        -0.007729688520722713, 0.007064130529506649, 0.999945173484644,
    ]).reshape(3, 3),
    P=np.array([435.2046959714599, 0, 367.4517211914062, -47.90639384423901,
                0, 435.2046959714599, 252.2008514404297, 0,
                0, 0, 1, 0]).reshape(3, 4))


def euroc_maps():
    """The rectification maps (map_x, map_y) of the left and right camera,
    float32 ``[480, 752]`` each."""
    return tuple(init_undistort_rectify_map(c["K"], c["dist"], c["R"],
                                            c["P"], EUROC_SIZE)
                 for c in (EUROC_LEFT, EUROC_RIGHT))


def euroc_stereo_stream(datapath, stride=1, image_size=(320, 512)):
    """EuRoC MAV stereo with the hardcoded factory rectification."""
    rectify = [FloatRemap(*m, EUROC_SIZE[::-1]) for m in euroc_maps()]
    left_dir = os.path.join(datapath, "mav0", "cam0", "data")
    right_dir = os.path.join(datapath, "mav0", "cam1", "data")
    names = sorted(os.listdir(left_dir))[::stride]
    H1, W1 = image_size
    fx, cx, cy = EUROC_LEFT["P"][0, 0], EUROC_LEFT["P"][0, 2], \
        EUROC_LEFT["P"][1, 2]
    for name in names:
        tstamp = float(name.split(".")[0]) / 1e9
        rpath = os.path.join(right_dir, name)
        try:
            left = imread(os.path.join(left_dir, name))
        except (FileNotFoundError, ValueError):
            continue  # where cv2.imread returns None, the JAX stream skips
        if not os.path.exists(rpath):
            continue
        right = imread(rpath)
        left = resize(rectify[0](left), (W1, H1))
        right = resize(rectify[1](right), (W1, H1))
        intr = np.asarray(
            [fx * W1 / EUROC_SIZE[0], fx * H1 / EUROC_SIZE[1],
             cx * W1 / EUROC_SIZE[0], cy * H1 / EUROC_SIZE[1]],
            np.float32,
        )
        yield tstamp, np.stack([left, right]), intr


def read_list(datapath, name):
    """(timestamp, path) entries of a TUM-layout list such as ``rgb.txt``."""
    entries = []
    with open(os.path.join(datapath, name)) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.strip().split()
            if parts:
                entries.append((float(parts[0]), parts[1]))
    return entries


def tum_rgbd_stream(datapath, stride=2, target_pixels=None):
    """TUM fr sequences with association and the per-sequence fr1/fr2/fr3
    intrinsics and distortion, cropped and halved to 240 x 320."""
    rgb = read_list(datapath, "rgb.txt")
    depth = read_list(datapath, "depth.txt")
    pairs = associate(
        np.asarray([r[0] for r in rgb]), np.asarray([d[0] for d in depth])
    )

    calib = np.asarray([535.4, 539.2, 320.1, 247.6], np.float32)
    seq = os.path.basename(os.path.normpath(datapath))
    if "freiburg1" in seq:
        calib = np.asarray([517.3, 516.5, 318.6, 255.3], np.float32)
        dist = np.asarray([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
    elif "freiburg2" in seq:
        calib = np.asarray([520.9, 521.0, 325.1, 249.7], np.float32)
        dist = np.asarray([0.2312, -0.7849, -0.0033, -0.0001, 0.9172])
    else:
        dist = None
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = calib
    undist = _Undistorter(K, dist) if dist is not None else None

    for ia, ib in pairs[::stride]:
        image = imread(os.path.join(datapath, rgb[ia][1]))
        d = imread(os.path.join(datapath, depth[ib][1]), anydepth=True
                   ).astype(np.float32) / 5000.0
        if undist is not None:
            image = undist(image)
        # crop borders + halve (test_tum.py protocol): 240x320
        image = image[16:-16, 24:-24]
        d = d[16:-16, 24:-24]
        h1, w1 = image.shape[:2]
        image = resize(image, (320, 240))
        d = resize(d, (320, 240), NEAREST)
        intr = np.asarray(
            [calib[0] * 320 / w1, calib[1] * 240 / h1,
             (calib[2] - 24) * 320 / w1, (calib[3] - 16) * 240 / h1],
            np.float32,
        )
        yield rgb[ia][0], image, d, intr
