"""Replica RGB-D dataset loader for the 3DGS stage (port of the JAX
package's ``data/replica.py``).  Layout: <scene>/results/frame%06d.jpg +
depth%06d.png (scale 6553.5), traj.txt with 4x4 c2w row-major poses.

Discovery and poses work; the colour frames are JPEG, which the port does
not read yet (``image_io.imread`` raises ``NotImplementedError``).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from lgu_slam_tpu_torch.data.image_io import imread
from lgu_slam_tpu_torch.data.imgproc import NEAREST, resize

DEPTH_SCALE = 6553.5
# Replica capture intrinsics (cam_params.json of the official release)
INTRINSICS = {"fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5,
              "H": 680, "W": 1200}


class ReplicaDataset:
    def __init__(self, scene_path, stride=1, downscale=2):
        self.scene = scene_path
        self.color_paths = sorted(
            glob.glob(os.path.join(scene_path, "results", "frame*.jpg"))
        )[::stride]
        self.depth_paths = sorted(
            glob.glob(os.path.join(scene_path, "results", "depth*.png"))
        )[::stride]
        poses = np.loadtxt(os.path.join(scene_path, "traj.txt")).reshape(
            -1, 4, 4
        )
        self.poses_c2w = poses[::stride]
        self.downscale = downscale
        s = 1.0 / downscale
        self.intr = np.asarray(
            [INTRINSICS["fx"] * s, INTRINSICS["fy"] * s,
             INTRINSICS["cx"] * s, INTRINSICS["cy"] * s], np.float32,
        )
        self.size = (INTRINSICS["H"] // downscale,
                     INTRINSICS["W"] // downscale)

    def __len__(self):
        return min(len(self.color_paths), len(self.poses_c2w))

    def __getitem__(self, i):
        """Returns (im [H,W,3] RGB in [0,1], depth [H,W] m, w2c [4,4],
        intrinsics [4])."""
        H, W = self.size
        im = imread(self.color_paths[i])[..., ::-1]
        im = resize(im, (W, H)).astype(np.float32) / 255.0
        d = imread(self.depth_paths[i], anydepth=True
                   ).astype(np.float32) / DEPTH_SCALE
        d = resize(d, (W, H), NEAREST)
        w2c = np.linalg.inv(self.poses_c2w[i])
        return im, d, w2c.astype(np.float32), self.intr

    def stream(self):
        """(t, image BGR uint8, depth, intrinsics) for the SLAM system."""
        for t in range(len(self)):
            im, d, _, intr = self[t]
            bgr = (im[..., ::-1] * 255).astype(np.uint8)
            yield t, bgr, d, intr
