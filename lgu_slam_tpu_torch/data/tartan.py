"""TartanAir training dataset (port of the JAX package's ``data/tartan.py``):
NED pose permutation, depth scale, scene discovery, and the official
mono/stereo test-split lists."""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from lgu_slam_tpu_torch import lie
from lgu_slam_tpu_torch.data.base import (
    ClipDataset,
    build_frame_graph_from_depths,
)

# tartan.py: depthscale
DEPTH_SCALE = 5.0

# NED -> camera xyz permutation (tartan.py:51: [1, 2, 0, 4, 5, 3, 6])
_PERM = [1, 2, 0, 4, 5, 3, 6]

# droid_slam/data_readers/tartan_test.txt (validation scene list)
TEST_SPLIT = [
    "abandonedfactory/abandonedfactory/Easy/P011",
    "abandonedfactory/abandonedfactory/Hard/P011",
    "abandonedfactory_night/abandonedfactory_night/Easy/P013",
    "abandonedfactory_night/abandonedfactory_night/Hard/P014",
    "amusement/amusement/Easy/P008",
    "amusement/amusement/Hard/P007",
    "carwelding/carwelding/Easy/P007",
    "endofworld/endofworld/Easy/P009",
    "gascola/gascola/Easy/P008",
    "gascola/gascola/Hard/P009",
    "hospital/hospital/Easy/P036",
    "hospital/hospital/Hard/P049",
    "japanesealley/japanesealley/Easy/P007",
    "japanesealley/japanesealley/Hard/P005",
    "neighborhood/neighborhood/Easy/P021",
    "neighborhood/neighborhood/Hard/P017",
    "ocean/ocean/Easy/P013",
    "ocean/ocean/Hard/P009",
    "office2/office2/Easy/P011",
    "office2/office2/Hard/P010",
    "office/office/Hard/P007",
    "oldtown/oldtown/Easy/P007",
    "oldtown/oldtown/Hard/P008",
    "seasidetown/seasidetown/Easy/P009",
    "seasonsforest/seasonsforest/Easy/P011",
    "seasonsforest/seasonsforest/Hard/P016",
    "seasonsforest_winter/seasonsforest_winter/Easy/P009",
    "seasonsforest_winter/seasonsforest_winter/Hard/P018",
    "soulcity/soulcity/Easy/P012",
    "soulcity/soulcity/Hard/P009",
    "westerndesert/westerndesert/Easy/P013",
    "westerndesert/westerndesert/Hard/P007",
]

INTRINSICS = np.asarray([320.0, 320.0, 320.0, 240.0], np.float32)


def ned_to_xyz(poses_ned: np.ndarray) -> np.ndarray:
    """TartanAir NED (x, y, z, qx, qy, qz, qw) -> camera-frame layout."""
    return poses_ned[:, _PERM]


class TartanAir(ClipDataset):
    def __init__(self, datapath, **kw):
        super().__init__("TartanAir", datapath, **kw)

    @staticmethod
    def depth_read(path):
        return np.load(path) / DEPTH_SCALE

    def _build_dataset_index(self):
        scene_info = {}
        scenes = glob.glob(
            os.path.join(self.datapath, "*/*/*/*/image_left")
        ) or glob.glob(os.path.join(self.datapath, "*/*/*/image_left"))
        for imdir in scenes:
            scene = os.path.dirname(imdir)
            if any(s in scene for s in TEST_SPLIT):
                continue
            images = sorted(glob.glob(os.path.join(imdir, "*.png")))
            depths = sorted(
                glob.glob(os.path.join(scene, "depth_left", "*.npy"))
            )
            posefile = os.path.join(scene, "pose_left.txt")
            if not images or len(images) != len(depths) or not os.path.exists(
                posefile
            ):
                continue
            poses = ned_to_xyz(np.loadtxt(posefile, delimiter=" "))
            # world-to-camera (the reference stores c2w here and inverts in
            # train.py:112; keep c2w and let the trainer invert)
            intr = np.tile(INTRINSICS, (len(images), 1))
            depths_small = [
                np.load(d)[::16, ::16] / DEPTH_SCALE for d in depths
            ]
            graph = build_frame_graph_from_depths(
                _poses_w2c(poses), np.stack(depths_small), intr / 16.0, f=1
            )
            scene_info[scene] = {
                "images": images,
                "depths": depths,
                "poses": poses,
                "intrinsics": intr,
                "graph": graph,
            }
        return scene_info


def _poses_w2c(poses_c2w: np.ndarray) -> np.ndarray:
    return lie.se3_inv(
        torch.from_numpy(np.asarray(poses_c2w, np.float32))).numpy()


def dataset_factory(names, datapath, **kw):
    """(reference data_readers/factory.py)"""
    sets = []
    for n in names:
        if n == "tartan":
            sets.append(TartanAir(datapath, **kw))
        else:
            raise ValueError(f"unknown dataset {n}")
    if len(sets) == 1:
        return sets[0]
    return ConcatDataset(sets)


class ConcatDataset:
    def __init__(self, sets):
        self.sets = sets
        self.lengths = [len(s) for s in sets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, i):
        for s, L in zip(self.sets, self.lengths):
            if i < L:
                return s[i]
            i -= L
        raise IndexError
