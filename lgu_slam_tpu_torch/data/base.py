"""Training dataset base: covisibility-sampled clips (port of the JAX
package's ``data/base.py``), on the port's PNG decoder, resize and
``geom/distance.frame_distance`` (on the CPU).

Pure-NumPy implementation (no torch DataLoader): scene info (image/depth
paths, poses, intrinsics) is built once and cached as a pickle; items are
n-frame clips sampled by covisibility (frame-graph distance in
[fmin, fmax]) and scale-normalized.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from lgu_slam_tpu_torch.data.image_io import imread
from lgu_slam_tpu_torch.data.imgproc import NEAREST, resize
from lgu_slam_tpu_torch.geom.distance import frame_distance


def build_frame_graph_from_depths(poses, depths, intrinsics, f=16,
                                  max_flow=256):
    """Covisibility graph from mean induced flow (reference
    data_readers/base.py:69-92 / rgbd_utils.py:105-190), downsampled by f.

    poses [N,7] (w2c), depths [N,H,W], intrinsics [N,4].
    Returns dict i -> (js, flow_mags).
    """
    N = len(poses)
    d8 = np.stack([
        resize(1.0 / np.maximum(d, 1e-3),
               (d.shape[1] // f, d.shape[0] // f), NEAREST)
        for d in depths
    ])
    intr = np.asarray(intrinsics[0], np.float32) / f
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    mask = ii != jj
    ii, jj = ii[mask], jj[mask]
    poses, d8, intr = (torch.from_numpy(np.asarray(a, np.float32))
                       for a in (poses, d8, intr))
    dist = frame_distance(poses, d8, intr, torch.from_numpy(ii),
                          torch.from_numpy(jj), 0.5).numpy()
    graph = {}
    for i in range(N):
        sel = ii == i
        js = jj[sel]
        ds = dist[sel]
        keep = ds < max_flow
        graph[i] = (js[keep], ds[keep])
    return graph


class ClipDataset:
    """Covisibility-sampled n-frame training clips."""

    def __init__(self, name, datapath, n_frames=4, fmin=8.0, fmax=96.0,
                 crop_size=(384, 512), cache_dir="cache", seed=0):
        self.name = name
        self.datapath = datapath
        self.n_frames = n_frames
        self.fmin = fmin
        self.fmax = fmax
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)

        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(cache_dir, f"{name}.pickle")
        if os.path.exists(cache):
            with open(cache, "rb") as fh:
                self.scene_info = pickle.load(fh)
        else:
            self.scene_info = self._build_dataset_index()
            with open(cache, "wb") as fh:
                pickle.dump(self.scene_info, fh)

        self.items = []
        for scene, info in self.scene_info.items():
            graph = info["graph"]
            for i in graph:
                if len(graph[i][0]) > self.n_frames:
                    self.items.append((scene, i))

    # subclasses implement:
    def _build_dataset_index(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def image_read(path):
        return imread(path)

    @staticmethod
    def depth_read(path):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        """Returns (images [n,H,W,3] u8, poses [n,7] camera-to-world,
        depths [n,H,W], intrinsics [n,4]) — reference base.py:94-150.
        The training step inverts the poses to w2c (train.py:112)."""
        scene, ix = self.items[index % len(self.items)]
        info = self.scene_info[scene]
        graph = info["graph"]

        frames = [ix]
        while len(frames) < self.n_frames:
            js, ds = graph[frames[-1]]
            sel = (ds > self.fmin) & (ds < self.fmax)
            cand = [j for j in js[sel] if j not in frames]
            if not cand:
                cand = [j for j in js if j not in frames]
            if not cand:
                cand = [(frames[-1] + 1) % len(info["images"])]
            frames.append(int(self.rng.choice(cand)))

        images, depths, poses, intr = [], [], [], []
        for i in frames:
            images.append(self.image_read(info["images"][i]))
            depths.append(self.depth_read(info["depths"][i]))
            poses.append(info["poses"][i])
            intr.append(info["intrinsics"][i])

        images = np.stack(images).astype(np.uint8)
        depths = np.stack(depths).astype(np.float32)
        poses = np.stack(poses).astype(np.float32)
        intr = np.stack(intr).astype(np.float32)

        # scale normalization: median depth -> ~1 (base.py:137-148)
        s = np.median(depths[depths > 0.01]) if (depths > 0.01).any() else 1.0
        depths = depths / s
        poses[:, :3] = poses[:, :3] / s

        H, W = self.crop_size
        h0, w0 = images.shape[1:3]
        if (h0, w0) != (H, W):
            images = np.stack([resize(im, (W, H)) for im in images])
            depths = np.stack([resize(d, (W, H), NEAREST) for d in depths])
            intr = intr * np.asarray(
                [W / w0, H / h0, W / w0, H / h0], np.float32
            )
        return images, poses, depths, intr
