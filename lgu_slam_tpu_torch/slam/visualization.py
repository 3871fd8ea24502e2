"""Reconstruction export (port of the JAX package's
``slam/visualization.py``; reference: droid_slam/visualization.py +
view_reconstruction.py).

The reference runs an interactive Open3D process fed by shared CUDA
tensors.  Open3D is not used here: this module gives the same geometry
path -- back-projection + multi-view consistency filtering
(droid_backends.iproj / depth_filter) -- as batch export utilities: point
clouds to .ply (self-contained binary writer) and camera frusta to line
sets.  The geometry runs on the device of the tensors it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from lgu_slam_tpu_torch import lie
from lgu_slam_tpu_torch.geom.depth_filter import depth_filter
from lgu_slam_tpu_torch.geom.projective import iproj
from lgu_slam_tpu_torch.utils.device import resolve_device, to_device, to_host


def _world_points(poses, disps, intr):
    """Every pixel of ``disps`` [N,h,w] back-projected to world points
    [N,h,w,3] with the w2c ``poses`` [N,7]."""
    N = disps.shape[0]
    X = iproj(disps, intr.expand(N, 4))
    Z = 1.0 / torch.clamp(X[..., 3], min=1e-6)
    pts_cam = X[..., :3] * Z[..., None]
    c2w = lie.se3_inv(poses)
    return lie.se3_act(c2w[:, None, None, :], pts_cam)


def backproject_points(poses, disps, intrinsics, images=None,
                       filter_thresh=0.005, filter_count=2, device=None):
    """Back-project filtered depth into world points
    (visualization.py:84-112).

    poses [N,7] (w2c), disps [N,h,w], intrinsics [4] (1/8 scale), images
    optional [N,H,W,3] for colors (sampled at [3::8, 3::8]); tensors or
    arrays.  Runs on the tensors' device, else on ``device`` (the card
    unless the caller passes another).
    Returns (points [M,3], colors [M,3] or None) as numpy.
    """
    dev = poses.device if torch.is_tensor(poses) else resolve_device(device)
    poses, disps, intr = (to_device(x, dev)
                          for x in (poses, disps, intrinsics))
    N = disps.shape[0]
    thresh = filter_thresh * torch.mean(disps, dim=(1, 2))
    counts = depth_filter(poses, disps, intr, torch.arange(N, device=dev),
                          thresh)
    mask = (counts >= filter_count) & (
        disps > 0.5 * disps.mean(dim=(1, 2), keepdim=True))

    pts = _world_points(poses, disps, intr)[mask].cpu().numpy()
    colors = None
    if images is not None:
        img8 = to_host(images)[:, 3::8, 3::8]
        colors = img8[mask.cpu().numpy()][:, ::-1]  # BGR -> RGB
    return pts, colors


def write_ply(path, points, colors=None):
    """Minimal binary-little-endian PLY writer."""
    n = len(points)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            rec = np.zeros(
                n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)]
            )
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())


def export_reconstruction(video, path, filter_thresh=0.005):
    """Dump the port ``Video``'s current map as a colored point cloud."""
    t = video.counter
    pts, colors = backproject_points(
        video.poses[:t], video.disps[:t], video.intrinsics[0],
        images=video.images[:t], filter_thresh=filter_thresh,
    )
    write_ply(path, pts, colors)
    return len(pts)


class IncrementalReconstruction:
    """Headless incremental consumer of the ``video.dirty`` protocol
    (reference droid_slam/visualization.py:81-154: the viewer wakes,
    reads ``dirty_index = where(video.dirty)``, clears the flags, and
    re-filters/re-projects ONLY those frames, updating per-frame point
    and camera actors).

    Here the "actors" are per-frame point/pose caches; ``export_ply``
    writes the current union, so snapshots grow as tracking proceeds
    without re-processing clean frames.
    """

    def __init__(self, video, filter_thresh=0.005, filter_count=2):
        self.video = video
        self.filter_thresh = filter_thresh
        self.filter_count = filter_count
        self.points = {}   # frame -> (pts [M,3], cols [M,3] | None)
        self.cameras = {}  # frame -> 7-vector world-to-camera pose

    def update(self):
        """Consume dirty flags; returns #frames refreshed."""
        v = self.video
        t = v.counter
        dirty = np.where(v.dirty[:t])[0]
        if len(dirty) == 0:
            return 0
        v.dirty[dirty] = False  # visualization.py:86

        poses = v.poses[:t]
        disps = v.disps[:t]
        intr = v.intrinsics[0]
        d_np = disps.cpu().numpy()

        # multiview-consistency counts for the dirty frames only
        thresh = self.filter_thresh * torch.mean(disps, dim=(1, 2))
        sel = torch.as_tensor(dirty, device=disps.device)
        counts = depth_filter(poses, disps, intr, sel,
                              thresh[sel]).cpu().numpy()

        pts_world = _world_points(poses, disps, intr).cpu().numpy()
        imgs = v.images[:t].cpu().numpy()[:, 3::8, 3::8]
        poses_np = poses.cpu().numpy()

        for k, f in enumerate(dirty):
            mask = (counts[k] >= self.filter_count) & (
                d_np[f] > 0.5 * d_np[f].mean()
            )
            self.points[int(f)] = (pts_world[f][mask],
                                   imgs[f][mask][:, ::-1])
            self.cameras[int(f)] = poses_np[f].copy()
        return len(dirty)

    def export_ply(self, path):
        """Write the union of all cached frame clouds."""
        if not self.points:
            write_ply(path, np.zeros((0, 3), np.float32))
            return 0
        pts = np.concatenate([p for p, _ in self.points.values()])
        cols = None
        if next(iter(self.points.values()))[1] is not None:
            cols = np.concatenate([c for _, c in self.points.values()])
        write_ply(path, pts, cols)
        return len(pts)

    def export_frusta(self, path, scale=0.05):
        """Camera frusta as a PLY line set (create_camera_actor analog)."""
        corners = torch.tensor([
            [0, 0, 0], [-1, -1, 1.5], [1, -1, 1.5], [1, 1, 1.5],
            [-1, 1, 1.5],
        ], dtype=torch.float32) * scale
        edges = np.asarray([
            [0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1],
        ], np.int32)
        verts, lines = [], []
        for k, (f, pose) in enumerate(sorted(self.cameras.items())):
            c2w = lie.se3_inv(torch.from_numpy(pose)[None])[0]
            v = lie.se3_act(c2w.expand(len(corners), 7), corners).numpy()
            verts.append(v)
            lines.append(edges + 5 * k)
        verts = np.concatenate(verts) if verts else np.zeros((0, 3))
        lines = np.concatenate(lines) if lines else np.zeros((0, 2), np.int32)
        with open(path, "wb") as fh:
            header = [
                "ply", "format binary_little_endian 1.0",
                f"element vertex {len(verts)}",
                "property float x", "property float y", "property float z",
                f"element edge {len(lines)}",
                "property int vertex1", "property int vertex2",
                "end_header",
            ]
            fh.write(("\n".join(header) + "\n").encode())
            fh.write(verts.astype("<f4").tobytes())
            fh.write(lines.astype("<i4").tobytes())
        return len(self.cameras)
