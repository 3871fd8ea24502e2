"""Gaussian map parameters with a fixed capacity (port of the JAX package's
``gs/params.py``; reference: to3DGS/executeSlam.py:138-227
initialize_params / get_pointcloud / add_new_gaussians, and
utils/gs_external.py prune/densify).

The Gaussian set lives in fixed-capacity device tensors with a host
``alive`` mask.  Slots are allocated in order, so the Gaussians ever added
fill the prefix ``[0, count)``; pruning only clears ``alive``.  The mapper
steps that prefix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lgu_slam_tpu_torch.utils.device import to_device

PARAM_KEYS = ("means3D", "rgb_colors", "unnorm_rotations",
              "logit_opacities", "log_scales")


def pointcloud_from_depth(color, depth, intr, c2w_rot, c2w_trans,
                          mask=None):
    """Back-project an RGB-D frame to a world point cloud
    (executeSlam.py get_pointcloud).

    color [H,W,3] in [0,1]; depth [H,W]; intr (fx, fy, cx, cy).
    Returns (pts [M,3], cols [M,3], mean_sq_dist [M]) as numpy (host).
    """
    H, W = depth.shape
    fx, fy, cx, cy = intr
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    Z = np.asarray(depth)
    X = (xs + 0.5 - cx) / fx * Z
    Y = (ys + 0.5 - cy) / fy * Z
    pts_cam = np.stack([X, Y, Z], -1).reshape(-1, 3)
    cols = np.asarray(color).reshape(-1, 3)

    m = Z.reshape(-1) > 0
    if mask is not None:
        m &= np.asarray(mask).reshape(-1)
    pts_cam = pts_cam[m]
    cols = cols[m]
    pts_world = pts_cam @ np.asarray(c2w_rot).T + np.asarray(c2w_trans)
    # projective mean-square distance (scale init): ((z / f))^2
    msq = (pts_cam[:, 2] / ((fx + fy) / 2)) ** 2
    return pts_world, cols, msq


@dataclass
class GaussianMap:
    """Fixed-capacity parameter tensors on one device, with host flags."""

    params: dict  # PARAM_KEYS -> [cap, ...] float32 tensors
    alive: np.ndarray  # [cap] bool (host)
    count: int
    capacity: int
    timestep: np.ndarray  # [cap] frame each Gaussian was added

    @staticmethod
    def create(capacity: int, device) -> "GaussianMap":
        f32 = dict(dtype=torch.float32, device=device)
        quat = torch.zeros(capacity, 4, **f32)
        quat[:, 0] = 1.0
        params = {
            "means3D": torch.zeros(capacity, 3, **f32),
            "rgb_colors": torch.zeros(capacity, 3, **f32),
            "unnorm_rotations": quat,
            "logit_opacities": torch.zeros(capacity, 1, **f32),
            "log_scales": torch.full((capacity, 1), -10.0, **f32),
        }
        return GaussianMap(
            params, np.zeros(capacity, bool), 0, capacity,
            np.zeros(capacity, np.float32),
        )

    @property
    def device(self) -> torch.device:
        return self.params["means3D"].device

    def live(self, n: int | None = None) -> dict:
        """The parameters of the prefix ``[0, n)`` (``count`` by default),
        as views."""
        n = self.count if n is None else n
        return {k: v[:n] for k, v in self.params.items()}

    def set_live(self, params: dict) -> None:
        """Write prefix tensors (``live()``'s layout) back."""
        for k, v in params.items():
            self.params[k][: v.shape[0]] = v

    def add_points(self, pts, cols, mean_sq_dist, time_idx: int):
        """Append new isotropic Gaussians (initialize_new_params)."""
        n = len(pts)
        free = self.capacity - self.count
        if n > free:
            pts, cols = pts[:free], cols[:free]
            mean_sq_dist = mean_sq_dist[:free]
            n = free
        if n == 0:
            return
        dev = self.device
        sl = slice(self.count, self.count + n)
        p = self.params
        p["means3D"][sl] = to_device(pts, dev)
        p["rgb_colors"][sl] = to_device(cols, dev)
        p["unnorm_rotations"][sl] = torch.tensor([1.0, 0, 0, 0], device=dev)
        p["logit_opacities"][sl] = 0.0
        p["log_scales"][sl] = torch.log(
            torch.sqrt(to_device(mean_sq_dist, dev)))[:, None]
        self.alive[sl] = True
        self.timestep[sl] = time_idx
        self.count += n

    def prune(self, mask_remove: np.ndarray):
        """Clear alive flags (gs_external.prune_gaussians analog)."""
        self.alive &= ~np.asarray(mask_remove, bool)

    def alive_device(self, n: int | None = None) -> torch.Tensor:
        """``alive`` of the prefix ``[0, n)`` (everything by default) on
        the device."""
        a = self.alive if n is None else self.alive[:n]
        return torch.from_numpy(a.copy()).to(self.device)

    def _append_rows(self, rows: dict, time_idx):
        """Write full parameter rows into free slots (densify append)."""
        n = rows["means3D"].shape[0]
        free = self.capacity - self.count
        if n > free:
            rows = {k: v[:free] for k, v in rows.items()}
            n = free
        if n == 0:
            return 0
        sl = slice(self.count, self.count + n)
        for k, v in rows.items():
            self.params[k][sl] = to_device(v, self.device)
        self.alive[sl] = True
        self.timestep[sl] = np.asarray(
            time_idx, np.float32
        )[:n] if np.ndim(time_idx) else time_idx
        self.count += n
        return n

    def densify(self, grads, scene_radius, grad_thresh=0.0002,
                num_to_split_into=2):
        """Gradient-thresholded clone/split densification
        (to3DGS/utils/gs_external.py:191-233):

        - **clone**: Gaussians with accumulated mean-2D-gradient >=
          ``grad_thresh`` and max scale <= 0.01 * scene_radius are
          duplicated in place;
        - **split**: large high-gradient Gaussians are replaced by
          ``num_to_split_into`` samples drawn from their own ellipsoid,
          with scales shrunk by 1 / (0.8 n); the original is removed.

        ``grads`` is the per-Gaussian accumulated ||dL/dmeans2D|| / denom
        (accumulate_mean2d_gradient).  Returns #Gaussians appended.
        """
        g = np.nan_to_num(np.asarray(grads))
        host = {k: v.cpu().numpy() for k, v in self.params.items()}
        scales_max = np.exp(host["log_scales"].max(axis=1))
        cand = (g >= grad_thresh) & self.alive
        cand[self.count:] = False
        small = scales_max <= 0.01 * scene_radius
        to_clone = np.where(cand & small)[0]
        to_split = np.where(cand & ~small)[0]
        if len(to_clone) == 0 and len(to_split) == 0:
            return 0

        added = 0
        if len(to_clone):
            rows = {k: v[to_clone] for k, v in host.items()}
            added += self._append_rows(rows, self.timestep[to_clone])
        if len(to_split):
            n = num_to_split_into
            reps = np.repeat(to_split, n)
            stds = np.exp(host["log_scales"][reps])  # [S*n, 1] isotropic
            rng = np.random.default_rng(self.count)
            samples = rng.normal(size=(len(reps), 3)).astype(
                np.float32
            ) * stds
            # rotate samples into the Gaussian frame (gs_external:222-225;
            # a no-op for isotropic scales, kept for parity)
            q = host["unnorm_rotations"][reps]
            q = q / np.maximum(
                np.linalg.norm(q, axis=-1, keepdims=True), 1e-12
            )
            w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
            R = np.stack([
                np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                          2 * (x * z + w * y)], -1),
                np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                          2 * (y * z - w * x)], -1),
                np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                          1 - 2 * (x * x + y * y)], -1),
            ], axis=-2)
            rows = {k: v[reps].copy() for k, v in host.items()}
            rows["means3D"] = rows["means3D"] + np.einsum(
                "nij,nj->ni", R, samples
            )
            rows["log_scales"] = np.log(
                np.exp(rows["log_scales"]) / (0.8 * n)
            )
            added += self._append_rows(rows, self.timestep[reps])
            self.alive[to_split] = False  # originals removed
        return added
