"""Synthetic multi-billboard scenes with exact poses and depths (the
port's own copy of the JAX package's ``data/synthetic.py``, identical in
every number: the same seeds render the same clips in both packages).

Textured fronto-parallel billboards at staggered depths are rendered by
exact ray-plane intersection, giving geometrically consistent images,
z-depth maps and camera trajectories.  Depth discontinuities and parallax
across planes make the scene non-degenerate for bundle adjustment, so the
training loop can learn flow on it.

Pure NumPy; render cost is O(n_planes * H * W) per frame.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticScene", "SyntheticDataset", "render_clip"]


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    x, y, z, w = q
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def _exp_so3(w: np.ndarray) -> np.ndarray:
    """Rotation vector -> quaternion (x, y, z, w)."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.asarray([0.0, 0.0, 0.0, 1.0])
    ax = w / th
    s = np.sin(th / 2.0)
    return np.asarray([ax[0] * s, ax[1] * s, ax[2] * s, np.cos(th / 2.0)])


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.asarray(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def _smooth_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """[h, w, 3] float texture in [0, 255] with multi-scale structure."""
    tex = np.zeros((h, w, 3), np.float32)
    for scale in (4, 8, 16, 32):
        coarse = rng.uniform(0, 1, (max(h // scale, 2), max(w // scale, 2), 3))
        # bilinear upsample by integer repetition + box smoothing
        up = np.repeat(np.repeat(coarse, scale, axis=0), scale, axis=1)
        up = up[:h, :w]
        if up.shape[:2] != (h, w):
            pad_h, pad_w = h - up.shape[0], w - up.shape[1]
            up = np.pad(up, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
        tex += up.astype(np.float32)
    for _ in range(2):  # smooth so bilinear sampling looks like texture
        tex = (
            tex
            + np.roll(tex, 1, 0)
            + np.roll(tex, -1, 0)
            + np.roll(tex, 1, 1)
            + np.roll(tex, -1, 1)
        ) / 5.0
    tex -= tex.min()
    tex *= 255.0 / max(tex.max(), 1e-6)
    return tex


class SyntheticScene:
    """A set of textured fronto-parallel billboards (planes z = const in
    world frame) plus a far background plane guaranteeing full coverage."""

    def __init__(self, seed: int = 0, n_planes: int = 7, tex_res: int = 256):
        rng = np.random.default_rng(seed)
        self.planes = []
        # staggered foreground billboards
        for k in range(n_planes):
            z = 3.0 + 7.0 * (k / max(n_planes - 1, 1)) + rng.uniform(-0.4, 0.4)
            half = rng.uniform(1.2, 3.0) * (z / 4.0)
            cx = rng.uniform(-0.5, 0.5) * z
            cy = rng.uniform(-0.4, 0.4) * z
            self.planes.append(
                dict(
                    z=z,
                    x0=cx - half,
                    x1=cx + half,
                    y0=cy - half,
                    y1=cy + half,
                    tex=_smooth_texture(rng, tex_res, tex_res),
                )
            )
        # background plane: huge extent at the far end
        zb = 14.0
        self.planes.append(
            dict(
                z=zb,
                x0=-6 * zb,
                x1=6 * zb,
                y0=-6 * zb,
                y1=6 * zb,
                tex=_smooth_texture(rng, 2 * tex_res, 2 * tex_res),
            )
        )
        # near-to-far so the first in-bounds hit wins (z-order)
        self.planes.sort(key=lambda p: p["z"])

    def render(self, pose_c2w: np.ndarray, intrinsics: np.ndarray,
               H: int, W: int):
        """Render one frame.

        pose_c2w: 7-vec (t, q) camera-to-world; intrinsics (fx, fy, cx, cy).
        Returns (image [H, W, 3] uint8, depth [H, W] float32 z-depth).
        """
        fx, fy, cx, cy = np.asarray(intrinsics, np.float64)
        R = _quat_to_mat(np.asarray(pose_c2w[3:7], np.float64))
        o = np.asarray(pose_c2w[:3], np.float64)

        u, v = np.meshgrid(np.arange(W), np.arange(H))
        d_c = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float64)], -1
        )
        d_w = d_c @ R.T  # [H, W, 3] world-frame ray directions

        img = np.zeros((H, W, 3), np.float32)
        depth = np.zeros((H, W), np.float32)
        todo = np.ones((H, W), bool)
        for p in self.planes:
            dz = d_w[..., 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                lam = (p["z"] - o[2]) / dz
            px = o[0] + lam * d_w[..., 0]
            py = o[1] + lam * d_w[..., 1]
            hit = (
                todo
                & (np.abs(dz) > 1e-9)
                & (lam > 0.2)
                & (px >= p["x0"])
                & (px < p["x1"])
                & (py >= p["y0"])
                & (py < p["y1"])
            )
            if not hit.any():
                continue
            tex = p["tex"]
            th, tw = tex.shape[:2]
            tx = (px[hit] - p["x0"]) / (p["x1"] - p["x0"]) * (tw - 1)
            ty = (py[hit] - p["y0"]) / (p["y1"] - p["y0"]) * (th - 1)
            x0 = np.clip(tx.astype(np.int64), 0, tw - 2)
            y0 = np.clip(ty.astype(np.int64), 0, th - 2)
            ax = (tx - x0)[:, None]
            ay = (ty - y0)[:, None]
            c = (
                tex[y0, x0] * (1 - ax) * (1 - ay)
                + tex[y0, x0 + 1] * ax * (1 - ay)
                + tex[y0 + 1, x0] * (1 - ax) * ay
                + tex[y0 + 1, x0 + 1] * ax * ay
            )
            img[hit] = c
            # z-depth in the camera frame equals lam (ray z-component is 1
            # in camera coordinates)
            depth[hit] = lam[hit].astype(np.float32)
            todo &= ~hit
        return np.clip(img, 0, 255).astype(np.uint8), depth


def make_trajectory(rng: np.random.Generator, n_frames: int,
                    t_step: float = 0.9, r_step: float = 0.05) -> np.ndarray:
    """Smooth random-walk camera trajectory, c2w 7-vec (t, q)."""
    poses = np.zeros((n_frames, 7), np.float32)
    poses[0, 6] = 1.0
    t = np.zeros(3)
    q = np.asarray([0.0, 0.0, 0.0, 1.0])
    vel = rng.normal(size=3) * t_step
    rot_vel = rng.normal(size=3) * r_step
    for k in range(1, n_frames):
        vel = 0.8 * vel + 0.3 * rng.normal(size=3) * t_step
        rot_vel = 0.8 * rot_vel + 0.3 * rng.normal(size=3) * r_step
        # keep z motion moderate so billboards stay in front
        step = vel * np.asarray([1.0, 0.7, 0.35])
        t = t + step
        t = np.clip(t, -1.6, 1.6)
        q = _quat_mul(q, _exp_so3(rot_vel))
        q = q / np.linalg.norm(q)
        poses[k, :3] = t
        poses[k, 3:] = q
    return poses


def render_clip(seed: int, n_frames: int, H: int = 96, W: int = 128,
                t_step: float = 0.9, r_step: float = 0.05,
                scene: SyntheticScene | None = None):
    """Render a full clip: (images [n,H,W,3] u8, poses_c2w [n,7],
    depths [n,H,W], intrinsics [n,4]).  Matches the ClipDataset item
    contract (data/base.py) with TartanAir-like scale statistics."""
    rng = np.random.default_rng(seed)
    scene = scene or SyntheticScene(seed=seed)
    intr = np.asarray([0.9 * W, 0.9 * W, W / 2.0, H / 2.0], np.float32)
    poses = make_trajectory(rng, n_frames, t_step, r_step)
    images = np.zeros((n_frames, H, W, 3), np.uint8)
    depths = np.zeros((n_frames, H, W), np.float32)
    for k in range(n_frames):
        images[k], depths[k] = scene.render(poses[k], intr, H, W)
    intrinsics = np.broadcast_to(intr, (n_frames, 4)).copy()
    return images, poses, depths, intrinsics


class SyntheticDataset:
    """ClipDataset-compatible synthetic training set.

    Items are n-frame windows of pre-rendered random-walk clips; poses are
    camera-to-world (the training step inverts them — train.py:112
    convention), depths are exact z-depths, scale-normalized to median
    depth 1 like data/base.py:137-148."""

    def __init__(self, n_scenes: int = 12, frames_per_scene: int = 24,
                 n_frames: int = 4, crop_size=(96, 128), seed: int = 0):
        self.n_frames = n_frames
        H, W = crop_size
        self.clips = []
        for s in range(n_scenes):
            self.clips.append(
                render_clip(seed + 1000 * s, frames_per_scene, H, W)
            )
        self.items = [
            (c, i)
            for c in range(n_scenes)
            for i in range(frames_per_scene - n_frames + 1)
        ]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        c, i = self.items[index % len(self.items)]
        images, poses, depths, intr = self.clips[c]
        sl = slice(i, i + self.n_frames)
        images = images[sl].copy()
        poses = poses[sl].copy()
        depths = depths[sl].copy()
        intr = intr[sl].copy()
        # scale normalization: median depth -> 1 (base.py:137-148)
        s = float(np.median(depths[depths > 0.01]))
        depths = depths / s
        poses[:, :3] = poses[:, :3] / s
        return images, poses, depths, intr
