"""Seeded billboard scenes rendered on the device: the traffic generator.

A scene is a set of textured fronto-parallel billboards at staggered depths
in front of a far background plane that covers every ray, rendered by exact
ray-plane intersection (the scene model of the port's ``data/synthetic.py``,
written in PyTorch so that frames are made on the card from the seed).  A
render gives BGR images, z-depth maps and the camera poses that made them,
so every pixel has a sensed depth and the poses are exact.

Poses are camera-to-world 7-vectors (t, q) with q = (x, y, z, w); the
camera looks along +z, towards the billboards.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BACKGROUND_Z = 14.0


def _texture(gen, n: int, res: int, device) -> torch.Tensor:
    """``n`` smooth textures [n, res, res, 3] in [0, 255]: uniform noise at
    four scales, blurred twice by a 5-point stencil."""
    tex = torch.zeros(n, 3, res, res, device=device)
    for scale in (4, 8, 16, 32):
        c = max(res // scale, 2)
        coarse = torch.rand(n, 3, c, c, generator=gen, device=device)
        tex += F.interpolate(coarse, size=(res, res), mode="nearest")
    for _ in range(2):
        tex = (tex + tex.roll(1, 2) + tex.roll(-1, 2) + tex.roll(1, 3)
               + tex.roll(-1, 3)) / 5.0
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    tex = tex - lo
    tex = tex * (255.0 / tex.amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6))
    return tex.permute(0, 2, 3, 1).contiguous()


class Scene:
    """``n_planes`` billboards between z = 3 and z = 10 and the background
    at z = 14, their textures drawn from ``gen`` (a ``torch.Generator`` on
    ``device``), their placement from ``layout`` (another generator) or,
    without it, from ``gen`` first."""

    def __init__(self, gen, device, n_planes: int = 7, tex_res: int = 256,
                 layout=None):
        place = gen if layout is None else layout
        u = torch.rand(n_planes, 4, generator=place,
                       device=place.device).cpu()
        planes = []
        for k in range(n_planes):
            z = 3.0 + 7.0 * k / max(n_planes - 1, 1) + 0.8 * (u[k, 0] - 0.5)
            half = (1.2 + 1.8 * u[k, 1]) * z / 4.0
            cx = (u[k, 2] - 0.5) * z
            cy = 0.8 * (u[k, 3] - 0.5) * z
            planes.append((float(z), float(cx - half), float(cx + half),
                           float(cy - half), float(cy + half)))
        zb = BACKGROUND_Z
        planes.append((zb, -6 * zb, 6 * zb, -6 * zb, 6 * zb))
        order = sorted(range(len(planes)), key=lambda i: planes[i][0])
        self.planes = [planes[i] for i in order]
        tex = _texture(gen, n_planes, tex_res, device)
        back = _texture(gen, 1, 2 * tex_res, device)[0]
        textures = list(tex) + [back]
        self.textures = [textures[i] for i in order]
        self.device = device

    def render(self, poses_c2w: torch.Tensor, intrinsics, H: int, W: int):
        """poses [n, 7] -> (images [n, H, W, 3] uint8 BGR, depth [n, H, W]
        float32 z-depth)."""
        dev = self.device
        poses = poses_c2w.to(dev, torch.float32)
        n = poses.shape[0]
        fx, fy, cx, cy = (float(v) for v in intrinsics)
        v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                              torch.arange(W, device=dev, dtype=torch.float32),
                              indexing="ij")
        d_c = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)],
                          -1)
        R = quat_to_mat(poses[:, 3:])  # [n, 3, 3]
        d_w = torch.einsum("hwk,nrk->nhwr", d_c, R)
        o = poses[:, None, None, :3]
        img = torch.zeros(n, H, W, 3, device=dev)
        depth = torch.zeros(n, H, W, device=dev)
        todo = torch.ones(n, H, W, dtype=torch.bool, device=dev)
        dz = d_w[..., 2]
        for (z, x0, x1, y0, y1), tex in zip(self.planes, self.textures):
            lam = (z - o[..., 2]) / torch.where(dz.abs() > 1e-9, dz,
                                                torch.ones_like(dz))
            px = o[..., 0] + lam * d_w[..., 0]
            py = o[..., 1] + lam * d_w[..., 1]
            hit = (todo & (dz.abs() > 1e-9) & (lam > 0.2) & (px >= x0)
                   & (px < x1) & (py >= y0) & (py < y1))
            th, tw = tex.shape[:2]
            tx = ((px - x0) / (x1 - x0) * (tw - 1)).clamp(0, tw - 1)
            ty = ((py - y0) / (y1 - y0) * (th - 1)).clamp(0, th - 1)
            ix = tx.long().clamp(0, tw - 2)
            iy = ty.long().clamp(0, th - 2)
            ax = (tx - ix)[..., None]
            ay = (ty - iy)[..., None]
            c = (tex[iy, ix] * (1 - ax) * (1 - ay)
                 + tex[iy, ix + 1] * ax * (1 - ay)
                 + tex[iy + 1, ix] * (1 - ax) * ay
                 + tex[iy + 1, ix + 1] * ax * ay)
            img = torch.where(hit[..., None], c, img)
            depth = torch.where(hit, lam, depth)
            todo = todo & ~hit
        return img.clamp(0, 255).to(torch.uint8), depth


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions [..., 4] (x, y, z, w) -> rotations [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def _euler_quat(yaw, pitch, roll) -> np.ndarray:
    """Rotation about y (yaw), then x (pitch), then z (roll) -> (x, y, z, w)."""
    def axis(a, k):
        q = np.zeros(4)
        q[k] = math.sin(a / 2.0)
        q[3] = math.cos(a / 2.0)
        return q
    return _quat_mul(_quat_mul(axis(yaw, 1), axis(pitch, 0)), axis(roll, 2))


def _quat_mul(a, b) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.asarray([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def loop_poses(frames: int, laps: int = 1, radius=(0.5, 0.35),
               z_amp: float = 0.15, yaw: float = 0.08, pitch: float = 0.05,
               lap_shift=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """A closed camera loop of ``frames`` poses, travelled ``laps`` times,
    each lap moved by ``lap_shift``: an ellipse in x-y of ``radius``, a
    z swing of ``z_amp`` at twice the rate, yaw and pitch swinging by
    ``yaw`` / ``pitch`` radians.  Returns camera-to-world [laps*frames, 7];
    the shape is the same for every seed."""
    out = np.zeros((laps * frames, 7))
    for k in range(laps * frames):
        lap, th = divmod(k, frames)
        th = 2.0 * math.pi * th / frames
        t = np.asarray([radius[0] * (math.cos(th) - 1.0),
                        radius[1] * math.sin(th),
                        z_amp * math.sin(2.0 * th)])
        out[k, :3] = t + lap * np.asarray(lap_shift)
        out[k, 3:] = _euler_quat(yaw * math.sin(th), pitch * math.cos(th),
                                 0.0)
    return torch.as_tensor(out, dtype=torch.float32)


def walk_poses(gen, frames: int, t_step: float = 0.9,
               r_step: float = 0.05) -> torch.Tensor:
    """The training clips' smooth random walk (``data/synthetic.py``'s
    ``make_trajectory``), its normal draws from ``gen``: camera-to-world
    [frames, 7], starting at the identity."""
    z = torch.randn(2 + 2 * frames, 3, generator=gen,
                    device=gen.device).double().cpu().numpy()
    poses = np.zeros((frames, 7))
    poses[0, 6] = 1.0
    t = np.zeros(3)
    q = np.asarray([0.0, 0.0, 0.0, 1.0])
    vel, rot = z[0] * t_step, z[1] * r_step
    for k in range(1, frames):
        vel = 0.8 * vel + 0.3 * z[2 * k] * t_step
        rot = 0.8 * rot + 0.3 * z[2 * k + 1] * r_step
        t = np.clip(t + vel * np.asarray([1.0, 0.7, 0.35]), -1.6, 1.6)
        th = np.linalg.norm(rot)
        dq = (np.asarray([0.0, 0.0, 0.0, 1.0]) if th < 1e-12 else
              np.concatenate([rot / th * math.sin(th / 2), [math.cos(th / 2)]]))
        q = _quat_mul(q, dq)
        q = q / np.linalg.norm(q)
        poses[k, :3] = t
        poses[k, 3:] = q
    return torch.as_tensor(poses, dtype=torch.float32)


def pinhole(H: int, W: int, focal: float) -> np.ndarray:
    """Intrinsics (fx, fy, cx, cy) with focal length ``focal * W``."""
    return np.asarray([focal * W, focal * W, W / 2.0, H / 2.0], np.float32)


def se3_inv(poses: torch.Tensor) -> torch.Tensor:
    """Inverse of (t, q) poses [..., 7]."""
    t, q = poses[..., :3], poses[..., 3:]
    qi = torch.cat([-q[..., :3], q[..., 3:]], -1)
    R = quat_to_mat(qi)
    return torch.cat([-(R @ t[..., None])[..., 0], qi], -1)
