"""TSDF fusion + mesh extraction (port of the JAX package's ``gs/tsdf.py``;
reference: to3DGS/pc2mesh.py -- renders each frame's RGB-D from the trained
Gaussians and integrates it into an Open3D ScalableTSDFVolume, then
extracts a triangle mesh).

Open3D is not used: a dense voxel TSDF is integrated on the device, and the
mesh comes from marching *tetrahedra* on the host (six tetrahedra per voxel
cube -- no 256-case tables, a watertight triangulation of the zero level
set)."""

from __future__ import annotations

import numpy as np
import torch

from lgu_slam_tpu_torch.utils.device import resolve_device, to_device


class TSDFVolume:
    """A dense TSDF grid on ``device`` (the card unless the caller passes
    another): tsdf, weight and color per voxel, and the voxel centres."""

    def __init__(self, bounds_min, bounds_max, voxel_size=0.02,
                 trunc=0.08, device=None):
        self.device = resolve_device(device)
        self.origin = np.asarray(bounds_min, np.float32)
        self.voxel = float(voxel_size)
        self.trunc = float(trunc)
        dims = np.ceil(
            (np.asarray(bounds_max) - self.origin) / voxel_size
        ).astype(int) + 1
        self.dims = tuple(int(d) for d in dims)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.tsdf = torch.ones(self.dims, **f32)
        self.weight = torch.zeros(self.dims, **f32)
        self.color = torch.zeros(self.dims + (3,), **f32)

        ii, jj, kk = np.meshgrid(
            np.arange(self.dims[0]), np.arange(self.dims[1]),
            np.arange(self.dims[2]), indexing="ij",
        )
        self._pts = torch.as_tensor(
            (np.stack([ii, jj, kk], -1).reshape(-1, 3) * self.voxel
             + self.origin).astype(np.float32),
            device=self.device,
        )

    def integrate(self, depth, color, intr, w2c_rot, w2c_trans):
        """Fuse one RGB-D frame (depth [H,W], color [H,W,3] in [0,1])."""
        self.tsdf, self.weight, self.color = _integrate(
            self.tsdf, self.weight, self.color, self._pts,
            *(to_device(x, self.device)
              for x in (depth, color, intr, w2c_rot, w2c_trans)),
            self.trunc,
        )

    def extract_mesh(self):
        """Marching tetrahedra over the fused volume.

        Returns (vertices [V,3], colors [V,3], triangles [T,3])."""
        return marching_tetrahedra(
            self.tsdf.cpu().numpy(), self.weight.cpu().numpy(),
            self.color.cpu().numpy(), self.origin, self.voxel,
        )


def _integrate(tsdf, weight, color, pts, depth, im, intr, R, t, trunc):
    H, W = depth.shape
    fx, fy, cx, cy = intr.unbind()
    cam = pts @ R.T + t
    z = cam[:, 2]
    u = fx * cam[:, 0] / torch.clamp(z, min=1e-6) + cx
    v = fy * cam[:, 1] / torch.clamp(z, min=1e-6) + cy
    # torch.round rounds half to even, as jnp.round does
    ui = torch.round(u).long()
    vi = torch.round(v).long()
    inb = (z > 0.05) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    ui = torch.clamp(ui, 0, W - 1)
    vi = torch.clamp(vi, 0, H - 1)
    d = depth[vi, ui]
    c = im[vi, ui]
    sdf = d - z
    valid = inb & (d > 0) & (sdf > -trunc)
    tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0)

    w_old = weight.reshape(-1)
    t_old = tsdf.reshape(-1)
    c_old = color.reshape(-1, 3)
    w_add = valid.to(torch.float32)
    w_new = w_old + w_add
    t_upd = (t_old * w_old + tsdf_new * w_add) / torch.clamp(w_new, min=1e-6)
    c_upd = (c_old * w_old[:, None] + c * w_add[:, None]) / torch.clamp(
        w_new, min=1e-6
    )[:, None]
    t_out = torch.where(valid, t_upd, t_old)
    c_out = torch.where(valid[:, None], c_upd, c_old)
    w_out = torch.where(valid, w_new, w_old)
    return (
        t_out.reshape(tsdf.shape),
        w_out.reshape(weight.shape),
        c_out.reshape(color.shape),
    )


# six tetrahedra per cube (corner indices into the 8 cube corners)
_TETS = np.asarray(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)
_CORNERS = np.asarray(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ]
)


# marching-tetrahedra case table: code (bitmask of corners with value < 0)
# -> flat list of tet-edge ids forming triangles (groups of 3).
# edges: 0:(0,1) 1:(0,2) 2:(0,3) 3:(1,2) 4:(1,3) 5:(2,3)
_TET_CASES = {
    1: [0, 1, 2],
    2: [0, 3, 4],
    4: [1, 3, 5],
    8: [2, 4, 5],
    14: [0, 2, 1],
    13: [0, 4, 3],
    11: [1, 5, 3],
    7: [2, 5, 4],
    # two-inside: quad split into two triangles (cyclically ordered edges)
    3: [1, 3, 4, 1, 4, 2],
    5: [0, 3, 5, 0, 5, 2],
    9: [0, 4, 5, 0, 5, 1],
    6: [0, 1, 5, 0, 5, 4],
    10: [0, 3, 5, 0, 5, 2],
    12: [1, 3, 4, 1, 4, 2],
}


def marching_tetrahedra(tsdf, weight, color, origin, voxel):
    """Zero level set of the TSDF as triangles (numpy, host-side).

    Vertices are emitted per triangle (no dedup); adequate for export.
    Returns (vertices [V,3], colors [V,3], triangles [T,3]).
    """
    D0, D1, D2 = tsdf.shape
    observed = weight > 0

    def corner(arr, c):
        return arr[c[0]:D0 - 1 + c[0], c[1]:D1 - 1 + c[1], c[2]:D2 - 1 + c[2]]

    vals = np.stack([corner(tsdf, c) for c in _CORNERS], -1)
    obs = np.stack([corner(observed, c) for c in _CORNERS], -1).all(-1)
    cols = np.stack([corner(color, c) for c in _CORNERS], -2)

    # inside = value < 0; a cube crosses the surface when it has corners on
    # both sides (>= 0 counts as outside so exact zeros don't drop cubes)
    inside_all = vals < 0
    crossing = obs & inside_all.any(-1) & (~inside_all).any(-1)
    idx = np.argwhere(crossing)
    if len(idx) == 0:
        return (np.zeros((0, 3)), np.zeros((0, 3)),
                np.zeros((0, 3), np.int64))

    base = idx.astype(np.float32) * voxel + origin
    cvals = vals[crossing]  # [M, 8]
    ccols = cols[crossing]  # [M, 8, 3]
    corner_pos = base[:, None, :] + _CORNERS[None] * voxel  # [M, 8, 3]

    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    v_out, c_out = [], []

    for tet in _TETS:
        tv = cvals[:, tet]  # [M, 4]
        tp = corner_pos[:, tet]  # [M, 4, 3]
        tc = ccols[:, tet]
        inside = tv < 0
        code = (
            inside[:, 0].astype(int)
            + 2 * inside[:, 1]
            + 4 * inside[:, 2]
            + 8 * inside[:, 3]
        )

        for bits, tri_edges in _TET_CASES.items():
            m = code == bits
            if not m.any():
                continue
            tri_pts, tri_cols = [], []
            for e in tri_edges:
                a, b = edges[e]
                va, vb = tv[m, a], tv[m, b]
                t = va / np.where(
                    np.abs(va - vb) < 1e-12, 1e-12, va - vb
                )
                tri_pts.append(tp[m, a] + t[:, None] * (tp[m, b] - tp[m, a]))
                tri_cols.append(tc[m, a] + t[:, None] * (tc[m, b] - tc[m, a]))
            # groups of 3 edge-verts = one triangle; interleave per cube
            k = len(tri_edges) // 3
            P = np.stack(tri_pts, 1).reshape(-1, 3)  # [m*3k, 3] cube-major
            C = np.stack(tri_cols, 1).reshape(-1, 3)
            v_out.append(P)
            c_out.append(C)

    V = np.concatenate(v_out, 0)
    C = np.concatenate(c_out, 0)
    T = np.arange(len(V), dtype=np.int64).reshape(-1, 3)
    return V, C, T


def write_mesh_ply(path, vertices, colors, triangles):
    """Binary PLY mesh writer."""
    n, t = len(vertices), len(triangles)
    with open(path, "wb") as f:
        header = [
            "ply", "format binary_little_endian 1.0",
            f"element vertex {n}",
            "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green",
            "property uchar blue",
            f"element face {t}",
            "property list uchar int vertex_indices",
            "end_header",
        ]
        f.write(("\n".join(header) + "\n").encode())
        rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = vertices
        rec["rgb"] = np.clip(colors * 255, 0, 255).astype(np.uint8)
        f.write(rec.tobytes())
        face = np.zeros(t, dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face["n"] = 3
        face["idx"] = triangles
        f.write(face.tobytes())
