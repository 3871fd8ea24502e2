"""Keyframe selection for the mapping window (port of the JAX package's
``gs/keyframes.py``, numpy on the host; reference:
to3DGS/utils/keyframe_selection.py ``keyframe_selection_overlap``): sample
pixels with valid depth in the current frame, back-project, reproject into
candidate keyframes, and rank by in-frustum overlap percentage."""

from __future__ import annotations

import numpy as np


def keyframe_selection_overlap(depth, w2c_rot, w2c_trans, intr, keyframes,
                               k=8, n_samples=1600, edge=20, rng=None):
    """depth [H,W]; keyframes: list of dicts with 'w2c_rot', 'w2c_trans',
    'id'.  Returns the ids of the k keyframes with highest overlap."""
    rng = rng or np.random.default_rng(0)
    H, W = depth.shape
    fx, fy, cx, cy = intr

    ys, xs = np.nonzero(depth > 0)
    if len(ys) == 0:
        return [kf["id"] for kf in keyframes[:k]]
    sel = rng.integers(0, len(ys), size=min(n_samples, len(ys)))
    ys, xs = ys[sel], xs[sel]
    z = depth[ys, xs]

    # back-project to world
    X = (xs + 0.5 - cx) / fx * z
    Y = (ys + 0.5 - cy) / fy * z
    pts_cam = np.stack([X, Y, z], -1)
    c2w_rot = np.asarray(w2c_rot).T
    c2w_t = -c2w_rot @ np.asarray(w2c_trans)
    pts_world = pts_cam @ c2w_rot.T + c2w_t

    scored = []
    for kf in keyframes:
        R = np.asarray(kf["w2c_rot"])
        t = np.asarray(kf["w2c_trans"])
        cam = pts_world @ R.T + t
        zc = cam[:, 2]
        ok = zc > 0.01
        u = fx * cam[:, 0] / np.maximum(zc, 1e-6) + cx
        v = fy * cam[:, 1] / np.maximum(zc, 1e-6) + cy
        inside = ok & (u >= edge) & (u < W - edge) & (v >= edge) & (
            v < H - edge
        )
        scored.append((float(inside.mean()), kf["id"]))
    scored.sort(key=lambda s: -s[0])
    return [sid for _, sid in scored[:k]]
