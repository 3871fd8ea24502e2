"""Synthetic camera frames for smoke runs and profiles of ``LGUSlam.track``."""

from __future__ import annotations

import numpy as np


def shifted_texture_frames(n: int, H: int, W: int, seed: int):
    """``n`` frames of a smoothed random texture under a steady diagonal
    shift, as ``(t, image [H, W, 3] uint8, intrinsics [4] float32)``."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(H + 3 * n, W + 2 * n, 3))
    base = base.astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
            + np.roll(base, 2, 0)) / 4.0
    intr = np.asarray([W * 0.8, W * 0.8, W / 2, H / 2], np.float32)
    for t in range(n):
        yield t, base[3 * t:3 * t + H, 2 * t:2 * t + W].astype(np.uint8), intr
