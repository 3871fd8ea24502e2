"""Photometric + spatial augmentation for training clips (port of the JAX
package's ``data/augmentation.py``): the same ``default_rng(seed)`` draws
in the same order, so that a seed gives the JAX package's output bit for
bit."""

from __future__ import annotations

import numpy as np


class RGBDAugmentor:
    def __init__(self, crop_size=(384, 512), seed=0):
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)

    def _color(self, images):
        """brightness/contrast/saturation jitter + random channel swap."""
        imgs = images.astype(np.float32)
        b = self.rng.uniform(0.8, 1.2)
        c = self.rng.uniform(0.8, 1.2)
        mean = imgs.mean(axis=(1, 2, 3), keepdims=True)
        imgs = (imgs - mean) * c + mean * b
        if self.rng.random() < 0.5:
            perm = self.rng.permutation(3)
            imgs = imgs[..., perm]
        return np.clip(imgs, 0, 255).astype(np.uint8)

    def __call__(self, images, poses, depths, intrinsics):
        images = self._color(images)

        # random scaled crop (augmentation.py:33-55)
        H, W = self.crop_size
        n, h0, w0 = images.shape[:3]
        if h0 > H and w0 > W:
            y0 = int(self.rng.integers(0, h0 - H + 1))
            x0 = int(self.rng.integers(0, w0 - W + 1))
            images = images[:, y0 : y0 + H, x0 : x0 + W]
            depths = depths[:, y0 : y0 + H, x0 : x0 + W]
            intrinsics = intrinsics - np.asarray([0, 0, x0, y0], np.float32)

        # horizontal flip
        if self.rng.random() < 0.5:
            images = images[:, :, ::-1].copy()
            depths = depths[:, :, ::-1].copy()
            intrinsics = intrinsics * np.asarray([1, 1, -1, 1], np.float32)
            intrinsics = intrinsics + np.asarray(
                [0, 0, images.shape[2] - 1, 0], np.float32
            )
        return images, poses, depths, intrinsics
