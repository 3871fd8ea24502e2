"""The traffic generator at tiny shapes on the CPU: closed loops, scenes
that cover every ray, the same inputs from the same seed, the layout that a
mix fixes, and each driver's inputs."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED
from perfbench.harness.drivers.track import render_loop
from perfbench.harness.drivers.train import render_pool
from perfbench.harness.scene import (
    Scene,
    loop_poses,
    pinhole,
    quat_to_mat,
    se3_inv,
    walk_poses,
)


def traffic(name):
    return json.loads((ROOT / f"perfbench/traffic/{name}.json").read_text())


def test_loop_closes_and_laps_shift():
    p = loop_poses(12, laps=2, lap_shift=(0.0, 0.1, 0.2))
    assert p.shape == (24, 7)
    assert torch.allclose(p[12, :3] - p[0, :3], torch.tensor([0.0, 0.1, 0.2]))
    assert torch.allclose(p[12, 3:], p[0, 3:])
    assert torch.allclose(p[:, 3:].norm(dim=-1), torch.ones(24))
    steps = (p[1:12, :3] - p[:11, :3]).norm(dim=-1)
    assert steps.min() > 0  # the camera moves every frame


def test_walk_starts_at_the_identity():
    g = torch.Generator().manual_seed(SEED)
    p = walk_poses(g, 5)
    assert torch.equal(p[0], torch.tensor([0.0] * 6 + [1.0]))
    assert torch.allclose(p[:, 3:].norm(dim=-1), torch.ones(5), atol=1e-6)
    assert p[:, :3].abs().max() <= 1.6


def test_se3_inv():
    p = loop_poses(8)
    q = se3_inv(se3_inv(p))
    assert torch.allclose(q, p, atol=1e-6)
    inv = se3_inv(p)
    R = quat_to_mat(p[:, 3:])
    t = (R @ inv[:, :3, None])[..., 0] + p[:, :3]
    assert t.abs().max() < 1e-6


def render(seed, layout=None):
    g = torch.Generator().manual_seed(seed)
    lay = None if layout is None else torch.Generator().manual_seed(layout)
    scene = Scene(g, "cpu", n_planes=3, tex_res=32, layout=lay)
    return scene.planes, scene.render(loop_poses(4), pinhole(24, 32, 0.9),
                                      24, 32)


def test_scene_covers_every_ray_and_repeats_with_its_seed():
    planes, (img, depth) = render(SEED)
    assert img.dtype == torch.uint8 and img.shape == (4, 24, 32, 3)
    assert (depth > 0).all() and depth.max() <= 14.0 + 1.0
    _, (img2, depth2) = render(SEED)
    assert torch.equal(img, img2) and torch.equal(depth, depth2)
    planes3, (img3, _) = render(SEED + 1)
    assert not torch.equal(img, img3) and planes3 != planes


def test_a_fixed_layout_keeps_the_geometry():
    p1, (img1, d1) = render(SEED, layout=7)
    p2, (img2, d2) = render(SEED + 1, layout=7)
    assert p1 == p2 and torch.equal(d1, d2)
    assert not torch.equal(img1, img2)


def test_track_and_ba_frames():
    t = dict(traffic("loop96"), planes=3)
    t["loop"] = dict(t["loop"], frames=6)
    imgs, depths, intr, poses = render_loop(t, 16, 24, SEED, "cpu")
    assert imgs.shape == (6, 16, 24, 3) and imgs.dtype == np.uint8
    assert depths.shape == (6, 16, 24) and (depths > 0).all()
    assert intr.tolist() == pytest.approx([0.9 * 24, 0.9 * 24, 12.0, 8.0])
    b = dict(traffic("loop64x2_ba"), planes=3)
    b["loop"] = dict(b["loop"], frames=4)
    imgs, _, _, poses = render_loop(b, 16, 24, SEED, "cpu")
    assert imgs.shape[0] == 8 and poses.shape == (8, 7)


def test_train_pool():
    t = dict(traffic("clips4"), planes=3, pool=2)
    cfg = {"image_size": [16, 24], "batch": 2, "n_frames": 3}
    pool = render_pool(t, cfg, SEED, "cpu")
    assert len(pool) == 2
    images, poses, disps, intr = pool[0]
    assert images.shape == (2, 3, 16, 24, 3) and poses.shape == (2, 3, 7)
    assert disps.shape == (2, 3, 16, 24) and intr.shape == (2, 3, 4)
    # depths are normalised to median 1
    for b in range(2):
        d = 1.0 / disps[b][disps[b] > 0]
        assert float(d.median()) == pytest.approx(1.0, rel=0.05)
    assert not torch.equal(pool[0][0], pool[1][0])  # rows all differ
