"""The plain reference at tiny size on the CPU: where the program runs in
float32 it agrees with the reference to rounding in every cell, and the
reference's pieces match their definitions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED, tiny
from perfbench.harness import core
from perfbench.reference.precision import rnd

# the program in float32 against the reference: rounding apart (the
# backend's one DBA solve amplifies the encoders' last bits ~1000-fold)
# (tracking's pose and disparity numbers are in units of the stated-
# precision reference's gap, which in float32 is nil: the unit is then its
# floor, 1e-3, and 0.1 of it is a gap of 1e-4)
AGREE = {"eth3d_rgbd.track": {"pose_ratio": 0.1, "disp_ratio": 0.1,
                              "feature_gap": 1e-4},
         "eth3d_rgbd.global_ba": 5e-3, "train_384x512.step": 1e-5}


@pytest.mark.parametrize("cell", sorted(AGREE))
def test_program_in_fp32_agrees_with_the_reference(cell):
    r = core.run_cell(cell, SEED, 0.2, False, device="cpu",
                      scale=tiny(cell, fp32=True), root=ROOT)
    assert r["correct"]
    for name, c in r["checks"].items():
        agree = AGREE[cell]
        limit = agree[name] if isinstance(agree, dict) else agree
        assert c["value"] <= limit, (name, c["value"])


def test_rounding_emulation():
    x = torch.tensor([1.0, 1.0 + 2 ** -9, 1000.0, -1e6, float("nan")])
    assert torch.equal(rnd(x[:4], "float32"), x[:4])
    assert rnd(x, "bfloat16")[1] == 1.0  # below bf16's 8 bits
    f8 = rnd(x, "float8_e4m3fn")
    assert f8[2] == 448.0 and f8[3] == -448.0  # saturates
    assert torch.isnan(f8[4])
    assert torch.equal(rnd(x[:2], torch.float8_e4m3fn), torch.ones(2))


def test_planner_is_the_ports_plain_planner():
    from lgu_slam_tpu_torch.utils.native import proximity_plan_plain
    from perfbench.reference.slam.planner import proximity_plan
    rng = np.random.default_rng(0)
    t, t0, t1 = 12, 3, 1
    ii, jj = np.meshgrid(np.arange(t0, t), np.arange(t1, t), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    for _ in range(5):
        d = rng.uniform(0, 30, ii.size).astype(np.float32)
        ex = rng.integers(0, t, (2, 6))
        args = (d, ii, jj, ex[0], ex[1], t0, t1, t, 2, 1, 16.0, 24, False)
        assert np.array_equal(proximity_plan(*args),
                              proximity_plan_plain(*args))
