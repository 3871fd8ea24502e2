"""The check against faults planted in the timed path, and the control.

Each cell runs tiny on the CPU with the program in float32 (where a sound
run agrees with the reference to rounding) and the cell's committed limits:
sound, it is correct; with each fault the cell can have planted under the
harness (a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced) it is not.  One chip has no
exchange between chips to leave out.  The control, the reference at the
precision below the configuration's in the program's place, comes out not
correct too; the training cell's control (TF32) needs the card.
"""

from __future__ import annotations

import pytest
import torch

from conftest import ROOT, SEED, tiny
from perfbench.harness import core


def run(cell, impl="program", fp32=True, device="cpu", root=ROOT):
    return core.run_cell(cell, SEED, 0.2, False, device=device, impl=impl,
                         scale=tiny(cell, fp32=fp32), root=root)


@pytest.mark.parametrize("cell", ["eth3d_rgbd.track", "eth3d_rgbd.global_ba",
                                  "train_384x512.step"])
def test_sound_runs_are_correct(cell):
    assert run(cell)["correct"]


# -- tracking -----------------------------------------------------------------

def test_track_state_unchanged(monkeypatch):
    from lgu_slam_tpu_torch.slam.system import LGUSlam
    monkeypatch.setattr(LGUSlam, "track", lambda self, *a, **k: None)
    assert not run("eth3d_rgbd.track")["correct"]


def test_track_answer_altered(monkeypatch):
    from lgu_slam_tpu_torch.slam.frontend import Frontend
    orig = Frontend.__call__

    def moved(self):
        orig(self)
        if self.is_initialized:  # the newest keyframe's pose, off by 1 cm
            self.video.poses[self.t1 - 1, 0] += 0.01

    monkeypatch.setattr(Frontend, "__call__", moved)
    assert not run("eth3d_rgbd.track")["correct"]


def test_track_plan_altered(monkeypatch):
    """The initialising call's proximity plan, altered where it is made:
    one more edge than the planner chose."""
    from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
    orig = FactorGraph.add_proximity_factors

    def more(self, *a, **k):
        orig(self, *a, **k)
        t = self.video.counter
        self.add_factors([t - 1], [0])

    monkeypatch.setattr(FactorGraph, "add_proximity_factors", more)
    r = run("eth3d_rgbd.track")
    assert not r["correct"]
    assert r["checks"]["pose_ratio"]["value"] == float("inf")


# -- the global bundle adjustment ---------------------------------------------

def test_ba_state_unchanged(monkeypatch):
    from lgu_slam_tpu_torch.slam.backend import Backend
    orig = Backend.__call__
    first = []

    def skip(self, steps=12):  # the warm pass plans; the rest do nothing
        if not first:
            first.append(1)
            return orig(self, steps)

    monkeypatch.setattr(Backend, "__call__", skip)
    assert not run("eth3d_rgbd.global_ba")["correct"]


def test_ba_half_the_edges_left_out(monkeypatch):
    import numpy as np
    from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
    orig = FactorGraph.update_lowmem

    def half(self, *a, **k):
        n = self.n_edges
        self.rm_factors(np.arange(n) >= n // 2, store=False)
        return orig(self, *a, **k)

    monkeypatch.setattr(FactorGraph, "update_lowmem", half)
    assert not run("eth3d_rgbd.global_ba")["correct"]


def test_ba_answer_altered(monkeypatch):
    from lgu_slam_tpu_torch.slam.backend import Backend
    orig = Backend.__call__

    def moved(self, steps=12):
        orig(self, steps)
        self.video.disps[: self.video.counter] *= 1.01

    monkeypatch.setattr(Backend, "__call__", moved)
    assert not run("eth3d_rgbd.global_ba")["correct"]


# -- training -----------------------------------------------------------------

def test_train_state_unchanged(monkeypatch):
    from lgu_slam_tpu_torch.parallel import train_dp

    def no_step(model, opt, batch, Gs0, disp0, *, cfg, ii, jj):
        total, metrics, carry = train_dp.loss_fn(model, batch, Gs0, disp0,
                                                 cfg=cfg, ii=ii, jj=jj)
        return metrics, carry

    monkeypatch.setattr(train_dp, "train_step", no_step)
    r = run("train_384x512.step")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(monkeypatch):
    from lgu_slam_tpu_torch.parallel import train_dp
    orig = train_dp.loss_fn

    def half(model, batch, Gs0, disp0, *, cfg, ii, jj):
        n = batch[0].shape[0] // 2
        return orig(model, tuple(x[:n] for x in batch), Gs0[:n], disp0[:n],
                    cfg=cfg, ii=ii, jj=jj)

    monkeypatch.setattr(train_dp, "loss_fn", half)
    assert not run("train_384x512.step")["correct"]


def test_train_answer_altered(monkeypatch):
    from lgu_slam_tpu_torch.parallel.train_dp import OneCycleAdamW
    orig = OneCycleAdamW.step

    def twice(self):  # each leaf moved double
        before = [p.detach().clone() for p in self.params]
        orig(self)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.add_(p - b)

    monkeypatch.setattr(OneCycleAdamW, "step", twice)
    assert not run("train_384x512.step")["correct"]


# -- the control ----------------------------------------------------------------

@pytest.mark.parametrize("cell", ["eth3d_rgbd.track", "eth3d_rgbd.global_ba"])
def test_control_is_not_correct(cell):
    r = run(cell, impl="control", fp32=False)
    assert not r["correct"]


@pytest.mark.cuda
def test_train_control_is_not_correct(cuda_device):
    r = run("train_384x512.step", impl="control", device=cuda_device)
    assert not r["correct"]
