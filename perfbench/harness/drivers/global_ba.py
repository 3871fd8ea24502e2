"""The global pass of ``terminate()``: ``Backend.__call__`` over a video of
keyframes that loops, with no frontend and no K1.

Set-up renders a loop travelled ``laps`` times (each lap shifted a little,
so that proximity finds near revisits) on the device, appends every frame
through ``MotionFilter.track`` (the encoders; every frame a keyframe),
writes the loop's true poses and sensed disparities as the tracked state
and keeps a copy of it.  Each call of the window restores that state and
runs one backend pass, so every pass plans the same graph: up to 16 edges
per keyframe, updated in chunks of ``backend_chunk`` edges.  A call's work
is its edges x steps / 128.

The check: once the window has closed, the reference appends the same
frames with its own encoders, takes the same state and runs the same pass;
the poses' and disparities' gaps are shares of the reference's own change
from that state, and the stored features of keyframes drawn from the seed
are compared too.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from perfbench.harness import roofline
from perfbench.harness.drivers import (
    Base,
    count_dba,
    count_model,
    read_kernel_samples,
    rel_err,
    rel_gap,
    sample_kernels,
)
from perfbench.harness.drivers.track import render_loop, slam_config
from perfbench.harness.scene import se3_inv
from perfbench.harness.weights import make_state_dict


@contextlib.contextmanager
def recording_plans(system, plans: list):
    """While open, every low-memory update of ``system``'s backend appends
    its edge list (ii, jj) to ``plans``."""
    cls = sys.modules[type(system.backend).__module__].FactorGraph
    orig = cls.update_lowmem

    def update_lowmem(graph, *args, **kwargs):
        plans.append((graph.ii.copy(), graph.jj.copy()))
        return orig(graph, *args, **kwargs)

    cls.update_lowmem = update_lowmem
    try:
        yield
    finally:
        cls.update_lowmem = orig


class Driver(Base):
    def __init__(self, cell, seed, device, impl):
        super().__init__(cell, seed, device, impl)
        self.cfg = cell.config["slam"]
        self.H, self.W = self.cfg["image_size"]
        self.peak_flops = roofline.peak_flops(self.cfg["compute_dtype"])
        self.steps = self.traffic["steps"]

    def _system(self, cfg_over: dict, buffer: int | None = None):
        over = dict(cfg_over, **({"buffer": buffer} if buffer else {}))
        if self.impl == "program" and not cfg_over:
            from lgu_slam_tpu_torch.slam.system import LGUSlam
            from lgu_slam_tpu_torch.utils.config import SLAMConfig
            return LGUSlam(self.weights, slam_config(SLAMConfig, self.cfg,
                                                      **over),
                           device=self.device)
        from perfbench.reference.config import SLAMConfig
        from perfbench.reference.system import RefSlam
        return RefSlam(self.weights, slam_config(SLAMConfig, self.cfg,
                                                 **over), self.device)

    def _fill(self, system):
        """Append every frame through the motion filter, then write the
        true poses and the sensed disparities."""
        for k in range(len(self.images)):
            system.filter.track(float(k), self.images[k], self.depths[k],
                                self.intr)
        v = system.video
        T = len(self.images)
        if v.counter != T:
            raise RuntimeError(f"the motion filter kept {v.counter} of {T} "
                               "frames")
        v.poses[:T] = se3_inv(self.poses_c2w).to(self.device)
        v.disps[:T] = v.disps_sens[:T]

    def setup(self):
        self.images, self.depths, self.intr, self.poses_c2w = render_loop(
            self.traffic, self.H, self.W, self.seed, self.device)
        self.weights = make_state_dict(self.seed, self.device)
        over = self.limits["control"] if self.impl == "control" else {}
        self.system = self._system(over)
        self._fill(self.system)
        v = self.system.video
        T = v.counter
        self.start = (v.poses[:T].clone(), v.disps[:T].clone(),
                      v.damping[:T].clone())
        self.plans = []
        self._plans = contextlib.ExitStack()
        self._plans.enter_context(recording_plans(self.system, self.plans))
        for _ in range(self.traffic["warm_passes"]):
            self.call()

    def call(self) -> float:
        v = self.system.video
        poses, disps, damping = self.start
        T = poses.shape[0]
        v.poses[:T] = poses
        v.disps[:T] = disps
        v.damping[:T] = damping
        self.system.backend(self.steps)
        ii, _ = self.plans[-1]
        return len(ii) * self.steps / 128.0

    def finish(self):
        v = self.system.video
        T = self.start[0].shape[0]
        self.after = (v.poses[:T].clone(), v.disps[:T].clone())
        self.kept = self.sample_draw(0, T, self.limits["sampled_keyframes"])
        self.feats = [(v.fmaps[k, 0].float().clone(), v.nets[k].float().clone(),
                       v.inps[k].float().clone()) for k in self.kept]
        self.plan = self.plans[-1]
        self._plans.close()
        del self.system
        self.system = None

    # -- tracing ----------------------------------------------------------

    def instrument(self, spans):
        s = self.system
        count_model(spans, type(s.net), self.H, self.W)
        graph_mod = sys.modules[sys.modules[
            type(s.backend).__module__].FactorGraph.__module__]
        count_dba(spans, graph_mod)
        package = type(s.net).__module__.rsplit(".", 1)[0]
        sample_kernels(spans, sys.modules[package + ".corr"])

    def read_samples(self, run):
        read_kernel_samples(run)

    def notes(self, run) -> list:
        edges = [len(ii) for ii, _ in self.plans]
        return [f"passes in the window: {len(run.calls)}; edges per pass "
                f"{sorted(set(edges))}; steps {self.steps}",
                *self.readings]

    # -- the check --------------------------------------------------------

    def check(self) -> dict:
        from perfbench.reference.models.net import normalize_images
        from perfbench.reference.precision import rnd
        from perfbench.reference.slam.motion_filter import subsample_depth

        T = self.start[0].shape[0]
        ref = self._system(self.limits["reference"], buffer=T + 1)
        v = ref.video
        # the same frames through the reference's own encoders
        dev = self.device
        v.counter = T
        v.images[:T] = torch.as_tensor(self.images, device=dev)
        v.intrinsics[:T] = torch.as_tensor(self.intr / 8.0, device=dev)
        v.disps_sens[:T] = torch.as_tensor(np.stack(
            [subsample_depth(d) for d in self.depths]), device=dev)
        fd = ref.cfg.feat_dtype
        with torch.no_grad():
            for a in range(0, T, 8):
                x = normalize_images(v.images[a:a + 8])
                v.fmaps[a:a + 8, 0] = rnd(ref.net.features(x), fd)
                net, inp = ref.net.context(x)
                v.nets[a:a + 8] = rnd(net, fd)
                v.inps[a:a + 8] = rnd(inp, fd)
        poses, disps, damping = self.start
        v.poses[:T] = poses
        v.disps[:T] = disps
        v.damping[:T] = damping
        plans = []
        with recording_plans(ref, plans):
            ref.backend(self.steps)
        pose = rel_gap(self.after[0], v.poses[:T], poses)
        disp = rel_gap(self.after[1], v.disps[:T], disps)
        feat = max(rel_err(a, b) for k, fs in zip(self.kept, self.feats)
                   for a, b in zip(fs, (v.fmaps[k, 0], v.nets[k], v.inps[k])))
        ii, jj = self.plan
        rii, rjj = plans[-1] if plans else (np.zeros(0), np.zeros(0))
        same = len(ii) == len(rii) and bool((ii == rii).all()
                                            and (jj == rjj).all())
        self.readings = [f"edges: program {len(ii)}, reference {len(rii)}, "
                         f"the same list: {same}"]
        return {"pose_gap": pose, "disp_gap": disp, "feature_gap": feat}
