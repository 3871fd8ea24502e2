"""Frontend: sliding-window local bundle adjustment over the newest
keyframes (port of the JAX package's ``slam/frontend.py``)."""

from __future__ import annotations

import torch

from perfbench.reference.models.net import LGUNet
from perfbench.reference.slam.factor_graph import FactorGraph
from perfbench.reference.slam.state import Video
from perfbench.reference.config import SLAMConfig


class Frontend:
    def __init__(self, net: LGUNet, video: Video, cfg: SLAMConfig):
        self.video = video
        self.cfg = cfg
        self.graph = FactorGraph(net, video, cfg, max_factors=cfg.max_factors)
        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.count = 0
        self.max_age = cfg.max_age
        self.iters1 = cfg.frontend_iters1
        self.iters2 = cfg.frontend_iters2

    @torch.no_grad()
    def __call__(self):
        if not self.is_initialized and self.video.counter == self.cfg.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()

    def _update(self):
        """Per-keyframe update."""
        cfg = self.cfg
        v = self.video
        self.count += 1
        self.t1 += 1

        if self.graph.n_edges > 0:
            self.graph.rm_factors(self.graph.age > self.max_age, store=True)

        self.graph.add_proximity_factors(
            self.t1 - 5, max(self.t1 - cfg.frontend_window, 0),
            rad=cfg.frontend_radius, nms=cfg.frontend_nms,
            thresh=cfg.frontend_thresh, beta=cfg.beta, remove=True)

        # RGB-D: adopt the sensed disparity where there is one
        t = self.t1 - 1
        v.disps[t] = torch.where(v.disps_sens[t] > 0, v.disps_sens[t],
                                 v.disps[t])

        self.graph.update_n(self.iters1, use_inactive=True)

        d = v.distance([self.t1 - 3], [self.t1 - 2], beta=cfg.beta,
                       bidirectional=True)[0]
        if d < cfg.keyframe_thresh:
            self.graph.rm_keyframe(self.t1 - 2)
            self.t1 -= 1
        else:
            self.graph.update_n(self.iters2, use_inactive=True)

        # seed the next keyframe from the newest one
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 1].mean()
        if self.graph.n_edges > 0:
            v.dirty[max(int(self.graph.ii.min()), 0): self.t1] = True

    def _initialize(self):
        """Bootstrap on the first ``warmup`` keyframes."""
        v = self.video
        self.t0 = 0
        self.t1 = v.counter

        self.graph.add_neighborhood_factors(self.t0, self.t1, r=3)
        self.graph.update_n(8, t0=1, use_inactive=True)

        self.graph.add_proximity_factors(
            0, 0, rad=2, nms=2, thresh=self.cfg.frontend_thresh,
            remove=False)
        self.graph.update_n(8, t0=1, use_inactive=True)

        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 4: self.t1].mean()

        self.is_initialized = True
        v.dirty[: self.t1] = True
        self.graph.rm_factors(self.graph.ii < self.cfg.warmup - 4, store=True)
