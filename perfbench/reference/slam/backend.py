"""Backend: one global bundle adjustment over all keyframes, a frozen plain
copy of the port's ``slam/backend.py`` on one device."""

from __future__ import annotations

import warnings

import numpy as np

from perfbench.reference.models.net import LGUNet
from perfbench.reference.slam.factor_graph import FactorGraph
from perfbench.reference.slam.state import Video
from perfbench.reference.config import SLAMConfig


class Backend:
    def __init__(self, net: LGUNet, video: Video, cfg: SLAMConfig):
        self.net = net
        self.video = video
        self.cfg = cfg

    def __call__(self, steps: int = 12):
        """Normalise the scale (monocular without sensed depth), plan up to
        16 edges per keyframe by proximity, run ``steps`` rounds of the
        low-memory update, and drop the edges."""
        cfg = self.cfg
        v = self.video
        t = v.counter
        if t < 2:
            return

        has_sens = bool((v.disps_sens[:t] > 0).any())
        if not v.stereo and not has_sens:
            v.normalize()

        max_factors = min(16 * t, cfg.backend_edge_cap)
        if 16 * t > cfg.backend_edge_cap:
            # the reference's global graph takes 16*t edges; a smaller cap
            # under-constrains the final BA, so say so
            warnings.warn(
                f"backend edge budget truncated: 16*t={16 * t} > "
                f"backend_edge_cap={cfg.backend_edge_cap}; the global BA "
                "runs with fewer factors than the reference protocol — "
                "raise cfg.backend_edge_cap for full accuracy",
                stacklevel=2)
        # the edge cap as the JAX package sizes it: 16*t rounded up to a
        # power of two, at least 128, at most backend_edge_cap
        bucket = min(cfg.backend_edge_cap,
                     max(128, 1 << int(np.ceil(np.log2(max(max_factors,
                                                           1))))))
        graph = FactorGraph(self.net, v, cfg, corr_impl="alt",
                            max_factors=max_factors, edge_bucket=bucket,
                            inactive_bucket=8)
        graph.add_proximity_factors(rad=cfg.backend_radius,
                                    nms=cfg.backend_nms,
                                    thresh=cfg.backend_thresh, beta=cfg.beta)
        graph.update_lowmem(steps=steps)
        graph.clear_edges()
        v.dirty[:t] = True
