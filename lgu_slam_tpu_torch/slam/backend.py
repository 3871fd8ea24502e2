"""Backend: one global bundle adjustment over all keyframes (port of the
JAX package's ``slam/backend.py``), on one device or sharded over the ranks
of a process group."""

from __future__ import annotations

import warnings

import numpy as np

from lgu_slam_tpu_torch.models.net import LGUNet
from lgu_slam_tpu_torch.parallel.backend_shard import broadcast_video
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.utils.config import SLAMConfig


class Backend:
    def __init__(self, net: LGUNet, video: Video, cfg: SLAMConfig,
                 group=None):
        """``group`` (a ``torch.distributed`` process group, one rank per
        device): every global pass runs sharded over its ranks by source
        keyframe (``parallel/backend_shard.py``), from rank 0's video."""
        self.net = net
        self.video = video
        self.cfg = cfg
        self.group = group

    def __call__(self, steps: int = 12):
        """Normalise the scale (monocular without sensed depth), plan up to
        16 edges per keyframe by proximity, run ``steps`` rounds of the
        low-memory update, and drop the edges."""
        cfg = self.cfg
        v = self.video
        if self.group is not None:
            broadcast_video(v, self.group)
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
        graph.update_lowmem(steps=steps, group=self.group)
        graph.clear_edges()
        v.dirty[:t] = True
