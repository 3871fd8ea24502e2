"""The SLAM system of the reference: motion filter, frontend and backend
over one keyframe video, with the port's ``LGUSlam`` attributes."""

from __future__ import annotations

from perfbench.reference.config import SLAMConfig
from perfbench.reference.models.net import LGUNet
from perfbench.reference.slam.backend import Backend
from perfbench.reference.slam.frontend import Frontend
from perfbench.reference.slam.motion_filter import MotionFilter
from perfbench.reference.slam.state import Video


class RefSlam:
    def __init__(self, state_dict: dict, cfg: SLAMConfig, device):
        self.cfg = cfg
        self.device = device
        self.net = LGUNet.from_config(cfg, device=device)
        self.net.load_state_dict(state_dict, strict=True)
        self.net.eval()
        self.video = Video(cfg, device)
        self.filter = MotionFilter(self.net, self.video, cfg)
        self.frontend = Frontend(self.net, self.video, cfg)
        self.backend = Backend(self.net, self.video, cfg)

    def track(self, tstamp, image, depth=None, intrinsics=None):
        """One frame: [H, W, 3] BGR uint8, depth [H, W], intrinsics (fx, fy,
        cx, cy) at full resolution."""
        self.filter.track(tstamp, image, depth, intrinsics)
        self.frontend()
