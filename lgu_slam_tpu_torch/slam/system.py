"""SLAM system entry point, tracking surface (port of ``LGUSlam.__init__``
and ``LGUSlam.track`` of the JAX package's ``slam/system.py``)."""

from __future__ import annotations

from lgu_slam_tpu_torch.models.net import LGUNet
from lgu_slam_tpu_torch.slam.frontend import Frontend
from lgu_slam_tpu_torch.slam.motion_filter import MotionFilter
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.device import resolve_device, use_full_fp32


class LGUSlam:
    """Motion filter + frontend over one keyframe video.

    ``state_dict`` is an LGUNet state dict in the reference torch layout
    (``models.net.init_state_dict`` or ``utils.weights``).  ``device``
    defaults to CUDA and raises when CUDA is absent; pass ``"cpu"`` to run
    the kernels' plain versions on the CPU."""

    def __init__(self, state_dict: dict, cfg: SLAMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.net = LGUNet.from_config(cfg, device=self.device)
        self.net.load_state_dict(state_dict, strict=True)
        self.net.eval()
        self.video = Video(cfg, self.device)
        self.filter = MotionFilter(self.net, self.video, cfg)
        self.frontend = Frontend(self.net, self.video, cfg)

    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Per-frame entry: image [H, W, 3] BGR uint8 (or a [2, H, W, 3]
        stereo pair), intrinsics (fx, fy, cx, cy) at full resolution."""
        self.filter.track(tstamp, image, depth, intrinsics)
        self.frontend()
