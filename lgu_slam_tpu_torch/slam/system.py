"""SLAM system entry point (port of ``LGUSlam`` of the JAX package's
``slam/system.py``): per-frame tracking and the final global pass."""

from __future__ import annotations

import numpy as np
import torch

from lgu_slam_tpu_torch.lie import se3_inv
from lgu_slam_tpu_torch.models.net import LGUNet
from lgu_slam_tpu_torch.slam.backend import Backend
from lgu_slam_tpu_torch.slam.frontend import Frontend
from lgu_slam_tpu_torch.slam.motion_filter import MotionFilter
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.slam.trajectory_filler import TrajectoryFiller
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.device import resolve_device, use_full_fp32


class LGUSlam:
    """Motion filter + frontend + backend + trajectory filler over one
    keyframe video, on one device.

    ``state_dict`` is an LGUNet state dict in the reference torch layout
    (``models.net.init_state_dict`` or ``utils.weights``).  ``device``
    defaults to CUDA and raises when CUDA is absent; pass ``"cpu"`` to run
    the kernels' plain versions on the CPU.

    ``process_group`` (one process per device, NCCL on CUDA, gloo on the
    CPU): the global backend passes run sharded over its ranks, as the JAX
    package's do over several devices.  Every rank tracks the same stream;
    each pass starts from rank 0's video, and every rank ends with the same
    result."""

    def __init__(self, state_dict: dict, cfg: SLAMConfig, device=None,
                 process_group=None):
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
        self.backend = Backend(self.net, self.video, cfg,
                               group=process_group)
        self.traj_filler = TrajectoryFiller(self.net, self.video, cfg)

    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Per-frame entry: image [H, W, 3] BGR uint8 (or a [2, H, W, 3]
        stereo pair), intrinsics (fx, fy, cx, cy) at full resolution."""
        self.filter.track(tstamp, image, depth, intrinsics)
        self.frontend()

    def terminate(self, stream=None, backend_steps=(7, 12)) -> np.ndarray:
        """Final global optimisation and trajectory filling: drops the
        frontend, runs the backend once per entry of ``backend_steps``, and
        fills every frame of ``stream`` (the tracked stream replayed) if
        one is given.  Returns the camera-to-world trajectory [T, 7] as
        numpy (t, q): of the stream's frames, else of the keyframes."""
        del self.frontend
        for steps in backend_steps:
            self.backend(steps)
        if stream is not None:
            poses_w2c = torch.as_tensor(self.traj_filler(stream))
        else:
            poses_w2c = self.video.poses[:self.video.counter].cpu()
        return se3_inv(poses_w2c).numpy()
