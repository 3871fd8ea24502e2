"""Motion filter / keyframe gate (port of
the JAX package's ``slam/motion_filter.py``).

Runs the feature encoder on every incoming frame, probes the flow against
the last keyframe with one 1-edge correlation pyramid, one lookup and one
update step, and appends a keyframe when the
mean predicted flow delta exceeds the threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.geom.projective import coords_grid
from perfbench.reference.lie import se3_identity
from perfbench.reference.models.net import LGUNet, normalize_images
from perfbench.reference.slam.state import Video
from perfbench.reference.config import SLAMConfig


def subsample_depth(depth: np.ndarray) -> np.ndarray:
    """Full-resolution depth -> 1/8 sensed disparity (0 where no depth)."""
    d = depth[3::8, 3::8]
    return np.where(d > 0, 1.0 / np.maximum(d, 1e-12), 0.0).astype(np.float32)


class MotionFilter:
    def __init__(self, net: LGUNet, video: Video, cfg: SLAMConfig):
        self.net = net
        self.video = video
        self.device = video.device
        self.thresh = cfg.filter_thresh
        self.cfg = cfg
        # K1's operand dtype for the probe: the encoder's output is bf16
        # values (widened) when it computes in bf16, so bf16 is lossless
        self.corr_dtype = (torch.bfloat16
                           if cfg.compute_dtype == "bfloat16"
                           else torch.float32)
        self.count = 0
        self.fmap = None  # fp32 features of the last keyframe
        self.hidden = None  # its context: GRU hidden seed and input
        self.inp = None

    def _encode(self, image: torch.Tensor) -> torch.Tensor:
        """[H, W, 3] BGR -> fmap [h, w, 128] fp32."""
        return self.net.features(normalize_images(image[None]))[0]

    def _flow_probe(self, gmap: torch.Tensor) -> torch.Tensor:
        """1-edge correlation + 1 GRU iteration: mean |delta| (device)."""
        pyr = self.net.build_corr(self.fmap[None], gmap[None],
                                  operand_dtype=self.corr_dtype)
        h, w = gmap.shape[:2]
        coords0 = coords_grid(h, w, device=self.device)[None]
        corr = self.net.lookup(pyr, coords0)
        _, delta, _ = self.net.update_step(
            self.hidden[None, None], self.inp[None, None], corr[None])
        return torch.linalg.norm(delta[0, 0], dim=-1).mean()

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None) -> bool:
        """image: [H, W, 3] BGR uint8 (or [2, H, W, 3] stereo pair).
        Returns True if a keyframe was appended."""
        image = np.asarray(image)
        stereo = image.ndim == 4
        img0 = torch.as_tensor(image[0] if stereo else image,
                               device=self.device)
        gmap = self._encode(img0)
        fmap_stack = gmap[None]
        if stereo:
            gmap1 = self._encode(torch.as_tensor(image[1], device=self.device))
            fmap_stack = torch.stack([gmap, gmap1], dim=0)

        h, w = gmap.shape[:2]
        sens = (torch.as_tensor(subsample_depth(np.asarray(depth)),
                                device=self.device)
                if depth is not None
                else torch.zeros(h, w, device=self.device))
        intr8 = torch.as_tensor(np.asarray(intrinsics, np.float32),
                                device=self.device) / 8.0
        fd = self.video.fmaps.dtype

        if self.video.counter > 0:
            delta = float(self._flow_probe(gmap))
            if not delta > self.thresh:  # a NaN probe is no keyframe
                self.count += 1
                return False
            self.count = 0
            # keep the pose/disp the frontend seeded for this slot
            pose = self.video.poses[self.video.counter].clone()
            disp = self.video.disps[self.video.counter].clone()
        else:
            pose = se3_identity(device=self.device)
            disp = torch.ones(h, w, device=self.device)

        hidden, inp = self.net.context(normalize_images(img0[None]))
        self.fmap, self.hidden, self.inp = gmap, hidden[0], inp[0]
        self.video.append(float(tstamp), img0, pose, disp, sens, intr8,
                          fmap_stack.to(fd), self.hidden.to(fd),
                          self.inp.to(fd))
        return True
