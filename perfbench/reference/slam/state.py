"""Keyframe video state, a frozen plain copy of the port's ``slam/state.py``.

A fixed-capacity keyframe store of device tensors, updated in place; the
keyframe counter and the dirty flags live on the host.  Features are held
in float32, rounded to ``cfg.feat_dtype`` when written.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.geom.distance import (
    frame_distance,
    frame_distance_bidirectional,
)
from perfbench.reference.geom.projective import projective_transform
from perfbench.reference.lie import se3_identity
from perfbench.reference.config import SLAMConfig
from perfbench.reference.precision import rnd

# edge pairs per distance evaluation (bounds the [pairs, h, w, 4] transients)
_DISTANCE_CHUNK = 1024


class Video:
    """Keyframe buffers: tstamp [N], images [N,H,W,3] uint8 BGR, poses
    [N,7] world-to-camera, disps/disps_sens/damping [N,h,w], disps_up
    [N,H,W] (only with ``cfg.upsample``), intrinsics [N,4] at 1/8 scale,
    fmaps [N,rig,h,w,128], nets/inps [N,h,w,128] in ``cfg.feat_dtype``."""

    _FIELDS = ("tstamp", "images", "poses", "disps", "disps_sens",
               "disps_up", "intrinsics", "fmaps", "nets", "inps", "damping")

    def __init__(self, cfg: SLAMConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        N = cfg.buffer
        H, W = cfg.image_size
        h, w = H // 8, W // 8
        rig = 2 if cfg.stereo else 1
        fd = torch.float32
        f32 = dict(dtype=torch.float32, device=self.device)
        self.tstamp = torch.zeros(N, **f32)
        self.images = torch.zeros(N, H, W, 3, dtype=torch.uint8,
                                  device=self.device)
        self.poses = se3_identity((N,), device=self.device)
        self.disps = torch.ones(N, h, w, **f32)
        self.disps_sens = torch.zeros(N, h, w, **f32)
        self.disps_up = (torch.zeros(N, H, W, **f32) if cfg.upsample
                         else torch.zeros(1, 1, 1, **f32))
        self.intrinsics = torch.zeros(N, 4, **f32)
        self.fmaps = torch.zeros(N, rig, h, w, 128, dtype=fd,
                                 device=self.device)
        self.nets = torch.zeros(N, h, w, 128, dtype=fd, device=self.device)
        self.inps = torch.zeros(N, h, w, 128, dtype=fd, device=self.device)
        self.damping = torch.full((N, h, w), 1e-6, **f32)
        self.counter = 0
        self.stereo = cfg.stereo
        self.dirty = np.zeros(N, bool)

    # -- mutation -----------------------------------------------------------

    def append(self, tstamp, image, pose, disp, disp_sens, intrinsics, fmap,
               net, inp):
        """Write one keyframe at slot ``counter``."""
        i = self.counter
        self.tstamp[i] = tstamp
        self.images[i] = image
        self.poses[i] = pose
        self.disps[i] = disp
        self.disps_sens[i] = disp_sens
        self.intrinsics[i] = intrinsics
        self.fmaps[i] = rnd(fmap, self.cfg.feat_dtype)
        self.nets[i] = rnd(net, self.cfg.feat_dtype)
        self.inps[i] = rnd(inp, self.cfg.feat_dtype)
        self.dirty[i] = True
        self.counter += 1

    def remove_keyframe(self, ix: int):
        """Copy slot ix+1 into slot ix (the frontend only removes the
        second-newest keyframe) and shrink the counter."""
        src = min(ix + 1, self.cfg.buffer - 1)
        for name in self._FIELDS:
            buf = getattr(self, name)
            if buf.shape[0] > ix:
                buf[ix] = buf[min(src, buf.shape[0] - 1)]
        self.counter -= 1

    def normalize(self):
        """Scale the mean inverse depth of the first ``counter`` keyframes
        to 1 and their translations to match."""
        n = self.counter
        s = self.disps[:n].mean()
        self.disps[:n] /= s
        self.poses[:n, :3] *= s
        self.dirty[:n] = True

    # -- geometry -----------------------------------------------------------

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64).reshape(-1),
                               device=self.device)

    def reproject(self, ii, jj):
        """Pixel coordinates [E, h, w, 2] of keyframe ii's pixels in
        keyframe jj, and their validity [E, h, w, 1], on the video's
        device."""
        return projective_transform(self.poses, self.disps, self.intrinsics,
                                    self._index(ii), self._index(jj))

    def distance(self, ii, jj, beta=0.3, bidirectional=True) -> np.ndarray:
        """Frame distance for an edge list, as numpy [E]."""
        ii, jj = self._index(ii), self._index(jj)
        fn = frame_distance_bidirectional if bidirectional else frame_distance
        out = [fn(self.poses, self.disps, self.intrinsics[0],
                  ii[lo:lo + _DISTANCE_CHUNK], jj[lo:lo + _DISTANCE_CHUNK],
                  beta)
               for lo in range(0, ii.shape[0], _DISTANCE_CHUNK)]
        if not out:
            return np.zeros(0, np.float32)
        return torch.cat(out).cpu().numpy()

    def distance_rect(self, i0, i1, j0, j1, beta=0.3) -> np.ndarray:
        """Bidirectional distance over the index rectangle [i0, i1) x
        [j0, j1), as numpy [i1 - i0, j1 - j0]."""
        ni, nj = i1 - i0, j1 - j0
        ii = np.repeat(np.arange(i0, i1), nj)
        jj = np.tile(np.arange(j0, j1), ni)
        return self.distance(ii, jj, beta=beta).reshape(ni, nj)

    def distance_matrix(self, beta=0.3) -> np.ndarray:
        """Bidirectional distance between every two of the first
        ``counter`` keyframes, as numpy [t, t]."""
        t = self.counter
        return self.distance_rect(0, t, 0, t, beta=beta)
