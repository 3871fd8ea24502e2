"""Pose filling for the frames that are no keyframes (port of the JAX
package's ``slam/trajectory_filler.py``): SE(3) interpolation between the
bracketing keyframes, then batches of 16 frames refined by motion-only BA
against the keyframe map."""

from __future__ import annotations

import numpy as np
import torch

from lgu_slam_tpu_torch.lie import se3_exp, se3_log, se3_mul, se3_rel
from lgu_slam_tpu_torch.models.net import LGUNet, normalize_images
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.utils.config import SLAMConfig

BATCH = 16


class TrajectoryFiller:
    def __init__(self, net: LGUNet, video: Video, cfg: SLAMConfig):
        self.net = net
        self.video = video
        self.cfg = cfg

    def _fill(self, tstamps, images, intrinsics) -> np.ndarray:
        """World-to-camera poses [M, 7] of up to BATCH frames.  The frames
        go into the scratch slots [N, N + BATCH) past the N keyframes (the
        batch padded by repeating its last frame), and a motion-only
        ``update_n(6)`` on a volume-correlation graph with edges from both
        bracketing keyframes to each frame refines their poses."""
        v = self.video
        dev = v.device
        N, M = v.counter, len(tstamps)
        pad = BATCH - M
        tt = np.asarray(list(tstamps) + [tstamps[-1]] * pad, np.float32)
        intr = np.stack(list(intrinsics) + [intrinsics[-1]] * pad)

        ts = v.tstamp[:N].cpu().numpy()
        t0 = np.asarray([max(int((ts <= t).sum()) - 1, 0) for t in tt])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        P0, P1 = v.poses[torch.as_tensor(t0, device=dev)], \
            v.poses[torch.as_tensor(t1, device=dev)]
        dt = torch.as_tensor(ts[t1] - ts[t0] + 1e-3, device=dev)[:, None]
        vel = se3_log(se3_rel(P0, P1)) / dt
        Gs = se3_mul(se3_exp(vel * torch.as_tensor(tt - ts[t0],
                                                   device=dev)[:, None]), P0)

        fmaps = self.net.features(normalize_images(
            torch.as_tensor(np.stack(images), device=dev)))
        # the padded frames repeat the last one
        fmaps = torch.cat([fmaps,
                           fmaps[-1:].expand((pad,) + fmaps.shape[1:])])

        s = slice(N, N + BATCH)
        v.tstamp[s] = torch.as_tensor(tt, device=dev)
        v.poses[s] = Gs
        v.disps[s] = 1.0
        v.disps_sens[s] = 0.0
        v.intrinsics[s] = torch.as_tensor(intr, device=dev) / 8.0
        v.fmaps[s, 0] = fmaps.to(v.fmaps.dtype)
        v.counter = N + BATCH

        graph = FactorGraph(self.net, v, self.cfg, corr_impl="volume",
                            max_factors=4 * BATCH, edge_bucket=2 * BATCH,
                            inactive_bucket=8)
        graph.add_factors(t0, np.arange(N, N + BATCH))
        graph.add_factors(t1, np.arange(N, N + BATCH))
        graph.update_n(6, t0=N, t1=N + BATCH, motion_only=True)

        out = np.array(v.poses[N:N + M].cpu())  # a copy: the slots are reused
        v.counter = N
        return out

    def _widen_for_fill(self):
        """Make room for the BATCH scratch slots when the keyframes leave
        too few: widen every per-slot buffer of the video once for the
        whole trajectory.  Returns the buffers to restore, or None."""
        v = self.video
        buf = v.poses.shape[0]
        if v.counter + BATCH <= buf:
            return None
        pad = v.counter + BATCH - buf
        saved = {name: getattr(v, name) for name in Video._FIELDS}
        for name, arr in saved.items():
            if arr.shape[0] == buf:  # not the (1, 1, 1) disps_up stand-in
                setattr(v, name, torch.cat(
                    [arr, arr.new_zeros((pad,) + arr.shape[1:])]))
        return saved

    @torch.no_grad()
    def __call__(self, image_stream) -> np.ndarray:
        """Fill every frame of the stream (items ``(t, image, ...,
        intrinsics)``; a stereo pair contributes its left image).  Returns
        the world-to-camera trajectory [T, 7]."""
        saved = self._widen_for_fill()
        counter = self.video.counter
        try:
            poses = []
            tstamps, images, intrinsics = [], [], []
            for item in image_stream:
                image = np.asarray(item[1])
                tstamps.append(item[0])
                images.append(image[0] if image.ndim == 4 else image)
                intrinsics.append(np.asarray(item[-1], np.float32))
                if len(tstamps) == BATCH:
                    poses.append(self._fill(tstamps, images, intrinsics))
                    tstamps, images, intrinsics = [], [], []
            if tstamps:
                poses.append(self._fill(tstamps, images, intrinsics))
            return np.concatenate(poses, axis=0)
        finally:
            # restore the counter and the buffers even when a batch failed
            self.video.counter = counter
            if saved is not None:
                for name, arr in saved.items():
                    setattr(self.video, name, arr)
