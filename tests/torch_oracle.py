"""The oracle of the port's end-to-end accuracy checks, and its scene.

The JAX package's tests/test_oracle_pipeline.py drives the real frontend
(init, proximity planning, the fused update + DBA, keyframe cull, inactive
store) and the real backend ``update_lowmem`` with the learned update
replaced by an oracle that emits ground-truth reprojection targets and unit
weights; the trajectory must then align to the ground truth at near-zero
ATE.  :class:`OracleNet` is that oracle for the port: it duck-types the
port's ``LGUNet`` at the four places the factor graph calls it
(``build_corr``, ``lookup``, ``alt_corr``, ``update_step``), so neither
correlation kernel runs.  :func:`run_pipeline` is the test's pipeline on
the port, on any device, with ``Backend(group=)`` for the sharded backend.

This file imports torch, numpy and the port only: ``chip_smoke.py`` loads it
by file path to run the pipeline on the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lgu_slam_tpu_torch import lie
from lgu_slam_tpu_torch.eval.ate import ate_rmse
from lgu_slam_tpu_torch.geom.projective import projective_transform
from lgu_slam_tpu_torch.slam.backend import Backend
from lgu_slam_tpu_torch.slam.frontend import Frontend
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.utils.config import SLAMConfig

CORR_CHANNELS = 196  # 4 levels x 7 x 7 taps

# tests/test_oracle_pipeline.py's configuration (64 x 96, an 8 x 12 grid)
ORACLE_CONFIG = dict(
    image_size=(64, 96), buffer=24, warmup=5,
    keyframe_thresh=0.25, frontend_window=10, frontend_radius=2,
    frontend_thresh=32.0, frontend_nms=1,
    frontend_iters1=6, frontend_iters2=4,
    max_factors=40, edge_bucket=48, inactive_bucket=48,
    pose_bucket=24, backend_edge_cap=128, backend_chunk=32,
    backend_thresh=64.0, backend_radius=2, backend_nms=1,
)


def full_width_config() -> SLAMConfig:
    """The oracle test's frontend and backend parameters on the default
    ``SLAMConfig()`` (384 x 512, a 48 x 64 grid): the frame-distance
    thresholds, which are mean flows in pixels of the 1/8 grid, grow with
    its width (x 64 / 12); the graph's capacities and chunk are the
    default's; a buffer of 32 keyframes holds the scene."""
    scale = SLAMConfig().wd8 / 12.0
    kw = {k: v for k, v in ORACLE_CONFIG.items()
          if k in ("warmup", "frontend_window", "frontend_radius",
                   "frontend_nms", "frontend_iters1", "frontend_iters2",
                   "backend_radius", "backend_nms")}
    return SLAMConfig(buffer=32,
                      keyframe_thresh=ORACLE_CONFIG["keyframe_thresh"] * scale,
                      frontend_thresh=ORACLE_CONFIG["frontend_thresh"] * scale,
                      backend_thresh=ORACLE_CONFIG["backend_thresh"] * scale,
                      **kw)


def make_scene(T: int, h: int, w: int):
    """tests/test_oracle_pipeline.py ``_make_scene``: world-to-camera
    poses [T, 7] from a random walk (frame 9 a near-duplicate, so the cull
    path fires), smooth disparities [T, h, w] and intrinsics [T, 4] of the
    1/8 grid, as numpy float32."""
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(T, 6)).astype(np.float32)
    xi[:, :3] *= 0.12  # translations
    xi[:, 3:] *= 0.015  # rotations
    xi[0] = 0
    xi[9] *= 0.02
    poses = lie.se3_exp(torch.from_numpy(np.cumsum(xi, axis=0))).numpy()
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 0.7 + 0.2 * np.sin(2 * np.pi * xx / w) * np.cos(2 * np.pi * yy / h)
    disps = np.stack([base + 0.05 * np.sin(t + yy / h)
                      for t in range(T)]).astype(np.float32)
    intr = np.broadcast_to(np.asarray([0.8 * w, 0.8 * w, w / 2.0, h / 2.0],
                                      np.float32), (T, 4)).copy()
    return poses, disps, intr


class OracleNet:
    """The port's ``LGUNet`` where the factor graph calls it, with the
    learned update replaced by the ground truth: the correlation carries
    (frame-i id, frame-j id, current reprojection) in its first four
    channels, and ``update_step`` returns delta = ground-truth reprojection
    - coords1 with unit weights, eta 1e-4 and the hidden state unchanged.

    Each keyframe's cached feature map holds its original frame id at
    channel 0 (see :func:`run_pipeline`), so after keyframe culls shift the
    video's slots the ids still address the right ground-truth poses."""

    def __init__(self, gt_poses, gt_disps, gt_intr, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.gt_poses = torch.as_tensor(gt_poses, **f32)
        self.gt_disps = torch.as_tensor(gt_disps, **f32)
        self.gt_intr = torch.as_tensor(gt_intr, **f32)

    @staticmethod
    def _encode(i_ids, j_ids, coords1):
        E, h, w, _ = coords1.shape
        corr = coords1.new_zeros(E, h, w, CORR_CHANNELS)
        corr[..., 0] = i_ids.float()[:, None, None]
        corr[..., 1] = j_ids.float()[:, None, None]
        corr[..., 2:4] = coords1
        return corr

    def build_corr(self, fmap1, fmap2, differentiable=False,
                   operand_dtype=None):
        return fmap1[:, 0, 0, 0].float(), fmap2[:, 0, 0, 0].float()

    def lookup(self, pyr, coords, differentiable=False):
        return self._encode(pyr[0], pyr[1], coords)

    def alt_corr(self, fmap_pyr, ii, jj, coords):
        # level 0 of the pooled pyramid is the features / 4 (rig 1: the
        # rig-expanded indices are the keyframe slots)
        return self._encode(fmap_pyr[0][ii][:, 0, 0, 0].float() * 4.0,
                            fmap_pyr[0][jj][:, 0, 0, 0].float() * 4.0,
                            coords)

    def update_step(self, net, inp, corr, flow=None, ii=None,
                    num_frames=None):
        _, E, h, w, _ = corr.shape
        i_ids = torch.round(corr[0, :, 0, 0, 0]).long()
        j_ids = torch.round(corr[0, :, 0, 0, 1]).long()
        coords1 = corr[0, ..., 2:4]
        gt, _ = projective_transform(self.gt_poses, self.gt_disps,
                                     self.gt_intr, i_ids, j_ids)
        delta = (gt - coords1)[None]
        weight = torch.ones_like(delta)
        F = num_frames
        eta = corr.new_full((1, F, h, w), 1e-4)
        upmask = corr.new_zeros(1, F, h, w, 576)
        slot_mask = torch.ones(F, dtype=torch.bool, device=corr.device)
        return net, delta, weight, eta, upmask, slot_mask


def scene_ate(gt_poses, tstamps, poses):
    """Sim(3)-aligned ATE of the keyframes' camera centres (of their
    world-to-camera poses [N, 7]) against the ground truth at their
    timestamps, and the ground truth's extent."""
    gt_xyz, est_xyz = (
        lie.se3_inv(torch.tensor(np.asarray(p, np.float32)))[:, :3].numpy()
        for p in (gt_poses[np.asarray(tstamps)], poses))
    rmse, _, _ = ate_rmse(gt_xyz, est_xyz, correct_scale=True)
    return rmse, float(np.linalg.norm(gt_xyz.max(0) - gt_xyz.min(0)))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_pipeline(cfg: SLAMConfig, T: int, device, group=None) -> dict:
    """tests/test_oracle_pipeline.py ``_run_pipeline`` on the port: T
    frames of the scene into the real Frontend (each new keyframe seeded as
    the frontend leaves it), then ``Backend(steps=6)``, on one
    device or sharded over ``group``.  Returns the ATE and the extent, the
    keyframes' count and timestamps, whether the cull fired, and the host
    milliseconds of each frontend call and of the backend pass (around a
    device synchronise)."""
    h, w = cfg.ht8, cfg.wd8
    H, W = cfg.image_size
    gt_poses, gt_disps, gt_intr = make_scene(T, h, w)
    oracle = OracleNet(gt_poses, gt_disps, gt_intr, device)
    video = Video(cfg, device)
    frontend = Frontend(oracle, video, cfg)

    img = torch.zeros(H, W, 3, dtype=torch.uint8, device=device)
    zeros_hw = torch.zeros(h, w, device=device)
    feat = torch.zeros(h, w, 128, dtype=video.nets.dtype, device=device)
    intr = torch.as_tensor(gt_intr[0], device=device)
    frontend_ms = []
    for t in range(T):
        idx = video.counter
        fmap = torch.zeros(1, h, w, 128, dtype=video.fmaps.dtype,
                           device=device)
        fmap[0, :, :, 0] = float(t)
        if idx == 0:
            pose = lie.se3_identity(device=device)
            disp = torch.ones(h, w, device=device)
        else:  # keep the frontend-seeded pose and disparity
            pose = video.poses[idx].clone()
            disp = video.disps[idx].clone()
        video.append(float(t), img, pose, disp, zeros_hw, intr, fmap, feat,
                     feat)
        _sync(device)
        start = time.perf_counter()
        frontend()
        _sync(device)
        frontend_ms.append((time.perf_counter() - start) * 1e3)
    culled = video.counter < T

    start = time.perf_counter()
    Backend(oracle, video, cfg, group=group)(steps=6)
    _sync(device)
    backend_ms = (time.perf_counter() - start) * 1e3

    k = video.counter
    tstamps = video.tstamp[:k].cpu().numpy().astype(int)
    rmse, extent = scene_ate(gt_poses, tstamps, video.poses[:k].cpu())
    return dict(ate=rmse, extent=extent, keyframes=k,
                tstamps=tstamps.tolist(), culled=culled,
                frontend_ms=frontend_ms, backend_ms=backend_ms,
                poses=video.poses[:k].cpu())
