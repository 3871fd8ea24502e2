"""SplaTAM-style mapping over a saved SLAM reconstruction (port of the JAX
package's ``gs/mapping.py``; reference: to3DGS/executeSlam.py
``imt_3dgsSlam``:372-700 + loss/loss.py).

Per frame: set the camera from the SLAM trajectory, densify where the
rendered silhouette is low or the depth error is high (add_new_gaussians,
:93-136), then run N mapping iterations of Adam on RGB (L1+SSIM 0.8/0.2) +
masked depth-L1 losses with periodic opacity pruning (:554-616).

The mapper steps the live prefix ``[0, count)`` of the map.  Dead slots in
it get zero gradients, as in the JAX package, whose capacity buckets only
add slots with zero gradients and zero moments, so both take the same
steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lgu_slam_tpu_torch.gs.params import (
    PARAM_KEYS,
    GaussianMap,
    pointcloud_from_depth,
)
from lgu_slam_tpu_torch.gs.render import render_rgbd
from lgu_slam_tpu_torch.gs.ssim import ssim
from lgu_slam_tpu_torch.utils.device import (
    full_fp32_convs,
    resolve_device,
    to_device,
    to_host,
)

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


@dataclass
class GSConfig:
    """(configs/replica/splatam.py essentials)"""

    capacity: int = 400_000
    map_every: int = 1
    keyframe_every: int = 5
    mapping_window_size: int = 24
    mapping_iters: int = 60
    sil_thres: float = 0.5
    prune_every: int = 20
    prune_opacity: float = 0.005
    prune_big_after: int = 0  # 0 = never remove big (scale>0.1*radius)
    densify_every: int = 0  # 0 = off; else clone/split cadence (iters)
    densify_grad_thresh: float = 0.0002
    num_to_split_into: int = 2
    lr_means3D: float = 0.0001
    lr_rgb: float = 0.0025
    lr_rots: float = 0.001
    lr_opacities: float = 0.05
    lr_scales: float = 0.001
    span: int = 6
    k_max: int = 96
    loss_im_l1: float = 0.8
    loss_im_ssim: float = 0.2
    loss_depth: float = 1.0


def learning_rates(cfg: GSConfig) -> dict:
    return {
        "means3D": cfg.lr_means3D,
        "rgb_colors": cfg.lr_rgb,
        "unnorm_rotations": cfg.lr_rots,
        "logit_opacities": cfg.lr_opacities,
        "log_scales": cfg.lr_scales,
    }


def adam_init(params: dict) -> dict:
    """Adam state for ``params``: step count and zero moments."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam_update(params: dict, grads: dict, state: dict, lrs: dict):
    """One step of optax's ``adam(lr, eps=1e-15)`` per parameter group,
    in optax's form ``m_hat / (sqrt(v_hat) + eps)``; the bias corrections
    are float32, computed on the host.  Returns the new parameters and
    state (nothing is updated in place)."""
    count = state["count"] + 1
    bc1 = float(1 - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(1 - np.float32(ADAM_B2) ** np.float32(count))
    out, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][k]
        nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][k]
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        out[k] = p + -lrs[k] * u
    return out, {"count": count, "mu": mu, "nu": nu}


def mapping_loss(cfg: GSConfig, img_size):
    """``loss_fn(params, xy_probe, alive, frame) -> (loss, (im_l1,
    depth_l1))``: depth L1 under the silhouette mask, plus 0.8 x L1 and
    0.2 x (1 - SSIM) on the image (loss.py)."""

    def loss_fn(params, xy_probe, alive, frame):
        im_gt, depth_gt, w2c_rot, w2c_trans, intr = frame
        img, depth, sil, _ = render_rgbd(
            params, alive, w2c_rot, w2c_trans, intr, img_size,
            span=cfg.span, k_max=cfg.k_max, xy_offset=xy_probe,
        )
        mask = ((depth_gt > 0) & (sil > cfg.sil_thres)).detach()
        depth_l1 = torch.sum(
            torch.abs(depth_gt - depth) * mask
        ) / torch.clamp(torch.sum(mask).to(depth.dtype), min=1.0)
        im_l1 = torch.mean(torch.abs(img - im_gt))
        im_ssim = 1.0 - ssim(img, im_gt)
        loss = (
            cfg.loss_depth * depth_l1
            + cfg.loss_im_l1 * im_l1
            + cfg.loss_im_ssim * im_ssim
        )
        return loss, (im_l1, depth_l1)

    return loss_fn


def make_mapping_step(cfg: GSConfig, img_size):
    """The mapping iteration: render + loss + backward + Adam update.

    ``step(params, opt_state, alive, frame)`` takes the parameters of the
    stepped slots (PARAM_KEYS -> [n, ...]), their Adam state, ``alive``
    [n] on the device and ``frame`` = (im, depth, w2c_rot, w2c_trans, intr)
    tensors; returns (params, opt_state, loss, (im_l1, depth_l1),
    g2d_norm [n]) as tensors, without a host sync.
    """
    lrs = learning_rates(cfg)
    loss_fn = mapping_loss(cfg, img_size)

    def step(params, opt_state, alive, frame):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        # the zero-valued xy probe's gradient is dL/dmeans2D -- the
        # densification signal (gs_external.accumulate_mean2d_gradient)
        xy_probe = torch.zeros(leaves["means3D"].shape[0], 2,
                               device=alive.device, requires_grad=True)
        with full_fp32_convs():
            loss, aux = loss_fn(leaves, xy_probe, alive, frame)
            *gl, g2d = torch.autograd.grad(
                loss, [leaves[k] for k in PARAM_KEYS] + [xy_probe])
        a = alive[:, None].to(loss.dtype)
        # frozen (dead) slots get no gradient
        grads = {k: g * a for k, g in zip(PARAM_KEYS, gl)}
        params, opt_state = adam_update(
            {k: v.detach() for k, v in params.items()}, grads, opt_state,
            lrs)
        g2d_norm = torch.linalg.norm(g2d, dim=-1) * a[:, 0]
        return (params, opt_state, loss.detach(),
                tuple(x.detach() for x in aux), g2d_norm)

    return step


class GaussianMapper:
    """Drives the full mapping loop over a reconstruction, on ``device``
    (the card unless the caller passes another)."""

    def __init__(self, cfg: GSConfig, img_size, device=None):
        self.cfg = cfg
        self.img_size = img_size
        self.device = resolve_device(device)
        self.map = GaussianMap.create(cfg.capacity, self.device)
        self.step = make_mapping_step(cfg, img_size)
        self.opt_state = None
        self.keyframes = []
        self.scene_radius = 1.0  # max depth / 3 of the first frame
        self._iter = 0
        self._g2d_accum = np.zeros(cfg.capacity, np.float32)
        self._g2d_denom = np.zeros(cfg.capacity, np.float32)

    def _ensure_opt(self):
        """Fresh Adam moments and step count over the whole capacity (the
        JAX package re-initialises them whenever Gaussians are added)."""
        self.opt_state = adam_init(self.map.params)

    def _stepped(self) -> int:
        """Slots a step or render covers: the live prefix, at least one
        (a map with no Gaussian renders one dead slot, as the JAX package
        renders a bucket of dead slots)."""
        return max(self.map.count, 1)

    def _live_opt(self, n: int) -> dict:
        s = self.opt_state
        return {"count": s["count"],
                "mu": {k: v[:n] for k, v in s["mu"].items()},
                "nu": {k: v[:n] for k, v in s["nu"].items()}}

    def _writeback(self, params, opt):
        self.map.set_live(params)
        for m in ("mu", "nu"):
            for k, v in opt[m].items():
                self.opt_state[m][k][: v.shape[0]] = v
        self.opt_state["count"] = opt["count"]

    def frame_tensors(self, im, depth, w2c_rot, w2c_trans, intr):
        """A frame as the step takes it: float32 tensors on the device."""
        return tuple(to_device(x, self.device)
                     for x in (im, depth, w2c_rot, w2c_trans, intr))

    def add_frame_gaussians(self, im, depth, w2c_rot, w2c_trans, intr,
                            time_idx, pcd_mask=None):
        """Densification by silhouette/depth error (executeSlam.py:93-136);
        ``im``/``depth`` numpy, the camera tensors or arrays."""
        cfg = self.cfg
        depth = np.asarray(depth)
        if self.map.count == 0:
            non_presence = np.ones(depth.shape, bool)
            self.scene_radius = float(np.max(depth)) / 3.0  # SplaTAM
            # scene_radius_depth_ratio (executeSlam.py:229)
        else:
            n = self._stepped()
            R, t, K = (to_device(x, self.device)
                       for x in (w2c_rot, w2c_trans, intr))
            with torch.no_grad():
                _, rdepth, sil, _ = render_rgbd(
                    self.map.live(n), self.map.alive_device(n), R, t, K,
                    self.img_size, span=cfg.span, k_max=cfg.k_max,
                )
            rdepth = to_host(rdepth)
            sil = to_host(sil)
            derr = np.abs(depth - rdepth) * (depth > 0)
            med = np.median(derr[derr > 0]) if (derr > 0).any() else 0.0
            non_presence = (sil < cfg.sil_thres) | (
                (rdepth > depth) & (derr > 50 * med)
            )
        m = non_presence & (depth > 0)
        if pcd_mask is not None:
            m &= pcd_mask
        if not m.any():
            return
        c2w_rot = to_host(w2c_rot).T
        c2w_trans = -c2w_rot @ to_host(w2c_trans)
        pts, cols, msq = pointcloud_from_depth(
            im, depth, to_host(intr), c2w_rot, c2w_trans, mask=m
        )
        self.map.add_points(pts, cols, msq, time_idx)
        self._ensure_opt()

    def map_frame(self, frames, iters=None):
        """Run mapping iterations over the keyframe window; ``frames`` is a
        list of (im, depth, w2c_rot, w2c_trans, intr) tensors on the
        device (``frame_tensors``).  Returns the losses as floats (one
        host sync per iteration)."""
        cfg = self.cfg
        iters = iters or cfg.mapping_iters
        rng = np.random.default_rng(len(self.keyframes))
        losses = []

        n = self._stepped()
        params = self.map.live(n)
        opt = self._live_opt(n)
        alive = self.map.alive_device(n)

        for it in range(iters):
            f = frames[int(rng.integers(0, len(frames)))]
            params, opt, loss, _, g2d = self.step(params, opt, alive, f)
            losses.append(float(loss))
            self._iter += 1
            if cfg.densify_every:
                g = to_host(g2d)
                self._g2d_accum[:n] += g
                self._g2d_denom[:n] += g > 0
            if (it + 1) % cfg.prune_every == 0:
                op = to_host(torch.sigmoid(params["logit_opacities"][:, 0]))
                rm = np.zeros(cfg.capacity, bool)
                rm[:n] = op < cfg.prune_opacity
                if cfg.prune_big_after and self._iter >= cfg.prune_big_after:
                    big = np.exp(to_host(params["log_scales"]).max(axis=1)
                                 ) > 0.1 * self.scene_radius
                    rm[:n] |= big
                self.map.prune(rm)
                alive = self.map.alive_device(n)
            if cfg.densify_every and self._iter % cfg.densify_every == 0:
                # densify reads and writes the capacity tensors: write the
                # prefix back first, then take it again (count may grow)
                self._writeback(params, opt)
                grads = self._g2d_accum / np.maximum(self._g2d_denom, 1.0)
                added = self.map.densify(
                    grads, self.scene_radius,
                    grad_thresh=cfg.densify_grad_thresh,
                    num_to_split_into=cfg.num_to_split_into,
                )
                if added:
                    self._ensure_opt()  # new slots -> fresh Adam moments
                self._g2d_accum[:] = 0.0
                self._g2d_denom[:] = 0.0
                n = self._stepped()
                params = self.map.live(n)
                opt = self._live_opt(n)
                alive = self.map.alive_device(n)

        self._writeback(params, opt)
        return losses

    def truncation_stats(self, frame):
        """Drop telemetry for one frame at the mapper's span/k_max (the
        caps truncate silently; the reference rasterizer is exact).
        Returns {dropped_pairs_kmax, clamped_radius, max_tile_load} as
        Python ints."""
        _, _, R, t, K = frame
        n = self._stepped()
        with torch.no_grad():
            out = render_rgbd(
                self.map.live(n), self.map.alive_device(n), R, t, K,
                self.img_size, span=self.cfg.span, k_max=self.cfg.k_max,
                with_stats=True,
            )
        return {k: int(v) for k, v in out[4].items()}
