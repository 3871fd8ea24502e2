"""The training step of the reference, a frozen copy of the port's
``parallel/train_dp.py`` on one device: the unrolled ``LGUNet.forward``
with a differentiable BA per step, the four losses, global-norm gradient
clipping (optax's rule: scale by ``clip / norm`` once the norm reaches
``clip``), and AdamW under optax's one-cycle learning rate."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import lie
from perfbench.reference.config import TrainConfig
from perfbench.reference.geom import losses


def window_edges(n_frames: int, radius: int = 2):
    """The training graph: every ordered pair i != j with |i - j| <= radius,
    as numpy arrays (ii, jj)."""
    pairs = [(i, j) for i in range(n_frames) for j in range(n_frames)
             if i != j and abs(i - j) <= radius]
    ii, jj = zip(*pairs)
    return np.asarray(ii), np.asarray(jj)


def onecycle_schedule(cfg: TrainConfig):
    """optax's ``linear_onecycle_schedule`` over ``max(steps, 4)`` steps with
    the JAX package's clamped ``pct_start``/``pct_final`` (so that no phase
    is shorter than 1.5 steps, where optax's schedule is NaN): step -> lr."""
    total = max(int(cfg.steps), 4)
    pct_start = min(max(cfg.pct_start, 1.5 / total), 0.45)
    pct_final = max(min(0.99, 1.0 - 1.5 / total), pct_start + 1.5 / total)
    div, final_div = 25.0, 1e4
    scales = {int(pct_start * total): div, int(pct_final * total): 1.0 / div,
              total: 1.0 / final_div}
    bounds = (0,) + tuple(sorted(scales))
    values = np.cumprod((cfg.lr / div,) + tuple(scales[b] for b in bounds[1:]))

    def lr(step: int) -> float:
        for k in range(len(bounds) - 1):
            if bounds[k] <= step < bounds[k + 1]:
                pct = (step - bounds[k]) / (bounds[k + 1] - bounds[k])
                return float((values[k + 1] - values[k]) * pct + values[k])
        return float(values[-1])

    return lr


class OneCycleAdamW:
    """Global-norm clip, then AdamW at ``schedule(count)``; ``count`` is the
    number of steps taken, as optax's counter."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = list(params)
        self.clip = cfg.clip
        self.schedule = onecycle_schedule(cfg)
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay)
        self.count = 0

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        for g in grads:
            g.mul_(scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> OneCycleAdamW:
    return OneCycleAdamW(model.parameters(), cfg)


def loss_fn(model, batch, Gs0, disp0, *, cfg: TrainConfig, ii, jj):
    """The training loss of one batch.  batch = (images [B, N, H, W, 3],
    poses [B, N, 7] camera-to-world, disps [B, N, H, W] full-resolution
    inverse depth, intrinsics [B, N, 4]); Gs0 [B, N, 7] / disp0
    [B, N, H/8, W/8] are the random-restart carry (all zero: start from the
    ground truth of frames 0 and 1).  Returns (total, metrics, carry)."""
    images, poses_gt, disps_gt, intrinsics = batch
    N = images.shape[1]
    Ps = lie.se3_inv(poses_gt)  # camera-to-world -> world-to-camera
    Gs = torch.cat([Ps[:, :1], Ps[:, 1:2].expand(-1, N - 1, -1)], dim=1)
    use0 = torch.any(Gs0 != 0)
    Gs = torch.where(use0, Gs0, Gs)
    disp8 = torch.where(use0, disp0,
                        torch.ones_like(disps_gt[:, :, 3::8, 3::8]))

    poses_est, disps_est, residuals, coord_loss = model(
        Gs, images, disp8, intrinsics / 8.0, ii, jj, cfg.iters, 2)

    geo, geo_m = losses.geodesic_loss(Ps, poses_est, ii, jj, do_scale=False)
    res, res_m = losses.residual_loss(residuals)
    flo, flo_m = losses.flow_loss(Ps, disps_gt, poses_est, disps_est,
                                  intrinsics)
    total = (cfg.w1 * geo + cfg.w2 * res + cfg.w3 * flo
             + cfg.w_coord * coord_loss)
    metrics = {**geo_m, **res_m, **flo_m, "coord": coord_loss, "loss": total}
    metrics = {k: v.detach() for k, v in metrics.items()}
    carry = (poses_est[-1].detach(),
             disps_est[-1][:, :, 3::8, 3::8].detach())
    return total, metrics, carry


def train_step(model, opt: OneCycleAdamW, batch, Gs0, disp0, *,
               cfg: TrainConfig, ii, jj):
    """One optimizer step on ``batch`` (see :func:`loss_fn`).  Returns
    (metrics, carry), both on the device."""
    opt.zero_grad()
    total, metrics, carry = loss_fn(model, batch, Gs0, disp0, cfg=cfg,
                                    ii=ii, jj=jj)
    total.backward()
    opt.step()
    return metrics, carry
