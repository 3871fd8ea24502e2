"""The training step (port of the JAX package's ``parallel/train_dp.py``):
the unrolled ``LGUNet.forward`` with a differentiable BA per step, the four
losses, global-norm gradient clipping, and AdamW under a one-cycle learning
rate, in one process or data-parallel over a process group.

Data parallelism is the counterpart of the JAX package's data mesh
(``make_data_mesh``, ``shard_batch``, ``replicate``): one process per
device, the model under :class:`SummingDDP` (made by :func:`data_parallel`,
which also makes every rank start from rank 0's weights), the batch split
over the ranks (:func:`shard_batch`).  The losses are means over the batch,
so the whole batch's loss is the ranks' mean when the batch divides evenly
(:func:`shard_batch` raises otherwise).  The update heads' ``GradClip``
zeroes gradient entries by their size, so each rank back-propagates its
loss divided by the world size (the scale of the whole batch's gradient)
and :class:`SummingDDP` sums the ranks' gradients instead of averaging
them: a step then equals the one-process step on the whole batch.  Both
halves of that rule live in :class:`SummingDDP`; :func:`train_step` refuses
a plain ``DistributedDataParallel``, whose average would scale the
gradients by 1 / world**2.  The global-norm clip in
:meth:`OneCycleAdamW.step` reads the gradients after that all-reduce.

The optimizer is ``optax.chain(clip_by_global_norm(clip), adamw(schedule,
weight_decay))`` written out: the clip scales the gradients by
``clip / norm`` when the global norm reaches ``clip`` (optax's rule;
``torch.nn.utils.clip_grad_norm_`` would divide by ``norm + 1e-6``), and
``torch.optim.AdamW`` applies the same decoupled weight decay as optax's
``adamw``.  The schedule is optax's ``linear_onecycle_schedule`` as a plain
function of the step (``torch.optim.lr_scheduler.OneCycleLR`` places its
phase boundaries elsewhere).  Nothing here synchronises with the host:
metrics stay 0-dim tensors on the device until the caller logs them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from lgu_slam_tpu_torch import lie
from lgu_slam_tpu_torch.geom import losses
from lgu_slam_tpu_torch.parallel.dba_shard import check_group
from lgu_slam_tpu_torch.utils.config import TrainConfig
from lgu_slam_tpu_torch.utils.device import resolve_device


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
    if (isinstance(model, DistributedDataParallel)
            and not isinstance(model, SummingDDP)):
        raise TypeError("train_step takes a data-parallel model made by "
                        "data_parallel(), not a plain DistributedDataParallel")
    opt.zero_grad()
    total, metrics, carry = loss_fn(model, batch, Gs0, disp0, cfg=cfg,
                                    ii=ii, jj=jj)
    if isinstance(model, SummingDDP):
        total = model.rank_share(total)
    total.backward()
    opt.step()
    return metrics, carry


class SummingDDP(DistributedDataParallel):
    """``DistributedDataParallel`` whose gradient all-reduce sums the ranks'
    gradients; each rank scales its loss by :meth:`rank_share` before the
    backward, so the sum is the whole batch's gradient (see the module
    docstring)."""

    def __init__(self, module: torch.nn.Module, group=None):
        dev = next(module.parameters()).device
        check_group(group, dev)
        super().__init__(
            module, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=group)
        self.register_comm_hook(self.process_group, _sum_hook)

    def rank_share(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's share of the whole batch's loss: its own batch's
        mean loss over the world size."""
        return loss / dist.get_world_size(self.process_group)


def _sum_hook(group, bucket):
    """DDP gradient hook: the ranks' sum (DDP's default divides by the
    world size)."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def data_parallel(model: torch.nn.Module, group=None) -> SummingDDP:
    """``model`` under :class:`SummingDDP` on ``group`` (default: the
    world), one device per process: NCCL for a model on CUDA, gloo for one
    on the CPU.  DDP broadcasts rank 0's parameters and buffers."""
    return SummingDDP(model, group)


def shard_batch(tensors, group=None):
    """This rank's contiguous share of the leading (batch) axis of every
    tensor in ``tensors``; raises unless the batch divides evenly over the
    ranks."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    B = tensors[0].shape[0]
    if B % world:
        raise ValueError(f"batch {B} does not divide over {world} ranks")
    n = B // world
    return tuple(x[rank * n:(rank + 1) * n] for x in tensors)


def mean_over_ranks(metrics: dict, group=None) -> dict:
    """The ranks' mean of each 0-dim metric (one all_reduce).  For the loss,
    a mean over the batch, this is the whole batch's value."""
    keys = sorted(metrics)
    x = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    x = x / dist.get_world_size(group)
    return dict(zip(keys, x))


def init_distributed(device):
    """Under torchrun (``WORLD_SIZE`` set, world size 1 included): join the
    process group from torchrun's environment (NCCL on the card, gloo on the
    CPU) and take this rank's card; otherwise one process.  Returns
    (device, rank)."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev, 0
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, dist.get_rank()
