#!/usr/bin/env python
"""Train LGUNet with the PyTorch port: the counterpart of ``scripts/train.py``.

    python scripts/train_torch.py --datapath TARTANAIR_ROOT [--steps N] \\
        [--ckpt checkpoints/NAME_001000.pt] [--device cpu]
    torchrun --nproc_per_node 4 scripts/train_torch.py --datapath ROOT

TartanAir clips (``data/tartan.dataset_factory``: covisibility-sampled
``--n_frames``-frame clips; ``--datapath synthetic`` takes the port's
synthetic clips instead) go through ``RGBDAugmentor`` into the train step
of ``parallel/train_dp.py`` (the unrolled forward with a differentiable BA,
the four losses, AdamW under the one-cycle schedule), repeated with the
poses and disparities carried over while a draw falls below
``--restart_prob``.  Metrics go to the ``Logger`` (100-step means); the
train state (weights, optimizer, step, data RNG) is saved every
``--ckpt_every`` steps to ``checkpoints/<name>_<step>.pt``, and ``--ckpt``
resumes from one.  Under ``torchrun`` the step runs data-parallel, one
process per device: every rank draws the same clips and trains on its share
of the batch; rank 0 logs and saves.  Runs on the card unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from lgu_slam_tpu_torch.data.augmentation import RGBDAugmentor  # noqa: E402
from lgu_slam_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from lgu_slam_tpu_torch.data.tartan import dataset_factory  # noqa: E402
from lgu_slam_tpu_torch.models.net import (  # noqa: E402
    LGUNet,
    init_state_dict,
)
from lgu_slam_tpu_torch.parallel.train_dp import (  # noqa: E402
    data_parallel,
    init_distributed,
    make_optimizer,
    mean_over_ranks,
    shard_batch,
    train_step,
    window_edges,
)
from lgu_slam_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_train_state,
    save_train_state,
)
from lgu_slam_tpu_torch.utils.config import (  # noqa: E402
    SLAMConfig,
    TrainConfig,
)
from lgu_slam_tpu_torch.utils.device import use_full_fp32  # noqa: E402
from lgu_slam_tpu_torch.utils.logger import Logger  # noqa: E402


def main(argv=None) -> dict:
    """Returns the last step's metrics."""
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="lgu_torch")
    p.add_argument("--datapath", required=True)
    p.add_argument("--ckpt", default=None, help="train state to resume")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=9)
    p.add_argument("--steps", type=int, default=250000)
    p.add_argument("--lr", type=float, default=1.3e-4)
    p.add_argument("--clip", type=float, default=2.5)
    p.add_argument("--n_frames", type=int, default=4)
    p.add_argument("--fmin", type=float, default=8.0)
    p.add_argument("--fmax", type=float, default=96.0)
    p.add_argument("--restart_prob", type=float, default=0.2)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev, rank = init_distributed(args.device)
    use_full_fp32()
    tcfg = TrainConfig(
        batch=args.batch, iters=args.iters, steps=args.steps, lr=args.lr,
        clip=args.clip, n_frames=args.n_frames, fmin=args.fmin,
        fmax=args.fmax, restart_prob=args.restart_prob,
        ckpt_every=args.ckpt_every,
    )
    # training keeps fp32 end to end (the JAX script's dtypes)
    net = LGUNet(device=dev)
    net.load_state_dict(init_state_dict(SLAMConfig(), seed=0))
    ddp = dist.is_initialized()
    model = data_parallel(net) if ddp else net
    opt = make_optimizer(model, tcfg)
    total, restored_rng = 0, None
    if args.ckpt:
        total, restored_rng = load_train_state(args.ckpt, model, opt)

    if args.datapath == "synthetic":
        db = SyntheticDataset(n_frames=tcfg.n_frames,
                              crop_size=tcfg.image_size)
    else:
        db = dataset_factory(["tartan"], args.datapath,
                             n_frames=tcfg.n_frames, fmin=tcfg.fmin,
                             fmax=tcfg.fmax)
    aug = RGBDAugmentor(crop_size=tcfg.image_size)
    rng = np.random.default_rng(0)
    if restored_rng is not None:
        rng.bit_generator.state = restored_rng

    B, N = tcfg.batch, tcfg.n_frames
    H, W = tcfg.image_size
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(N))
    logger = Logger(args.name) if rank == 0 else None
    os.makedirs("checkpoints", exist_ok=True)

    metrics = {}
    while total < tcfg.steps:
        idx = rng.integers(0, len(db), size=B)
        items = [aug(*db[int(i)]) for i in idx]
        images, poses, depths, intr = (np.stack(x) for x in zip(*items))
        disps = np.where(depths > 0.01, 1.0 / np.maximum(depths, 0.01), 0.0)
        batch = tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                      for x in (images, poses, disps, intr))
        carry = (torch.zeros(B, N, 7, device=dev),
                 torch.zeros(B, N, H // 8, W // 8, device=dev))
        if ddp:
            batch, carry = shard_batch(batch), shard_batch(carry)
        t0 = time.time()
        # random restarts carrying poses and disparities
        while True:
            step_metrics, carry = train_step(model, opt, batch, *carry,
                                             cfg=tcfg, ii=ii, jj=jj)
            if rng.random() >= tcfg.restart_prob:
                break
        if ddp:
            step_metrics = mean_over_ranks(step_metrics)
        metrics = {k: v.item() for k, v in step_metrics.items()}
        metrics["step_time"] = time.time() - t0
        total += 1
        if logger is not None:
            logger.push(metrics, total)
        if total % tcfg.ckpt_every == 0 and rank == 0:
            path = f"checkpoints/{args.name}_{total:06d}.pt"
            save_train_state(path, model, opt, total,
                             rng.bit_generator.state)
            print("saved", path)
    if ddp:
        dist.destroy_process_group()
    return metrics


if __name__ == "__main__":
    main()
