#!/usr/bin/env python
"""Where the time of the PyTorch port's train step goes, on one GPU.

    python scripts/profile_torch_train.py [--out DIR]

Takes two warm-up steps of the default ``TrainConfig()`` (384 x 512,
batch 2, 4 frames, 20 edges, 9 iterations, fp32 without TF32) on synthetic
clips from random weights, then records two steps under ``torch.profiler``.
It prints the wall time per step, the device's busy share, the device time
per kernel group and per kernel, and the PyTorch ops with the most device
time by input shape; the full tables go to ``DIR/profile_torch_train.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from profile_torch_terminate import recorded  # noqa: E402
from profile_torch_track import (  # noqa: E402
    card_name,
    print_summary,
    summarize,
)

from lgu_slam_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from lgu_slam_tpu_torch.models.net import (  # noqa: E402
    LGUNet,
    init_state_dict,
)
from lgu_slam_tpu_torch.parallel.train_dp import (  # noqa: E402
    make_optimizer,
    train_step,
    window_edges,
)
from lgu_slam_tpu_torch.utils.config import (  # noqa: E402
    SLAMConfig,
    TrainConfig,
)
from lgu_slam_tpu_torch.utils.device import use_full_fp32  # noqa: E402

WARMUP, STEPS = 2, 2


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    use_full_fp32()
    cfg = TrainConfig()
    H, W = cfg.image_size
    B, N = cfg.batch, cfg.n_frames
    db = SyntheticDataset(n_scenes=2, frames_per_scene=N + 1, n_frames=N,
                          crop_size=(H, W), seed=0)
    rng = np.random.default_rng(0)

    def batch():
        items = [db[int(i)] for i in rng.integers(0, len(db), size=B)]
        images, poses, depths, intr = (np.stack(x) for x in zip(*items))
        disps = np.where(depths > 0.01, 1.0 / np.maximum(depths, 0.01), 0.0)
        return tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                     for x in (images, poses, disps, intr))

    net = LGUNet(device=dev)
    net.load_state_dict(init_state_dict(SLAMConfig(), seed=0))
    opt = make_optimizer(net, cfg)
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(N))
    Gs0 = torch.zeros(B, N, 7, device=dev)
    disp0 = torch.zeros(B, N, H // 8, W // 8, device=dev)
    batches = [batch() for _ in range(WARMUP + STEPS)]

    def steps(bs):
        for b in bs:
            train_step(net, opt, b, Gs0, disp0, cfg=cfg, ii=ii, jj=jj)

    steps(batches[:WARMUP])
    prof, wall = recorded(lambda: steps(batches[WARMUP:]))
    report = summarize(prof, wall, STEPS, card_name())
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_train.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])
    print_summary(report, "train step")


if __name__ == "__main__":
    main()
