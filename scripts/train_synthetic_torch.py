#!/usr/bin/env python
"""Training on synthetic clips with the PyTorch port: the counterpart of
``scripts/train_synthetic.py``.

    python scripts/train_synthetic_torch.py --steps 300 --size 96 128
    python scripts/train_synthetic_torch.py --device cpu --steps 12 \\
        --batch 2 --iters 2 --size 64 96 --scenes 2 --frames_per_scene 10

Runs the port's train step (``parallel/train_dp.py``: the unrolled
``LGUNet.forward`` with a differentiable BA per step, the four losses, the
global-norm clip, AdamW under the one-cycle schedule) on the port's
``SyntheticDataset`` (exact poses and depths), then compares the means of
the first and the last tenth of the steps: ``learned`` holds when the loss
and the flow EPE (``f_error``) both fell by at least 20 %.  It saves the
train state (``--out``) and writes the summary (``--summary``).  The
trained-against-random holdout ATE of the JAX script needs the port's
evaluation code and is not run here.  Runs on the card unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
from lgu_slam_tpu_torch.utils.checkpoint import save_train_state  # noqa: E402
from lgu_slam_tpu_torch.utils.config import (  # noqa: E402
    SLAMConfig,
    TrainConfig,
)
from lgu_slam_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
    use_full_fp32,
)

KEYS = ("loss", "f_error", "rot_error", "tr_error")


def summarize(history, window_frac=0.1):
    """Means of the first and the last ``window_frac`` of the steps."""
    w = max(3, int(len(history) * window_frac))
    first = {k: float(np.mean([h[k] for h in history[:w]])) for k in KEYS}
    last = {k: float(np.mean([h[k] for h in history[-w:]])) for k in KEYS}
    return first, last, w


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--size", type=int, nargs=2, default=(96, 128))
    p.add_argument("--scenes", type=int, default=10)
    p.add_argument("--frames_per_scene", type=int, default=24)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--device", default=None)
    p.add_argument("--out", default="checkpoints/synthetic_proof_torch.pt")
    p.add_argument("--summary", default="build/synthetic_training_torch.json")
    args = p.parse_args()

    dev = resolve_device(args.device)
    use_full_fp32()
    H, W = args.size
    cfg = TrainConfig(batch=args.batch, iters=args.iters, steps=args.steps,
                      lr=args.lr, n_frames=4, image_size=(H, W),
                      pct_start=0.05)
    db = SyntheticDataset(n_scenes=args.scenes,
                          frames_per_scene=args.frames_per_scene,
                          n_frames=cfg.n_frames, crop_size=(H, W), seed=0)
    print(f"[train_synth] dataset: {len(db)} clips ({args.scenes} scenes x "
          f"{args.frames_per_scene} frames) on {dev}")
    net = LGUNet(device=dev)
    net.load_state_dict(init_state_dict(SLAMConfig(), seed=0))
    opt = make_optimizer(net, cfg)
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(cfg.n_frames))
    B, N = cfg.batch, cfg.n_frames
    Gs0 = torch.zeros(B, N, 7, device=dev)
    disp0 = torch.zeros(B, N, H // 8, W // 8, device=dev)

    rng = np.random.default_rng(0)
    history = []
    t_start = time.time()
    for step in range(cfg.steps):
        items = [db[int(i)] for i in rng.integers(0, len(db), size=B)]
        images, poses, depths, intr = (np.stack(x) for x in zip(*items))
        disps = np.where(depths > 0.01, 1.0 / np.maximum(depths, 0.01), 0.0)
        batch = tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                      for x in (images, poses, disps, intr))
        t0 = time.time()
        metrics, _ = train_step(net, opt, batch, Gs0, disp0, cfg=cfg, ii=ii,
                                jj=jj)
        metrics = {k: v.item() for k, v in metrics.items()}  # logs: syncs
        metrics["step_time"] = time.time() - t0
        history.append(metrics)
        if step < 3 or (step + 1) % args.log_every == 0:
            print(f"[train_synth] step {step + 1}/{cfg.steps} "
                  f"loss={metrics['loss']:.4f} "
                  f"f_error={metrics['f_error']:.3f} "
                  f"rot={metrics['rot_error']:.4f} "
                  f"tr={metrics['tr_error']:.4f} "
                  f"({metrics['step_time']:.2f}s)", flush=True)
    elapsed = time.time() - t_start

    first, last, w = summarize(history)
    print(f"[train_synth] {cfg.steps} steps in {elapsed:.0f}s; first-{w}-step "
          f"means vs last-{w}-step means:")
    for k in first:
        print(f"  {k}: {first[k]:.4f} -> {last[k]:.4f} "
              f"({100 * (1 - last[k] / max(first[k], 1e-12)):+.1f}% lower)")
    summary = {
        "steps": cfg.steps, "elapsed_s": elapsed, "device": str(dev),
        "card": torch.cuda.get_device_name(0) if dev.type == "cuda" else None,
        "ms_per_step_median": 1e3 * float(np.median(
            [h["step_time"] for h in history])),
        "first": first, "last": last,
        "learned": bool(last["loss"] < 0.8 * first["loss"]
                        and last["f_error"] < 0.8 * first["f_error"]),
    }
    for path in (args.out, args.summary):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_train_state(args.out, net, opt, cfg.steps, rng.bit_generator.state)
    with open(args.summary, "w") as fh:
        json.dump(summary, fh, indent=2)
    print(f"[train_synth] train state -> {args.out}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
