#!/usr/bin/env python
"""Training on synthetic clips with the PyTorch port: the counterpart of
``scripts/train_synthetic.py``.

    python scripts/train_synthetic_torch.py --steps 400 --holdout
    python scripts/train_synthetic_torch.py --holdout_from \
        checkpoints/synthetic_proof_torch.pt
    python scripts/train_synthetic_torch.py --device cpu --steps 12 \
        --batch 2 --iters 2 --size 64 96 --scenes 2 --frames_per_scene 10
    torchrun --nproc_per_node 4 scripts/train_synthetic_torch.py --steps 400

Runs the port's train step (``parallel/train_dp.py``: the unrolled
``LGUNet.forward`` with a differentiable BA per step, the four losses, the
global-norm clip, AdamW under the one-cycle schedule) on the port's
``SyntheticDataset`` (exact poses and depths), then compares the means of
the first and the last tenth of the steps: ``learned`` holds when the loss
and the flow EPE (``f_error``) both fell by at least 20 %.  It saves the
train state (``--out``) and writes the summary (``--summary``).

``--holdout`` then tracks a held-out clip (``render_clip`` seed 90210,
``--holdout_frames`` frames) in fp32 with the trained and with the random
initial weights, runs ``terminate`` over it, and scores the Sim(3)-aligned
ATE of each against the exact trajectory; ``--holdout_from`` skips
training and takes the trained weights from a train state.  The script
asserts that the trained weights beat the random ones.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the step runs data-parallel, one
process per device: every rank draws the same clips and trains on its
share of the batch; rank 0 logs, saves and runs the holdout.  Runs on the
card unless ``--device`` says otherwise.
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
import torch.distributed as dist  # noqa: E402

from lgu_slam_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticDataset,
    render_clip,
)
from lgu_slam_tpu_torch.eval.ate import ate_rmse  # noqa: E402
from lgu_slam_tpu_torch.models.net import (  # noqa: E402
    LGUNet,
    init_state_dict,
)
from lgu_slam_tpu_torch.parallel.train_dp import (  # noqa: E402
    data_parallel,
    make_optimizer,
    mean_over_ranks,
    shard_batch,
    train_step,
    window_edges,
)
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.checkpoint import (  # noqa: E402
    save_train_state,
    unwrap,
)
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


def holdout_config(H: int, W: int, n_frames: int) -> SLAMConfig:
    """The JAX script's holdout configuration, in fp32."""
    return SLAMConfig(
        image_size=(H, W), buffer=n_frames + 20, warmup=8,
        filter_thresh=0.1, keyframe_thresh=0.25, frontend_window=12,
        frontend_radius=2, frontend_thresh=24.0, frontend_iters1=4,
        frontend_iters2=2, max_factors=48, edge_bucket=64,
        inactive_bucket=64, pose_bucket=n_frames + 20, frame_bucket=48,
        backend_edge_cap=16 * n_frames, backend_chunk=64,
        backend_thresh=32.0, volume_dtype="float32",
        compute_dtype="float32", feat_dtype="float32")


def run_holdout(weights: dict, size, n_frames: int, device) -> dict:
    """Track the held-out clip with each state dict of ``weights`` (name ->
    state dict) and ``terminate`` over it; returns name -> Sim(3)-aligned
    ATE against the exact trajectory (camera-to-world translations)."""
    H, W = size
    images, poses_gt, _, intr = render_clip(
        seed=90210, n_frames=n_frames, H=H, W=W, t_step=0.6, r_step=0.03)
    cfg = holdout_config(H, W, n_frames)
    out = {}
    for name, sd in weights.items():
        slam = LGUSlam(sd, cfg, device=device)
        for t in range(n_frames):
            slam.track(float(t), images[t], intrinsics=intr[t])
        traj = slam.terminate(
            (float(t), images[t], intr[t]) for t in range(n_frames))
        rmse, _, _ = ate_rmse(poses_gt[:, :3], traj[:, :3],
                              correct_scale=True)
        out[name] = float(rmse)
        print(f"[train_synth] holdout ATE ({name} weights): {rmse:.4f}",
              flush=True)
    return out


def init_distributed(device):
    """Under torchrun: join the process group (NCCL on the card, gloo on
    the CPU) and take this rank's card.  Returns (device, rank)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return resolve_device(device), 0
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, dist.get_rank()


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
    p.add_argument("--holdout", action="store_true")
    p.add_argument("--holdout_from", default=None,
                   help="skip training; run the holdout ATE comparison "
                        "with the weights of this train state")
    p.add_argument("--holdout_frames", type=int, default=30)
    p.add_argument("--out", default="checkpoints/synthetic_proof_torch.pt")
    p.add_argument("--summary", default="build/synthetic_training_torch.json")
    args = p.parse_args()

    dev, rank = init_distributed(args.device)
    use_full_fp32()
    H, W = args.size
    random_sd = init_state_dict(SLAMConfig(), seed=0)
    for path in (args.out, args.summary):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    if args.holdout_from:
        state = torch.load(args.holdout_from, map_location="cpu",
                           weights_only=True)
        print(f"[train_synth] holdout-only from {args.holdout_from} "
              f"(step {state['step']})")
        ate = run_holdout({"trained": state["model"], "random": random_sd},
                          (H, W), args.holdout_frames, dev)
        with open(args.summary, "w") as fh:
            json.dump({"holdout_ate": ate}, fh, indent=2)
        print(json.dumps({"holdout_ate": ate}))
        assert ate["trained"] < ate["random"], (
            "trained weights did not beat random-init ATE")
        print("[train_synth] TRAINED WEIGHTS BEAT RANDOM INIT")
        return

    cfg = TrainConfig(batch=args.batch, iters=args.iters, steps=args.steps,
                      lr=args.lr, n_frames=4, image_size=(H, W),
                      pct_start=0.05)
    db = SyntheticDataset(n_scenes=args.scenes,
                          frames_per_scene=args.frames_per_scene,
                          n_frames=cfg.n_frames, crop_size=(H, W), seed=0)
    print(f"[train_synth] dataset: {len(db)} clips ({args.scenes} scenes x "
          f"{args.frames_per_scene} frames) on {dev}")
    net = LGUNet(device=dev)
    net.load_state_dict(random_sd)
    ddp = dist.is_initialized()
    model = data_parallel(net) if ddp else net
    opt = make_optimizer(model, cfg)
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(cfg.n_frames))
    B, N = cfg.batch, cfg.n_frames
    Gs0 = torch.zeros(B, N, 7, device=dev)
    disp0 = torch.zeros(B, N, H // 8, W // 8, device=dev)
    if ddp:
        Gs0, disp0 = shard_batch((Gs0, disp0))

    # one draw for the whole batch: every rank sees the clips a one-process
    # run sees, and trains on its share
    rng = np.random.default_rng(0)
    history = []
    t_start = time.time()
    for step in range(cfg.steps):
        items = [db[int(i)] for i in rng.integers(0, len(db), size=B)]
        images, poses, depths, intr = (np.stack(x) for x in zip(*items))
        disps = np.where(depths > 0.01, 1.0 / np.maximum(depths, 0.01), 0.0)
        batch = tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                      for x in (images, poses, disps, intr))
        if ddp:
            batch = shard_batch(batch)
        t0 = time.time()
        metrics, _ = train_step(model, opt, batch, Gs0, disp0, cfg=cfg,
                                ii=ii, jj=jj)
        if ddp:
            metrics = mean_over_ranks(metrics)
        metrics = {k: v.item() for k, v in metrics.items()}  # logs: syncs
        metrics["step_time"] = time.time() - t0
        history.append(metrics)
        if rank == 0 and (step < 3 or (step + 1) % args.log_every == 0):
            print(f"[train_synth] step {step + 1}/{cfg.steps} "
                  f"loss={metrics['loss']:.4f} "
                  f"f_error={metrics['f_error']:.3f} "
                  f"rot={metrics['rot_error']:.4f} "
                  f"tr={metrics['tr_error']:.4f} "
                  f"({metrics['step_time']:.2f}s)", flush=True)
    elapsed = time.time() - t_start
    if rank != 0:
        dist.destroy_process_group()
        return

    first, last, w = summarize(history)
    print(f"[train_synth] {cfg.steps} steps in {elapsed:.0f}s; first-{w}-step "
          f"means vs last-{w}-step means:")
    for k in first:
        print(f"  {k}: {first[k]:.4f} -> {last[k]:.4f} "
              f"({100 * (1 - last[k] / max(first[k], 1e-12)):+.1f}% lower)")
    summary = {
        "steps": cfg.steps, "elapsed_s": elapsed, "device": str(dev),
        "ranks": dist.get_world_size() if ddp else 1,
        "card": torch.cuda.get_device_name(0) if dev.type == "cuda" else None,
        "ms_per_step_median": 1e3 * float(np.median(
            [h["step_time"] for h in history])),
        "first": first, "last": last,
        "learned": bool(last["loss"] < 0.8 * first["loss"]
                        and last["f_error"] < 0.8 * first["f_error"]),
    }
    save_train_state(args.out, model, opt, cfg.steps, rng.bit_generator.state)
    print(f"[train_synth] train state -> {args.out}")
    if args.holdout:
        trained = {k: v.detach().cpu().clone()
                   for k, v in unwrap(model).state_dict().items()}
        summary["holdout_ate"] = run_holdout(
            {"trained": trained, "random": random_sd}, (H, W),
            args.holdout_frames, dev)
    with open(args.summary, "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary))
    if ddp:
        dist.destroy_process_group()
    if args.holdout:
        assert summary["holdout_ate"]["trained"] < \
            summary["holdout_ate"]["random"], (
                "trained weights did not beat random-init ATE")
        print("[train_synth] TRAINED WEIGHTS BEAT RANDOM INIT")


if __name__ == "__main__":
    main()
