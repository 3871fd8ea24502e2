#!/usr/bin/env python
"""Self-contained smoke demo of the PyTorch port: the counterpart of
``scripts/synthetic_demo.py``.  Writes a generated textured sequence as PNG
files (the port's own encoder), reads it back through ``image_stream`` and
tracks it through the full SLAM system (motion filter -> frontend ->
backend -> trajectory filler) with random weights.

The scene is a textured plane observed by a translating camera (frames
are crops sliding over a large texture), so flow is nonzero and keyframes
accumulate.  With random weights the trajectory is not metric: the script
asserts pipeline health, finite poses for every input frame.

    python scripts/synthetic_demo_torch.py [--frames 30] [--device cpu]

Runs on the card unless ``--device`` says otherwise.  ``--viewer`` waits
for the port of the live viewer (ROADMAP A.R item 7).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.image_io import imwrite  # noqa: E402
from lgu_slam_tpu_torch.data.streams import image_stream  # noqa: E402
from lgu_slam_tpu_torch.eval.ate import save_tum_trajectory  # noqa: E402
from lgu_slam_tpu_torch.models.net import init_state_dict  # noqa: E402
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.config import SLAMConfig  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402


def generate_sequence(out_dir, frames=30, H=120, W=160, seed=0):
    """Write a sliding-crop textured sequence + calib file."""
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, (H * 2, W * 2, 3)).astype(np.float32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, 2, 0)) / 4  # smooth for stable gradients
    big = big.astype(np.uint8)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    for t in range(frames):
        ox, oy = 2 * t, t
        imwrite(os.path.join(img_dir, f"{t:04d}.png"),
                big[oy:oy + H, ox:ox + W])
    calib = os.path.join(out_dir, "calib.txt")
    with open(calib, "w") as f:
        f.write(f"{W:.1f} {W:.1f} {W / 2:.1f} {H / 2:.1f}\n")
    return img_dir, calib


def main(argv=None) -> np.ndarray:
    """Returns the trajectory (camera-to-world, [frames, 7])."""
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--viewer", action="store_true",
                   help="not ported yet (ROADMAP A.R item 7)")
    p.add_argument("--trajectory_path", default=None,
                   help="output trajectory file (default: inside the "
                        "demo's tempdir, discarded on exit)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.viewer:
        p.error("--viewer is not ported yet (ROADMAP A.R item 7: the host "
                "tools)")
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as td:
        img_dir, calib = generate_sequence(td, frames=args.frames)
        if args.trajectory_path is None:
            args.trajectory_path = os.path.join(
                td, "synthetic_trajectory.txt")

        def make_stream():
            return image_stream(img_dir, calib, stride=1,
                                target_pixels=8000)

        first = next(iter(make_stream()))
        H, W = first[1].shape[:2]
        cfg = SLAMConfig(
            image_size=(H, W), buffer=max(32, args.frames + 18),
            warmup=4, filter_thresh=0.01, keyframe_thresh=0.01,
        )
        slam = LGUSlam(init_state_dict(cfg, seed=0), cfg, device=device)

        tstamps = []
        for t, image, intr in make_stream():
            slam.track(t, image, intrinsics=intr)
            tstamps.append(t)

        kf = slam.video.counter
        traj = slam.terminate(make_stream())
        if len(traj) != len(tstamps) or not np.isfinite(traj).all():
            raise RuntimeError(f"trajectory {traj.shape} for {len(tstamps)} "
                               "frames, or non-finite poses")
        save_tum_trajectory(args.trajectory_path, tstamps, traj)
        print(f"tracked {len(tstamps)} frames -> {kf} keyframes; "
              f"trajectory ({len(traj)} poses, finite) -> "
              f"{args.trajectory_path}")
        print("synthetic demo OK")
    return traj


if __name__ == "__main__":
    main()
