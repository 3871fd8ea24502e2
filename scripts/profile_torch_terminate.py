#!/usr/bin/env python
"""Where the time of the PyTorch port's ``terminate()`` goes, on one GPU.

    python scripts/profile_torch_terminate.py [--out DIR]

Tracks 24 synthetic 384 x 512 keyframes with ``SLAMConfig()`` (thresholds
0 so random weights take every frame), as ``chip_smoke.py`` phase 3 does,
then runs one backend pass and one 16-frame filler batch to warm up, and
records a backend pass of two low-memory steps and one filler batch under
``torch.profiler``.  For each it prints the wall time per unit (backend
step, filler batch), the device's busy share, the device time per kernel
group and per kernel, and the PyTorch ops with the most device time by
input shape; the full tables go to ``DIR/profile_torch_terminate.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import torch  # noqa: E402
from profile_torch_track import (  # noqa: E402
    card_name,
    print_summary,
    summarize,
)
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from lgu_slam_tpu_torch.models.net import init_state_dict  # noqa: E402
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.config import SLAMConfig  # noqa: E402
from lgu_slam_tpu_torch.utils.synthetic import (  # noqa: E402
    shifted_texture_frames,
)

KEYFRAMES = 24
STEPS = 2  # low-memory steps recorded


def recorded(fn):
    """Run ``fn`` under the profiler; returns (profile, wall ms)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return prof, wall_ms


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_terminate: needs an NVIDIA GPU")

    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0)
    H, W = cfg.image_size
    slam = LGUSlam(init_state_dict(cfg, 0), cfg)
    frames = list(shifted_texture_frames(KEYFRAMES, H, W, 1))
    for t, img, intr in frames:
        slam.track(float(t), img, intrinsics=intr)
    del slam.frontend  # as terminate() does
    batch = frames[:16]
    slam.backend(1)
    slam.traj_filler(iter(batch))

    card = card_name()
    reports = {}
    prof, wall = recorded(lambda: slam.backend(STEPS))
    reports["backend_step"] = summarize(prof, wall, STEPS, card)
    prof, wall = recorded(lambda: slam.traj_filler(iter(batch)))
    reports["filler_batch"] = summarize(prof, wall, 1, card)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_terminate.json"),
              "w") as f:
        json.dump(reports, f, indent=1)
    print(card)
    for unit, report in reports.items():
        print_summary(report, unit.replace("_", " "))


if __name__ == "__main__":
    main()
