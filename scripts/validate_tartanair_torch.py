#!/usr/bin/env python
"""TartanAir validation with the PyTorch port: the counterpart of
``scripts/validate_tartanair.py``.  Per-scene ATE, RPE and KITTI scores at
``TARTANAIR_CONFIG`` over the scenes of ``--datapath`` (the official test
split's layout), with the ATE-vs-threshold success curve.

    python scripts/validate_tartanair_torch.py --datapath ROOT \\
        --weights FILE [--scenes ...] [--device cpu]

``--weights`` takes a reference ``.pth``, a train state of the port or a
JAX params pickle.  Runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.image_io import imread  # noqa: E402
from lgu_slam_tpu_torch.data.imgproc import resize  # noqa: E402
from lgu_slam_tpu_torch.data.tartan import (  # noqa: E402
    INTRINSICS,
    ned_to_xyz,
)
from lgu_slam_tpu_torch.eval.ate import (  # noqa: E402
    ate_rmse,
    kitti_metrics,
    rpe,
)
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.checkpoint import load_weights  # noqa: E402
from lgu_slam_tpu_torch.utils.config import TARTANAIR_CONFIG  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402


def tartan_stream(scene, stride=1, image_size=(384, 512)):
    images = sorted(glob.glob(os.path.join(scene, "image_left", "*.png")))
    H, W = image_size
    for t, path in enumerate(images[::stride]):
        img = imread(path)
        h0, w0 = img.shape[:2]
        img = resize(img, (W, H))
        intr = INTRINSICS * np.asarray(
            [W / w0, H / h0, W / w0, H / h0], np.float32
        )
        yield t, img, intr


def evaluate_scene(scene, state_dict, device=None):
    slam = LGUSlam(state_dict, TARTANAIR_CONFIG, device=device)
    for t, img, intr in tartan_stream(scene):
        slam.track(t, img, intrinsics=intr)
    traj = slam.terminate(tartan_stream(scene))

    gt = ned_to_xyz(
        np.loadtxt(os.path.join(scene, "pose_left.txt"), delimiter=" ")
    )
    n = min(len(gt), len(traj))
    rmse, _, _ = ate_rmse(gt[:n, :3], traj[:n, :3], correct_scale=True)
    t_rpe, r_rpe = rpe(gt[:n], traj[:n])
    kitti = kitti_metrics(gt[:n], traj[:n])
    return {"ate": rmse, "rpe_trans": t_rpe, "rpe_rot": r_rpe, **kitti}


def main(argv=None) -> dict:
    """Returns the scores per scene."""
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True, help="TartanAir test root")
    p.add_argument("--weights", required=True)
    p.add_argument("--stereo", action="store_true",
                   help="accepted as the JAX script accepts it; its scores "
                        "are the monocular ones")
    p.add_argument("--scenes", nargs="*", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    state_dict = load_weights(args.weights)

    scenes = args.scenes or sorted(
        glob.glob(os.path.join(args.datapath, "*/P*"))
    )
    results = {}
    for scene in scenes:
        r = evaluate_scene(scene, state_dict, device=device)
        results[scene] = r
        print(scene, json.dumps(r))

    ates = [r["ate"] for r in results.values()]
    # ATE-vs-threshold success curve
    curve = {
        f"<{th}": float(np.mean([a < th for a in ates]))
        for th in (0.05, 0.1, 0.25, 0.5, 1.0)
    }
    print(json.dumps({"mean_ate": float(np.mean(ates)), "success": curve}))
    return results


if __name__ == "__main__":
    main()
