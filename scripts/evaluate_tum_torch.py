#!/usr/bin/env python
"""TUM-RGBD evaluation with the PyTorch port: the counterpart of
``scripts/evaluate_tum.py``.  Runs mono SLAM (``--use_depth``: RGB-D) on fr1
sequences at stride 2 at ``TUM_CONFIG``, fills the trajectory at stride 1
and scores the Sim(3)-aligned ATE against ``groundtruth.txt``.

    python scripts/evaluate_tum_torch.py --datapath TUM_ROOT --weights FILE \\
        [--sequences rgbd_dataset_freiburg1_desk ...] [--device cpu]

``--weights`` takes a reference ``.pth``, a train state of the port or a
JAX params pickle.  Runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.streams import tum_rgbd_stream  # noqa: E402
from lgu_slam_tpu_torch.eval.ate import associate, ate_rmse  # noqa: E402
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.checkpoint import load_weights  # noqa: E402
from lgu_slam_tpu_torch.utils.config import TUM_CONFIG  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402

# the reference's tools/evaluate_tum.sh sequence list
SEQUENCES = [
    "rgbd_dataset_freiburg1_360",
    "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_desk2",
    "rgbd_dataset_freiburg1_floor",
    "rgbd_dataset_freiburg1_plant",
    "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg1_rpy",
    "rgbd_dataset_freiburg1_teddy",
    "rgbd_dataset_freiburg1_xyz",
]


def load_gt(datapath):
    gt = np.loadtxt(
        os.path.join(datapath, "groundtruth.txt"), comments="#"
    )
    return gt[:, 0], gt[:, 1:8]


def evaluate_sequence(datapath, state_dict, use_depth=False, upsample=False,
                      device=None):
    """Track, fill and score one sequence; returns (ATE RMSE, number of
    poses).  ``--upsample`` keeps full-resolution disparities through the
    learned convex-upsampling masks."""
    slam = LGUSlam(state_dict, TUM_CONFIG.replace(upsample=upsample),
                   device=device)
    for t, image, depth, intr in tum_rgbd_stream(datapath, stride=2):
        slam.track(t, image, depth=depth if use_depth else None,
                   intrinsics=intr)

    def stream():
        for t, image, depth, intr in tum_rgbd_stream(datapath, stride=1):
            yield t, image, intr

    traj = slam.terminate(stream())
    est_t = [t for t, *_ in tum_rgbd_stream(datapath, stride=1)]

    gt_t, gt_poses = load_gt(datapath)
    pairs = associate(np.asarray(est_t[: len(traj)]), gt_t, max_dt=0.08)
    ia = [a for a, _ in pairs]
    ib = [b for _, b in pairs]
    rmse, _, _ = ate_rmse(
        gt_poses[ib][:, :3], traj[ia][:, :3], correct_scale=True
    )
    return rmse, len(traj)


def main(argv=None) -> dict:
    """Returns the ATE and the number of poses per sequence evaluated."""
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True, help="TUM root dir")
    p.add_argument("--weights", required=True)
    p.add_argument("--sequences", nargs="*", default=SEQUENCES)
    p.add_argument("--use_depth", action="store_true")
    p.add_argument("--upsample", action="store_true",
                   help="maintain full-res disparities via the learned "
                        "convex-upsampling masks")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    state_dict = load_weights(args.weights)

    results = {}
    for seq in args.sequences:
        path = os.path.join(args.datapath, seq)
        if not os.path.isdir(path):
            print("skip", seq)
            continue
        rmse, n = evaluate_sequence(path, state_dict, args.use_depth,
                                    upsample=args.upsample, device=device)
        results[seq] = {"ate": rmse, "poses": n}
        print(f"{seq}: ATE {rmse:.4f} m over {n} frames")

    if results:
        ate = {seq: r["ate"] for seq, r in results.items()}
        print(json.dumps({"mean_ate": float(np.mean(list(ate.values()))),
                          "per_seq": ate}))
    return results


if __name__ == "__main__":
    main()
