#!/usr/bin/env python
"""EuRoC stereo evaluation with the PyTorch port: the counterpart of
``scripts/evaluate_euroc.py``.  Stereo tracking at stride 2 at
``EUROC_CONFIG`` (320 x 512, the factory rectification), trajectory fill at
stride 1, Sim(3)-aligned ATE against the state-estimate ground truth.

    python scripts/evaluate_euroc_torch.py --datapath EUROC_ROOT \\
        --weights FILE [--sequences MH_01_easy ...] [--gt_dir DIR] \\
        [--device cpu]

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

from lgu_slam_tpu_torch.data.streams import euroc_stereo_stream  # noqa: E402
from lgu_slam_tpu_torch.eval.ate import (  # noqa: E402
    associate,
    ate_rmse,
    load_euroc_gt_txt,
)
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.checkpoint import load_weights  # noqa: E402
from lgu_slam_tpu_torch.utils.config import EUROC_CONFIG  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402

SEQUENCES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
    "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]


def load_gt(datapath, gt_txt=None):
    """Ground truth from the dataset's state-estimate csv, or -- when
    ``gt_txt`` is given -- from a standalone EuRoC gt .txt in the format
    the reference vendors at data/euroc_groundtruth/*.txt."""
    if gt_txt is not None:
        return load_euroc_gt_txt(gt_txt)
    path = os.path.join(
        datapath, "mav0", "state_groundtruth_estimate0", "data.csv"
    )
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    # t[ns], px py pz, qw qx qy qz -> (t, q(xyzw))
    t = data[:, 0] / 1e9
    poses = np.concatenate(
        [data[:, 1:4], data[:, [5, 6, 7, 4]]], axis=1
    )
    return t, poses


def evaluate_sequence(datapath, state_dict, gt_txt=None, device=None):
    """Track, fill and score one sequence; returns (ATE RMSE, number of
    poses)."""
    slam = LGUSlam(state_dict, EUROC_CONFIG, device=device)
    for t, image, intr in euroc_stereo_stream(datapath, stride=2):
        slam.track(t, image, intrinsics=intr)

    fill = euroc_stereo_stream(datapath, stride=1)
    traj = slam.terminate(fill)
    est_t = [t for t, *_ in euroc_stereo_stream(datapath, stride=1)]

    gt_t, gt_poses = load_gt(datapath, gt_txt=gt_txt)
    pairs = associate(np.asarray(est_t[: len(traj)]), gt_t, max_dt=0.05)
    ia = [a for a, _ in pairs]
    ib = [b for _, b in pairs]
    rmse, _, _ = ate_rmse(
        gt_poses[ib][:, :3], traj[ia][:, :3], correct_scale=True
    )
    return rmse, len(traj)


def main(argv=None) -> dict:
    """Returns the ATE and the number of poses per sequence evaluated."""
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--sequences", nargs="*", default=SEQUENCES)
    p.add_argument("--gt_dir", default=None,
                   help="directory of <seq>.txt gt files "
                        "(reference data/euroc_groundtruth format)")
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
        gt_txt = (
            os.path.join(args.gt_dir, seq + ".txt") if args.gt_dir else None
        )
        rmse, n = evaluate_sequence(path, state_dict, gt_txt=gt_txt,
                                    device=device)
        results[seq] = {"ate": rmse, "poses": n}
        print(f"{seq}: ATE {rmse:.4f} m over {n} frames")

    if results:
        ate = {seq: r["ate"] for seq, r in results.items()}
        print(json.dumps({"mean_ate": float(np.mean(list(ate.values()))),
                          "per_seq": ate}))
    return results


if __name__ == "__main__":
    main()
