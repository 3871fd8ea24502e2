#!/usr/bin/env python
"""ETH3D SLAM evaluation with the PyTorch port: the counterpart of
``scripts/evaluate_eth3d.py``.  RGB-D tracking (depth / 5000) with the
depth-conditioned BA at ``ETH3D_CONFIG``, writing timestamped trajectory
files in the official submission format.

    python scripts/evaluate_eth3d_torch.py --datapath ETH3D_ROOT \\
        --weights FILE [--sequences ...] [--outdir DIR] [--device cpu]

``--weights`` takes a reference ``.pth``, a train state of the port or a
JAX params pickle.  Runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.image_io import imread  # noqa: E402
from lgu_slam_tpu_torch.data.imgproc import NEAREST, resize  # noqa: E402
from lgu_slam_tpu_torch.data.streams import read_list  # noqa: E402
from lgu_slam_tpu_torch.eval.ate import (  # noqa: E402
    associate,
    save_tum_trajectory,
)
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.checkpoint import load_weights  # noqa: E402
from lgu_slam_tpu_torch.utils.config import ETH3D_CONFIG  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402


def eth3d_stream(datapath, stride=1, use_depth=True):
    """(t, image, [depth,] intrinsics) of an ETH3D SLAM sequence, cropped
    to multiples of 8."""
    rgb = read_list(datapath, "rgb.txt")
    depth = read_list(datapath, "depth.txt")
    pairs = associate(
        np.asarray([r[0] for r in rgb]), np.asarray([d[0] for d in depth])
    )
    calib = np.loadtxt(os.path.join(datapath, "calibration.txt"))

    for ia, ib in pairs[::stride]:
        image = imread(os.path.join(datapath, rgb[ia][1]))
        d = imread(os.path.join(datapath, depth[ib][1]), anydepth=True
                   ).astype(np.float32) / 5000.0
        h0, w0 = image.shape[:2]
        h1 = h0 - h0 % 8
        w1 = w0 - w0 % 8
        image = resize(image, (w1, h1))
        d = resize(d, (w1, h1), NEAREST)
        intr = np.asarray(
            [calib[0] * w1 / w0, calib[1] * h1 / h0,
             calib[2] * w1 / w0, calib[3] * h1 / h0], np.float32,
        )
        if use_depth:
            yield rgb[ia][0], image, d, intr
        else:
            yield rgb[ia][0], image, intr


def main(argv=None) -> dict:
    """Returns the trajectory file written per sequence."""
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--sequences", nargs="*", default=None)
    p.add_argument("--outdir", default="eth3d_results")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    state_dict = load_weights(args.weights)

    os.makedirs(args.outdir, exist_ok=True)
    seqs = args.sequences or sorted(os.listdir(args.datapath))
    written = {}
    for seq in seqs:
        path = os.path.join(args.datapath, seq)
        if not os.path.isdir(path):
            continue
        slam = LGUSlam(state_dict, ETH3D_CONFIG, device=device)
        tstamps = []
        for t, image, d, intr in eth3d_stream(path):
            slam.track(t, image, depth=d, intrinsics=intr)
            tstamps.append(t)
        traj = slam.terminate(eth3d_stream(path, use_depth=False))
        out = os.path.join(args.outdir, f"{seq}.txt")
        save_tum_trajectory(out, tstamps[: len(traj)], traj)
        written[seq] = out
        print(seq, "->", out)
    return written


if __name__ == "__main__":
    main()
