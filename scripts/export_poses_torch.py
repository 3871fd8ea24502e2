#!/usr/bin/env python
"""Convert a quaternion trajectory to 4x4 pose matrices with the port's
loaders: the counterpart of ``scripts/export_poses.py``.  Pure numpy: no
model runs, so the script takes no device.

Input formats:
  tum      : "t tx ty tz qx qy qz qw" per line (scripts/demo_torch.py output)
  tartan   : TartanAir pose_left.txt "x y z qx qy qz qw" in NED axes
             (permuted to camera xyz as data/tartan.py does)

Writes an [N, 4, 4] .npy stack, and one flattened 4x4 per line when --txt
is given.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.rgbd_datasets import (  # noqa: E402
    quat_pose_to_matrix,
)
from lgu_slam_tpu_torch.data.tartan import ned_to_xyz  # noqa: E402


def main(argv=None) -> np.ndarray:
    """Returns the [N, 4, 4] matrices written."""
    p = argparse.ArgumentParser()
    p.add_argument("trajectory")
    p.add_argument("--format", choices=["tum", "tartan"], default="tum")
    p.add_argument("--out", default=None, help=".npy output (default: "
                   "trajectory path with .npy suffix)")
    p.add_argument("--txt", default=None,
                   help="optional flat-matrix text output")
    args = p.parse_args(argv)

    raw = np.loadtxt(args.trajectory)
    if args.format == "tum":
        pvecs = raw[:, 1:8]  # drop timestamp
    else:
        pvecs = ned_to_xyz(raw)

    mats = np.stack([quat_pose_to_matrix(v) for v in pvecs])
    out = args.out or os.path.splitext(args.trajectory)[0] + ".npy"
    np.save(out, mats.astype(np.float32))
    if args.txt:
        np.savetxt(args.txt, mats.reshape(len(mats), 16), fmt="%.9f")
    print(f"wrote {len(mats)} poses -> {out}")
    return mats


if __name__ == "__main__":
    main()
