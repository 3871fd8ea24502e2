#!/usr/bin/env python
"""Export a saved reconstruction (the ``.npz`` of ``scripts/demo_torch.py
--reconstruction_path``) to a filtered point cloud ``.ply`` with the
PyTorch port: the counterpart of ``scripts/view_reconstruction.py``
(reference: view_reconstruction.py).

    python scripts/view_reconstruction_torch.py --reconstruction recon.npz \\
        [--out reconstruction.ply] [--device cpu]

The multi-view depth filter and the back-projection run on the card unless
``--device`` says otherwise.  ``--serve`` (the interactive web viewer) is
not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.slam.visualization import (  # noqa: E402
    backproject_points,
    write_ply,
)
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402

NOT_PORTED = ("--serve is not ported yet: it needs the live viewer "
              "(slam/live_viewer.py)")


def main(argv=None) -> int:
    """Returns the number of points written."""
    p = argparse.ArgumentParser()
    p.add_argument("--reconstruction", required=True, help=".npz path")
    p.add_argument("--out", default="reconstruction.ply")
    p.add_argument("--filter_thresh", type=float, default=0.005)
    p.add_argument("--serve", action="store_true", help=NOT_PORTED)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.serve:
        p.error(NOT_PORTED)
    device = resolve_device(args.device)

    data = np.load(args.reconstruction)
    disps = data["disps"]
    if disps.ndim == 3 and disps.shape[1] == data["images"].shape[1]:
        disps8 = disps[:, 3::8, 3::8]  # full-res disps_up -> 1/8
    else:
        disps8 = disps
    pts, colors = backproject_points(
        data["poses"], disps8, data["intrinsics"][0],
        images=data["images"], filter_thresh=args.filter_thresh,
        device=device,
    )
    write_ply(args.out, pts, colors)
    print(f"{len(pts)} points -> {args.out}")
    return len(pts)


if __name__ == "__main__":
    main()
