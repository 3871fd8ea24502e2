#!/usr/bin/env python
"""Export a saved reconstruction (the ``.npz`` of ``scripts/demo_torch.py
--reconstruction_path``) to a filtered point cloud ``.ply`` with the
PyTorch port: the counterpart of ``scripts/view_reconstruction.py``
(reference: view_reconstruction.py).

    python scripts/view_reconstruction_torch.py --reconstruction recon.npz \\
        [--out reconstruction.ply] [--serve [--port 8090]] [--device cpu]

The multi-view depth filter and the back-projection run on the card unless
``--device`` says otherwise.  ``--serve`` serves the filtered cloud and the
cameras in the live web viewer (``slam/live_viewer.py``) at ``--port`` on
every interface until interrupted, instead of writing the ``.ply``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.slam.live_viewer import LiveViewer  # noqa: E402
from lgu_slam_tpu_torch.slam.visualization import (  # noqa: E402
    backproject_points,
    write_ply,
)
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402


class Snapshot:
    """A fixed reconstruction in the shape the viewer reads: one cloud
    and the keyframes' world-to-camera poses."""

    def __init__(self, points, colors, poses):
        self.points = {0: (points, colors)}
        self.cameras = {i: np.asarray(p) for i, p in enumerate(poses)}

    def update(self):
        return 0


def wait(viewer: LiveViewer):
    """Serve until interrupted (ctrl-c), then close the viewer."""
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        viewer.close()


def main(argv=None) -> int:
    """Returns the number of points written (or served)."""
    p = argparse.ArgumentParser()
    p.add_argument("--reconstruction", required=True, help=".npz path")
    p.add_argument("--out", default="reconstruction.ply")
    p.add_argument("--filter_thresh", type=float, default=0.005)
    p.add_argument("--serve", action="store_true",
                   help="serve the cloud in the interactive web viewer "
                        "instead of writing a .ply")
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
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
    if args.serve:
        viewer = LiveViewer(Snapshot(pts, colors, data["poses"]),
                            port=args.port, host="0.0.0.0")
        print(f"serving {len(pts)} points at {viewer.url} (ctrl-c to stop)")
        wait(viewer)
        return len(pts)
    write_ply(args.out, pts, colors)
    print(f"{len(pts)} points -> {args.out}")
    return len(pts)


if __name__ == "__main__":
    main()
