#!/usr/bin/env python
"""Monocular / RGB-D demo with the PyTorch port: the counterpart of
``scripts/demo.py``.

    python scripts/demo_torch.py --imagedir DIR --calib calib.txt \\
        [--depthdir DIR] [--weights FILE] [--device cpu]

Runs the SLAM system on an image directory (PNG or JPEG frames;
``--depthdir`` adds aligned 16-bit depth PNGs), fills the trajectory of
every frame and saves it in TUM format, plus an optional reconstruction
``.npz`` (the keys of the JAX demo's) for the 3DGS stage
(``scripts/gs_slam_torch.py``).  ``--export_every N`` writes growing
``.ply`` snapshots of the filtered point cloud and the camera frusta every
N tracked frames, and a final pair after ``terminate()``, into
``--export_dir``.  ``--viewer`` serves the growing reconstruction in the
live web viewer (``slam/live_viewer.py``) at ``--viewer_port`` on every
interface, refreshed after each tracked frame and after ``terminate()``;
it serves until the process exits (``main`` returns it).  ``--weights``
takes a reference ``.pth``, a train state of the port or a JAX params
pickle (``utils/checkpoint.load_weights``); without it the weights are the
port's random init.  Runs on the card unless ``--device`` says otherwise.
The time spent reading frames (decode, undistort, resize), tracking them
and refreshing the viewer is printed per frame at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.streams import (  # noqa: E402
    image_stream,
    rgbd_stream,
)
from lgu_slam_tpu_torch.eval.ate import save_tum_trajectory  # noqa: E402
from lgu_slam_tpu_torch.models.net import init_state_dict  # noqa: E402
from lgu_slam_tpu_torch.slam.live_viewer import LiveViewer  # noqa: E402
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.slam.visualization import (  # noqa: E402
    IncrementalReconstruction,
)
from lgu_slam_tpu_torch.utils.checkpoint import load_weights  # noqa: E402
from lgu_slam_tpu_torch.utils.config import SLAMConfig  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402
from lgu_slam_tpu_torch.utils.profiling import PhaseTimer  # noqa: E402


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--imagedir", required=True)
    p.add_argument("--depthdir", default=None, help="aligned depth (RGB-D)")
    p.add_argument("--calib", required=True)
    p.add_argument("--weights", default=None,
                   help="reference .pth, port train state or JAX params "
                        "pickle")
    p.add_argument("--t0", type=int, default=0)
    p.add_argument("--stride", type=int, default=3)
    p.add_argument("--buffer", type=int, default=512)
    p.add_argument("--filter_thresh", type=float, default=2.4)
    p.add_argument("--warmup", type=int, default=12)
    p.add_argument("--keyframe_thresh", type=float, default=3.5)
    p.add_argument("--frontend_thresh", type=float, default=16.0)
    p.add_argument("--frontend_window", type=int, default=20)
    p.add_argument("--frontend_radius", type=int, default=1)
    p.add_argument("--frontend_nms", type=int, default=1)
    p.add_argument("--backend_thresh", type=float, default=22.0)
    p.add_argument("--backend_radius", type=int, default=2)
    p.add_argument("--backend_nms", type=int, default=3)
    p.add_argument("--upsample", action="store_true")
    p.add_argument("--trajectory_path", default="trajectory.txt")
    p.add_argument("--reconstruction_path", default=None)
    p.add_argument("--target_pixels", type=int, default=384 * 512,
                   help="resize frames to ~this many pixels")
    p.add_argument("--export_every", type=int, default=0,
                   help="write growing .ply snapshots every N frames")
    p.add_argument("--export_dir", default="recon")
    p.add_argument("--viewer", action="store_true",
                   help="serve a live interactive web viewer")
    p.add_argument("--viewer_port", type=int, default=8090)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def export(inc: IncrementalReconstruction, export_dir: str, tag: str):
    """Write the current point cloud and camera frusta as .ply files."""
    inc.export_ply(os.path.join(export_dir, f"points_{tag}.ply"))
    inc.export_frusta(os.path.join(export_dir, f"cameras_{tag}.ply"))


def main(argv=None) -> dict:
    """Returns the trajectory's timestamps and poses (camera-to-world,
    ``[T, 7]``), the per-phase times (``PhaseTimer.summary()``), the live
    viewer (still serving; None without ``--viewer``) and the incremental
    reconstruction it serves."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    def make_stream():
        if args.depthdir:
            return rgbd_stream(
                args.imagedir, args.depthdir, args.calib, args.stride,
                target_pixels=args.target_pixels,
            )
        return image_stream(args.imagedir, args.calib, args.stride,
                            target_pixels=args.target_pixels)

    # probe first frame for image size
    first = next(iter(make_stream()))
    H, W = first[1].shape[:2]

    cfg = SLAMConfig(
        image_size=(H, W), buffer=args.buffer,
        filter_thresh=args.filter_thresh, warmup=args.warmup,
        keyframe_thresh=args.keyframe_thresh,
        frontend_thresh=args.frontend_thresh,
        frontend_window=args.frontend_window,
        frontend_radius=args.frontend_radius,
        frontend_nms=args.frontend_nms,
        backend_thresh=args.backend_thresh,
        backend_radius=args.backend_radius,
        backend_nms=args.backend_nms,
        upsample=args.upsample,
    )
    weights = (load_weights(args.weights) if args.weights
               else init_state_dict(cfg, seed=0))
    slam = LGUSlam(weights, cfg, device=device)
    inc = viewer = None
    if args.export_every or args.viewer:
        inc = IncrementalReconstruction(slam.video)
    if args.export_every:
        os.makedirs(args.export_dir, exist_ok=True)
    if args.viewer:
        viewer = LiveViewer(inc, port=args.viewer_port, host="0.0.0.0")
        print(f"live viewer at {viewer.url}")

    timer = PhaseTimer()
    tstamps = []
    n_tracked = 0
    frames = iter(make_stream())
    while True:
        with timer.phase("read"):
            item = next(frames, None)
        if item is None:
            break
        t, image = item[0], item[1]
        if t < args.t0:
            continue
        depth = item[2] if args.depthdir else None
        with timer.phase("track", sync=device):
            slam.track(t, image, depth=depth, intrinsics=item[-1])
        tstamps.append(t)
        n_tracked += 1
        if viewer is not None:
            with timer.phase("view"):
                viewer.refresh()
        # consume the dirty-flag protocol incrementally
        # (droid_slam/visualization.py:81-112)
        if args.export_every and n_tracked % args.export_every == 0 \
                and (viewer is not None or inc.update()):
            export(inc, args.export_dir, f"{n_tracked:05d}")

    with timer.phase("terminate", sync=device):
        traj = slam.terminate(make_stream())
    if viewer is not None:
        viewer.refresh()
    elif inc is not None:
        inc.update()
    if args.export_every:
        export(inc, args.export_dir, "final")
    save_tum_trajectory(args.trajectory_path, tstamps[: len(traj)], traj)
    print(f"trajectory ({len(traj)} poses) -> {args.trajectory_path}")
    print(json.dumps({"ms_per_frame": {
        k: v["mean_ms"] for k, v in timer.summary().items()}}))

    if args.reconstruction_path:
        v = slam.video
        n = v.counter
        np.savez_compressed(
            args.reconstruction_path,
            tstamps=v.tstamp[:n].cpu().numpy(),
            images=v.images[:n].cpu().numpy(),
            disps=(v.disps_up if args.upsample else v.disps)[:n]
            .cpu().numpy(),
            poses=v.poses[:n].cpu().numpy(),
            intrinsics=v.intrinsics[:n].cpu().numpy(),
        )
        print("reconstruction ->", args.reconstruction_path)
    return {"tstamps": tstamps[: len(traj)], "trajectory": traj,
            "phases": timer.summary(), "viewer": viewer,
            "reconstruction": inc}


if __name__ == "__main__":
    main()
