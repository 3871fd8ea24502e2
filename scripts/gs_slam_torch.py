#!/usr/bin/env python
"""3DGS mapping over a saved SLAM reconstruction with the PyTorch port: the
counterpart of ``scripts/gs_slam.py`` (reference: to3DGS/executeSlam.py +
pc2mesh.py).

    python scripts/gs_slam_torch.py --reconstruction recon.npz \\
        [--mesh mesh.ply] [--max_frames N] [--device cpu]

Loads the ``.npz`` that ``scripts/demo_torch.py --reconstruction_path``
writes (BGR uint8 images, ``disps`` at 1/8 or, with ``--upsample``, full
resolution, world-to-camera poses, 1/8-scale intrinsics), fits an isotropic
Gaussian-splat scene with the SplaTAM-style mapping loop, saves it, and
with ``--mesh`` renders each frame and fuses a TSDF mesh.  Runs on the card
unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lgu_slam_tpu_torch.gs.mapping import (  # noqa: E402
    GaussianMapper,
    GSConfig,
)
from lgu_slam_tpu_torch.gs.render import render_rgbd  # noqa: E402
from lgu_slam_tpu_torch.gs.tsdf import TSDFVolume, write_mesh_ply  # noqa: E402
from lgu_slam_tpu_torch.lie import so3_matrix  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--reconstruction", required=True,
                   help=".npz from scripts/demo_torch.py")
    p.add_argument("--out", default="gs_scene.npz")
    p.add_argument("--mesh", default=None, help="optional mesh .ply output")
    p.add_argument("--mapping_iters", type=int, default=60)
    p.add_argument("--capacity", type=int, default=400000)
    p.add_argument("--voxel", type=float, default=0.02)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Returns the Gaussian count, each frame's last loss and, with
    ``--mesh``, the mesh's vertex and triangle counts."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    data = np.load(args.reconstruction)
    images = data["images"]  # [T, H, W, 3] BGR uint8
    disps = data["disps"]
    poses = data["poses"]  # [T, 7] w2c
    intr8 = data["intrinsics"][0]  # 1/8 scale

    T = len(images) if args.max_frames is None else min(
        len(images), args.max_frames
    )
    H, W = images.shape[1:3]
    h, w = disps.shape[1:3]
    scale = H // h  # 1 if disps_up saved, 8 otherwise
    intr = intr8 * 8.0 / scale
    img_size = (h, w)

    cfg = GSConfig(capacity=args.capacity, mapping_iters=args.mapping_iters)
    mapper = GaussianMapper(cfg, img_size, device=device)

    def frame_data(t):
        img = images[t]
        if scale != 1:
            img = img[scale // 2::scale, scale // 2::scale]
        im = img[..., ::-1].astype(np.float32) / 255.0
        depth = 1.0 / np.maximum(np.asarray(disps[t]), 1e-3)
        R = so3_matrix(torch.from_numpy(poses[t, 3:7])).numpy()
        return im, depth, R, poses[t, :3], intr

    window = []
    frame_losses = []
    for t in range(T):
        im, depth, R, tr, K = frame_data(t)
        mapper.add_frame_gaussians(im, depth, R, tr, K, t)
        window.append(mapper.frame_tensors(im, depth, R, tr, K))
        window = window[-cfg.mapping_window_size:]
        losses = mapper.map_frame(window)
        frame_losses.append(losses[-1])
        msg = (
            f"frame {t}: {mapper.map.count} gaussians, "
            f"loss {losses[-1]:.4f}"
        )
        if t % 10 == 0:
            # truncation telemetry: the span/k_max caps drop
            # contributions silently (the reference rasterizer is exact)
            st = mapper.truncation_stats(window[-1])
            if st["dropped_pairs_kmax"] or st["clamped_radius"]:
                msg += (
                    f"  [TRUNCATED: {st['dropped_pairs_kmax']} pairs past "
                    f"k_max (max tile load {st['max_tile_load']}), "
                    f"{st['clamped_radius']} radii clamped — raise "
                    "cfg.k_max/span]"
                )
        print(msg)

    np.savez_compressed(
        args.out,
        **{k: v.cpu().numpy() for k, v in mapper.map.params.items()},
        alive=mapper.map.alive,
        timestep=mapper.map.timestep,
    )
    print("scene ->", args.out)
    result = {"gaussians": mapper.map.count, "losses": frame_losses}

    if args.mesh:
        # render-and-fuse (pc2mesh.py:86-144), over the live prefix (the
        # slots past it are dead and render nothing)
        live = mapper.map.live()
        alive = mapper.map.alive_device(mapper.map.count)
        pts = mapper.map.params["means3D"].cpu().numpy()[mapper.map.alive]
        lo = pts.min(0) - 0.2
        hi = pts.max(0) + 0.2
        vol = TSDFVolume(lo, hi, voxel_size=args.voxel, device=device)
        for t in range(T):
            im, depth, R, tr, K = mapper.frame_tensors(*frame_data(t))
            with torch.no_grad():
                img_r, depth_r, sil, _ = render_rgbd(
                    live, alive, R, tr, K, img_size,
                    span=cfg.span, k_max=cfg.k_max,
                )
            d = torch.where(sil > 0.5, depth_r, torch.zeros_like(depth_r))
            vol.integrate(d, img_r, K, R, tr)
        V, C, Tri = vol.extract_mesh()
        write_mesh_ply(args.mesh, V, C, Tri)
        print(f"mesh: {len(V)} verts, {len(Tri)} tris -> {args.mesh}")
        result.update(mesh_vertices=len(V), mesh_triangles=len(Tri))
    return result


if __name__ == "__main__":
    main()
