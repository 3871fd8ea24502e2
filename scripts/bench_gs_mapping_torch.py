#!/usr/bin/env python
"""3DGS mapping-iteration benchmark at Replica scale with the PyTorch port:
the counterpart of ``scripts/bench_gs_mapping.py``.

    python scripts/bench_gs_mapping_torch.py [--reps 10] [--device cpu]

Times the port's mapping iteration (``make_mapping_step``: one 5-channel
RGB + depth + depth^2 render over a shared tile binning, SSIM + L1 + depth
loss, the backward through the tile renderer, the Adam update) at
SplaTAM's Replica settings: a 1200 x 680 image, 200,000 live Gaussians in
the live prefix of a 400,000-capacity map (to3DGS/configs/replica/
splatam.py), ``GSConfig()`` (span 6, k_max 96).  The scene is random from a
seed, drawn as the JAX script draws it: means uniform in [-2, 2]^3 around
z = 2.5, uniform colours, identity rotations, opacity 0.5, scales
0.01-0.02; the target is a uniform random image and depth 2.5-3.5.  Each
iteration is timed alone between device synchronisations, after one
warm-up iteration.

Prints one JSON line {"metric": "gs_mapping_iters_per_s", ...} with the
median and mean ms per iteration, the peak device memory, the frame's
truncation telemetry and the device's name.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from lgu_slam_tpu_torch.gs.mapping import (  # noqa: E402
    GSConfig,
    adam_init,
    make_mapping_step,
)
from lgu_slam_tpu_torch.gs.params import GaussianMap  # noqa: E402
from lgu_slam_tpu_torch.gs.render import render_rgbd  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402

H, W = 680, 1200
N_LIVE = 200_000
CAPACITY = 400_000


def bench_scene(device, img_size=(H, W), n_live=N_LIVE, capacity=CAPACITY,
                seed=0):
    """(map, frame): a capacity-``capacity`` GaussianMap whose prefix holds
    ``n_live`` random Gaussians, and the target frame, on ``device``."""
    Hh, Ww = img_size
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = dict(device=device, generator=gen)
    gmap = GaussianMap.create(capacity, device)
    p = gmap.params
    depth_mean = 2.5
    p["means3D"][:n_live] = torch.rand(n_live, 3, **dev) * 4.0 - 2.0 + \
        torch.tensor([0.0, 0.0, depth_mean], device=device)
    p["rgb_colors"][:n_live] = torch.rand(n_live, 3, **dev)
    p["logit_opacities"][:n_live] = 0.0
    p["log_scales"][:n_live] = torch.log(
        0.01 + 0.01 * torch.rand(n_live, 1, **dev))
    gmap.alive[:n_live] = True
    gmap.count = n_live
    intr = torch.tensor([600.0, 600.0, Ww / 2.0, Hh / 2.0], device=device)
    frame = (torch.rand(Hh, Ww, 3, **dev),
             depth_mean + torch.rand(Hh, Ww, **dev),
             torch.eye(3, device=device), torch.zeros(3, device=device),
             intr)
    return gmap, frame


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device, reps=10, img_size=(H, W), n_live=N_LIVE, capacity=CAPACITY,
        cfg=None) -> dict:
    """The benchmark: per-iteration ms (median and mean over ``reps`` after
    one warm-up), peak device memory of an iteration, truncation stats."""
    cfg = cfg or GSConfig(capacity=capacity)
    gmap, frame = bench_scene(device, img_size, n_live, capacity)
    step = make_mapping_step(cfg, img_size)
    params = gmap.live()
    opt = adam_init(params)
    alive = gmap.alive_device(gmap.count)
    with torch.no_grad():
        stats = render_rgbd(params, alive, *frame[2:], img_size,
                            span=cfg.span, k_max=cfg.k_max,
                            with_stats=True)[4]
    stats = {k: int(v) for k, v in stats.items()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, opt, loss, _, _ = step(params, opt, alive, frame)  # warm-up
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        params, opt, loss, _, _ = step(params, opt, alive, frame)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    mean = statistics.fmean(ms)
    return {
        "metric": "gs_mapping_iters_per_s",
        "value": 1e3 / mean,
        "unit": f"mapping iters/s ({img_size[1]}x{img_size[0]}, {n_live} "
                "gaussians, fwd+bwd+adam)",
        "ms_per_iter": mean,
        "ms_per_iter_median": statistics.median(ms),
        "ms_per_iter_all": ms,
        "peak_memory_gb": peak,
        "loss": float(loss),
        "truncation": stats,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    result = run(device, reps=args.reps)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
