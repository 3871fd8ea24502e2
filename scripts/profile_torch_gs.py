#!/usr/bin/env python
"""Where the device time of the port's 3DGS mapping iteration goes, on one
GPU.

    python scripts/profile_torch_gs.py [--out DIR]

Builds ``bench_gs_mapping_torch.py``'s configuration (680 x 1200, 200,000
live Gaussians of a 400,000-capacity map, ``GSConfig()``), takes two
warm-up iterations, then records two under ``torch.profiler``.  Each
PyTorch op's own device time is put in one stage, by its name, its input
shapes and whether an autograd backward node launched it:

- key sort + tile ranges: the depth-rank and (tile, rank) key sorts, the
  ``searchsorted`` ranges;
- top-K gathers: the forward's indexing (the per-tile lists and the
  per-Gaussian data gathered along them);
- backward scatter-adds: the gathers' backward (``IndexBackward0``);
- compositing forward / backward: ops on the [tiles, 256, K] or
  [tiles, 256, C] compositing tensors (alpha, cumprod, weights, bmm);
- SSIM forward / backward: the 11 x 11 convolutions;
- projection, binning, loss, Adam: the rest.

It also times 10 iterations that read the loss on the host after each, as
``GaussianMapper.map_frame`` does, against 10 that synchronise once at the
end: the difference is the per-iteration host sync's cost.  Prints the
summary; the full tables go to ``DIR/profile_torch_gs.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import torch  # noqa: E402
from bench_gs_mapping_torch import H, W, bench_scene  # noqa: E402
from profile_torch_terminate import recorded  # noqa: E402
from profile_torch_track import card_name  # noqa: E402

from lgu_slam_tpu_torch.gs.mapping import (  # noqa: E402
    GSConfig,
    adam_init,
    make_mapping_step,
)
from lgu_slam_tpu_torch.gs.render import TILE  # noqa: E402

WARMUP, STEPS, TIMED = 2, 2, 10


def own_device_ms(evt) -> float:
    """Device ms of the kernels an op launched itself (not its children)."""
    return sum(k.duration for k in evt.kernels) / 1e3


def stage_of(evt, k_max: int) -> str:
    """The stage an op belongs to (module docstring)."""
    name = evt.name
    node, parent = None, evt.cpu_parent
    while parent is not None:
        if "Backward" in parent.name:
            node = parent.name
        parent = parent.cpu_parent
    shapes = [s for s in (evt.input_shapes or []) if s]
    compositing = any(len(s) == 3 and s[1] == TILE * TILE
                      and s[2] in (k_max, 3, 5, 1) for s in shapes)
    if node is not None:
        if "IndexBackward" in node:
            return "backward scatter-adds"
        if "Convolution" in node:
            return "SSIM backward"
        if compositing:
            return "compositing backward"
        return "projection, binning, loss, Adam"
    if name in ("aten::sort", "aten::searchsorted"):
        return "key sort + tile ranges"
    if name == "aten::index":
        return "top-K gathers"
    if "convolution" in name:
        return "SSIM forward"
    if compositing:
        return "compositing forward"
    return "projection, binning, loss, Adam"


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_gs: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = GSConfig()
    gmap, frame = bench_scene(dev)
    step = make_mapping_step(cfg, (H, W))
    state = [gmap.live(), adam_init(gmap.live())]
    alive = gmap.alive_device(gmap.count)

    def iterate(n, read_loss):
        for _ in range(n):
            params, opt, loss, _, _ = step(*state, alive, frame)
            state[:] = [params, opt]
            if read_loss:
                float(loss)

    iterate(WARMUP, True)
    prof, wall = recorded(lambda: iterate(STEPS, True))
    stages = defaultdict(float)
    ops = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or \
                not evt.kernels:
            continue
        ms = own_device_ms(evt)
        stages[stage_of(evt, cfg.k_max)] += ms / STEPS
        op = ops[(evt.name, str(evt.input_shapes)[:120])]
        op[0] += ms / STEPS
        op[1] += 1
    busy = sum(stages.values())

    timed = {}
    for read_loss in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterate(TIMED, read_loss)
        torch.cuda.synchronize()
        timed[read_loss] = 1e3 * (time.perf_counter() - t0) / TIMED
    report = dict(
        card=card_name(), image=[H, W], live=gmap.count,
        wall_ms_per_iter_profiled=wall / STEPS,
        device_busy_ms_per_iter=busy,
        device_busy_share_profiled=busy * STEPS / wall,
        stages_ms_per_iter=dict(sorted(stages.items(),
                                       key=lambda kv: -kv[1])),
        ms_per_iter_loss_read_each=timed[True],
        ms_per_iter_one_sync=timed[False],
        host_sync_ms_per_iter=timed[True] - timed[False],
        ops=[dict(name=k[0], input_shapes=k[1], ms_per_iter=v[0],
                  calls_per_iter=v[1] / STEPS)
             for k, v in sorted(ops.items(), key=lambda kv: -kv[1][0])[:40]],
    )
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_gs.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])
    for s, ms in report["stages_ms_per_iter"].items():
        print(f"  {s:36s} {ms:9.3f} ms")
    for o in report["ops"][:20]:
        print(f"  {o['ms_per_iter']:9.3f} ms {o['calls_per_iter']:6.1f}x  "
              f"{o['name']} {o['input_shapes']}")
    print(json.dumps({k: v for k, v in report.items() if k != "ops"}))


if __name__ == "__main__":
    main()
