#!/usr/bin/env python
"""Where the time of the PyTorch port's keyframe update goes, on one GPU.

    python scripts/profile_torch_track.py [--out DIR]

Tracks synthetic 384 x 512 frames with ``SLAMConfig()`` (thresholds 0 so
random weights take every frame) through the warm-up, the initialisation
and two keyframe updates, then records four more keyframe updates under
``torch.profiler``.  It prints the wall time per keyframe update, the share
of that time the device was busy, and the device time per kernel group and
per kernel, and the PyTorch ops with the most device time by input shape;
the full tables go to ``DIR/profile_torch_track.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from lgu_slam_tpu_torch.models.net import init_state_dict  # noqa: E402
from lgu_slam_tpu_torch.slam.system import LGUSlam  # noqa: E402
from lgu_slam_tpu_torch.utils.config import SLAMConfig  # noqa: E402
from lgu_slam_tpu_torch.utils.synthetic import (  # noqa: E402
    shifted_texture_frames,
)

UPDATES = 4  # keyframe updates recorded

# kernel name -> group, first match wins: cuDNN's convolutions are told
# from cuBLAS's xmma gemms by "fprop"/"cudnn", its FFT convolutions by their
# FFT and complex (cf32, float2) pieces; LU counts as a solve
GROUPS = (
    ("K1 masked_corr", ("masked_corr_kernel",)),
    ("K2 pyramid_lookup", ("pyramid_lookup_kernel",)),
    ("cholesky / LU / solve", ("potrf", "potrs", "getrf", "getrs", "trsm",
                               "trsv", "xxtrf", "syrk", "cusolver")),
    ("convolution", ("fprop", "dgrad", "wgrad", "cudnn", "winograd",
                     "DSE::", "fft", "cf32", "region_transform")),
    ("gemm / gemv", ("gemm", "gemv", "nvjet", "cublas", "cutlass")),
    ("pooling", ("pool",)),
    ("copy / cast / cat", ("copy", "Copy", "fill", "Memcpy", "Memset")),
    ("reduction", ("reduce", "Reduce")),
    ("index / scatter / gather", ("index", "scatter", "gather")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def summarize(prof, wall_ms: float, n: int, card: str) -> dict:
    """Per unit of work (``n`` units recorded in ``wall_ms``): the device
    time by kernel group and by kernel, the busy share, and the PyTorch ops
    with the most device time by input shape."""
    kernels = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[evt.name]
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    groups = defaultdict(float)
    for name, (ms, _) in kernels.items():
        groups[group_of(name)] += ms
    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:15]
    return dict(
        card=card, units=n, wall_ms_per_unit=wall_ms / n,
        device_busy_ms_per_unit=busy_ms / n,
        device_busy_share=busy_ms / wall_ms,
        kernel_launches_per_unit=sum(v[1] for v in kernels.values()) / n,
        groups_ms_per_unit={g: ms / n for g, ms in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        kernels=[dict(name=k, ms_per_unit=v[0] / n,
                      launches_per_unit=v[1] / n)
                 for k, v in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])],
        ops=[dict(name=e.key, input_shapes=str(e.input_shapes),
                  ms_per_unit=e.self_device_time_total / 1e3 / n,
                  calls_per_unit=e.count / n) for e in ops],
    )


def print_summary(report: dict, unit: str) -> None:
    print(f"per {unit}: wall {report['wall_ms_per_unit']:.1f} ms, "
          f"device busy {report['device_busy_ms_per_unit']:.1f} ms "
          f"({100 * report['device_busy_share']:.1f} %), "
          f"{report['kernel_launches_per_unit']:.0f} kernel launches")
    for g, ms in report["groups_ms_per_unit"].items():
        print(f"  {g:28s} {ms:9.3f} ms")
    for k in report["kernels"][:25]:
        print(f"  {k['ms_per_unit']:9.3f} ms {k['launches_per_unit']:7.1f}x"
              f"  {k['name'][:110]}")
    for o in report["ops"]:
        print(f"  {o['ms_per_unit']:9.3f} ms {o['calls_per_unit']:7.1f}x"
              f"  {o['name']} {o['input_shapes'][:100]}")
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("kernels", "ops")}))


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_track: needs an NVIDIA GPU")

    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0)
    H, W = cfg.image_size
    slam = LGUSlam(init_state_dict(cfg, 0), cfg)
    n_warm = cfg.warmup + 2
    frames = list(shifted_texture_frames(n_warm + UPDATES, H, W, 1))
    for t, img, intr in frames[:n_warm]:
        slam.track(float(t), img, intrinsics=intr)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for t, img, intr in frames[n_warm:]:
            slam.track(float(t), img, intrinsics=intr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    card = card_name()
    report = summarize(prof, wall_ms, UPDATES, card)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "profile_torch_track.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print_summary(report, "keyframe update")


if __name__ == "__main__":
    main()
