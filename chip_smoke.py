#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lgu_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Three phases; any failure exits non-zero.

1. Build the CUDA kernels from ``lgu_slam_tpu_torch/csrc`` with nvcc for
   sm_90a (printing ptxas' register/shared-memory summary) and hold each
   kernel against its plain PyTorch version on the card, at the tracking
   shapes (E = 48 edges, 48 x 64 feature maps) and at odd geometries, with
   out-of-bounds coordinates and offsets beyond the +-4 clip.
2. Run ``LGUSlam.track`` at a tiny size (64 x 96, fp32 dtypes, thresholds
   0) on a synthetic stream twice -- on the card with the kernels and on
   the CPU with the plain versions, from one state dict -- and compare the
   keyframe count, the edge lists and the keyframe poses.
3. Run ``LGUSlam.track`` at the full width of the default ``SLAMConfig()``
   (384 x 512 images, bf16 volumes/features/convs) on synthetic frames with
   random weights, thresholds 0 so that every frame is a keyframe and the
   frontend runs, then a few frames with the keyframe gate closed.  The
   kernels' launch counters must match the probes, pyramid rebuilds and
   GRU iterations the run made.

Before the last line it prints the card's name and power limit, one JSON
line with each kernel's error, time, bound and launches, and the tracking
times.  The last line is ``{"ok": true, "device": {...}}``.  Data and
weights come from fixed seeds; nothing needs the network.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lgu_slam_tpu_torch.models.net import init_state_dict
from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.masked_corr import (
    masked_corr_level0,
    masked_corr_level0_plain,
)
from lgu_slam_tpu_torch.ops.pyramid_lookup import (
    RADIUS,
    RD,
    fused_pyramid_lookup,
    fused_pyramid_lookup_plain,
    level_dims,
    tap_positions,
)
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.motion_filter import MotionFilter
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.device import use_full_fp32
from lgu_slam_tpu_torch.utils.synthetic import shifted_texture_frames

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNELS = ("masked_corr", "pyramid_lookup")
MAIN_E, MAIN_H, MAIN_W = 48, 48, 64  # frontend graph at 384 x 512


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events).
    Every input at the tracking shapes exceeds the 50 MB L2, so the reads
    are cold without a flush."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 1: kernels against their plain versions ---------------------------

def corr_inputs(gen, E, H, W, dev):
    f1 = torch.randn(E, H, W, 128, generator=gen).to(dev)
    f2 = torch.randn(E, H, W, 128, generator=gen).to(dev)
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H),
                                      indexing="xy"), -1).float()
    mean = (grid + 3.0 * torch.randn(E, H, W, 2, generator=gen)).to(dev)
    cov = (0.05 + 5.0 * torch.rand(E, H, W, 2, generator=gen)).to(dev)
    return f1, f2, mean, cov


def lookup_inputs(gen, E, H, W, dev, dtype):
    P1 = H * W
    levels = [torch.randn(E, P1, h * w, generator=gen).to(dev, dtype)
              for h, w in level_dims(H, W)]
    scale = torch.tensor([W, H], dtype=torch.float32)
    # coordinates from 20 % outside the plane on either side, offsets past
    # the +-4 clip
    cflat = ((torch.rand(E, P1, 2, generator=gen) * 1.4 - 0.2) * scale)
    off0 = torch.rand(E, P1, RD, RD, 2, generator=gen) * 9.0 - 4.5
    off1 = torch.rand(E, P1, RD, RD, 2, generator=gen) * 9.0 - 4.5
    return levels, cflat.to(dev), off0.to(dev), off1.to(dev)


def lookup_level_bytes(levels, cflat, off0, off1, H, W) -> int:
    """Bytes of pyramid the lookup must read for these inputs: the distinct
    in-bounds bilinear corners per (edge, pixel, level), probe included."""
    dims = level_dims(H, W)
    h1, w1 = dims[1]
    probe = tap_positions(cflat / 2.0, None, 1)
    gate = torch.sigmoid(torch.var(
        sample_taps_flat(levels[1], h1, w1, *probe), dim=-1))
    offs = (off0, off1 * gate[..., None, None, None], None, None)
    total = 0
    for lvl, (h, w) in enumerate(dims):
        px, py = tap_positions(cflat / 2.0 ** lvl, offs[lvl], RADIUS)
        if lvl == 1:
            px = torch.cat([px, probe[0]], -1)
            py = torch.cat([py, probe[1]], -1)
        x1, y1 = torch.floor(px), torch.floor(py)
        live = (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
        idx = []
        for dy in (0, 1):
            for dx in (0, 1):
                ok = live & (x1 + dx < w) & (y1 + dy < h)
                flat = ((y1 + dy) * w + x1 + dx).long()
                idx.append(torch.where(ok, flat, torch.full_like(flat, -1)))
        idx = torch.sort(torch.cat(idx, -1), dim=-1).values
        distinct = (idx[..., 1:] != idx[..., :-1]) & (idx[..., 1:] >= 0)
        total += int(distinct.sum()) + int((idx[..., 0] >= 0).sum())
    return total * levels[0].element_size()


def phase_kernels(dev) -> dict:
    logs = _build.build_all(KERNELS)
    for name in KERNELS:
        print(f"== nvcc -gencode arch=compute_90a,code=sm_90a "
              f"lgu_slam_tpu_torch/csrc/{name}.cu")
        print(logs[name].strip())
    gen = torch.Generator().manual_seed(SEED)
    use_full_fp32()
    results = {}

    # K1 at odd geometries (ragged last tile), fp32 and bf16 outputs
    for E, H, W in ((3, 30, 40), (2, 7, 9)):
        args = corr_inputs(gen, E, H, W, dev)
        for dt in (torch.float32, torch.bfloat16):
            out = masked_corr_level0(*args, out_dtype=dt).float()
            ref = masked_corr_level0_plain(*args, out_dtype=dt).float()
            torch.cuda.synchronize()
            if dt == torch.float32:
                check(torch.allclose(out, ref, atol=2e-4, rtol=1e-4),
                      f"K1 fp32 {E}x{H}x{W}: max err "
                      f"{(out - ref).abs().max().item()}")
            else:
                rel = ((out - ref).abs() / (ref.abs() + 1.0)).max().item()
                check(rel < 0.02, f"K1 bf16 {E}x{H}x{W}: rel err {rel}")
    # K1 at the tracking shapes: fp32, then the bf16 volume of the path
    args = corr_inputs(gen, MAIN_E, MAIN_H, MAIN_W, dev)
    out = masked_corr_level0(*args, out_dtype=torch.float32)
    ref = masked_corr_level0_plain(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    check(torch.allclose(out, ref, atol=2e-4, rtol=1e-4),
          f"K1 fp32 main shapes: max err {(out - ref).abs().max().item()}")
    del out, ref
    out = masked_corr_level0(*args, out_dtype=torch.bfloat16).float()
    ref = masked_corr_level0_plain(*args, out_dtype=torch.bfloat16).float()
    torch.cuda.synchronize()
    rel = ((out - ref).abs() / (ref.abs() + 1.0)).max().item()
    check(rel < 0.02, f"K1 bf16 main shapes: rel err {rel}")
    k1_err = (out - ref).abs().max().item()
    del out, ref
    ms = cuda_ms(lambda: masked_corr_level0(*args, out_dtype=torch.bfloat16))
    plain_ms = cuda_ms(lambda: masked_corr_level0_plain(
        *args, out_dtype=torch.bfloat16), reps=3, warmup=1)
    a = (args[0] / 4.0).reshape(MAIN_E, -1, 128)
    b = (args[1] / 4.0).reshape(MAIN_E, -1, 128).transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.bmm(a, b))
    del a, b
    P = MAIN_H * MAIN_W
    k1_bytes = (2 * MAIN_E * P * 128 * 4 + 2 * MAIN_E * P * 2 * 4
                + MAIN_E * P * P * 2)
    k1_flops = 2 * MAIN_E * P * P * 128
    b_ms = 1e3 * k1_bytes / HBM_BYTES_PER_S
    o_ms = 1e3 * k1_flops / FP32_FLOP_PER_S
    results["masked_corr_level0"] = dict(
        name="masked_corr_level0", route="cuda",
        source="lgu_slam_tpu_torch/csrc/masked_corr.cu",
        replaces="lgu_slam_tpu/ops/pallas_corr.py:61",
        max_abs_err=k1_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(b_ms, o_ms),
        bound_by="operations" if o_ms >= b_ms else "bytes",
        library_ms=library_ms,
        library_call="torch.bmm of the fp32 operands (product only)",
        shapes=f"E={MAIN_E} {MAIN_H}x{MAIN_W} C=128 -> bf16",
    )
    del args

    # K2 at odd halving chains and TUM's 30 x 40, both level dtypes
    for E, H, W in ((2, 12, 24), (2, 30, 40), (1, 13, 17)):
        for dt in (torch.float32, torch.bfloat16):
            lv, cflat, off0, off1 = lookup_inputs(gen, E, H, W, dev, dt)
            out = fused_pyramid_lookup(lv, cflat, off0, off1, H, W)
            ref = fused_pyramid_lookup_plain(lv, cflat, off0, off1, H, W)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err < 2e-4, f"K2 {dt} {E}x{H}x{W}: max err {err}")
    lv, cflat, off0, off1 = lookup_inputs(gen, MAIN_E, MAIN_H, MAIN_W, dev,
                                          torch.bfloat16)
    out = fused_pyramid_lookup(lv, cflat, off0, off1, MAIN_H, MAIN_W)
    ref = fused_pyramid_lookup_plain(lv, cflat, off0, off1, MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    k2_err = (out - ref).abs().max().item()
    check(k2_err < 2e-4, f"K2 bf16 main shapes: max err {k2_err}")
    del out, ref
    ms = cuda_ms(lambda: fused_pyramid_lookup(lv, cflat, off0, off1,
                                              MAIN_H, MAIN_W))
    plain_ms = cuda_ms(lambda: fused_pyramid_lookup_plain(
        lv, cflat, off0, off1, MAIN_H, MAIN_W), reps=3, warmup=1)
    P1 = MAIN_H * MAIN_W
    k2_bytes = (lookup_level_bytes(lv, cflat, off0, off1, MAIN_H, MAIN_W)
                + cflat.numel() * 4 + off0.numel() * 4 + off1.numel() * 4
                + MAIN_E * P1 * 4 * RD * RD * 4)
    results["fused_pyramid_lookup"] = dict(
        name="fused_pyramid_lookup", route="cuda",
        source="lgu_slam_tpu_torch/csrc/pyramid_lookup.cu",
        replaces="lgu_slam_tpu/ops/pallas_lookup.py:524",
        max_abs_err=k2_err, ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * k2_bytes / HBM_BYTES_PER_S, bound_by="bytes",
        library_ms=None, library_call=None,
        shapes=f"E={MAIN_E} {MAIN_H}x{MAIN_W} bf16 levels -> fp32 [E,P1,196]",
    )
    del lv, cflat, off0, off1
    torch.cuda.empty_cache()
    print("phase 1: kernels built for sm_90a and within tolerance of their "
          "plain versions")
    return results


# -- phases 2 and 3: track() --------------------------------------------------

def tiny_config() -> SLAMConfig:
    """The configuration of the JAX package's end-to-end test, in fp32."""
    return SLAMConfig(
        image_size=(64, 96), buffer=24, warmup=5, filter_thresh=0.0,
        keyframe_thresh=0.0, frontend_window=8, frontend_iters1=2,
        frontend_iters2=1, max_factors=24, edge_bucket=32, inactive_bucket=32,
        volume_dtype="float32", feat_dtype="float32",
        compute_dtype="float32")


def phase_small_track(dev):
    cfg = tiny_config()
    sd = init_state_dict(cfg, SEED)
    runs = {}
    for where in (dev, torch.device("cpu")):
        slam = LGUSlam(sd, cfg, device=where)
        for t, img, intr in shifted_texture_frames(14, 64, 96, SEED + 3):
            slam.track(float(t), img, intrinsics=intr)
        g = slam.frontend.graph
        n = slam.video.counter
        runs[where.type] = (n, g.ii.copy(), g.jj.copy(),
                            slam.video.poses[:n].cpu())
    (n_c, ii_c, jj_c, p_c), (n_h, ii_h, jj_h, p_h) = runs["cuda"], runs["cpu"]
    check(n_c == n_h, f"keyframes: cuda {n_c} != cpu {n_h}")
    check(np.array_equal(ii_c, ii_h) and np.array_equal(jj_c, jj_h),
          "edge lists differ between cuda and cpu")
    err = (p_c - p_h).abs().max().item()
    # fp32 both sides; the two devices sum in different orders and the
    # difference grows through 14 frames of random-weight tracking
    check(err < 1e-2, f"keyframe poses: cuda vs cpu max err {err}")
    print(f"phase 2: tiny track() agrees on cuda and cpu: {n_c} keyframes, "
          f"{len(ii_c)} edges, pose max abs err {err:.3g}")


class CallCounts:
    """Counts the calls that launch the kernels, independently of the
    wrappers' own launch counters."""

    def __init__(self):
        self.probes = self.rebuilds = self.iterations = 0
        probe = MotionFilter._flow_probe
        build = FactorGraph._build_pyramid
        update_n = FactorGraph.update_n
        counts = self

        def counted_probe(self_, gmap):
            counts.probes += 1
            return probe(self_, gmap)

        def counted_build(self_):
            counts.rebuilds += 1
            return build(self_)

        def counted_update_n(self_, n, *a, **kw):
            if self_.n_edges > 0:
                counts.iterations += n
            return update_n(self_, n, *a, **kw)

        MotionFilter._flow_probe = counted_probe
        FactorGraph._build_pyramid = counted_build
        FactorGraph.update_n = counted_update_n


def phase_full_track(dev, kernels: dict) -> dict:
    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0)
    H, W = cfg.image_size
    slam = LGUSlam(init_state_dict(cfg, SEED), cfg, device=dev)
    n_kf, n_gated = 24, 4
    frames = list(shifted_texture_frames(n_kf + n_gated, H, W, SEED + 1))
    calls = CallCounts()
    masked_corr_level0.launches = 0
    fused_pyramid_lookup.launches = 0
    kf_ms, gated_ms, snap = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t, img, intr in frames:
        if t == n_kf:
            slam.filter.thresh = float("inf")  # close the keyframe gate
        before = slam.video.counter
        t_start = time.perf_counter()
        slam.track(float(t), img, intrinsics=intr)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t_start)
        (kf_ms if slam.video.counter > before else gated_ms).append(dt)
        if t in (cfg.warmup - 1, n_kf - 1):  # after initialise / last update
            snap[t] = (masked_corr_level0.launches,
                       fused_pyramid_lookup.launches)
    k1, k2 = masked_corr_level0.launches, fused_pyramid_lookup.launches

    n = slam.video.counter
    poses = slam.video.poses[:n]
    disps = slam.video.disps[:n]
    check(n == n_kf, f"video.counter {n} != {n_kf} keyframes")
    check(bool(torch.isfinite(poses).all()), "non-finite keyframe poses")
    check(bool(torch.isfinite(disps).all()) and disps.min().item() >= 1e-3,
          "non-finite or unclamped disparities")
    check(slam.frontend.is_initialized, "the frontend never initialised")
    check(len(gated_ms) == n_gated, "the closed gate still took keyframes")
    check(k1 > 0 and k2 > 0, f"kernel launches K1={k1} K2={k2}")
    check(k1 == calls.probes + calls.rebuilds,
          f"K1 launches {k1} != probes {calls.probes} + rebuilds "
          f"{calls.rebuilds}")
    check(k2 == calls.probes + calls.iterations,
          f"K2 launches {k2} != probes {calls.probes} + GRU iterations "
          f"{calls.iterations}")
    # per keyframe the initialised frontend took (probe included), and per
    # frame the closed gate turned away
    n_updates = n_kf - cfg.warmup
    for i, name in enumerate(("masked_corr_level0", "fused_pyramid_lookup")):
        steady = snap[n_kf - 1][i] - snap[cfg.warmup - 1][i]
        kernels[name].update(
            launches=(k1, k2)[i],
            launches_per_keyframe=steady / n_updates,
            launches_per_non_keyframe=((k1, k2)[i] - snap[n_kf - 1][i])
            / n_gated)
    g = slam.frontend.graph
    report = dict(
        frames=len(frames), keyframes=n, edges=g.n_edges,
        inactive_edges=len(g.ii_inac), probes=calls.probes,
        pyramid_rebuilds=calls.rebuilds, gru_iterations=calls.iterations,
        ms_per_keyframe_median=statistics.median(kf_ms[cfg.warmup:]),
        ms_per_warmup_keyframe_median=statistics.median(kf_ms[1:cfg.warmup]),
        ms_initialize_frame=kf_ms[cfg.warmup - 1],
        ms_per_non_keyframe_median=statistics.median(gated_ms),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    print(f"phase 3: full-width track() ({H}x{W}, bf16): {n} keyframes, "
          f"{g.n_edges} edges, K1 launches {k1}, K2 launches {k2}, poses "
          "finite")
    return report


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    t_start = time.perf_counter()
    kernels = phase_kernels(dev)
    phase_small_track(dev)
    report = phase_full_track(dev, kernels)
    report["seconds"] = time.perf_counter() - t_start
    print(json.dumps({"tracking": report}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
