#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lgu_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Eight phases; any failure exits non-zero.

1. Build the CUDA kernels from ``lgu_slam_tpu_torch/csrc`` with nvcc for
   sm_90a, all at once (printing ptxas' register/shared-memory summary),
   and hold each kernel against its plain PyTorch version on the card: K1
   (both kernels: fp32 operands on the 3xTF32 wgmma kernel, on features
   holding bf16 values and on full-mantissa fp32 features; bf16 operands on
   the bf16 wgmma kernel; fp32 and bf16 volumes) at the tracking shapes
   (E = 48 edges, 48 x 64 feature maps) and at odd geometries, with windows
   across tile edges; K2 at odd geometries and at E = 1, 2, 8, 24 and 48
   (the motion filter's probe, backend sub-chunks, the frontend's mean, the
   TPU probes' shape), with out-of-bounds coordinates and offsets beyond the
   +-4 clip, timed at each E beside its corner and 32-byte-sector bounds;
   K3/K4 (``window_lookup``) at E = 48,
   P1 = 3072 on bf16 planes of 48 x 64, 24 x 32 (49 taps, and the 9-tap
   probe), 12 x 16, 6 x 8 and 13 x 17, with out-of-bounds and NaN
   positions, timed on the device alone (a CUDA graph over input copies
   whose launches touch more than twice the L2 between two launches on
   one copy) beside its byte and 32-byte-sector bounds;
   K5 (``row_gather``) and K6 (``k2_stream_floor``, ``k2_one_level``) at
   the shapes of their TPU probes (E = 48, 48 x 64; [48, 3072, 24, 128])
   and at odd geometries, then the probes' own entry point,
   ``scripts/profile_torch_k2_parts.py``, which times them (K6
   ``one_level`` on the device alone, beside its sector bound).
2. Run ``LGUSlam.track`` and then ``terminate(stream)`` at a tiny size
   (64 x 96, fp32 dtypes, thresholds 0) on a synthetic stream twice -- on
   the card with the kernels and on the CPU with the plain versions, from
   one state dict -- and compare the keyframes, the edge lists, the
   keyframe poses and the filled trajectories; then one train step at
   64 x 96 (batch 1, 3 frames, 3 iterations) on both devices from one state
   dict: the loss, every metric, every gradient and the weights after the
   optimizer step.  The fp32 configuration launches K1's fp32-operand
   (3xTF32) kernel only.
3. Run ``LGUSlam.track`` at the full width of the default ``SLAMConfig()``
   (384 x 512 images, bf16 volumes/features/convs) on synthetic frames with
   random weights, thresholds 0 so that every frame is a keyframe and the
   frontend runs, then a few frames with the keyframe gate closed.  The
   kernels' launch counters must match the probes, pyramid rebuilds and
   GRU iterations the run made; every K1 launch is the bf16-operand
   kernel (bf16 keyframe store, bf16 encoder).  K2's launches are reported
   per edge count.
4. Run ``terminate(stream)`` on phase 3's system (backend passes of 7 and
   12 steps over its 24 keyframes, then the trajectory filled for the 28
   frames).  K2's launches must equal the backend's correlation
   sub-chunks plus the filler's GRU iterations, K1's (bf16 operands) the
   filler's pyramid rebuilds.
5. Train at the full width of the default ``TrainConfig()`` (384 x 512,
   batch 2, 4 frames, 10 edges per clip, 9 iterations, fp32) on synthetic
   clips for 3 steps: the loss, the metrics, every gradient and the weights
   stay finite, the weights move, and neither K1 nor K2 launches (the
   training forward is the differentiable formulation).
6. Run ``LGUSlam.track`` at full width in the fp32 configuration (the JAX
   package's evaluation dtypes: fp32 volumes, features and convolutions),
   10 keyframes with thresholds 0: every K1 launch is the fp32-operand
   kernel (probes + pyramid rebuilds), K2's launches are probes + GRU
   iterations; the median ms per keyframe update and the peak memory.
7. The multi-device paths at world size 1, under NCCL on one process group
   (``tcp://127.0.0.1`` at a free port, destroyed at the end): one sharded
   DBA step (12 frames of 48 x 64, 2 Gauss-Newton iterations) against the
   one-process ``dba_step`` on the same inputs; the sharded backend pass
   over 12 full-width keyframes tracked from phase 3's frames, through
   ``Backend`` over the group (K2's launches must equal the sharded
   sub-chunks times the steps), and once more with the edges sorted by
   source frame, where its chunks are the one-process pass's, against that
   pass from the same state; one full-width ``TrainConfig()`` step under
   ``data_parallel`` (DistributedDataParallel) against a plain
   ``train_step`` from the same weights, batch and carry: the loss, the
   clipped gradients and the weights after the step (a weight whose
   gradient's sign is held to fp32 rounding).  Each is timed beside its
   one-process path.
8. The entry points a user runs, through their ``main`` functions, on
   sequences written to disk with the port's own PNG encoder (rendered
   along known trajectories by ``data/synthetic.py``): a 40-frame TUM
   RGB-D sequence (480 x 640, fr1, 16-bit depth) and a 16-frame EuRoC
   stereo sequence (752 x 480 gray pairs), with a reference ``.pth`` of
   random weights (``module.`` prefixes, 3-output heads).
   ``scripts/demo_torch.py`` mono and RGB-D at full width (undistorted and
   resized to 384 x 512, thresholds 0, every 2nd frame),
   ``scripts/evaluate_tum_torch.py`` (240 x 320) and
   ``scripts/evaluate_euroc_torch.py`` (stereo, rectified to 320 x 512):
   each run's trajectory has a finite pose per frame and launched K1 (the
   bf16-operand kernel) and K2.  Beside them, the host's ms per frame of
   decoding, undistorting or rectifying, and resizing, and the demo's ms
   per tracked frame.

Before the last line it prints the tracking, terminate, training, fp32
tracking, world-size-1 and entry-point reports, the run's wall time, the
card's name and power limit, and one JSON line with each kernel's error,
time, bound and launches.  The last line is ``{"ok": true, "device": {...}}``.
Data and weights come from fixed seeds; nothing needs the network.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lgu_slam_tpu_torch.data.fixtures import (
    write_euroc_sequence,
    write_tum_sequence,
)
from lgu_slam_tpu_torch.data.image_io import imread
from lgu_slam_tpu_torch.data.imgproc import (
    FloatRemap,
    resize,
    undistort_maps,
)
from lgu_slam_tpu_torch.data.streams import euroc_maps
from lgu_slam_tpu_torch.data.synthetic import SyntheticDataset
from lgu_slam_tpu_torch.geom.dba import DbaPlan, dba_step
from lgu_slam_tpu_torch.geom.projective import projective_transform
from lgu_slam_tpu_torch.lie import se3_exp, se3_inv, se3_mul
from lgu_slam_tpu_torch.models.net import LGUNet, init_state_dict
from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.k2_parts import (
    k2_one_level,
    k2_one_level_plain,
    k2_stream_floor,
    k2_stream_floor_plain,
)
from lgu_slam_tpu_torch.ops.masked_corr import (
    masked_corr_level0,
    masked_corr_level0_plain,
)
from lgu_slam_tpu_torch.ops.pyramid_lookup import (
    RD,
    fused_pyramid_lookup,
    fused_pyramid_lookup_plain,
    level_dims,
)
from lgu_slam_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat, window_deltas
from lgu_slam_tpu_torch.ops.window_lookup import window_lookup
from lgu_slam_tpu_torch.parallel.backend_shard import backend_plan
from lgu_slam_tpu_torch.parallel.dba_shard import dba_step_sharded
from lgu_slam_tpu_torch.parallel.train_dp import (
    data_parallel,
    make_optimizer,
    train_step,
    window_edges,
)
from lgu_slam_tpu_torch.slam.backend import Backend
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.motion_filter import MotionFilter
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.slam.trajectory_filler import TrajectoryFiller
from lgu_slam_tpu_torch.utils.checkpoint import TRIMMED_HEADS
from lgu_slam_tpu_torch.utils.config import SLAMConfig, TrainConfig
from lgu_slam_tpu_torch.utils.device import use_full_fp32
from lgu_slam_tpu_torch.utils.measure import (
    BF16_FLOP_PER_S,
    FP32_FLOP_PER_S,
    TF32_FLOP_PER_S,
    bytes_ms,
    cold_graph_ms,
    cuda_ms,
    graph_ms,
    lookup_bytes,
    taps_plane_bytes,
)
from lgu_slam_tpu_torch.utils.synthetic import shifted_texture_frames

SEED = 0
KERNELS = ("masked_corr_tf32", "masked_corr_tc", "pyramid_lookup",
           "window_lookup", "row_gather", "k2_stream")
# K1's two kernels: (name, source, operand dtype)
K1_KERNELS = (
    ("masked_corr_level0_tf32", "masked_corr_tf32.cu", torch.float32),
    ("masked_corr_level0_tc", "masked_corr_tc.cu", torch.bfloat16))
SCRIPTS = Path(__file__).resolve().parent / "scripts"
PROBES = SCRIPTS / "profile_torch_k2_parts.py"
MAIN_E, MAIN_H, MAIN_W = 48, 48, 64  # frontend graph at 384 x 512
# K2's edge counts: the motion filter's probe, the backend's last sub-chunk
# of a chunk (phase 4 launches 223 of its 539 at E = 2) and a whole one,
# the frontend's mean, the TPU probes' shape
K2_EDGES = (1, 2, SLAMConfig().backend_sub_chunk, 24, MAIN_E)
# K3/K4 cases: (TPU kernel, its file:line, plane h x w, radius, max offset)
WINDOW_CASES = (
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 48,
     64, 3, 4),
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 24,
     32, 3, 4),
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 24,
     32, 1, 0),
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 13,
     17, 3, 4),
    ("dense_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:246", 12, 16,
     3, 0),
    ("dense_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:246", 6, 8,
     3, 0),
)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# -- phase 1: kernels against their plain versions ---------------------------

def corr_inputs(gen, E, H, W, dev, full_mantissa=False):
    """fp32 features holding bf16 values (so that both K1 kernels see the
    same numbers), or with ``full_mantissa`` all 24 bits (so that the lo
    terms of the 3xTF32 kernel are exercised); means scattered around each
    pixel, a third of them on an integer and a third just below one
    (floor's edges), so that windows cross tile edges at every offset;
    covariances from 0.05 (a sharp Gaussian) to 20 (one felt at the
    window's edge)."""
    f1 = torch.randn(E, H, W, 128, generator=gen)
    f2 = torch.randn(E, H, W, 128, generator=gen)
    if not full_mantissa:
        f1, f2 = f1.bfloat16().float(), f2.bfloat16().float()
    f1, f2 = f1.to(dev), f2.to(dev)
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H),
                                      indexing="xy"), -1).float()
    mean = grid + 3.0 * torch.randn(E, H, W, 2, generator=gen)
    pick = torch.randint(0, 3, (E, H, W, 1), generator=gen)
    mean = torch.where(pick == 0, torch.round(mean), mean)
    mean = torch.where(pick == 1, torch.floor(mean) + 0.999, mean).to(dev)
    cov = 0.05 + 20.0 * torch.rand(E, H, W, 2, generator=gen) ** 2
    return f1, f2, mean, cov.to(dev)


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


def k1_check(args, tag):
    """K1 against its plain version on the same inputs, fp32 out (atol 2e-4,
    rtol 1e-4: a 128-channel dot summed in another order) and bf16 out
    (one bf16 step: |err| / (|ref| + 1) < 0.02).  Returns the max abs
    errors of the bf16 and the fp32 volumes."""
    out = masked_corr_level0(*args, out_dtype=torch.float32)
    ref = masked_corr_level0_plain(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, atol=2e-4, rtol=1e-4),
          f"K1 {tag} -> fp32: max err {err32}")
    del out, ref
    out = masked_corr_level0(*args, out_dtype=torch.bfloat16).float()
    ref = masked_corr_level0_plain(*args, out_dtype=torch.bfloat16).float()
    torch.cuda.synchronize()
    rel = ((out - ref).abs() / (ref.abs() + 1.0)).max().item()
    check(rel < 0.02, f"K1 {tag} -> bf16: rel err {rel}")
    return (out - ref).abs().max().item(), err32


def k1_cases(gen, dev) -> dict:
    """Both K1 kernels against the plain version at odd geometries (ragged
    last tiles; 7 x 9 rows of no multiple of 16 bytes) and at the tracking
    shapes, the fp32-operand kernel on bf16-valued and on full-mantissa
    features; then each timed at the tracking shapes (bf16 and fp32
    volumes) beside its bounds and one torch.bmm of the same operands (the
    product alone, fp32 without TF32), and at the probe's E = 1."""
    for E, H, W in ((3, 30, 40), (2, 7, 9), (1, 48, 64)):
        f1, f2, mean, cov = corr_inputs(gen, E, H, W, dev)
        k1_check((f1, f2, mean, cov), f"fp32 operands {E}x{H}x{W}")
        k1_check((f1.bfloat16(), f2.bfloat16(), mean, cov),
                 f"bf16 operands {E}x{H}x{W}")
        k1_check(corr_inputs(gen, E, H, W, dev, full_mantissa=True),
                 f"full-mantissa fp32 operands {E}x{H}x{W}")
    f1, f2, mean, cov = corr_inputs(gen, MAIN_E, MAIN_H, MAIN_W, dev,
                                    full_mantissa=True)
    k1_check((f1.bfloat16().float(), f2.bfloat16().float(), mean, cov),
             "bf16-valued fp32 operands main shapes")
    out = {}
    for name, source, dt in K1_KERNELS:
        args = (f1.to(dt), f2.to(dt), mean, cov)
        err, err32 = k1_check(args, f"{dt} operands main shapes")
        ms = cuda_ms(lambda: masked_corr_level0(*args,
                                                out_dtype=torch.bfloat16))
        ms32 = cuda_ms(lambda: masked_corr_level0(*args,
                                                  out_dtype=torch.float32))
        plain_ms = cuda_ms(lambda: masked_corr_level0_plain(
            *args, out_dtype=torch.bfloat16), reps=3, warmup=1)
        a = (args[0] / 4.0).reshape(MAIN_E, -1, 128)
        b = (args[1] / 4.0).reshape(MAIN_E, -1, 128).transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.bmm(a, b))
        del a, b
        # the motion filter's probe: one edge, timed on the device alone
        probe = tuple(x[:1] for x in args)
        probe_ms = graph_ms(lambda: masked_corr_level0(
            *probe, out_dtype=torch.bfloat16))
        bound, bound_by = k1_bound(MAIN_E, dt)
        operands = str(dt).replace("torch.", "")
        out[name] = dict(
            name=name, route="cuda",
            source=f"lgu_slam_tpu_torch/csrc/{source}",
            replaces="lgu_slam_tpu/ops/pallas_corr.py:61",
            operands=operands, max_abs_err=err, max_abs_err_fp32_out=err32,
            ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
            library_call=f"torch.bmm of the {operands} operands (product "
                         "only; fp32 without TF32)",
            ms_fp32_out=ms32,
            bound_ms_fp32_out=k1_bound(MAIN_E, dt, torch.float32)[0],
            shapes=f"E={MAIN_E} {MAIN_H}x{MAIN_W} C=128 {operands} -> bf16 "
                   "(full-mantissa features)",
            probe_ms=probe_ms, probe_bound_ms=k1_bound(1, dt)[0])
        if dt == torch.float32:
            # the fp32 SIMT rate: the bound of the earlier kernel
            out[name]["simt_bound_ms"] = \
                1e3 * 2 * MAIN_E * (MAIN_H * MAIN_W) ** 2 * 128 \
                / FP32_FLOP_PER_S
        del args, probe
    return out


def k1_bound(E, dt, out_dt=torch.bfloat16):
    """K1's bound at E edges of the tracking shapes: the larger of its
    bytes (operands and mean/cov read once, the volume written once) over
    HBM's rate and its operations over the tensor cores' rate: for fp32
    operands three TF32 products (3xTF32), for bf16 one bf16 product."""
    P = MAIN_H * MAIN_W
    esize = torch.empty(0, dtype=dt).element_size()
    osize = torch.empty(0, dtype=out_dt).element_size()
    b_ms = bytes_ms(2 * E * P * 128 * esize + 2 * E * P * 2 * 4
                    + E * P * P * osize)
    flop = 2 * E * P * P * 128
    o_ms = 1e3 * (3 * flop / TF32_FLOP_PER_S if dt == torch.float32
                  else flop / BF16_FLOP_PER_S)
    return max(b_ms, o_ms), "operations" if o_ms >= b_ms else "bytes"


def phase_kernels(dev) -> dict:
    logs = _build.build_all(KERNELS)
    for name in KERNELS:
        print(f"== nvcc -gencode arch=compute_90a,code=sm_90a "
              f"lgu_slam_tpu_torch/csrc/{name}.cu")
        print(logs[name].strip())
    gen = torch.Generator().manual_seed(SEED)
    use_full_fp32()
    results = {}

    results.update(k1_cases(gen, dev))

    # K2 at odd halving chains and TUM's 30 x 40, both level dtypes
    for E, H, W in ((2, 12, 24), (2, 30, 40), (1, 13, 17)):
        for dt in (torch.float32, torch.bfloat16):
            lv, cflat, off0, off1 = lookup_inputs(gen, E, H, W, dev, dt)
            out = fused_pyramid_lookup(lv, cflat, off0, off1, H, W)
            ref = fused_pyramid_lookup_plain(lv, cflat, off0, off1, H, W)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err < 2e-4, f"K2 {dt} {E}x{H}x{W}: max err {err}")
    results["fused_pyramid_lookup"] = k2_edge_cases(gen, dev)
    torch.cuda.empty_cache()

    for case in WINDOW_CASES:
        results[f"{case[0]}:{case[2]}x{case[3]}:r{case[4]}"] = \
            window_case(gen, dev, *case)
    torch.cuda.empty_cache()
    results.update(k2_parts_cases(gen, dev))
    torch.cuda.empty_cache()
    print("phase 1: kernels built for sm_90a and within tolerance of their "
          "plain versions")
    return results


def k2_edge_cases(gen, dev) -> dict:
    """K2 at the edge counts its call sites run, on the tracking planes,
    both level dtypes within 2e-4 of the plain version; timed (bf16 levels)
    on the device alone (a CUDA graph of 50 launches: at E = 1 the
    wrapper's host time exceeds the kernel's) and by CUDA events over
    launches back to back, beside its byte and 32-byte-sector bounds."""
    at = {}
    errs = []
    for E in K2_EDGES:
        for dt in (torch.float32, torch.bfloat16):
            lv, cflat, off0, off1 = lookup_inputs(gen, E, MAIN_H, MAIN_W,
                                                  dev, dt)
            out = fused_pyramid_lookup(lv, cflat, off0, off1, MAIN_H, MAIN_W)
            ref = fused_pyramid_lookup_plain(lv, cflat, off0, off1, MAIN_H,
                                             MAIN_W)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err < 2e-4, f"K2 {dt} E={E} {MAIN_H}x{MAIN_W}: max err "
                  f"{err}")
            errs.append(err)
            del out, ref
            if dt != torch.bfloat16:
                continue

            def call():
                fused_pyramid_lookup(lv, cflat, off0, off1, MAIN_H, MAIN_W)

            at[E] = dict(
                ms=graph_ms(call), ms_eager=cuda_ms(call, reps=50),
                bound_ms=bytes_ms(lookup_bytes(lv, cflat, off0, off1, MAIN_H,
                                               MAIN_W)),
                sector_bound_ms=bytes_ms(lookup_bytes(
                    lv, cflat, off0, off1, MAIN_H, MAIN_W, sectors=True)))
            if E == MAIN_E:
                plain_ms = cuda_ms(lambda: fused_pyramid_lookup_plain(
                    lv, cflat, off0, off1, MAIN_H, MAIN_W), reps=3, warmup=1)
            del lv, cflat, off0, off1
    main = at[MAIN_E]
    return dict(
        name="fused_pyramid_lookup", route="cuda",
        source="lgu_slam_tpu_torch/csrc/pyramid_lookup.cu",
        replaces="lgu_slam_tpu/ops/pallas_lookup.py:524",
        max_abs_err=max(errs), ms=main["ms"], plain_ms=plain_ms,
        bound_ms=main["bound_ms"], bound_by="bytes",
        sector_bound_ms=main["sector_bound_ms"],
        library_ms=None, library_call=None,
        shapes=f"E={MAIN_E} {MAIN_H}x{MAIN_W} bf16 levels -> fp32 [E,P1,196]",
        at_edges=at)


def load_probes():
    """The K2-parts probes' entry point, scripts/profile_torch_k2_parts.py."""
    spec = importlib.util.spec_from_file_location("profile_torch_k2_parts",
                                                  PROBES)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k2_parts_cases(gen, dev) -> dict:
    """K5 and K6 against their plain versions at odd geometries and at the
    probes' shapes; then the probes' entry point, whose launches are the
    kernels' path (counted from 0), and the plain and library times."""
    # odd geometries: rows that are no multiple of 8 (the scalar path of
    # the stream floor), fp32 planes, row indices outside [0, S)
    for E, H, W in ((2, 13, 17), (1, 12, 24)):
        lv, cflat, off0, off1 = lookup_inputs(gen, E, H, W, dev,
                                              torch.bfloat16)
        err = (k2_stream_floor(lv, cflat, off0, off1)
               - k2_stream_floor_plain(lv, cflat, off0, off1)).abs().max()
        check(err.item() < 1e-3, f"K6 stream {E}x{H}x{W}: max err {err}")
        for lvl in range(4):
            for v in (lv[lvl], lv[lvl].float()):
                err = (k2_one_level(v, cflat, lvl, H, W)
                       - k2_one_level_plain(v, cflat, lvl, H, W)).abs().max()
                check(err.item() < 2e-4, f"K6 level {lvl} {v.dtype} "
                      f"{E}x{H}x{W}: max err {err}")
    V = torch.randn(3, 40, 7, 48, generator=gen).to(dev, torch.bfloat16)
    s = torch.randint(-2, 9, (3, 40, 48), generator=gen, dtype=torch.int32)
    s = s.to(dev)
    check(torch.equal(row_gather(V, s), row_gather_plain(V, s)),
          "K5 with indices outside [0, S) differs from its plain version")

    probes = load_probes()
    inp = probes.probe_inputs(dev, SEED)
    lv, cflat, off0, off1, V, s = (inp[k] for k in ("levels", "cflat",
                                                     "off0", "off1", "V",
                                                     "s"))
    PH, PW = probes.H, probes.W
    errs = {"row_gather": (row_gather(V, s)
                           - row_gather_plain(V, s)).abs().max().item(),
            "k2_stream_floor": (
                k2_stream_floor(lv, cflat, off0, off1)
                - k2_stream_floor_plain(lv, cflat, off0, off1)).abs().max()
            .item()}
    for lvl in range(4):
        errs[f"k2_one_level:l{lvl}"] = (
            k2_one_level(lv[lvl], cflat, lvl, PH, PW)
            - k2_one_level_plain(lv[lvl], cflat, lvl, PH, PW)).abs().max()\
            .item()
    torch.cuda.synchronize()
    check(errs["row_gather"] == 0.0, f"K5: max err {errs['row_gather']}")
    check(errs["k2_stream_floor"] < 1e-3,
          f"K6 stream floor: max err {errs['k2_stream_floor']}")
    for lvl in range(4):
        err = errs[f"k2_one_level:l{lvl}"]
        check(err < 2e-4, f"K6 level {lvl}: max err {err}")

    # the probes' path, its launches counted from 0
    for fn in (row_gather, k2_stream_floor, k2_one_level):
        fn.launches = 0
    prof = probes.profile(dev, inp)
    launches = dict(row_gather=row_gather.launches,
                    k2_stream_floor=k2_stream_floor.launches,
                    k2_one_level=k2_one_level.launches)
    check(all(n > 0 for n in launches.values()),
          f"the probes' entry point launched {launches}")

    s64 = s.long()[:, :, None]
    srcs = [*lv, cflat, off0, off1]
    dsts = [torch.empty_like(x) for x in srcs]

    def copy_inputs():
        for d, x in zip(dsts, srcs):
            d.copy_(x)

    shapes = f"E={probes.E} {PH}x{PW} bf16 levels -> fp32 [E,P1,64]"
    out = {
        "row_gather": dict(
            name="row_gather", route="cuda",
            source="lgu_slam_tpu_torch/csrc/row_gather.cu",
            replaces="_prof_sublane.py:54", max_abs_err=errs["row_gather"],
            ms=prof["row_gather"]["ms"],
            plain_ms=cuda_ms(lambda: row_gather_plain(V, s), reps=3,
                             warmup=1),
            bound_ms=prof["row_gather"]["bound_ms"], bound_by="bytes",
            sector_bound_ms=prof["row_gather"]["sector_bound_ms"],
            sectors_of_v=prof["row_gather"]["sectors_of_v"],
            library_ms=cuda_ms(lambda: torch.gather(V, 2, s64)),
            library_call="torch.gather(V, 2, s) with int64 indices",
            launches=launches["row_gather"],
            launches_path="scripts/profile_torch_k2_parts.py",
            shapes=f"V bf16 {tuple(V.shape)}, s int32 {tuple(s.shape)} -> "
                   "fp32"),
        "k2_stream_floor": dict(
            name="k2_stream_floor", route="cuda",
            source="lgu_slam_tpu_torch/csrc/k2_stream.cu",
            replaces="_prof_kparts.py:58",
            max_abs_err=errs["k2_stream_floor"],
            ms=prof["k2_stream_floor"]["ms"],
            plain_ms=cuda_ms(lambda: k2_stream_floor_plain(
                lv, cflat, off0, off1), reps=3, warmup=1),
            bound_ms=prof["k2_stream_floor"]["bound_ms"], bound_by="bytes",
            library_ms=cuda_ms(copy_inputs),
            library_call="device-to-device copy_ of every input "
                         "(reads and writes the input bytes)",
            launches=launches["k2_stream_floor"],
            launches_path="scripts/profile_torch_k2_parts.py",
            k2_whole_ms=prof["k2_whole"]["ms"],
            k2_whole_bound_ms=prof["k2_whole"]["bound_ms"], shapes=shapes),
    }
    for lvl in range(4):
        key = f"k2_one_level_{lvl}"
        out[f"k2_one_level:l{lvl}"] = dict(
            name="k2_one_level", route="cuda",
            source="lgu_slam_tpu_torch/csrc/pyramid_lookup.cu",
            replaces="_prof_kparts.py:88",
            max_abs_err=errs[f"k2_one_level:l{lvl}"], ms=prof[key]["ms"],
            ms_eager=prof[key]["ms_eager"],
            plain_ms=cuda_ms(lambda lvl=lvl: k2_one_level_plain(
                lv[lvl], cflat, lvl, PH, PW), reps=3, warmup=1),
            bound_ms=prof[key]["bound_ms"], bound_by="bytes",
            sector_bound_ms=prof[key]["sector_bound_ms"],
            library_ms=None,
            library_call=None,
            launches=launches["k2_one_level"],
            launches_path="scripts/profile_torch_k2_parts.py (all levels)",
            shapes=f"level {lvl} ({prof[key]['plane']}) of {shapes}")
    return out


def window_inputs(gen, dev, h, w, radius, max_off):
    """K3/K4 inputs at E = 48, P1 = 3072: a bf16 plane [h, w] per (edge,
    pixel); tap positions of a (2r+1)^2 window plus offsets up to
    +-max_off around bases from 20 % outside the plane on either side,
    some of them NaN."""
    E, P1 = MAIN_E, MAIN_H * MAIN_W
    vol = torch.randn(E, P1, h * w, generator=gen).to(dev, torch.bfloat16)
    base = (torch.rand(E, P1, 2, generator=gen) * 1.4 - 0.2) \
        * torch.tensor([w, h], dtype=torch.float32)
    K = (2 * radius + 1) ** 2
    off = (torch.rand(E, P1, K, 2, generator=gen) * 2 - 1) * max_off
    dx, dy = window_deltas(radius)
    px = base[..., 0:1] + off[..., 0] + dx
    py = base[..., 1:2] + off[..., 1] + dy
    px[:, ::7, K // 2] = float("nan")
    py[:, 3::11, 0] = float("nan")
    return vol, px.to(dev), py.to(dev)


def window_case(gen, dev, name, replaces, h, w, radius, max_off) -> dict:
    """Hold K3/K4 against sample_taps_flat at one geometry; time both, the
    kernel on the device alone (a CUDA graph over input copies,
    ``cold_graph_ms``) and by CUDA events over eager launches, beside its byte
    and 32-byte-sector bounds."""
    vol, px, py = window_inputs(gen, dev, h, w, radius, max_off)
    out = window_lookup(vol, h, w, px, py)
    ref = sample_taps_flat(vol, h, w, px, py)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(err < 2e-4, f"{name} {h}x{w} r={radius}: max err {err}")
    check(bool(torch.isfinite(out).all()), f"{name} {h}x{w}: non-finite")
    del out, ref
    io = 3 * px.numel() * 4
    esize = vol.element_size()
    touched = io + taps_plane_bytes(px, py, h, w, esize, sectors=True)
    ms = cold_graph_ms(lambda v, x, y: window_lookup(v, h, w, x, y),
                       (vol, px, py), touched)
    ms_eager = cuda_ms(lambda: window_lookup(vol, h, w, px, py))
    plain_ms = cuda_ms(lambda: sample_taps_flat(vol, h, w, px, py), reps=3,
                       warmup=1)
    E, P1, K = px.shape
    return dict(
        name=name, route="cuda",
        source="lgu_slam_tpu_torch/csrc/window_lookup.cu",
        replaces=replaces, max_abs_err=err, ms=ms, ms_eager=ms_eager,
        plain_ms=plain_ms,
        bound_ms=bytes_ms(io + taps_plane_bytes(px, py, h, w, esize)),
        bound_by="bytes",
        sector_bound_ms=bytes_ms(touched),
        library_ms=None, library_call=None,
        shapes=f"E={E} P1={P1} bf16 plane {h}x{w}, K={K} -> fp32 [E,P1,K]")


# -- phases 2 and 3: track() --------------------------------------------------

def tiny_config() -> SLAMConfig:
    """The configuration of the JAX package's end-to-end test, in fp32."""
    return SLAMConfig(
        image_size=(64, 96), buffer=24, warmup=5, filter_thresh=0.0,
        keyframe_thresh=0.0, frontend_window=8, frontend_iters1=2,
        frontend_iters2=1, max_factors=24, edge_bucket=32, inactive_bucket=32,
        backend_edge_cap=64, backend_chunk=32, volume_dtype="float32",
        feat_dtype="float32", compute_dtype="float32")


def reset_counts():
    """Every count of K1 and K2 to 0."""
    masked_corr_level0.launches = 0
    masked_corr_level0.launches_bf16 = 0
    masked_corr_level0.launches_fp32 = 0
    masked_corr_level0.edges = 0
    fused_pyramid_lookup.launches = 0
    fused_pyramid_lookup.launches_by_edges = {}


def phase_small_track(dev, kernels: dict):
    cfg = tiny_config()
    sd = init_state_dict(cfg, SEED)
    frames = list(shifted_texture_frames(14, 64, 96, SEED + 3))
    runs = []
    for where in (dev, torch.device("cpu")):
        if where == dev:
            reset_counts()
        slam = LGUSlam(sd, cfg, device=where)
        for t, img, intr in frames:
            slam.track(float(t), img, intrinsics=intr)
        g = slam.frontend.graph
        n = slam.video.counter
        # copies: the backend rescales the poses in place
        track = (n, g.ii.copy(), g.jj.copy(),
                 slam.video.poses[:n].cpu().clone())
        with warnings.catch_warnings():  # the 16*t budget is capped at 64
            warnings.simplefilter("ignore", UserWarning)
            traj = slam.terminate(stream=iter(frames), backend_steps=(2, 1))
        runs.append(track + (slam.video.poses[:n].cpu().clone(), traj))
        if where == dev:
            k1_all = masked_corr_level0.launches
            k1_fp32 = masked_corr_level0.launches_fp32
            k1_bf16 = masked_corr_level0.launches_bf16
            k1_edges = masked_corr_level0.edges
    # the fp32 configuration runs K1's fp32-operand (3xTF32) kernel only
    check(k1_fp32 > 0 and k1_bf16 == 0 and k1_all == k1_fp32,
          f"tiny fp32 run: K1 launches {k1_all}, fp32-operand kernel "
          f"{k1_fp32}, bf16 kernel {k1_bf16}")
    kernels["masked_corr_level0_tf32"].update(launches_tiny=k1_fp32,
                                              edges_tiny=k1_edges)
    (n_c, ii_c, jj_c, p_c, b_c, x_c), (n_h, ii_h, jj_h, p_h, b_h, x_h) = runs
    check(n_c == n_h, f"keyframes: cuda {n_c} != cpu {n_h}")
    check(np.array_equal(ii_c, ii_h) and np.array_equal(jj_c, jj_h),
          "edge lists differ between cuda and cpu")
    err = (p_c - p_h).abs().max().item()
    # fp32 both sides; the two devices sum in different orders and the
    # difference grows through 14 frames of random-weight tracking
    check(err < 1e-2, f"keyframe poses: cuda vs cpu max err {err}")
    # terminate: on the card the backend's correlation is bf16 planes
    # through K2, on the CPU fp32 fused tap dots; the global BA amplifies
    # the tracking difference, and the filler's motion-only BA amplifies
    # any difference of its keyframes (tests/test_torch_terminate.py)
    check(x_c.shape == (14, 7) and np.isfinite(x_c).all(),
          f"cuda trajectory {x_c.shape} not finite")
    b_err = (b_c - b_h).abs().max().item()
    x_err = float(np.abs(x_c - x_h).max())
    check(b_err < 2e-2, f"backend keyframe poses: cuda vs cpu max err "
          f"{b_err}")
    check(x_err < 5e-2, f"trajectory: cuda vs cpu max err {x_err}")
    print(f"phase 2: tiny track() + terminate() agree on cuda and cpu: "
          f"{n_c} keyframes, {len(ii_c)} edges, pose max abs err "
          f"{err:.3g}, after the backend {b_err:.3g}, trajectory "
          f"{x_err:.3g}")


def synthetic_batch(db, idx, dev):
    """Clips ``idx`` of a SyntheticDataset as a training batch on ``dev``:
    (images, camera-to-world poses, full-resolution inverse depth,
    intrinsics)."""
    images, poses, depths, intr = (np.stack(x) for x in
                                   zip(*(db[i] for i in idx)))
    disps = np.where(depths > 0.01, 1.0 / np.maximum(depths, 0.01), 0.0)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                 for x in (images, poses, disps, intr))


def phase_small_train(dev) -> dict:
    """One train step at 64 x 96 (batch 1, 3 frames, 3 iterations) on the
    card and on the CPU from one state dict, fp32 without TF32."""
    cfg = TrainConfig(batch=1, iters=3, steps=20, lr=1e-4, n_frames=3,
                      image_size=(64, 96))
    H, W = cfg.image_size
    sd = init_state_dict(SLAMConfig(), SEED)
    db = SyntheticDataset(n_scenes=1, frames_per_scene=5, n_frames=3,
                          crop_size=(H, W), seed=SEED)
    runs = []
    for where in (dev, torch.device("cpu")):
        net = LGUNet(device=where)
        net.load_state_dict(sd)
        opt = make_optimizer(net, cfg)
        ii, jj = (torch.from_numpy(x).to(where) for x in window_edges(3))
        metrics, _ = train_step(
            net, opt, synthetic_batch(db, [1], where),
            torch.zeros(1, 3, 7, device=where),
            torch.zeros(1, 3, H // 8, W // 8, device=where), cfg=cfg, ii=ii,
            jj=jj)
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {n: p.grad.cpu() for n, p in net.named_parameters()},
                     {n: p.detach().cpu() for n, p in net.named_parameters()}))
    (m_c, g_c, p_c), (m_h, g_h, p_h) = runs
    # shares under a threshold move by one edge's (bad_rot, bad_tr: 1/6) or
    # one pixel's (1px) share when a value crosses it
    shares = ("bad_rot", "bad_tr", "1px")
    metric_err = {k: abs(m_c[k] - m_h[k]) / max(abs(m_h[k]), 1e-3)
                  for k in m_h if k not in shares}
    check(all(abs(m_c[k] - m_h[k]) <= 1 / 6 + 1e-6 for k in shares),
          f"train step shares cuda vs cpu: {m_c} {m_h}")
    # the gradients' relative difference per tensor, against a floor of
    # 1e-4 of the largest gradient (the biases that the encoder's instance
    # norm cancels have gradients of fp32 noise)
    floor = 1e-4 * max(g.abs().max().item() for g in g_h.values())
    grad_err = {n: (g_c[n] - g_h[n]).abs().max().item()
                / max(g_h[n].abs().max().item(), floor) for n in g_h}
    lr = opt.schedule(0)
    step_diff = torch.cat([(p_c[n] - p_h[n]).abs().reshape(-1) for n in p_h])
    worst = max(grad_err, key=grad_err.get)
    report = dict(
        metric_max_rel_err=max(metric_err.values()),
        grad_max_rel_err=grad_err[worst], grad_worst_tensor=worst,
        grad_median_rel_err=statistics.median(grad_err.values()),
        weights_max_abs_diff=step_diff.max().item(), lr=lr,
        weights_share_beyond_1pct_lr=(step_diff > 0.01 * lr).float().mean()
        .item())
    # the JAX package and the port agree on the CPU to 2e-4 (metrics) and
    # 2e-2 (the encoder's gradients, tests/test_torch_train.py); the card
    # sums in other orders, with atomics in the gathers' backward, and its
    # convolutions pick other algorithms: a few times those
    check(report["metric_max_rel_err"] < 5e-4,
          f"train step metrics cuda vs cpu: {metric_err}")
    check(report["grad_max_rel_err"] < 0.1,
          f"train step gradients cuda vs cpu: {worst} {grad_err[worst]}")
    check(report["weights_max_abs_diff"] <= 2 * lr + 1e-6,
          f"weights after the step differ by {report['weights_max_abs_diff']}")
    check(report["weights_share_beyond_1pct_lr"] < 0.05,
          f"weights after the step: {report['weights_share_beyond_1pct_lr']}"
          " of the entries differ by more than 1 % of the learning rate")
    print(f"phase 2: tiny train step agrees on cuda and cpu: metrics "
          f"{report['metric_max_rel_err']:.3g}, gradients "
          f"{report['grad_max_rel_err']:.3g} ({worst}), weights "
          f"{report['weights_max_abs_diff']:.3g}")
    return report


def sub_chunks(n_edges: int, chunk: int, sub_chunk: int) -> int:
    """K2 launches of one low-memory step: per chunk of ``chunk`` edges,
    one per sub-chunk (``sub_chunk`` halved until it divides the chunk)."""
    total = 0
    for lo in range(0, n_edges, chunk):
        e = min(chunk, n_edges - lo)
        sc = sub_chunk
        while e % sc:
            sc //= 2
        total += e // sc
    return total


class CallCounts:
    """Counts the calls that launch the kernels, independently of the
    wrappers' own launch counters, and times the backend passes and the
    filler's batches, while it is entered (it patches the methods and
    restores them on exit)."""

    def __init__(self):
        self.probes = self.rebuilds = self.iterations = 0
        self.lowmem = []  # (edges, steps) per FactorGraph.update_lowmem
        self.backend_ms = []  # per Backend call
        self.fill_ms = []  # per TrajectoryFiller batch
        self._saved = []

    def _patch(self, cls, name, wrap):
        orig = getattr(cls, name)
        self._saved.append((cls, name, orig))
        setattr(cls, name, wrap(orig))

    @staticmethod
    def _timed(out):
        def wrap(orig):
            def timed(*a, **kw):
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                result = orig(*a, **kw)
                torch.cuda.synchronize()
                out.append(1e3 * (time.perf_counter() - t_start))
                return result
            return timed
        return wrap

    def __enter__(self):
        counts = self

        def probe(orig):
            def counted(self_, gmap):
                counts.probes += 1
                return orig(self_, gmap)
            return counted

        def build(orig):
            def counted(self_):
                counts.rebuilds += 1
                return orig(self_)
            return counted

        def update_n(orig):
            def counted(self_, n, *a, **kw):
                if self_.n_edges > 0:
                    counts.iterations += n
                return orig(self_, n, *a, **kw)
            return counted

        def lowmem(orig):
            sig = inspect.signature(orig)

            def counted(self_, *a, **kw):
                args = sig.bind(self_, *a, **kw)
                args.apply_defaults()
                counts.lowmem.append((self_.n_edges, args.arguments["steps"]))
                return orig(self_, *a, **kw)
            return counted

        self._patch(MotionFilter, "_flow_probe", probe)
        self._patch(FactorGraph, "_build_pyramid", build)
        self._patch(FactorGraph, "update_n", update_n)
        self._patch(FactorGraph, "update_lowmem", lowmem)
        self._patch(Backend, "__call__", self._timed(self.backend_ms))
        self._patch(TrajectoryFiller, "_fill", self._timed(self.fill_ms))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)


def phase_full_track(dev, kernels: dict, cfg: SLAMConfig, n_kf: int,
                     n_gated: int):
    """track() at full width with thresholds 0 (every frame a keyframe),
    then ``n_gated`` frames with the keyframe gate closed.  K1's launches
    must all be the kernel of the configuration's feature dtype, and equal
    the motion filter's probes plus the pyramid rebuilds; K2's the probes
    plus the GRU iterations."""
    H, W = cfg.image_size
    fp32 = cfg.feat_dtype == "float32"
    k1_name = "masked_corr_level0_tf32" if fp32 else "masked_corr_level0_tc"
    slam = LGUSlam(init_state_dict(cfg, SEED), cfg, device=dev)
    frames = list(shifted_texture_frames(n_kf + n_gated, H, W, SEED + 1))

    def k1_launches():  # those of the configuration's K1 kernel
        return (masked_corr_level0.launches_fp32 if fp32
                else masked_corr_level0.launches_bf16)

    reset_counts()
    window_lookup.launches = 0
    kf_ms, gated_ms, snap = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CallCounts() as calls:
        for t, img, intr in frames:
            if t == n_kf:
                slam.filter.thresh = float("inf")  # close the keyframe gate
            before = slam.video.counter
            t_start = time.perf_counter()
            slam.track(float(t), img, intrinsics=intr)
            torch.cuda.synchronize()
            dt = 1e3 * (time.perf_counter() - t_start)
            (kf_ms if slam.video.counter > before else gated_ms).append(dt)
            if t in (cfg.warmup - 1, n_kf - 1):  # after initialise / update
                snap[t] = (k1_launches(), fused_pyramid_lookup.launches)
    k1, k2 = k1_launches(), fused_pyramid_lookup.launches
    k1_all, k1_edges = masked_corr_level0.launches, masked_corr_level0.edges

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
    # SLAMConfig() keeps bf16 features and computes the encoder in bf16:
    # every K1 launch is the bf16-operand kernel; the fp32 configuration's
    # are all the fp32-operand (3xTF32) kernel
    check(k1 == calls.probes + calls.rebuilds,
          f"K1 {k1_name} launches {k1} != probes {calls.probes} + rebuilds "
          f"{calls.rebuilds}")
    check(k1_all == k1, f"K1 launches of the other kernel: {k1_all - k1}")
    check(k2 == calls.probes + calls.iterations,
          f"K2 launches {k2} != probes {calls.probes} + GRU iterations "
          f"{calls.iterations}")
    # per keyframe the initialised frontend took (probe included), and per
    # frame the closed gate turned away
    n_updates = n_kf - cfg.warmup
    tag = "_track_fp32" if fp32 else "_track"
    kernels[k1_name]["edges" + tag] = k1_edges
    for i, name in enumerate((k1_name, "fused_pyramid_lookup")):
        steady = snap[n_kf - 1][i] - snap[cfg.warmup - 1][i]
        kernels[name].update({
            "launches" + tag: (k1, k2)[i],
            "launches_per_keyframe" + tag: steady / n_updates})
        if n_gated:
            kernels[name]["launches_per_non_keyframe" + tag] = \
                ((k1, k2)[i] - snap[n_kf - 1][i]) / n_gated
    kernels["fused_pyramid_lookup"]["launches_by_edges" + tag] = dict(
        sorted(fused_pyramid_lookup.launches_by_edges.items()))
    g = slam.frontend.graph
    report = dict(
        frames=len(frames), keyframes=n, edges=g.n_edges,
        inactive_edges=len(g.ii_inac), probes=calls.probes,
        pyramid_rebuilds=calls.rebuilds, gru_iterations=calls.iterations,
        ms_per_keyframe_median=statistics.median(kf_ms[cfg.warmup:]),
        ms_per_warmup_keyframe_median=statistics.median(kf_ms[1:cfg.warmup]),
        ms_initialize_frame=kf_ms[cfg.warmup - 1],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        k1_launches=k1, k2_launches=k2,
        k2_launches_by_edges=kernels["fused_pyramid_lookup"][
            "launches_by_edges" + tag])
    if n_gated:
        report["ms_per_non_keyframe_median"] = statistics.median(gated_ms)
    return report, slam, frames


def phase_terminate(slam, frames, kernels: dict) -> dict:
    """terminate(stream) at full width on phase 3's system."""
    cfg = slam.cfg
    n = slam.video.counter
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    with CallCounts() as calls:
        traj = slam.terminate(stream=iter(frames), backend_steps=(7, 12))
    torch.cuda.synchronize()
    ms_total = 1e3 * (time.perf_counter() - t_start)
    k1, k2 = masked_corr_level0.launches_bf16, fused_pyramid_lookup.launches
    k1_all, k1_edges = masked_corr_level0.launches, masked_corr_level0.edges

    check(traj.shape == (len(frames), 7), f"trajectory shape {traj.shape}")
    check(bool(np.isfinite(traj).all()), "non-finite trajectory")
    qn = np.linalg.norm(traj[:, 3:], axis=-1)
    check(bool(np.abs(qn - 1.0).max() < 1e-3),
          f"quaternion norms off 1 by {np.abs(qn - 1.0).max()}")
    check(bool(torch.isfinite(slam.video.poses[:n]).all()),
          "non-finite keyframe poses after the backend")
    check([s for _, s in calls.lowmem] == [7, 12],
          f"backend passes {calls.lowmem}")
    per_step = [sub_chunks(e, cfg.backend_chunk, cfg.backend_sub_chunk)
                for e, _ in calls.lowmem]
    backend_k2 = sum(s * c for (_, s), c in zip(calls.lowmem, per_step))
    check(k1 > 0 and k2 > 0, f"kernel launches K1={k1} K2={k2}")
    check(calls.probes == 0, "terminate() ran the motion filter")
    check(k1 == calls.rebuilds,
          f"K1 bf16 launches {k1} != filler pyramid rebuilds "
          f"{calls.rebuilds}")
    check(k1_all == k1, f"K1 fp32-operand launches {k1_all - k1} in "
          "terminate()")
    check(k2 == backend_k2 + calls.iterations,
          f"K2 launches {k2} != backend sub-chunks {backend_k2} + filler "
          f"GRU iterations {calls.iterations}")
    for name, k in (("masked_corr_level0_tc", k1),
                    ("fused_pyramid_lookup", k2)):
        kernels[name]["launches_terminate"] = k
    kernels["masked_corr_level0_tc"]["edges_terminate"] = k1_edges
    kernels["fused_pyramid_lookup"]["launches_per_backend_step"] = per_step
    kernels["fused_pyramid_lookup"]["launches_by_edges_terminate"] = dict(
        sorted(fused_pyramid_lookup.launches_by_edges.items()))
    report = dict(
        keyframes=n, frames=len(frames), backend_edges=[e for e, _ in
                                                        calls.lowmem],
        backend_steps=[s for _, s in calls.lowmem],
        ms_per_backend_call=calls.backend_ms,
        ms_per_backend_step=[ms / s for ms, (_, s) in
                             zip(calls.backend_ms, calls.lowmem)],
        filler_batches=len(calls.fill_ms), ms_per_filler_batch=calls.fill_ms,
        filler_pyramid_rebuilds=calls.rebuilds,
        filler_gru_iterations=calls.iterations, ms_terminate=ms_total,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        k2_launches_by_edges=kernels["fused_pyramid_lookup"][
            "launches_by_edges_terminate"])
    print(f"phase 4: full-width terminate(): {len(calls.lowmem)} backend "
          f"passes over {report['backend_edges']} edges, "
          f"{len(calls.fill_ms)} filler batches, trajectory "
          f"{traj.shape} finite, K1 launches {k1}, K2 launches {k2}")
    return report


def phase_train(dev) -> dict:
    """Three train steps at the full width of the default TrainConfig()."""
    cfg = TrainConfig()
    H, W = cfg.image_size
    N = cfg.n_frames
    db = SyntheticDataset(n_scenes=2, frames_per_scene=N + 1, n_frames=N,
                          crop_size=(H, W), seed=SEED)
    batches = [synthetic_batch(db, idx, dev)
               for idx in ([0, 2], [1, 3], [2, 0])]
    net = LGUNet(device=dev)
    net.load_state_dict(init_state_dict(SLAMConfig(), SEED))
    w0 = [p.detach().clone() for p in net.parameters()]
    opt = make_optimizer(net, cfg)
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(N))
    Gs0 = torch.zeros(cfg.batch, N, 7, device=dev)
    disp0 = torch.zeros(cfg.batch, N, H // 8, W // 8, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches:
        t_start = time.perf_counter()
        metrics, carry = train_step(net, opt, batch, Gs0, disp0, cfg=cfg,
                                    ii=ii, jj=jj)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t_start))
        metrics = {k: v.item() for k, v in metrics.items()}
        losses.append(metrics)
        check(all(np.isfinite(v) for v in metrics.values()),
              f"non-finite metrics {metrics}")
        check(all(bool(torch.isfinite(p.grad).all())
                  for p in net.parameters()), "non-finite gradients")
        check(all(bool(torch.isfinite(c).all()) for c in carry),
              "non-finite carry")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
          "non-finite weights")
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(net.parameters(), w0))
    check(moved > 1e-6, f"the weights did not move ({moved})")
    k1, k2 = masked_corr_level0.launches, fused_pyramid_lookup.launches
    check(k1 == 0 and k2 == 0,
          f"the train steps launched K1 {k1} and K2 {k2} times")
    report = dict(
        image_size=[H, W], batch=cfg.batch, frames=N, iters=cfg.iters,
        edges_per_clip=len(ii), ms_per_step=step_ms,
        ms_per_step_mean_2_3=statistics.mean(step_ms[1:]),
        peak_memory_gb=peak, weights_max_move=moved, metrics=losses,
        launches_k1=k1, launches_k2=k2)
    print(f"phase 5: full-width training ({H}x{W}, batch {cfg.batch}, {N} "
          f"frames, {cfg.iters} iterations): 3 finite steps, "
          f"{report['ms_per_step_mean_2_3']:.1f} ms per step (steps 2-3), "
          f"peak {peak:.2f} GB, losses "
          f"{[round(m['loss'], 4) for m in losses]}, K1/K2 launches 0")
    return report


# -- phase 7: the multi-device paths at world size 1 --------------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def timed(fn):
    """(fn(), its wall ms on the card)."""
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t_start)


def dba_scene(dev, N=12, H=48, W=64):
    """tests/test_dba_shard.py's scene at the frontend's 1/8 resolution:
    N frames, every edge |i - j| <= 2, targets from the true poses, the
    start perturbed."""
    gen = torch.Generator().manual_seed(SEED)
    xi = torch.cumsum(torch.randn(N, 6, generator=gen) * 0.03, 0)
    poses_gt = se3_exp(xi).to(dev)
    disps_gt = (0.6 + 0.2 * torch.rand(N, H, W, generator=gen)).to(dev)
    intr = torch.tensor([W * 1.2, W * 1.2, W / 2, H / 2], device=dev)
    pairs = [(i, j) for i in range(N) for j in range(N)
             if 0 < abs(i - j) <= 2]
    ii, jj = (np.asarray(x) for x in zip(*pairs))
    target, _ = projective_transform(
        poses_gt, disps_gt, intr.expand(N, 4),
        torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev))
    poses0 = se3_mul(se3_exp((torch.randn(N, 6, generator=gen) * 0.02)
                             .to(dev)), poses_gt)
    disps0 = disps_gt + (torch.randn(N, H, W, generator=gen) * 0.02).to(dev)
    return (poses0, disps0, intr, torch.zeros_like(disps0), target,
            torch.ones_like(target), torch.full_like(disps0, 1e-3), ii, jj)


def phase_world_size_1_dba(dev, group) -> dict:
    """One sharded DBA step against the one-process dba_step."""
    poses0, disps0, intr, sens, target, weight, eta, ii, jj = dba_scene(dev)
    N = poses0.shape[0]
    plan = DbaPlan.build(ii, jj, 1, N, dev)
    ms, ms_ref = [], []
    for _ in range(3):  # the first of each builds its plans and warms up
        (p, d), t = timed(lambda: dba_step_sharded(
            group, poses0, disps0, intr, sens, target, weight, eta, ii, jj,
            1, N, iters=2))
        (p_ref, d_ref), t_ref = timed(lambda: dba_step(
            poses0, disps0, intr, sens, target, weight, eta, plan, iters=2))
        ms.append(t)
        ms_ref.append(t_ref)
    pose_err = (p - p_ref).abs().max().item()
    disp_err = ((d - d_ref).abs() / (2e-4 + 1e-3 * d_ref.abs())).max().item()
    # tests/test_dba_shard.py's tolerances: poses atol 2e-5 (rtol 1e-4),
    # disparities atol 2e-4 / rtol 1e-3
    check(pose_err < 2e-5 + 1e-4 * p_ref.abs().max().item(),
          f"sharded DBA poses vs dba_step: {pose_err}")
    check(disp_err <= 1.0, f"sharded DBA disparities vs dba_step: "
          f"{disp_err} of the tolerance")
    return dict(frames=N, edges=len(ii), pose_max_abs_err=pose_err,
                disp_err_share_of_tolerance=disp_err, ms_sharded=ms[-1],
                ms_one_process=ms_ref[-1], ms_sharded_all=ms,
                ms_one_process_all=ms_ref)


def phase_world_size_1_backend(dev, group, kernels: dict, n_kf=12,
                               steps=3) -> dict:
    """The sharded backend pass over n_kf full-width keyframes tracked from
    phase 3's frames: through Backend over the group, then with the edges
    sorted by ii against the one-process pass from the same state."""
    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0)
    H, W = cfg.image_size
    sd = init_state_dict(cfg, SEED)
    slam = LGUSlam(sd, cfg, device=dev, process_group=group)
    for t, img, intr in shifted_texture_frames(n_kf, H, W, SEED + 1):
        slam.track(float(t), img, intrinsics=intr)
    v = slam.video
    check(v.counter == n_kf, f"{v.counter} keyframes, not {n_kf}")
    del slam.frontend
    torch.cuda.empty_cache()
    state = {name: getattr(v, name).clone() for name in v._FIELDS}

    def restore():
        for name, x in state.items():
            getattr(v, name).copy_(x)

    # Backend over the group: proximity edges, K2 per sharded sub-chunk
    reset_counts()
    with CallCounts() as calls:
        with warnings.catch_warnings():  # the 16*t budget may be capped
            warnings.simplefilter("ignore", UserWarning)
            _, ms_backend = timed(lambda: slam.backend(steps))
    k2 = fused_pyramid_lookup.launches
    check(masked_corr_level0.launches == 0, "the backend launched K1")
    (n_edges, s), = calls.lowmem
    check(s == steps, f"backend steps {s}")
    check(bool(torch.isfinite(v.poses[:n_kf]).all())
          and bool(torch.isfinite(v.disps[:n_kf]).all()),
          "non-finite poses or disparities after the sharded pass")
    # at world size 1 the one rank holds every edge, in chunks of
    # backend_chunk in ii order: K2 once per sub-chunk of each chunk
    per_step = sub_chunks(n_edges, cfg.backend_chunk, cfg.backend_sub_chunk)
    check(k2 == per_step * steps,
          f"K2 launches {k2} != sharded sub-chunks {per_step} x {steps}")
    kernels["fused_pyramid_lookup"]["launches_sharded_backend"] = k2

    # edges sorted by ii: the sharded chunks are the one-process chunks
    restore()
    net = slam.net
    kw = dict(corr_impl="alt", max_factors=min(16 * n_kf,
                                               cfg.backend_edge_cap),
              edge_bucket=cfg.backend_edge_cap, inactive_bucket=8)
    graph = FactorGraph(net, v, cfg, **kw)
    graph.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                                thresh=cfg.backend_thresh, beta=cfg.beta)
    order = np.argsort(graph.ii, kind="stable")
    ii, jj = graph.ii[order], graph.jj[order]
    plan = backend_plan(ii, v.poses.shape[0], 1)
    check(np.array_equal(plan.perm[0], np.arange(len(ii))),
          "sorted edges: the sharded plan reorders them")
    out = {}
    for name, g in (("sharded", group), ("one_process", None),
                    ("one_process_again", None)):
        restore()
        graph = FactorGraph(net, v, cfg, **kw)
        graph.add_factors(ii, jj)
        _, ms = timed(lambda: graph.update_lowmem(steps=steps, group=g))
        out[name] = (v.poses[:n_kf].clone(), v.disps[:n_kf].clone(), ms)
        del graph

    def gaps(a, b):
        """Max abs pose gap; disparity gaps relative to max(|d|, 1e-3):
        the 99th percentile and the max."""
        (p_a, d_a, _), (p_b, d_b, _) = out[a], out[b]
        rel = ((d_a - d_b).abs() / d_b.abs().clamp(min=1e-3)).flatten()
        return ((p_a - p_b).abs().max().item(),
                torch.quantile(rel[:2 ** 24].float(), 0.99).item(),
                rel.max().item())

    pose_err, disp_q99, disp_max = gaps("sharded", "one_process")
    self_pose, self_q99, self_max = gaps("one_process_again", "one_process")
    # the same chunks and GRU updates; the card's index_add_ scatters are
    # atomic, so the one-process pass differs from itself run to run (on
    # an H100: poses ~5e-6, disparities' 99th percentile ~1e-3 relative,
    # their max 0.08-0.24 at pixels that no edge constrains); the sharded
    # pass is held to 20 x and 10 x those
    check(pose_err < 1e-4, f"sorted edges: sharded vs one-process poses "
          f"{pose_err}")
    check(disp_q99 < 1e-2, f"sorted edges: sharded vs one-process "
          f"disparities, 99th percentile (relative) {disp_q99}")
    ms_s, ms_1 = out["sharded"][2], out["one_process"][2]
    report = dict(keyframes=n_kf, steps=steps, backend_edges=n_edges,
                  k2_launches=k2, k2_per_step=per_step,
                  ms_backend_call=ms_backend,
                  ms_per_step_backend_call=ms_backend / steps,
                  sorted_edges=len(ii),
                  ms_per_step_sharded=ms_s / steps,
                  ms_per_step_one_process=ms_1 / steps,
                  ms_per_step_one_process_again=out[
                      "one_process_again"][2] / steps,
                  sorted_pose_max_abs_err=pose_err,
                  sorted_disp_q99_rel_err=disp_q99,
                  sorted_disp_max_rel_err=disp_max,
                  one_process_self_pose_max_abs_err=self_pose,
                  one_process_self_disp_q99_rel_err=self_q99,
                  one_process_self_disp_max_rel_err=self_max)
    del slam, state
    torch.cuda.empty_cache()
    return report


def phase_world_size_1_train(dev, group) -> dict:
    """One full-width TrainConfig() step under DDP against a plain
    train_step from the same weights, batch and carry; a second step of
    each is timed too.  The carry is the ground-truth start (every frame
    after the first at frame 1's pose) moved by 1e-3 twists: at the start
    itself the edges among those frames sit on the lookup's integer grid,
    where the step's gradient moves by tens of percent under 1e-6 of pose
    (tests/test_torch_parallel.py), and the card's atomics differ by
    more."""
    cfg = TrainConfig()
    H, W = cfg.image_size
    N = cfg.n_frames
    db = SyntheticDataset(n_scenes=2, frames_per_scene=N + 1, n_frames=N,
                          crop_size=(H, W), seed=SEED)
    batch = synthetic_batch(db, [0, 2], dev)
    Ps = se3_inv(batch[1])
    Gs0 = torch.cat([Ps[:, :1], Ps[:, 1:2].expand(-1, N - 1, -1)], dim=1)
    gen = torch.Generator().manual_seed(SEED)
    tw = torch.randn(Gs0.shape[:2] + (6,), generator=gen).to(dev) * 1e-3
    tw[:, 0] = 0
    Gs0 = se3_mul(se3_exp(tw), Gs0)
    disp0 = torch.ones(cfg.batch, N, H // 8, W // 8, device=dev)
    sd = init_state_dict(SLAMConfig(), SEED)
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(N))
    runs = {}
    for name in ("ddp", "plain"):
        net = LGUNet(device=dev)
        net.load_state_dict(sd)
        model = data_parallel(net, group) if name == "ddp" else net
        opt = make_optimizer(model, cfg)

        def step():
            return train_step(model, opt, batch, Gs0, disp0, cfg=cfg, ii=ii,
                              jj=jj)

        (metrics, _), ms = timed(step)
        lr = opt.schedule(0)
        weights = {n: p.detach().clone() for n, p in net.named_parameters()}
        # the clipped gradients AdamW read: its first moment / (1 - beta1)
        grads = {n: opt.adamw.state[p]["exp_avg"] / (1.0 - 0.9)
                 for n, p in net.named_parameters()}
        _, ms_again = timed(step)  # DDP's first step also sets up buckets
        runs[name] = (metrics["loss"].item(), [ms, ms_again], weights, grads)
        del model, net, opt
    (loss_d, ms_d, w_d, g_d), (loss_p, ms_p, w_p, g_p) = runs["ddp"], \
        runs["plain"]
    loss_err = abs(loss_d - loss_p) / abs(loss_p)
    check(np.isfinite(loss_d) and loss_err < 1e-5,
          f"DDP loss {loss_d} vs plain {loss_p}")
    # each gradient tensor to 1e-2 of its largest entry; where the plain
    # gradient exceeds twice that, Adam's first step moves the weight by lr
    # in the gradient's sign, and the two agree to fp32 rounding; elsewhere
    # (an entry within the tolerance of 0) they lie within 2 lr.  The
    # feature encoder's biases in front of its instance norms (all but its
    # output conv's) have gradients of rounding noise: weights only.
    grad_err, sure_err, other_err, noise = 0.0, 0.0, 0.0, 0.0
    top_all = max(g.abs().max().item() for g in g_p.values())
    for n, g in g_p.items():
        top = g.abs().max().item()
        dw = (w_d[n] - w_p[n]).abs()
        other_err = max(other_err, dw.max().item() / lr)
        if (n.startswith("fnet.") and n.endswith(".bias")
                and n != "fnet.conv2.bias"):
            noise = max(noise, top / top_all)
            continue
        grad_err = max(grad_err,
                       (g_d[n] - g).abs().max().item() / max(top, 1e-30))
        sure = g.abs() > 2 * 1e-2 * top
        room = 1e-3 * lr + 1e-6 * w_p[n].abs()
        if sure.any():
            sure_err = max(sure_err, (dw[sure] / room[sure]).max().item())
    check(grad_err <= 1e-2, f"DDP gradients differ by {grad_err:.3g} of "
          "a tensor's largest entry")
    check(sure_err <= 1.0, "DDP weights with a held gradient sign differ "
          f"by {sure_err:.3g} x (1e-3 lr + 1e-6 |w|)")
    check(other_err <= 2 * (1 + 1e-3), f"DDP weights differ by "
          f"{other_err:.3g} lr")
    torch.cuda.empty_cache()
    return dict(loss_ddp=loss_d, loss_plain=loss_p, loss_rel_err=loss_err,
                grads_max_rel_err=grad_err, lr=lr,
                weights_sign_held_err_over_room=sure_err,
                weights_max_abs_diff_over_lr=other_err,
                noise_grads_max_over_top=noise, ms_step_ddp=ms_d,
                ms_step_plain=ms_p)


def phase_world_size_1(dev, kernels: dict) -> dict:
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        check(dist.get_backend(group) == "nccl" and
              dist.get_world_size(group) == 1, "not an NCCL group of 1")
        report = dict(world_size=1, backend="nccl",
                      dba=phase_world_size_1_dba(dev, group),
                      backend_pass=phase_world_size_1_backend(dev, group,
                                                              kernels),
                      train=phase_world_size_1_train(dev, group))
    finally:
        dist.destroy_process_group()
    d, b, t = report["dba"], report["backend_pass"], report["train"]
    print(f"phase 7: sharded DBA step {d['ms_sharded']:.2f} ms (one "
          f"process {d['ms_one_process']:.2f} ms), pose err "
          f"{d['pose_max_abs_err']:.3g}; sharded backend "
          f"{b['ms_per_step_sharded']:.1f} ms per step (one process "
          f"{b['ms_per_step_one_process']:.1f} ms) over "
          f"{b['sorted_edges']} edges, K2 launches {b['k2_launches']}; "
          f"DDP train steps {t['ms_step_ddp'][0]:.1f}, "
          f"{t['ms_step_ddp'][1]:.1f} ms (plain {t['ms_step_plain'][0]:.1f},"
          f" {t['ms_step_plain'][1]:.1f} ms), loss rel err "
          f"{t['loss_rel_err']:.3g}, gradients {t['grads_max_rel_err']:.3g}"
          f", weights {t['weights_max_abs_diff_over_lr']:.3g} lr")
    print("phase 7: the sharded DBA, the sharded backend pass and the DDP "
          "train step ran at world size 1 (one process, one card, NCCL)")
    return report


# -- phase 8: the entry points on on-disk sequences --------------------------

def load_script(name: str):
    """``scripts/<name>.py`` as a module (its ``main(argv)``)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_pth(path: Path, seed: int = SEED) -> None:
    """Random weights saved as a reference checkpoint: ``module.`` prefixes
    and 3-output weight/delta heads, which the loader strips and trims."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in init_state_dict(SLAMConfig(), seed).items():
        if k.startswith(TRIMMED_HEADS):
            v = torch.cat([v, torch.randn((1,) + v.shape[1:], generator=gen)])
        sd["module." + k] = v
    torch.save(sd, path)


def host_ms(fn, items) -> float:
    """Median host ms of ``fn`` over ``items``."""
    ms = []
    for item in items:
        t_start = time.perf_counter()
        fn(item)
        ms.append(1e3 * (time.perf_counter() - t_start))
    return statistics.median(ms)


def host_costs(tum: Path, euroc: Path) -> dict:
    """The host's ms per frame of each step that feeds a frame: the TUM
    sequence's 480 x 640 colour PNGs decoded, undistorted (fr1) and resized
    to 384 x 512 (the demo's path), and the EuRoC pairs' 752 x 480 gray
    PNGs decoded, rectified and resized to 320 x 512 (both cameras)."""
    rgb = sorted((tum / "rgb").iterdir())[:10]
    images = [imread(str(f)) for f in rgb]
    K = np.asarray([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]])
    undist = undistort_maps(K, [0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
                            (640, 480))
    flat = [undist(im) for im in images]
    cams = [sorted((euroc / "mav0" / c / "data").iterdir())[:6]
            for c in ("cam0", "cam1")]
    pairs = [[imread(str(f)) for f in fs] for fs in zip(*cams)]
    rectify = [FloatRemap(*m, (480, 752)) for m in euroc_maps()]
    rectified = [[r(im) for r, im in zip(rectify, pair)] for pair in pairs]
    return {
        "tum_480x640_to_384x512": dict(
            decode_ms=host_ms(lambda f: imread(str(f)), rgb),
            undistort_ms=host_ms(undist, images),
            resize_ms=host_ms(lambda im: resize(im, (512, 384)), flat)),
        "euroc_stereo_752x480_to_320x512": dict(
            decode_ms=host_ms(lambda fs: [imread(str(f)) for f in fs],
                              list(zip(*cams))),
            remap_ms=host_ms(lambda p: [r(im) for r, im in zip(rectify, p)],
                             pairs),
            resize_ms=host_ms(lambda p: [resize(im, (512, 320)) for im in p],
                              rectified))}


def entry_run(name: str, fn, kernels: dict, runs: dict):
    """Run one entry point with K1/K2's counts from 0; checks that it
    launched both, K1 only as the bf16-operand kernel (every configuration
    here keeps SLAMConfig()'s bf16 dtypes), and records the counts."""
    reset_counts()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    k1, k2 = masked_corr_level0.launches_bf16, fused_pyramid_lookup.launches
    check(k1 > 0 and k2 > 0, f"{name}: kernel launches K1={k1} K2={k2}")
    check(masked_corr_level0.launches == k1,
          f"{name}: K1 fp32-operand launches "
          f"{masked_corr_level0.launches - k1}")
    runs[name] = dict(seconds=time.perf_counter() - t_start, k1_launches=k1,
                      k2_launches=k2)
    for kname, k in (("masked_corr_level0_tc", k1),
                     ("fused_pyramid_lookup", k2)):
        kernels[kname]["launches_entry_points"] = \
            kernels[kname].get("launches_entry_points", 0) + k
    return out


def finite_trajectory(name: str, path: Path, n: int) -> None:
    traj = np.loadtxt(path)
    check(traj.shape == (n, 8), f"{name}: trajectory {traj.shape}, not "
          f"{n} poses")
    check(bool(np.isfinite(traj).all()), f"{name}: non-finite poses")


def phase_entry_points(dev, kernels: dict, n_tum: int = 40,
                       n_euroc: int = 16, stride: int = 2) -> dict:
    """The entry points a user runs, through their ``main`` functions on
    the card, on sequences written to disk with the port's PNG encoder:
    ``demo_torch`` mono and RGB-D at full width (384 x 512, thresholds 0,
    every ``stride``-th frame), ``evaluate_tum_torch`` (240 x 320) and
    ``evaluate_euroc_torch`` (stereo, 320 x 512), all with a reference
    ``.pth`` of random weights; beside them the host's ms per frame of
    decoding, undistorting or rectifying, and resizing."""
    demo = load_script("demo_torch")
    tum_eval = load_script("evaluate_tum_torch")
    euroc_eval = load_script("evaluate_euroc_torch")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t_start = time.perf_counter()
        tum = Path(write_tum_sequence(
            str(root / "tum" / "rgbd_dataset_freiburg1_desk"), n_tum))
        euroc = Path(write_euroc_sequence(str(root / "euroc" / "MH_01_easy"),
                                          n_euroc))
        weights = root / "weights.pth"
        reference_pth(weights)
        calib = root / "calib.txt"
        calib.write_text("517.3 516.5 318.6 255.3 0.2624 -0.9531 -0.0054 "
                         "0.0026 1.1633\n")
        fixture_s = time.perf_counter() - t_start
        host = host_costs(tum, euroc)

        n_demo = len(range(0, n_tum, stride))
        demo_args = ["--imagedir", str(tum / "rgb"), "--calib", str(calib),
                     "--weights", str(weights), "--stride", str(stride),
                     "--filter_thresh", "0", "--keyframe_thresh", "0",
                     "--device", str(dev)]
        for name, extra in (("demo_mono", []),
                            ("demo_rgbd", ["--depthdir", str(tum / "depth")])):
            traj = root / f"{name}.txt"
            out = entry_run(name, lambda: demo.main(
                demo_args + extra + ["--trajectory_path", str(traj)]),
                kernels, runs)
            finite_trajectory(name, traj, n_demo)
            runs[name].update(frames=n_demo, ms_per_frame={
                k: v["mean_ms"] for k, v in out["phases"].items()})
        for name, script, path, n in (
                ("evaluate_tum", tum_eval, tum, n_tum),
                ("evaluate_euroc", euroc_eval, euroc, n_euroc)):
            out = entry_run(name, lambda: script.main(
                ["--datapath", str(path.parent), "--weights", str(weights),
                 "--sequences", path.name, "--device", str(dev)]),
                kernels, runs)
            result = out[path.name]
            check(result["poses"] == n and np.isfinite(result["ate"]),
                  f"{name}: {result}")
            runs[name].update(poses=result["poses"], ate=result["ate"])
    report = dict(fixture_seconds=fixture_s, host_ms_per_frame=host,
                  runs=runs)
    tum_host = host["tum_480x640_to_384x512"]
    print(f"phase 8: demo_torch mono and RGB-D ({n_demo} frames at 384 x "
          f"512), evaluate_tum_torch ({n_tum} poses) and "
          f"evaluate_euroc_torch (stereo, {n_euroc} poses) on sequences "
          f"written to disk: trajectories finite; host ms per 480 x 640 "
          f"frame: decode {tum_host['decode_ms']:.1f}, undistort "
          f"{tum_host['undistort_ms']:.1f}, resize "
          f"{tum_host['resize_ms']:.1f}; demo ms per tracked frame "
          f"{runs['demo_mono']['ms_per_frame']['track']:.1f}; K1 launches "
          f"{sum(r['k1_launches'] for r in runs.values())}, K2 launches "
          f"{sum(r['k2_launches'] for r in runs.values())}")
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
    phase_small_track(dev, kernels)
    small_train = phase_small_train(dev)
    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0)
    report, slam, frames = phase_full_track(dev, kernels, cfg, 24, 4)
    print(f"phase 3: full-width track() ({cfg.image_size}, bf16): "
          f"{report['keyframes']} keyframes, {report['edges']} edges, K1 "
          f"launches {report['k1_launches']}, K2 launches "
          f"{report['k2_launches']}, poses finite")
    terminate = phase_terminate(slam, frames, kernels)
    del slam, frames
    torch.cuda.empty_cache()
    train = phase_train(dev)
    train["small_cuda_vs_cpu"] = small_train
    torch.cuda.empty_cache()
    t_fp32 = time.perf_counter()
    cfg32 = cfg.replace(warmup=5, volume_dtype="float32",
                        feat_dtype="float32", compute_dtype="float32")
    fp32, slam, _ = phase_full_track(dev, kernels, cfg32, 10, 0)
    del slam
    fp32["seconds"] = time.perf_counter() - t_fp32
    print(f"phase 6: full-width track() ({cfg32.image_size}, fp32): "
          f"{fp32['keyframes']} keyframes, K1 fp32-operand launches "
          f"{fp32['k1_launches']}, K2 launches {fp32['k2_launches']}, "
          f"{fp32['ms_per_keyframe_median']:.1f} ms per keyframe update, "
          f"peak {fp32['peak_memory_gb']:.2f} GB, poses finite")
    torch.cuda.empty_cache()
    world1 = phase_world_size_1(dev, kernels)
    torch.cuda.empty_cache()
    entry_points = phase_entry_points(dev, kernels)
    # launches on the main path: K1 bf16 and K2 over track() +
    # terminate() and phase 8's entry points, K2 also over phase 7's
    # sharded backend pass, K1 fp32 operands over phase 6's track()
    for name in ("masked_corr_level0_tc", "fused_pyramid_lookup"):
        k = kernels[name]
        k["launches"] = k["launches_track"] + k["launches_terminate"] + \
            k.get("launches_sharded_backend", 0) + \
            k["launches_entry_points"]
    k = kernels["masked_corr_level0_tf32"]
    k["launches"] = k["launches_track_fp32"]
    for k in kernels.values():
        if "launches" not in k:
            k["launches"] = window_lookup.launches
    seconds = time.perf_counter() - t_start
    print(json.dumps({"tracking": report}))
    print(json.dumps({"terminate": terminate}))
    print(json.dumps({"training": train}))
    print(json.dumps({"tracking_fp32": fp32}))
    print(json.dumps({"world_size_1": world1}))
    print(json.dumps({"entry_points": entry_points}))
    print(json.dumps({"seconds": seconds}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
