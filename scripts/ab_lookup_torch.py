#!/usr/bin/env python
"""Time kernels K3/K4 (``window_lookup``) and K6 ``one_level``
(``k2_one_level``) built from two sources on one card, in alternating
turns: another revision's against this checkout's.

    mkdir -p build/lookup_parent
    for f in window_lookup.cu pyramid_lookup.cu bilinear.cuh; do
        git show REV:lgu_slam_tpu_torch/csrc/$f > build/lookup_parent/$f
    done
    python scripts/ab_lookup_torch.py --parent build/lookup_parent \\
        [--variant NAME=DIR] [--out DIR]

Every source is compiled with the port's nvcc flags (ptxas' register
summary is printed).  The cases: K3/K4 at every geometry of
``chip_smoke.WINDOW_CASES`` (E = 48, P1 = 3072, bf16 planes, the inputs of
``chip_smoke.window_inputs`` from a generator seeded 0), and K6
``one_level`` on each level of the probes' inputs
(``scripts/profile_torch_k2_parts.probe_inputs``, seed 0).  The sources
run in mirrored turns (parent, change, variants..., variants..., change,
parent: ``--variant NAME=DIR`` adds designs tried, timed as often as the
parent); each time is a mean over 50 launches on the device alone (one
CUDA graph) cycling through copies of the inputs, so many that the
launches between two on one copy touch more than twice the 50 MB L2, each
launch with an output of its own (``utils/measure.cold_graph_ms``); beside
it the mean by CUDA events over eager launches.  Every output must be
within 2e-4 of the plain version.  Each case stands beside its byte bound
(distinct corners) and its 32-byte-sector bound (distinct sectors), with
the positions or coordinates read once and the output written once.
Prints one JSON line and writes it to ``DIR/ab_lookup_torch.json``.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import torch  # noqa: E402
import ab_torch  # noqa: E402
import profile_torch_k2_parts as probes  # noqa: E402
from profile_torch_track import card_name  # noqa: E402

import chip_smoke  # noqa: E402
from lgu_slam_tpu_torch.ops import _build  # noqa: E402
from lgu_slam_tpu_torch.ops.k2_parts import (  # noqa: E402
    ONE_LEVEL_TAPS,
    k2_one_level_plain,
    one_level_positions,
)
from lgu_slam_tpu_torch.ops.pyramid_lookup import level_dims  # noqa: E402
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat  # noqa: E402
from lgu_slam_tpu_torch.utils.measure import (  # noqa: E402
    bytes_ms,
    cold_copies,
    cold_graph_ms,
    cuda_ms,
    taps_plane_bytes,
)


def build(src_dir, tag: str) -> dict:
    """Both kernels' entry points from the sources in ``src_dir``."""
    return dict(
        window_lookup=ab_torch.entry(ab_torch.build(
            os.path.join(src_dir, "window_lookup.cu"), tag),
            "window_lookup", 4, 6),
        k2_one_level=ab_torch.entry(ab_torch.build(
            os.path.join(src_dir, "pyramid_lookup.cu"), tag),
            "k2_one_level", 3, 5))


def window_call(lib, h, w):
    def run(vol, px, py):
        E, P1, K = px.shape
        out = torch.empty(E, P1, K, device=px.device)
        _build.check(lib["window_lookup"](
            vol.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(), E,
            P1, K, h, w, 1, torch.cuda.current_stream().cuda_stream),
            "window_lookup")
        return out
    return run


def one_level_call(lib, lvl, h, w):
    def run(level, cflat):
        E, P1 = cflat.shape[:2]
        out = torch.empty(E, P1, ONE_LEVEL_TAPS, device=cflat.device)
        _build.check(lib["k2_one_level"](
            level.data_ptr(), cflat.data_ptr(), out.data_ptr(), E * P1, h, w,
            lvl, 1, torch.cuda.current_stream().cuda_stream), "k2_one_level")
        return out
    return run


def time_case(libs, inputs, make_call, ref, io, plane_bytes,
              plane_sector_bytes) -> dict:
    """Every library on ``inputs`` (a tuple of tensors) in mirrored turns;
    ``io`` + ``plane_sector_bytes`` are the bytes a launch touches."""
    touched = io + plane_sector_bytes
    ms = {t: [] for t in libs}
    ms_eager = {t: [] for t in libs}
    err = {}
    for tag in ab_torch.turns(tuple(libs)):
        call = make_call(libs[tag])
        if tag not in err:
            out = call(*inputs)
            torch.cuda.synchronize()
            err[tag] = (out - ref).abs().max().item()
            if not err[tag] <= 2e-4:
                sys.exit(f"ab_lookup_torch: {tag} differs from the plain "
                         f"version by {err[tag]}")
            del out
        ms[tag].append(cold_graph_ms(call, inputs, touched))
        ms_eager[tag].append(cuda_ms(lambda: call(*inputs), reps=50,
                                     warmup=5))
    return dict(ms=ms, ms_eager=ms_eager, max_abs_err=err,
                bound_ms=bytes_ms(io + plane_bytes),
                sector_bound_ms=bytes_ms(touched),
                copies=cold_copies(touched), touched_bytes=touched)


def compare(libs: dict, dev) -> dict:
    result = {}
    for name, _, h, w, radius, max_off in chip_smoke.WINDOW_CASES:
        vol, px, py = chip_smoke.window_inputs(
            torch.Generator().manual_seed(0), dev, h, w, radius, max_off)
        ref = sample_taps_flat(vol, h, w, px, py)
        key = f"{name}:{h}x{w}:K{px.shape[-1]}"
        result[key] = time_case(
            libs, (vol, px, py), lambda lib, h=h, w=w: window_call(lib, h, w),
            ref, 3 * px.numel() * 4, taps_plane_bytes(px, py, h, w, 2),
            taps_plane_bytes(px, py, h, w, 2, sectors=True))
        print(key, json.dumps(result[key]), flush=True)
        del vol, px, py, ref
        torch.cuda.empty_cache()
    inp = probes.probe_inputs(dev, 0)
    lv, cflat = inp["levels"], inp["cflat"]
    del inp
    H, W = probes.H, probes.W
    for lvl, (h, w) in enumerate(level_dims(H, W)):
        px, py = one_level_positions(cflat, lvl)
        ref = k2_one_level_plain(lv[lvl], cflat, lvl, H, W)
        key = f"k2_one_level:l{lvl}:{h}x{w}"
        result[key] = time_case(
            libs, (lv[lvl], cflat),
            lambda lib, lvl=lvl, h=h, w=w: one_level_call(lib, lvl, h, w),
            ref, cflat.numel() * 4 + px.numel() * 4,
            taps_plane_bytes(px, py, h, w, 2),
            taps_plane_bytes(px, py, h, w, 2, sectors=True))
        print(key, json.dumps(result[key]), flush=True)
        del px, py, ref
        torch.cuda.empty_cache()
    return result


def main():
    args = ab_torch.arguments(
        "directory with the other revision's window_lookup.cu, "
        "pyramid_lookup.cu and bilinear.cuh",
        "further sources to time (a directory as for --parent), in the "
        "turns with parent and change", out=True)
    ab_torch.need_card("ab_lookup_torch")
    dirs = {"parent": args.parent, "change": str(_build.CSRC),
            **args.variant}
    libs = {tag: build(d, tag) for tag, d in dirs.items()}
    report = {"card": card_name(),
              "ab_lookup": compare(libs, torch.device("cuda"))}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ab_lookup_torch.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
