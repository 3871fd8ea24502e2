#!/usr/bin/env python
"""Time kernel K2 (``fused_pyramid_lookup``) built from two sources on one
card, in alternating turns: another revision's against this checkout's.

    mkdir -p build/k2_parent
    git show REV:lgu_slam_tpu_torch/csrc/pyramid_lookup.cu \\
        > build/k2_parent/pyramid_lookup.cu
    git show REV:lgu_slam_tpu_torch/csrc/bilinear.cuh \\
        > build/k2_parent/bilinear.cuh
    python scripts/ab_k2_torch.py --parent build/k2_parent

Both sources are compiled with the port's nvcc flags (ptxas' register
summary is printed) and run on the tracking planes (48 x 64, bf16 levels,
the inputs of ``chip_smoke.py`` phase 1) at the edge counts of K2's call
sites (``chip_smoke.K2_EDGES``): E = 1 (the motion filter's probe), 2 and
8 (backend sub-chunks), 24 (the frontend's mean) and 48 (the TPU probes'
shape), in the order parent, change, change, parent.  Each time is a mean
over 50 launches: on the device alone (one CUDA graph of the launches) and
by CUDA events over the launches back to back.  The outputs must be equal
bit for bit, or within 2e-4 where the arithmetic was changed.  Prints one
JSON line.

``--variant NAME=DIR`` (repeatable) adds further sources, each timed once
per E after the four turns: designs tried and not kept.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import torch  # noqa: E402

import ab_torch  # noqa: E402
import chip_smoke  # noqa: E402
from lgu_slam_tpu_torch.ops import _build  # noqa: E402
from lgu_slam_tpu_torch.utils.measure import cuda_ms, graph_ms  # noqa: E402

H, W = 48, 64
EDGES = chip_smoke.K2_EDGES


def compare(libs: dict, dev) -> dict:
    """Every library's K2 at each E of EDGES, timed in the turns of parent
    and change (the variants once each, after them)."""
    tags = ab_torch.turns(("parent", "change")) + tuple(
        t for t in libs if t not in ("parent", "change"))
    result = {}
    for E in EDGES:
        lv, cflat, off0, off1 = chip_smoke.lookup_inputs(
            torch.Generator().manual_seed(0), E, H, W, dev, torch.bfloat16)
        outs = {tag: torch.empty(E, H * W, 196, device=dev) for tag in libs}

        def run(tag):
            status = libs[tag](
                *(v.data_ptr() for v in lv), cflat.data_ptr(),
                off0.data_ptr(), off1.data_ptr(), outs[tag].data_ptr(), E, H,
                W, 1, torch.cuda.current_stream().cuda_stream)
            _build.check(status, f"fused_pyramid_lookup ({tag})")

        ms = {tag: [] for tag in libs}
        ms_eager = {tag: [] for tag in libs}
        for tag in tags:
            ms[tag].append(graph_ms(lambda: run(tag)))
            ms_eager[tag].append(cuda_ms(lambda: run(tag), reps=50,
                                         warmup=5))
        torch.cuda.synchronize()
        ref = outs["parent"]
        result[E] = {
            "ms": ms, "ms_eager": ms_eager,
            "equal_to_parent": {t: torch.equal(o, ref)
                                for t, o in outs.items()},
            "max_abs_diff_to_parent": {t: (o - ref).abs().max().item()
                                       for t, o in outs.items()}}
        for t, err in result[E]["max_abs_diff_to_parent"].items():
            if err > 2e-4:
                sys.exit(f"ab_k2_torch: {t} differs from parent by {err} "
                         f"at E={E}")
        del lv, cflat, off0, off1, outs
    return result


def main():
    args = ab_torch.arguments(
        "directory with the other revision's pyramid_lookup.cu and "
        "bilinear.cuh",
        "a further source to time (a directory as for --parent), once per "
        "E after the four turns")
    ab_torch.need_card("ab_k2_torch")
    dirs = {"parent": args.parent, "change": str(_build.CSRC),
            **args.variant}
    libs = {tag: ab_torch.entry(
        ab_torch.build(os.path.join(d, "pyramid_lookup.cu"), f"k2_{tag}"),
        "fused_pyramid_lookup", 8, 4) for tag, d in dirs.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "k2_ab": compare(libs, torch.device("cuda"))}))


if __name__ == "__main__":
    main()
