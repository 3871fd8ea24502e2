#!/usr/bin/env python
"""Time K1 with fp32 operands (``masked_corr_level0``) on one card, in
alternating turns: another revision's fp32-operand kernel against this
checkout's, beside ``torch.bmm`` of the same fp32 operands (TF32 off, as
``use_full_fp32()`` sets it; the product alone).

    mkdir -p build/k1_parent
    git show REV:lgu_slam_tpu_torch/csrc/masked_corr.cu \\
        > build/k1_parent/masked_corr.cu
    python scripts/ab_k1_torch.py --parent build/k1_parent

The parent source is the SIMT kernel that fp32 operands ran on before the
3xTF32 kernel (``csrc/masked_corr_tf32.cu``); it is compiled with the
port's nvcc flags (ptxas' register summary is printed), the change through
``ops/_build.py``.  Both run on full-mantissa fp32 features at the
tracking planes (48 x 64, C = 128, the inputs of ``chip_smoke.py`` phase
1) at E = 1 (the motion filter's probe) and E = 48, into bf16 and fp32
volumes, in the order parent, change, bmm, bmm, change, parent.  Each time
is a mean over launches on the device alone (one CUDA graph of the
launches).  Both kernels must agree with the plain version within the
fp32 tolerance (atol 2e-4, rtol 1e-4; bf16 out: one bf16 step).  Prints
one JSON line.

``--variant NAME=DIR`` (repeatable) adds other sources of the 3xTF32
kernel (``DIR/masked_corr_tf32.cu``), each timed once per case after the
six turns: designs tried and not kept.
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
from lgu_slam_tpu_torch.ops.masked_corr import (  # noqa: E402
    masked_corr_level0,
    masked_corr_level0_plain,
    tf32_schedule,
)
from lgu_slam_tpu_torch.utils.device import use_full_fp32  # noqa: E402
from lgu_slam_tpu_torch.utils.measure import graph_ms  # noqa: E402

H, W = 48, 64
EDGES = (1, 48)
ORDER = ab_torch.turns(("parent", "change", "bmm"))


def agrees(out, ref, out_dtype) -> bool:
    """The fp32 tolerance, or one bf16 step for a bf16 volume."""
    out, ref = out.float(), ref.float()
    if out_dtype == torch.float32:
        return torch.allclose(out, ref, atol=2e-4, rtol=1e-4)
    return ((out - ref).abs() / (ref.abs() + 1.0)).max().item() < 0.02


def compare(parent, variants: dict, dev) -> dict:
    """Each E and volume dtype: the turns of ORDER, then each variant once;
    every kernel against the plain version."""
    result = {}
    for E in EDGES:
        f1, f2, mean, cov = chip_smoke.corr_inputs(
            torch.Generator().manual_seed(0), E, H, W, dev,
            full_mantissa=True)
        a = (f1 / 4.0).reshape(E, H * W, 128)
        b = (f2 / 4.0).reshape(E, H * W, 128).transpose(1, 2)
        for out_dtype in (torch.bfloat16, torch.float32):
            outs = {}

            def run(tag):
                if tag == "change":
                    outs[tag] = masked_corr_level0(f1, f2, mean, cov,
                                                   out_dtype=out_dtype)
                elif tag == "bmm":
                    torch.bmm(a, b)
                else:
                    out = outs.setdefault(tag, torch.empty(
                        E, H * W, H * W, dtype=out_dtype, device=dev))
                    # the parent's SIMT kernel takes C; the variants of the
                    # 3xTF32 kernel take its grid
                    fn, args = ((parent, (128, 4)) if tag == "parent" else
                                (variants[tag],
                                 (4, *tf32_schedule(E, H * W)[1:])))
                    status = fn(f1.data_ptr(), f2.data_ptr(),
                                mean.data_ptr(), cov.data_ptr(),
                                out.data_ptr(), E, H, W, *args,
                                int(out_dtype == torch.bfloat16),
                                torch.cuda.current_stream().cuda_stream)
                    _build.check(status, f"masked_corr_level0 ({tag})")

            tags = ORDER + tuple(variants)
            ms = {tag: [] for tag in tags}
            reps = 50 if E == 1 else 10
            for tag in tags:
                ms[tag].append(graph_ms(lambda: run(tag), reps=reps))
            kernels = ("parent", "change", *variants)
            for tag in kernels:
                run(tag)
            ref = masked_corr_level0_plain(f1, f2, mean, cov,
                                           out_dtype=out_dtype)
            torch.cuda.synchronize()
            key = f"E={E} {str(out_dtype).replace('torch.', '')} out"
            result[key] = {
                "ms": ms,
                "agree_with_plain": {t: agrees(outs[t], ref, out_dtype)
                                     for t in kernels},
                "max_abs_diff_to_plain": {
                    t: (outs[t].float() - ref.float()).abs().max().item()
                    for t in kernels}}
            for t, ok in result[key]["agree_with_plain"].items():
                if not ok:
                    sys.exit(f"ab_k1_torch: {t} disagrees with the plain "
                             f"version at {key}")
            del outs, ref
        del f1, f2, mean, cov, a, b
        torch.cuda.empty_cache()
    return result


def main():
    args = ab_torch.arguments(
        "directory with the other revision's masked_corr.cu",
        "a directory with another masked_corr_tf32.cu, timed once per case "
        "after the six turns")
    ab_torch.need_card("ab_k1_torch")
    use_full_fp32()
    parent = ab_torch.entry(
        ab_torch.build(os.path.join(args.parent, "masked_corr.cu"),
                       "k1_parent"), "masked_corr_level0", 5, 6)
    variants = {name: ab_torch.entry(
        ab_torch.build(os.path.join(src, "masked_corr_tf32.cu"),
                       f"k1_{name}"), "masked_corr_level0_tf32", 5, 7)
        for name, src in args.variant.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "k1_ab": compare(parent, variants,
                                       torch.device("cuda"))}))


if __name__ == "__main__":
    main()
