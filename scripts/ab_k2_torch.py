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
summary is printed) and run on the tracking shapes (E = 48, 48 x 64, bf16
levels, the inputs of ``chip_smoke.py`` phase 1) in the order parent,
change, change, parent, twice; each time is a CUDA-event mean over 50
launches.  The outputs must be equal.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lgu_slam_tpu_torch.ops import _build  # noqa: E402
from lgu_slam_tpu_torch.utils.measure import cuda_ms  # noqa: E402

E, H, W = 48, 48, 64


def build(src: str, out: str) -> ctypes.CDLL:
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    print(src, [line.strip() for line in (r.stdout + r.stderr).splitlines()
                if "registers" in line])
    lib = ctypes.CDLL(out)
    lib.fused_pyramid_lookup.restype = ctypes.c_int
    lib.fused_pyramid_lookup.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True,
                   help="directory with the other revision's "
                        "pyramid_lookup.cu and bilinear.cuh")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_k2_torch: needs an NVIDIA GPU")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = {
        "parent": build(os.path.join(args.parent, "pyramid_lookup.cu"),
                        str(_build.BUILD_DIR / "libk2_ab_parent.so")),
        "change": build(str(_build.CSRC / "pyramid_lookup.cu"),
                        str(_build.BUILD_DIR / "libk2_ab_change.so")),
    }
    dev = torch.device("cuda")
    lv, cflat, off0, off1 = chip_smoke.lookup_inputs(
        torch.Generator().manual_seed(0), E, H, W, dev, torch.bfloat16)
    outs = {tag: torch.empty(E, H * W, 196, device=dev) for tag in libs}

    def run(tag):
        status = libs[tag].fused_pyramid_lookup(
            *(v.data_ptr() for v in lv), cflat.data_ptr(), off0.data_ptr(),
            off1.data_ptr(), outs[tag].data_ptr(), E, H, W, 1,
            torch.cuda.current_stream().cuda_stream)
        _build.check(status, f"fused_pyramid_lookup ({tag})")

    ms = {tag: [] for tag in libs}
    for tag in ("parent", "change", "change", "parent") * 2:
        ms[tag].append(cuda_ms(lambda: run(tag), reps=50, warmup=5))
    torch.cuda.synchronize()
    print(json.dumps({
        "equal_outputs": torch.equal(outs["parent"], outs["change"]),
        "ms": ms}))


if __name__ == "__main__":
    main()
