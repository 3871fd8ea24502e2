#!/usr/bin/env python3
"""Where the bf16-operand K1 kernel's time goes, on one GPU.

    python scripts/profile_torch_k1_parts.py

Builds ``lgu_slam_tpu_torch/csrc/masked_corr_tc.cu`` as it is and four
variants of it with one part removed each (the Gaussian, the global stores,
the whole epilogue, the wgmma products), all into ``build/k1_parts/``, and
times each at the tracking shapes (E = 48, 48 x 64, C = 128) with CUDA
events, for bf16 and fp32 volumes, beside ``zero_()`` of the same volume
(a store-only yardstick).  The variants compute wrong volumes on purpose:
only their times mean anything.  Prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from lgu_slam_tpu_torch.ops import _build  # noqa: E402
from lgu_slam_tpu_torch.utils.measure import bytes_ms, cuda_ms  # noqa: E402

E, H, W = 48, 48, 64
# variant -> the source's lines replaced
VARIANTS = {
    "whole": [],
    "no_gaussian": [("if (x_hit && fy", "if (false && x_hit && fy")],
    "no_stores": [("if (p >= P || q0 >= P) continue;",
                   "if (p >= 0) continue;")],
    "no_epilogue": [("if (lane == 0) mbar_arrive(&empty_b[s]);",
                     "if (lane == 0) mbar_arrive(&empty_b[s]);\n"
                     "    continue;")],
    "no_wgmma": [("wgmma_m64n128k16(acc, desc(a_base + off), "
                  "desc(b_base + off), kk > 0);", "(void)off;")],
}


def build(out_dir: Path) -> dict:
    src = (_build.CSRC / "masked_corr_tc.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                sys.exit(f"profile_torch_k1_parts: '{old}' not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out_dir / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        fn = lib.masked_corr_level0_tc
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        libs[name] = fn
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_k1_parts: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    libs = build(_build.BUILD_DIR.parent / "k1_parts")
    P = H * W
    gen = torch.Generator().manual_seed(0)
    f1 = torch.randn(E, P, 128, generator=gen).to(dev, torch.bfloat16)
    f2 = torch.randn(E, P, 128, generator=gen).to(dev, torch.bfloat16)
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H),
                                      indexing="xy"), -1).float()
    mean = (grid.reshape(P, 2) + 3 * torch.randn(E, P, 2, generator=gen))
    cov = 0.05 + 5 * torch.rand(E, P, 2, generator=gen)
    mean, cov = mean.to(dev), cov.to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": torch.cuda.get_device_name(0),
              "shapes": f"E={E} {H}x{W} C=128 bf16 operands"}
    for dt in (torch.bfloat16, torch.float32):
        out = torch.empty(E, P, P, dtype=dt, device=dev)
        key = str(dt).replace("torch.", "")

        def call(fn):
            status = fn(f1.data_ptr(), f2.data_ptr(), mean.data_ptr(),
                        cov.data_ptr(), out.data_ptr(), E, H, W, 4,
                        int(dt == torch.bfloat16), stream)
            if status:
                raise RuntimeError(f"launch failed: {status}")

        result[key] = {name: cuda_ms(lambda fn=fn: call(fn))
                       for name, fn in libs.items()}
        result[key]["zero_"] = cuda_ms(out.zero_)
        result[key]["bound_ms"] = bytes_ms(
            2 * E * P * 128 * 2 + 2 * E * P * 2 * 4
            + E * P * P * out.element_size())
        del out
    print(json.dumps({"k1_parts": result}))


if __name__ == "__main__":
    main()
