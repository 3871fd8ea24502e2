#!/usr/bin/env python3
"""Where the time of K1's two tensor-core kernels goes, on one GPU.

    python scripts/profile_torch_k1_parts.py

Builds each kernel source as it is and variants of it with one part removed
each, all into ``build/k1_parts/``:

- ``masked_corr_tc.cu`` (bf16 operands): the Gaussian, the global stores,
  the whole epilogue, the wgmma products;
- ``masked_corr_tf32.cu`` (fp32 operands, 3xTF32): the Gaussian, the
  global stores, the whole epilogue, the hi/lo split of the landed tiles,
  the wgmma products;

and times each at the tracking shapes (E = 48, 48 x 64, C = 128) with CUDA
events, for bf16 and fp32 volumes, beside ``zero_()`` of the same volume
(a store-only yardstick) and the kernel's byte and operation bounds.  The
variants compute wrong volumes on purpose: only their times mean anything.
Prints one JSON line.
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
from lgu_slam_tpu_torch.ops.masked_corr import tf32_schedule  # noqa: E402
from lgu_slam_tpu_torch.utils.measure import (  # noqa: E402
    BF16_FLOP_PER_S,
    TF32_FLOP_PER_S,
    bytes_ms,
    cuda_ms,
)

E, H, W = 48, 48, 64
# the part removed by each variant: the source's lines replaced
COMMON = {
    "whole": [],
    "no_gaussian": [("if (x_hit && fy", "if (false && x_hit && fy")],
    "no_stores": [("if (p >= P || q0 >= P) continue;",
                   "if (p >= 0) continue;")],
}
# kernel -> (source, entry point, operand dtype, products per product,
# its own variants)
KERNELS = {
    "tc": ("masked_corr_tc", "masked_corr_level0_tc", torch.bfloat16, 1, {
        "no_epilogue": [("if (lane == 0) mbar_arrive(&empty_b[s]);",
                         "if (lane == 0) mbar_arrive(&empty_b[s]);\n"
                         "    continue;")],
        "no_wgmma": [("wgmma_m64n128k16(acc, desc(a_base + off), "
                      "desc(b_base + off), kk > 0);", "(void)off;")]}),
    "tf32": ("masked_corr_tf32", "masked_corr_level0_tf32", torch.float32, 3,
             {"no_epilogue": [("if (lane == 0) mbar_arrive(&empty_b[s]);",
                               "if (lane == 0) mbar_arrive(&empty_b[s]);\n"
                               "    continue;")],
              "no_split": [("split_tile(a_hi, a_lo, t);", ""),
                           ("split_tile(b_hi + s * TILE_BYTES, "
                            "b_lo + s * TILE_BYTES, t);", "")],
              "no_wgmma": [
                  ("wgmma_m64n64k8(acc, desc(a_lo + off), desc(bh + off), "
                   "kk > 0);", "(void)off;"),
                  ("wgmma_m64n64k8(acc, desc(a_hi + off), desc(bl + off), "
                   "1);", ""),
                  ("wgmma_m64n64k8(acc, desc(a_hi + off), desc(bh + off), "
                   "1);", "")]}),
}


def build(out_dir: Path) -> dict:
    """Every variant of both kernels, compiled in parallel: {(kernel,
    variant): entry point}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, (source, _, _, _, own) in KERNELS.items():
        src = (_build.CSRC / f"{source}.cu").read_text()
        for name, subs in {**COMMON, **own}.items():
            text = src
            for old, new in subs:
                if old not in text:
                    sys.exit(f"profile_torch_k1_parts: '{old}' not in "
                             f"{source}.cu")
                text = text.replace(old, new)
            cu = out_dir / f"{kernel}_{name}.cu"
            cu.write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                   "-o", str(out_dir / f"lib{kernel}_{name}.so"), str(cu)]
            procs[kernel, name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    fns = {}
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {kernel} variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{kernel}_{name}.so"))
        fn = getattr(lib, KERNELS[kernel][1])
        n_int = 5 if kernel == "tc" else 7
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fns[kernel, name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_k1_parts: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    fns = build(_build.BUILD_DIR.parent / "k1_parts")
    P = H * W
    gen = torch.Generator().manual_seed(0)
    f1 = torch.randn(E, P, 128, generator=gen).to(dev)
    f2 = torch.randn(E, P, 128, generator=gen).to(dev)
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H),
                                      indexing="xy"), -1).float()
    mean = (grid.reshape(P, 2) + 3 * torch.randn(E, P, 2, generator=gen))
    cov = 0.05 + 5 * torch.rand(E, P, 2, generator=gen)
    mean, cov = mean.to(dev), cov.to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": torch.cuda.get_device_name(0),
              "shapes": f"E={E} {H}x{W} C=128"}
    for kernel, (_, _, op_dt, products, _) in KERNELS.items():
        a, b = f1.to(op_dt), f2.to(op_dt)
        extra = () if kernel == "tc" else tf32_schedule(E, P)[1:]
        rate = BF16_FLOP_PER_S if kernel == "tc" else TF32_FLOP_PER_S
        ops_ms = 1e3 * products * 2 * E * P * P * 128 / rate
        res = result[kernel] = {"operands": str(op_dt).replace("torch.", "")}
        for dt in (torch.bfloat16, torch.float32):
            out = torch.empty(E, P, P, dtype=dt, device=dev)

            def call(fn):
                status = fn(a.data_ptr(), b.data_ptr(), mean.data_ptr(),
                            cov.data_ptr(), out.data_ptr(), E, H, W, 4,
                            *extra, int(dt == torch.bfloat16), stream)
                if status:
                    raise RuntimeError(f"launch failed: {status}")

            key = str(dt).replace("torch.", "")
            res[key] = {name: cuda_ms(lambda fn=fn: call(fn))
                        for (k, name), fn in fns.items() if k == kernel}
            res[key]["zero_"] = cuda_ms(out.zero_)
            res[key]["bytes_bound_ms"] = bytes_ms(
                2 * a.numel() * a.element_size() + 2 * E * P * 2 * 4
                + out.numel() * out.element_size())
            res[key]["operations_bound_ms"] = ops_ms
            del out
        del a, b
    print(json.dumps({"k1_parts": result}))


if __name__ == "__main__":
    main()
