"""Per-lane row gather (kernel K5, ``csrc/row_gather.cu``).

Replaces the Pallas probe ``run`` of the JAX package's ``_prof_sublane.py``
(its two bodies, a select chain over the S rows and a sublane gather,
compute one function)::

    out[e, p, l] = V[e, p, s[e, p, l], l]

with V bf16 [E, P, S, L], s int32 [E, P, L] and out fp32 [E, P, L]; an
index outside [0, S) reads 0.  It is a microbenchmark of K2's access
pattern (2-byte values gathered from a few rows), run by
``scripts/profile_torch_k2_parts.py``; no system path calls it.

:func:`row_gather` launches the kernel on a CUDA tensor and runs
:func:`row_gather_plain` on a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from lgu_slam_tpu_torch.ops import _build


def row_gather_plain(V: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.gather`` along the row axis."""
    S = V.shape[2]
    ok = (s >= 0) & (s < S)
    idx = torch.where(ok, s, torch.zeros_like(s)).long()
    out = torch.gather(V, 2, idx[:, :, None]).squeeze(2).float()
    return torch.where(ok, out, torch.zeros_like(out))


def _launch(V, s):
    E, P, S, L = V.shape
    dev = s.device
    if (V.device != dev or V.dtype != torch.bfloat16
            or not V.is_contiguous()):
        raise ValueError(f"row_gather: V must be a contiguous bfloat16 tensor "
                         f"on {dev}, got {V.dtype} on {V.device}")
    if (s.dtype != torch.int32 or not s.is_contiguous()
            or tuple(s.shape) != (E, P, L)):
        raise ValueError(f"row_gather: s must be a contiguous int32 "
                         f"{(E, P, L)}, got {s.dtype} {tuple(s.shape)}")
    out = torch.empty(E, P, L, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("row_gather")
    fn = lib.row_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(V.data_ptr(), s.data_ptr(), out.data_ptr(), E * P, S, L,
                    stream)
    _build.check(status, "row_gather")
    row_gather.launches += 1
    return out


def row_gather(V: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """V [E, P, S, L] bf16, s [E, P, L] int32 -> [E, P, L] fp32."""
    if s.device.type == "cpu":
        return row_gather_plain(V, s)
    if s.device.type != "cuda":
        raise ValueError(f"row_gather: no kernel for device {s.device}")
    return _launch(V, s)


row_gather.launches = 0  # kernel launches, counted by _launch
