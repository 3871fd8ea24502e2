"""Bilinear taps at arbitrary positions on one flat correlation level
(kernels K3 and K4, ``csrc/window_lookup.cu``).

Replaces the Pallas kernels ``window_lookup_packed`` and
``dense_lookup_packed`` of the JAX package's ``ops/pallas_lookup.py``: both
compute :func:`~lgu_slam_tpu_torch.ops.sampler.sample_taps_flat` (the
reference CUDA boundary rule; a NaN position reads 0), the dense one as a
tent over a whole tiny plane because the TPU had no fast gather.  On the
GPU one kernel serves both shapes; the lane-packed ``[S, 128]`` storage of
the TPU is not ported, the level stays flat ``[E, P1, H2 * W2]``.

:func:`window_lookup` launches the kernel on a CUDA tensor and runs its
plain version, ``sample_taps_flat``, on a CPU tensor; any other device
raises.
"""

from __future__ import annotations

import ctypes

import torch

from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat


def _kernel():
    """The kernel's C function, its argument types set at its first use
    (ctypes keeps the function object, so later launches skip it)."""
    fn = _build.load("window_lookup").window_lookup
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return fn


def _launch(vol, H2, W2, px, py):
    E, P1, K = px.shape
    dev = px.device
    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_lookup: level dtype {vol.dtype} is neither "
                         "float32 nor bfloat16")
    if (vol.device != dev or not vol.is_contiguous()
            or tuple(vol.shape) != (E, P1, H2 * W2)):
        raise ValueError(
            f"window_lookup: vol must be a contiguous {(E, P1, H2 * W2)} on "
            f"{dev}, got {tuple(vol.shape)} on {vol.device}")
    for name, t in (("px", px), ("py", py)):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != (E, P1, K)):
            raise ValueError(
                f"window_lookup: {name} must be a contiguous float32 "
                f"{(E, P1, K)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if E * P1 * K >= 2 ** 31:
        raise ValueError(f"window_lookup: {E * P1 * K} taps, the kernel "
                         "indexes them with 32 bits")
    out = torch.empty(E, P1, K, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(vol.data_ptr(), px.data_ptr(), py.data_ptr(),
                    out.data_ptr(), E, P1, K, H2, W2,
                    int(vol.dtype == torch.bfloat16), stream)
    _build.check(status, "window_lookup")
    window_lookup.launches += 1
    return out


def window_lookup(vol, H2: int, W2: int, px, py):
    """Bilinear taps of the flat level vol [E, P1, H2*W2] (fp32 or bf16)
    at px/py [E, P1, K] -> [E, P1, K] fp32."""
    if px.device.type == "cpu":
        return sample_taps_flat(vol, H2, W2, px, py)
    if px.device.type != "cuda":
        raise ValueError(f"window_lookup: no kernel for device {px.device}")
    return _launch(vol, H2, W2, px, py)


window_lookup.launches = 0  # kernel launches, counted by _launch
