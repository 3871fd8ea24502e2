"""Level 0 of the correlation pyramid: all-pairs correlation with the fused
Gaussian-uncertainty re-weighting (kernel K1, ``csrc/masked_corr.cu``).

Replaces the Pallas kernel ``masked_corr_level0`` of the JAX package's
``ops/pallas_corr.py``.  Per edge e, source pixel p and target pixel q::

    corr = <f1[e, p], f2[e, q]> / 16
    out  = corr * (1 + 3 exp(-(dx^2/c1 + dy^2/c2) / 2) / (6.28 sqrt(c1 c2)))

inside the 9x9 window around floor(mean[e, p]) (dx, dy from the unfloored
mean), ``out = corr`` outside, written as [E, P, P] in ``out_dtype``.

:func:`masked_corr_level0` launches the kernel on a CUDA tensor and runs
:func:`masked_corr_level0_plain` on a CPU tensor; any other device raises.
The training forward calls the plain version itself, in fp32 on every
device, and autograd differentiates it (``models/corr.py``): the kernel has
no backward, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.sampler import gaussian_window_mask

TWO_PI = 6.28  # the reference's literal (gaussianMask_cuda.py:85)
EDGE_CHUNK = 8  # edges per step of the plain version (bounds fp32 transients)


def masked_corr_level0_plain(fmap1, fmap2, mean, cov, radius: int = 4,
                             out_dtype=torch.bfloat16):
    """Plain PyTorch version.  fmap1/fmap2 [E, H, W, C], mean/cov
    [E, H, W, 2] -> [E, P, P] in ``out_dtype``."""
    E, H, W, C = fmap1.shape
    P = H * W
    out = torch.empty(E, P, P, dtype=out_dtype, device=fmap1.device)
    for lo in range(0, E, EDGE_CHUNK):
        sl = slice(lo, lo + EDGE_CHUNK)
        n = fmap1[sl].shape[0]
        a = fmap1[sl].reshape(n, P, C).float() / 4.0
        b = fmap2[sl].reshape(n, P, C).float() / 4.0
        corr = torch.bmm(a, b.transpose(1, 2)).reshape(n, H, W, H, W)
        m, c = mean[sl].float(), cov[sl].float()
        masked = gaussian_window_mask(corr, m, c, radius)
        denom = TWO_PI * torch.sqrt(c[..., 0] * c[..., 1])[..., None, None]
        out[sl] = (masked / denom + corr).reshape(n, P, P).to(out_dtype)
    return out


def _launch(fmap1, fmap2, mean, cov, radius, out_dtype):
    E, H, W, C = fmap1.shape
    P = H * W
    dev = fmap1.device
    for name, t, shape in (("fmap1", fmap1, (E, H, W, C)),
                           ("fmap2", fmap2, (E, H, W, C)),
                           ("mean", mean, (E, H, W, 2)),
                           ("cov", cov, (E, H, W, 2))):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"masked_corr_level0: {name} must be float32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"masked_corr_level0: {name} must be a "
                             f"contiguous {shape}, got {tuple(t.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"masked_corr_level0: out_dtype {out_dtype} "
                         "is neither float32 nor bfloat16")
    out = torch.empty(E, P, P, dtype=out_dtype, device=dev)
    if E == 0:
        return out
    lib = _build.load("masked_corr")
    fn = lib.masked_corr_level0
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(fmap1.data_ptr(), fmap2.data_ptr(), mean.data_ptr(),
                    cov.data_ptr(), out.data_ptr(), E, H, W, C, radius,
                    int(out_dtype == torch.bfloat16), stream)
    _build.check(status, "masked_corr_level0")
    masked_corr_level0.launches += 1
    return out


def masked_corr_level0(fmap1, fmap2, mean, cov, radius: int = 4,
                       out_dtype=torch.bfloat16):
    """Masked level-0 volume [E, P, P] in ``out_dtype`` (fp32 or bf16).

    On CUDA the inputs must be contiguous float32 (the frontend's bf16
    video features are widened by the caller, as in the JAX kernel)."""
    if fmap1.device.type == "cpu":
        return masked_corr_level0_plain(fmap1, fmap2, mean, cov, radius,
                                        out_dtype)
    if fmap1.device.type != "cuda":
        raise ValueError(f"masked_corr_level0: no kernel for device "
                         f"{fmap1.device}")
    return _launch(fmap1, fmap2, mean, cov, radius, out_dtype)


masked_corr_level0.launches = 0  # kernel launches, counted by _launch
