"""Level 0 of the correlation pyramid: all-pairs correlation with the fused
Gaussian-uncertainty re-weighting (kernel K1).

Replaces the Pallas kernel ``masked_corr_level0`` of the JAX package's
``ops/pallas_corr.py``.  Per edge e, source pixel p and target pixel q::

    corr = <f1[e, p], f2[e, q]> / 16
    out  = corr * (1 + 3 exp(-(dx^2/c1 + dy^2/c2) / 2) / (6.28 sqrt(c1 c2)))

inside the 9x9 window around floor(mean[e, p]) (dx, dy from the unfloored
mean), ``out = corr`` outside, written as [E, P, P] in ``out_dtype``.

:func:`masked_corr_level0` launches a kernel on a CUDA tensor and runs
:func:`masked_corr_level0_plain` on a CPU tensor; any other device raises.
On the card it dispatches on the operands' dtype, both the same:

- bfloat16 -> ``csrc/masked_corr_tc.cu``, wgmma on the tensor cores with
  fp32 accumulation.  The product of two bf16 values is exact in fp32, so
  this is the fp32 function up to the order of summation.  Callers pass
  bf16 only where the values are bf16 already (``models/corr.py``).
- float32 -> ``csrc/masked_corr.cu``, an SIMT fp32 kernel.

Any other operand dtype raises; a failed build or launch raises and never
reroutes.  The training forward calls the plain version itself, in fp32 on
every device, and autograd differentiates it (``models/corr.py``): the
kernels have no backward, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.sampler import gaussian_window_mask

TWO_PI = 6.28  # the reference's literal (gaussianMask_cuda.py:85)
EDGE_CHUNK = 8  # edges per step of the plain version (bounds fp32 transients)
TC_CHANNELS = 128  # the bf16 kernel's channel count (one smem stage)


def masked_corr_level0_plain(fmap1, fmap2, mean, cov, radius: int = 4,
                             out_dtype=torch.bfloat16):
    """Plain PyTorch version.  fmap1/fmap2 [E, H, W, C] (fp32 or bf16,
    widened to fp32), mean/cov [E, H, W, 2] -> [E, P, P] in
    ``out_dtype``."""
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


OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _check_operands(fmap1, fmap2):
    if fmap1.dtype != fmap2.dtype or fmap1.dtype not in OPERAND_DTYPES:
        raise ValueError(f"masked_corr_level0: the operands must both be "
                         f"float32 or both bfloat16, got {fmap1.dtype} and "
                         f"{fmap2.dtype}")


def _launch(fmap1, fmap2, mean, cov, radius, out_dtype):
    E, H, W, C = fmap1.shape
    P = H * W
    dev = fmap1.device
    bf16 = fmap1.dtype == torch.bfloat16
    for name, t, shape, dt in (("fmap1", fmap1, (E, H, W, C), fmap1.dtype),
                               ("fmap2", fmap2, (E, H, W, C), fmap1.dtype),
                               ("mean", mean, (E, H, W, 2), torch.float32),
                               ("cov", cov, (E, H, W, 2), torch.float32)):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"masked_corr_level0: {name} must be {dt} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"masked_corr_level0: {name} must be a "
                             f"contiguous {shape}, got {tuple(t.shape)}")
    if bf16 and C != TC_CHANNELS:
        raise ValueError(f"masked_corr_level0: the bf16 kernel takes "
                         f"{TC_CHANNELS} channels, got {C}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"masked_corr_level0: out_dtype {out_dtype} "
                         "is neither float32 nor bfloat16")
    out = torch.empty(E, P, P, dtype=out_dtype, device=dev)
    if E == 0:
        return out
    if bf16:
        lib = _build.load("masked_corr_tc")
        fn = lib.masked_corr_level0_tc
        args = (E, H, W, radius)
    else:
        lib = _build.load("masked_corr")
        fn = lib.masked_corr_level0
        args = (E, H, W, C, radius)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (len(args) + 1) \
        + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(fmap1.data_ptr(), fmap2.data_ptr(), mean.data_ptr(),
                    cov.data_ptr(), out.data_ptr(), *args,
                    int(out_dtype == torch.bfloat16), stream)
    _build.check(status, "masked_corr_level0")
    masked_corr_level0.launches += 1
    masked_corr_level0.launches_bf16 += int(bf16)
    masked_corr_level0.edges += E
    return out


def masked_corr_level0(fmap1, fmap2, mean, cov, radius: int = 4,
                       out_dtype=torch.bfloat16):
    """Masked level-0 volume [E, P, P] in ``out_dtype`` (fp32 or bf16).

    fmap1/fmap2 are both float32 or both bfloat16; on CUDA they, mean and
    cov (float32) must be contiguous, and bf16 operands have 128
    channels."""
    _check_operands(fmap1, fmap2)
    if fmap1.device.type == "cpu":
        return masked_corr_level0_plain(fmap1, fmap2, mean, cov, radius,
                                        out_dtype)
    if fmap1.device.type != "cuda":
        raise ValueError(f"masked_corr_level0: no kernel for device "
                         f"{fmap1.device}")
    return _launch(fmap1, fmap2, mean, cov, radius, out_dtype)


# counted by _launch: kernel launches (both kernels), those of the bf16
# kernel, and the edges over all launches
masked_corr_level0.launches = 0
masked_corr_level0.launches_bf16 = 0
masked_corr_level0.edges = 0
