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
- float32 -> ``csrc/masked_corr_tf32.cu``, wgmma on the tensor cores as
  three TF32 products per product (3xTF32: ``a_hi b_hi + a_hi b_lo +
  a_lo b_hi``), fp32 up to rounding.

Both kernels take 128 channels (every call site's).

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
TC_CHANNELS = 128  # the kernels' channel count
TF32_ROWS = 64  # the fp32-operand kernel's source pixels per block
TF32_COLS = 64  # and target pixels per tile
BLOCKS_TARGET = 264  # blocks to aim for: two waves of the H100's 132 SMs


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
        out[sl] = window_epilogue(corr, mean[sl].float(), cov[sl].float(),
                                  radius).reshape(n, P, P).to(out_dtype)
    return out


def window_epilogue(corr, mean, cov, radius: int):
    """The Gaussian re-weighting of corr [n, H, W, H, W] (fp32) inside each
    source pixel's window, mean/cov [n, H, W, 2] fp32: the kernels'
    epilogue."""
    masked = gaussian_window_mask(corr, mean, cov, radius)
    denom = TWO_PI * torch.sqrt(cov[..., 0] * cov[..., 1])[..., None, None]
    return masked / denom + corr


OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _check_operands(fmap1, fmap2):
    if fmap1.dtype != fmap2.dtype or fmap1.dtype not in OPERAND_DTYPES:
        raise ValueError(f"masked_corr_level0: the operands must both be "
                         f"float32 or both bfloat16, got {fmap1.dtype} and "
                         f"{fmap2.dtype}")


def tf32_schedule(E: int, P: int):
    """The fp32-operand kernel's grid: (row blocks, runs, tiles per run).
    Block (r, y, e) computes source pixels 64r.. of edge e against the
    64-pixel target tiles of run y; the tiles of a row block are split
    into runs when E * row blocks would leave SMs idle (the motion
    filter's one-edge probe)."""
    rows = -(-P // TF32_ROWS)
    tiles = -(-P // TF32_COLS)
    runs = min(max(-(-BLOCKS_TARGET // max(E * rows, 1)), 1), tiles)
    per_run = -(-tiles // runs)
    return rows, -(-tiles // per_run), per_run


def check_kernel_inputs(fmap1, fmap2, mean, cov, out_dtype):
    """Raise ValueError unless the kernels take these inputs: contiguous
    [E, H, W, 128] operands of one dtype, float32 mean and cov
    [E, H, W, 2] on the operands' device, an fp32 or bf16 volume."""
    _check_operands(fmap1, fmap2)
    E, H, W, C = fmap1.shape
    dev = fmap1.device
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
    if C != TC_CHANNELS:
        raise ValueError(f"masked_corr_level0: the kernels take "
                         f"{TC_CHANNELS} channels, got {C}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"masked_corr_level0: out_dtype {out_dtype} "
                         "is neither float32 nor bfloat16")


def _launch(fmap1, fmap2, mean, cov, radius, out_dtype):
    check_kernel_inputs(fmap1, fmap2, mean, cov, out_dtype)
    E, H, W, _ = fmap1.shape
    P = H * W
    dev = fmap1.device
    bf16 = fmap1.dtype == torch.bfloat16
    out = torch.empty(E, P, P, dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if bf16:
        fn = _build.load("masked_corr_tc").masked_corr_level0_tc
        args = (E, H, W, radius)
    else:
        fn = _build.load("masked_corr_tf32").masked_corr_level0_tf32
        args = (E, H, W, radius, *tf32_schedule(E, P)[1:])
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
    masked_corr_level0.launches_fp32 += int(not bf16)
    masked_corr_level0.edges += E
    return out


def masked_corr_level0(fmap1, fmap2, mean, cov, radius: int = 4,
                       out_dtype=torch.bfloat16):
    """Masked level-0 volume [E, P, P] in ``out_dtype`` (fp32 or bf16).

    fmap1/fmap2 are both float32 or both bfloat16; on CUDA they, mean and
    cov (float32) must be contiguous, and the operands have 128
    channels."""
    _check_operands(fmap1, fmap2)
    if fmap1.device.type == "cpu":
        return masked_corr_level0_plain(fmap1, fmap2, mean, cov, radius,
                                        out_dtype)
    if fmap1.device.type != "cuda":
        raise ValueError(f"masked_corr_level0: no kernel for device "
                         f"{fmap1.device}")
    return _launch(fmap1, fmap2, mean, cov, radius, out_dtype)


# counted by _launch: kernel launches (both kernels), those of the bf16-
# and of the fp32-operand kernel, and the edges over all launches
masked_corr_level0.launches = 0
masked_corr_level0.launches_bf16 = 0
masked_corr_level0.launches_fp32 = 0
masked_corr_level0.edges = 0
