"""Probes that decompose K2's time (kernel K6): its memory floor and each
pyramid level alone.

Replaces the Pallas probes of the JAX package's ``_prof_kparts.py``:

- ``dma_only`` -> :func:`k2_stream_floor` (``csrc/k2_stream.cu``).  On the
  TPU its BlockSpec DMA moved every byte of K2's inputs and the body summed
  64 lanes of one row; a GPU kernel reads only what it loads, so the port's
  kernel computes a function that needs every byte: per (edge, pixel) and
  k < 64, the sum over every input row (the four flat bf16 levels, the
  coordinates, both offset fields) of the elements whose index in their
  row is k modulo 64.
- ``one_level`` -> :func:`k2_one_level` (``k2_one_level`` in
  ``csrc/pyramid_lookup.cu``, a kernel of its own since the redesign: it no
  longer runs K2's per-level code): the bilinear taps of one level at
  ``cflat / 2^lvl + (k // 7 - 3, k % 7 - 3)`` for k < 49 and the centre tap
  for k = 49 .. 63, with K2's boundary rule; no offsets and no gate.

Both run in ``scripts/profile_torch_k2_parts.py``; no system path calls
them.  Each wrapper launches its kernel on a CUDA tensor and runs its plain
version on a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.pyramid_lookup import NUM_LEVELS, RD, level_dims
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat

FOLD = 64  # output lanes per pixel of both probes
ONE_LEVEL_TAPS = 64


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[E, P1, n] -> [E, P1, 64]: element j of a row summed into j mod 64."""
    E, P1, n = x.shape
    x = F.pad(x.float(), (0, (-n) % FOLD))
    return x.reshape(E, P1, -1, FOLD).sum(dim=2)


def k2_stream_floor_plain(levels, cflat, off0, off1) -> torch.Tensor:
    """levels: 4 flat levels [E, P1, h_l*w_l]; cflat [E, P1, 2];
    off0/off1 [E, P1, 7, 7, 2].  Returns [E, P1, 64] fp32."""
    E, P1 = cflat.shape[:2]
    rows = list(levels) + [cflat, off0.reshape(E, P1, -1),
                           off1.reshape(E, P1, -1)]
    return sum(_fold(r) for r in rows)


def _check(name, t, dev, dtype, shape):
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launch_stream(levels, cflat, off0, off1):
    E, P1 = cflat.shape[:2]
    dev = cflat.device
    if len(levels) != NUM_LEVELS:
        raise ValueError(f"k2_stream_floor: {NUM_LEVELS} levels, got "
                         f"{len(levels)}")
    for lvl, v in enumerate(levels):
        if v.dim() != 3:
            raise ValueError(f"k2_stream_floor: level {lvl} must be [E, P1, n]")
        _check(f"k2_stream_floor: level {lvl}", v, dev, torch.bfloat16,
               (E, P1, v.shape[2]))
    _check("k2_stream_floor: cflat", cflat, dev, torch.float32, (E, P1, 2))
    for name, t in (("off0", off0), ("off1", off1)):
        _check(f"k2_stream_floor: {name}", t, dev, torch.float32,
               (E, P1, RD, RD, 2))
    out = torch.empty(E, P1, FOLD, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("k2_stream")
    fn = lib.k2_stream_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(v.data_ptr() for v in levels),
                    *(v.shape[2] for v in levels), cflat.data_ptr(),
                    off0.data_ptr(), off1.data_ptr(), out.data_ptr(), E * P1,
                    RD * RD * 2, stream)
    _build.check(status, "k2_stream_floor")
    k2_stream_floor.launches += 1
    return out


def k2_stream_floor(levels, cflat, off0, off1) -> torch.Tensor:
    """K2's inputs (bf16 levels) -> [E, P1, 64] fp32 (module docstring)."""
    if cflat.device.type == "cpu":
        return k2_stream_floor_plain(levels, cflat, off0, off1)
    if cflat.device.type != "cuda":
        raise ValueError(f"k2_stream_floor: no kernel for device "
                         f"{cflat.device}")
    return _launch_stream(tuple(levels), cflat, off0, off1)


k2_stream_floor.launches = 0  # kernel launches, counted by _launch_stream


def one_level_positions(cflat: torch.Tensor, lvl: int):
    """The probe's tap positions (px, py) [E, P1, 64] on level ``lvl``."""
    k = torch.arange(ONE_LEVEL_TAPS, device=cflat.device)
    live = k < RD * RD
    dx = torch.where(live, k // RD - RD // 2, 0).float()
    dy = torch.where(live, k % RD - RD // 2, 0).float()
    base = cflat / 2.0 ** lvl
    return base[..., 0:1] + dx, base[..., 1:2] + dy


def k2_one_level_plain(level, cflat, lvl: int, H: int, W: int):
    """level [E, P1, h*w] (level ``lvl`` of an H x W pyramid); cflat
    [E, P1, 2] in level-0 pixels.  Returns [E, P1, 64] fp32."""
    h, w = level_dims(H, W)[lvl]
    return sample_taps_flat(level, h, w, *one_level_positions(cflat, lvl))


def _launch_one_level(level, cflat, lvl, H, W):
    E, P1 = cflat.shape[:2]
    dev = cflat.device
    h, w = level_dims(H, W)[lvl]
    if level.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"k2_one_level: level dtype {level.dtype} is "
                         "neither float32 nor bfloat16")
    _check("k2_one_level: level", level, dev, level.dtype, (E, P1, h * w))
    _check("k2_one_level: cflat", cflat, dev, torch.float32, (E, P1, 2))
    if cflat.data_ptr() % 8:
        raise ValueError("k2_one_level: cflat must start on 8 bytes (the "
                         "kernel reads (x, y) pairs)")
    out = torch.empty(E, P1, ONE_LEVEL_TAPS, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.load("pyramid_lookup").k2_one_level
    if fn.argtypes is None:  # set once: ctypes keeps the function object
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(level.data_ptr(), cflat.data_ptr(), out.data_ptr(),
                    E * P1, h, w, lvl, int(level.dtype == torch.bfloat16),
                    stream)
    _build.check(status, "k2_one_level")
    k2_one_level.launches += 1
    return out


def k2_one_level(level, cflat, lvl: int, H: int, W: int) -> torch.Tensor:
    """K2's taps on level ``lvl`` alone -> [E, P1, 64] fp32."""
    if not 0 <= lvl < NUM_LEVELS:
        raise ValueError(f"k2_one_level: level {lvl} outside 0..3")
    if cflat.device.type == "cpu":
        return k2_one_level_plain(level, cflat, lvl, H, W)
    if cflat.device.type != "cuda":
        raise ValueError(f"k2_one_level: no kernel for device {cflat.device}")
    return _launch_one_level(level, cflat, lvl, H, W)


k2_one_level.launches = 0  # kernel launches, counted by _launch_one_level
