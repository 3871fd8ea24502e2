"""Fused deformable lookup over the 4-level correlation pyramid (kernel K2,
``csrc/pyramid_lookup.cu``).

Replaces the Pallas kernel ``fused_pyramid_lookup`` of
the JAX package's ``ops/pallas_lookup.py`` (``models/corr.py`` ``corr_lookup``
semantics, including the per-lookup level-1 gate):

1. a radius-1 probe of level 1 at coords/2; ``gate = sigmoid(var)`` of its
   9 taps (unbiased variance);
2. 4 levels x 49 taps at coords/2^l + (i-3, j-3) (channel ``i*7+j``,
   i along x); level 0 adds ``off0``, level 1 adds ``off1 * gate``; the
   centre tap's offset is zeroed and offsets are clipped to +-4;
3. bilinear taps with the reference CUDA boundary rule
   (:func:`~lgu_slam_tpu_torch.ops.sampler.sample_taps_flat`).

:func:`fused_pyramid_lookup` launches the kernel on a CUDA tensor and runs
:func:`fused_pyramid_lookup_plain` on a CPU tensor; any other device raises.
The training forward calls the plain version itself, on every device, and
autograd differentiates it (``models/corr.py``): the kernel has no
backward, as in the JAX package.  The kernel runs one warp per (edge,
pixel) and is held to 32 registers so that every warp slot of an SM is
filled: its time follows the loads in flight (see the source).
"""

from __future__ import annotations

import ctypes

import torch

from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat, window_deltas

NUM_LEVELS = 4
RADIUS = 3
RD = 2 * RADIUS + 1
OUT_C = NUM_LEVELS * RD * RD  # 196


def level_dims(H: int, W: int):
    """(h_l, w_l) of the 4 levels: 2x2 pools that floor odd extents."""
    dims = []
    for _ in range(NUM_LEVELS):
        dims.append((H, W))
        H, W = H // 2, W // 2
    return dims


def tap_positions(base, offset, radius: int):
    """Tap positions (px, py) [E, P1, K] from base coords [E, P1, 2] and
    per-tap offsets [E, P1, rd, rd, 2] (None for a plain window), with the
    centre-tap offset zeroed and offsets clipped to +-4.  The zeroing is
    straight-through, as in the JAX package: the centre offset's value is 0
    and its gradient passes as if it were not zeroed."""
    rd = 2 * radius + 1
    dx, dy = window_deltas(radius, base.device)
    if offset is None:
        return base[..., 0:1] + dx, base[..., 1:2] + dy
    off = offset.reshape(offset.shape[:2] + (rd * rd, 2))
    centre = torch.arange(rd * rd, device=off.device) == radius * rd + radius
    off = torch.where(centre[:, None], off - off.detach(), off)
    off = torch.clamp(off, -4.0, 4.0)
    return base[..., 0:1] + off[..., 0] + dx, base[..., 1:2] + off[..., 1] + dy


def fused_pyramid_lookup_plain(levels, cflat, off0, off1, H: int, W: int):
    """Plain PyTorch version.  levels: 4 flat levels [E, P1, h_l*w_l];
    cflat [E, P1, 2]; off0/off1 [E, P1, 7, 7, 2].  Returns [E, P1, 196]."""
    dims = level_dims(H, W)
    h1, w1 = dims[1]
    ppx, ppy = tap_positions(cflat / 2.0, None, 1)
    probe = sample_taps_flat(levels[1], h1, w1, ppx, ppy)
    gate = torch.sigmoid(torch.var(probe, dim=-1))[..., None, None, None]
    offs = (off0, off1 * gate, None, None)
    out = []
    for lvl, (hh, ww) in enumerate(dims):
        base = cflat / (2.0 ** lvl)
        px, py = tap_positions(base, offs[lvl], RADIUS)
        out.append(sample_taps_flat(levels[lvl], hh, ww, px, py))
    return torch.cat(out, dim=-1)


def _launch(levels, cflat, off0, off1, H, W):
    E, P1 = cflat.shape[:2]
    dev = cflat.device
    if P1 != H * W:
        raise ValueError(f"fused_pyramid_lookup: P1={P1} != H*W={H * W}")
    vdt = levels[0].dtype
    if vdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_pyramid_lookup: level dtype {vdt} is "
                         "neither float32 nor bfloat16")
    for lvl, ((hh, ww), v) in enumerate(zip(level_dims(H, W), levels)):
        if (v.device != dev or v.dtype != vdt or not v.is_contiguous()
                or tuple(v.shape) != (E, P1, hh * ww)):
            raise ValueError(
                f"fused_pyramid_lookup: level {lvl} must be a contiguous "
                f"{vdt} {(E, P1, hh * ww)} on {dev}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}")
    for name, t, shape in (("cflat", cflat, (E, P1, 2)),
                           ("off0", off0, (E, P1, RD, RD, 2)),
                           ("off1", off1, (E, P1, RD, RD, 2))):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(
                f"fused_pyramid_lookup: {name} must be a contiguous float32 "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    out = torch.empty(E, P1, OUT_C, dtype=torch.float32, device=dev)
    if E * P1 == 0:
        return out
    # the kernel reads each offset pair as one 8-byte word: a view that
    # starts between two words is copied
    off0, off1 = (o if o.data_ptr() % 8 == 0 else o.clone()
                  for o in (off0, off1))
    lib = _build.load("pyramid_lookup")
    fn = lib.fused_pyramid_lookup
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(v.data_ptr() for v in levels), cflat.data_ptr(),
                    off0.data_ptr(), off1.data_ptr(), out.data_ptr(), E, H,
                    W, int(vdt == torch.bfloat16), stream)
    _build.check(status, "fused_pyramid_lookup")
    fused_pyramid_lookup.launches += 1
    by_e = fused_pyramid_lookup.launches_by_edges
    by_e[E] = by_e.get(E, 0) + 1
    return out


def fused_pyramid_lookup(levels, cflat, off0, off1, H: int, W: int):
    """Deformable pyramid lookup -> [E, P1, 196] fp32 (level-major)."""
    if cflat.device.type == "cpu":
        return fused_pyramid_lookup_plain(levels, cflat, off0, off1, H, W)
    if cflat.device.type != "cuda":
        raise ValueError(f"fused_pyramid_lookup: no kernel for device "
                         f"{cflat.device}")
    return _launch(tuple(levels), cflat, off0, off1, H, W)


# counted by _launch: kernel launches, and launches per edge count E
fused_pyramid_lookup.launches = 0
fused_pyramid_lookup.launches_by_edges = {}
