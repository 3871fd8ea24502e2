"""The yardstick's peaks and kernel bounds (frozen copies of the port's
``utils/measure.py`` peaks and bound arithmetic, which later changes to the
port cannot move).

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit).  A bound is the least time the card could take for a launch: the
larger of its bytes over HBM's rate and its operations over the compute
peak of its type.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 494.7e12  # tensor cores
BF16_FLOP_PER_S = 989e12  # tensor cores

NUM_LEVELS = 4
RADIUS = 3
RD = 2 * RADIUS + 1


def peak_flops(compute: str) -> float:
    """The peak FLOP/s of a configuration's compute type: ``bfloat16``,
    ``tf32`` or ``float32`` (full fp32, TF32 off)."""
    return {"bfloat16": BF16_FLOP_PER_S, "tf32": TF32_FLOP_PER_S,
            "float32": FP32_FLOP_PER_S}[compute]


def k1_bound_ms(E: int, H: int, W: int, C: int, operand_bytes: int,
                out_bytes: int) -> float:
    """K1 (the masked level-0 volume, [E, P, P] from two [E, P, C]
    operands, P = H * W): its operands and mean/cov read once and the
    volume written once, against its products on the tensor cores (bf16
    operands: one bf16 product; fp32 operands: three TF32 products)."""
    P = H * W
    nbytes = 2 * E * P * C * operand_bytes + 2 * E * P * 2 * 4 \
        + E * P * P * out_bytes
    flop = 2 * E * P * P * C
    ops_s = (flop / BF16_FLOP_PER_S if operand_bytes == 2
             else 3 * flop / TF32_FLOP_PER_S)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_s)


def level_dims(H: int, W: int):
    dims = []
    for _ in range(NUM_LEVELS):
        dims.append((H, W))
        H, W = H // 2, W // 2
    return dims


def _window_deltas(radius: int, device):
    rd = 2 * radius + 1
    di = torch.arange(rd, dtype=torch.float32, device=device) - radius
    return di.repeat_interleave(rd), di.repeat(rd)


def _tap_positions(base, offset, radius: int):
    rd = 2 * radius + 1
    dx, dy = _window_deltas(radius, base.device)
    if offset is None:
        return base[..., 0:1] + dx, base[..., 1:2] + dy
    off = offset.reshape(offset.shape[:2] + (rd * rd, 2)).clone()
    off[:, :, radius * rd + radius] = 0.0
    off = off.clamp(-4.0, 4.0)
    return base[..., 0:1] + off[..., 0] + dx, base[..., 1:2] + off[..., 1] + dy


def _sample_flat(vol, h, w, px, py):
    """Bilinear taps of a flat level [E, P1, h*w] at px/py [E, P1, K] with
    the reference boundary rule (0 unless the floor corner is inside)."""
    x1, y1 = torch.floor(px), torch.floor(py)
    ok0 = (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
    xi = x1.clamp(-1, w).long()
    yi = y1.clamp(-1, h).long()

    def at(iy, ix):
        ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        idx = torch.where(ok, iy * w + ix, torch.zeros_like(ix))
        return torch.where(ok, torch.gather(vol, -1, idx).float(), 0.0)

    fx, fy = px - x1, py - y1
    out = (at(yi, xi) * (1 - fy) * (1 - fx) + at(yi, xi + 1) * (1 - fy) * fx
           + at(yi + 1, xi) * fy * (1 - fx) + at(yi + 1, xi + 1) * fy * fx)
    return torch.where(ok0, out, 0.0)


def _distinct_sectors(px, py, h, w, elem_size: int) -> int:
    """The distinct 32-byte sectors of the flat [E, P1, h*w] level that the
    bilinear taps px/py [E, P1, K] read (in-bounds corners only)."""
    x1, y1 = torch.floor(px), torch.floor(py)
    live = (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
    E, P1 = px.shape[:2]
    base = torch.arange(E * P1, device=px.device).reshape(E, P1, 1) * (h * w)
    idx = []
    for dy in (0, 1):
        for dx in (0, 1):
            ok = live & (x1 + dx < w) & (y1 + dy < h)
            flat = ((y1 + dy) * w + x1 + dx).long()
            idx.append(torch.where(ok, (base + flat) * elem_size // 32, -1))
    idx = torch.sort(torch.cat(idx, -1), dim=-1).values
    new = (idx[..., 1:] != idx[..., :-1]) & (idx[..., 1:] >= 0)
    return int(new.sum()) + int((idx[..., 0] >= 0).sum())


def k2_bound_ms(level1, cflat, off0, off1, H: int, W: int,
                elem_size: int) -> float:
    """K2 (the fused deformable lookup): the distinct 32-byte sectors its
    taps read on every level (the probe's included), the coordinates and
    offsets read once and the [E, P1, 196] fp32 output written once.
    ``level1`` is level 1 of the pyramid (the probe that gates level 1's
    offsets reads it); the other levels' values do not move the taps."""
    dims = level_dims(H, W)
    h1, w1 = dims[1]
    probe = _tap_positions(cflat / 2.0, None, 1)
    gate = torch.sigmoid(torch.var(_sample_flat(level1, h1, w1, *probe),
                                   dim=-1))
    offs = (off0, off1 * gate[..., None, None, None], None, None)
    sectors = 0
    for lvl, (h, w) in enumerate(dims):
        px, py = _tap_positions(cflat / 2.0 ** lvl, offs[lvl], RADIUS)
        if lvl == 1:
            px = torch.cat([px, probe[0]], -1)
            py = torch.cat([py, probe[1]], -1)
        sectors += _distinct_sectors(px, py, h, w, elem_size)
    E, P1 = cflat.shape[:2]
    nbytes = (32 * sectors + cflat.numel() * 4 + off0.numel() * 4
              + off1.numel() * 4 + E * P1 * NUM_LEVELS * RD * RD * 4)
    return 1e3 * nbytes / HBM_BYTES_PER_S
