"""Kernel timing and bounds on the card, shared by ``chip_smoke.py`` and
``scripts/profile_torch_k2_parts.py``."""

from __future__ import annotations

import torch

from lgu_slam_tpu_torch.ops.pyramid_lookup import (
    RADIUS,
    RD,
    level_dims,
    tap_positions,
)
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # tensor cores
TF32_FLOP_PER_S = 494.7e12  # tensor cores
L2_BYTES = 50 * 2 ** 20


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events).
    Every input at the tracking shapes exceeds the 50 MB L2, so the reads
    are cold without a flush."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 50, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls replayed from one
    CUDA graph: no host time between the launches, so a launch shorter than
    its wrapper's host time is timed on the device alone.  ``fn`` may be a
    sequence of callables, called in turn (launches on copies of the
    inputs, :func:`cold_graph_ms`); their outputs are then held until the
    replay ends, so that every launch writes fresh memory.  A single
    callable's output is freed at once and its memory reused by the next
    launch."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    for _ in range(warmup):
        for f in fns:
            f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    held = []
    with torch.cuda.graph(graph):
        for i in range(reps):
            out = fns[i % len(fns)]()
            if len(fns) > 1:
                held.append(out)
            del out
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del held
    return start.elapsed_time(stop) / reps


def cold_copies(touched_bytes: int) -> int:
    """How many copies of its inputs a launch that touches
    ``touched_bytes`` (the bytes it reads and writes: for a gather, its
    sectors, not its whole inputs) cycles through, so that between two
    launches on one copy the launches on the other copies touch more than
    twice the L2 cache: each launch then reads its inputs from device
    memory."""
    return 1 + -(-2 * L2_BYTES // max(int(touched_bytes), 1))


def cold_graph_ms(fn, inputs, touched_bytes: int, reps: int = 50) -> float:
    """:func:`graph_ms` of ``fn(*inputs)`` cycling through
    :func:`cold_copies` copies of ``inputs`` (tensors), each launch
    with an output of its own."""
    copies = [tuple(inputs)] + [tuple(x.clone() for x in inputs)
                                for _ in range(cold_copies(touched_bytes)
                                               - 1)]
    return graph_ms([lambda c=c: fn(*c) for c in copies], reps)


def bytes_ms(nbytes: float) -> float:
    """The least time, in ms, to move ``nbytes`` through device memory."""
    return 1e3 * nbytes / HBM_BYTES_PER_S


def _corner_index(px, py, h, w):
    """Flat plane index of each in-bounds bilinear corner of the taps
    px/py [E, P1, K], -1 for the others: [E, P1, 4K]."""
    x1, y1 = torch.floor(px), torch.floor(py)
    live = (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
    idx = []
    for dy in (0, 1):
        for dx in (0, 1):
            ok = live & (x1 + dx < w) & (y1 + dy < h)
            flat = torch.where(ok, (y1 + dy) * w + x1 + dx, -1.0).long()
            idx.append(flat)
    return torch.cat(idx, -1)


def _distinct(idx) -> int:
    """Distinct non-negative entries along the last axis, summed."""
    idx = torch.sort(idx, dim=-1).values
    distinct = (idx[..., 1:] != idx[..., :-1]) & (idx[..., 1:] >= 0)
    return int(distinct.sum()) + int((idx[..., 0] >= 0).sum())


def distinct_corners(px, py, h, w) -> int:
    """The plane elements that the bilinear taps px/py [E, P1, K] read, each
    (edge, pixel) on its own plane [h, w]: in-bounds corners counted once."""
    return _distinct(_corner_index(px, py, h, w))


def distinct_sectors(px, py, h, w, elem_size: int) -> int:
    """The 32-byte sectors that the bilinear taps px/py [E, P1, K] read,
    each (edge, pixel) on its own plane [h, w] of the flat [E, P1, h*w]
    array with ``elem_size``-byte elements; a sector is counted once per
    plane (the planes of the tracking shapes span whole sectors)."""
    idx = _corner_index(px, py, h, w)
    E, P1 = px.shape[:2]
    base = torch.arange(E * P1, device=px.device).reshape(E, P1, 1) * (h * w)
    return _distinct(torch.where(idx >= 0, (base + idx) * elem_size // 32,
                                 -1))


def taps_plane_bytes(px, py, h, w, elem_size: int,
                     sectors: bool = False) -> int:
    """Plane bytes that the bilinear taps px/py [E, P1, K] must read from
    the flat [E, P1, h*w] level: the distinct in-bounds corners, or with
    ``sectors`` the distinct 32-byte sectors that hold them."""
    if sectors:
        return 32 * distinct_sectors(px, py, h, w, elem_size)
    return elem_size * distinct_corners(px, py, h, w)


def lookup_bytes(levels, cflat, off0, off1, H, W,
                 sectors: bool = False) -> int:
    """Bytes K2 must move for these inputs: the distinct in-bounds bilinear
    corners per (edge, pixel, level), probe included, or with ``sectors``
    the distinct 32-byte sectors that hold them (the DRAM's access
    granule), the coordinates and offsets read once and the output written
    once."""
    dims = level_dims(H, W)
    h1, w1 = dims[1]
    probe = tap_positions(cflat / 2.0, None, 1)
    gate = torch.sigmoid(torch.var(
        sample_taps_flat(levels[1], h1, w1, *probe), dim=-1))
    offs = (off0, off1 * gate[..., None, None, None], None, None)
    esize = levels[0].element_size()
    plane_bytes = 0
    for lvl, (h, w) in enumerate(dims):
        px, py = tap_positions(cflat / 2.0 ** lvl, offs[lvl], RADIUS)
        if lvl == 1:
            px = torch.cat([px, probe[0]], -1)
            py = torch.cat([py, probe[1]], -1)
        plane_bytes += taps_plane_bytes(px, py, h, w, esize, sectors)
    E, P1 = cflat.shape[:2]
    return (plane_bytes + cflat.numel() * 4 + off0.numel() * 4
            + off1.numel() * 4 + E * P1 * 4 * RD * RD * 4)
