#!/usr/bin/env python
"""What K2's time (the fused pyramid lookup) is made of, on one GPU: the
port's counterpart of the TPU probes ``_prof_kparts.py`` and
``_prof_sublane.py``.

    python scripts/profile_torch_k2_parts.py [--out DIR]

At the probe's shapes (E = 48 edges, 48 x 64 feature maps, bf16 levels,
coordinates on the pixel grid plus 1.5 N(0, 1), offsets uniform in +-3) it
times, as CUDA-event means after warm-up (each level alone also on the
device alone):

- K2 whole (``fused_pyramid_lookup``);
- K2's memory floor: every input byte streamed once (``k2_stream_floor``);
- each level alone (``k2_one_level``, K6's own kernel: since its redesign
  it no longer runs K2's per-level code), on the device alone: a CUDA
  graph of 50 launches cycling through copies of the level and the
  coordinates, so many that the launches between two on one copy touch
  (read their sectors, write their outputs) more than twice the 50 MB L2,
  each launch with its own output (``utils/measure.cold_graph_ms``), and
  by CUDA events over eager launches (``ms_eager``);
- K5, the per-lane row gather at [48, 3072, 24, 128] (``row_gather``).

Each time stands beside its bound: the bytes the kernel must move over
3.35 TB/s; for the lookups, the distinct in-bounds corners the taps read,
and for each level alone also the distinct 32-byte sectors that hold them
(``sector_bound_ms``); for the row gather, a byte bound (2 bytes per
gathered value) and a sector bound (every distinct 32-byte sector of V
that the run's indices touch).
It prints one JSON object and writes it to ``DIR/profile_torch_k2_parts.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import torch  # noqa: E402
from profile_torch_track import card_name  # noqa: E402

from lgu_slam_tpu_torch.geom.projective import coords_grid  # noqa: E402
from lgu_slam_tpu_torch.ops.k2_parts import (  # noqa: E402
    k2_one_level,
    k2_stream_floor,
    one_level_positions,
)
from lgu_slam_tpu_torch.ops.pyramid_lookup import (  # noqa: E402
    RD,
    fused_pyramid_lookup,
    level_dims,
)
from lgu_slam_tpu_torch.ops.row_gather import row_gather  # noqa: E402
from lgu_slam_tpu_torch.utils.measure import (  # noqa: E402
    bytes_ms,
    cold_graph_ms,
    cuda_ms,
    lookup_bytes,
    taps_plane_bytes,
)

E, H, W = 48, 48, 64  # the probe's K2 shapes (the tracking graph)
P1 = H * W
S, L = 24, 128  # K5's rows and lanes per (edge, pixel)
SECTOR = 32  # bytes


def probe_inputs(dev, seed: int = 0) -> dict:
    """K2's inputs at the probe's shapes and K5's (V, s), from a seeded
    generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    levels = [randn(E, P1, h * w).to(torch.bfloat16)
              for h, w in level_dims(H, W)]
    grid = coords_grid(H, W, device=dev).reshape(1, P1, 2)
    cflat = (grid + 1.5 * randn(E, P1, 2)).contiguous()
    off0, off1 = (torch.rand(E, P1, RD, RD, 2, generator=gen, device=dev)
                  * 6.0 - 3.0 for _ in range(2))
    V = randn(E, P1, S, L).to(torch.bfloat16)
    s = torch.randint(0, S, (E, P1, L), generator=gen, device=dev,
                      dtype=torch.int32)
    return dict(levels=levels, cflat=cflat, off0=off0, off1=off1, V=V, s=s)


def row_gather_sectors(s: torch.Tensor) -> int:
    """Distinct 32-byte sectors of V (bf16 rows of L lanes) that indices s
    [E, P, L] touch: per (e, p) and group of 16 lanes, one sector per
    distinct row."""
    groups = torch.sort(s.reshape(-1, SECTOR // 2), dim=-1).values
    return int(groups.shape[0]) + int((groups[:, 1:] != groups[:, :-1]).sum())


def profile(dev, inputs: dict, reps: int = 10, warmup: int = 2) -> dict:
    """Times and bounds of every probe on ``inputs`` (probe_inputs)."""
    lv, cflat = inputs["levels"], inputs["cflat"]
    off0, off1, V, s = (inputs[k] for k in ("off0", "off1", "V", "s"))
    out = {}

    def entry(name, fn, nbytes, **extra):
        out[name] = dict(ms=cuda_ms(fn, reps, warmup),
                         bound_ms=bytes_ms(nbytes), **extra)

    entry("k2_whole", lambda: fused_pyramid_lookup(lv, cflat, off0, off1, H,
                                                   W),
          lookup_bytes(lv, cflat, off0, off1, H, W))
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (*lv, cflat, off0, off1))
    entry("k2_stream_floor", lambda: k2_stream_floor(lv, cflat, off0, off1),
          in_bytes + E * P1 * 64 * 4, input_bytes=in_bytes)
    for lvl, (h, w) in enumerate(level_dims(H, W)):
        px, py = one_level_positions(cflat, lvl)
        io = cflat.numel() * 4 + E * P1 * 64 * 4
        touched = io + taps_plane_bytes(px, py, h, w, 2, sectors=True)
        out[f"k2_one_level_{lvl}"] = dict(
            ms=cold_graph_ms(lambda v, c, lvl=lvl: k2_one_level(v, c, lvl, H,
                                                                W),
                             (lv[lvl], cflat), touched),
            ms_eager=cuda_ms(lambda lvl=lvl: k2_one_level(lv[lvl], cflat,
                                                          lvl, H, W),
                             reps, warmup),
            bound_ms=bytes_ms(io + taps_plane_bytes(px, py, h, w, 2)),
            sector_bound_ms=bytes_ms(touched), plane=f"{h}x{w}")
        del px, py
    io = s.numel() * 4 + s.numel() * 4  # s read, out written
    sectors = row_gather_sectors(s)
    entry("row_gather", lambda: row_gather(V, s), io + s.numel() * 2,
          sector_bound_ms=bytes_ms(io + sectors * SECTOR),
          sectors_of_v=sectors / (V.numel() * 2 // SECTOR))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_k2_parts: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    report = profile(dev, probe_inputs(dev))
    report["card"] = card_name()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_k2_parts.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
