#!/usr/bin/env python
"""Write the committed AVIF fixtures of ``tests/data/avif/``: files written
by encoders independent of the port (``cv2.imwrite`` over libavif and
libaom, Pillow over its own libavif and libaom) and by the port's lossless
writer, for the tests and for machines that have neither Pillow nor OpenCV
(the card machine of ``chip_smoke.py``).

    python scripts/make_avif_fixtures_torch.py [--out tests/data/avif]

Lossless files, read bit for bit (a 48 x 64 crop of a rendered frame unless
named otherwise):

- ``cv2_speed{0..9}.avif``: ``cv2.imwrite`` at ``IMWRITE_AVIF_QUALITY`` 100
  and ``IMWRITE_AVIF_SPEED`` 0-9, 8-bit colour (identity matrix, 4:4:4);
- ``cv2_c10_37x53.avif``, ``cv2_c12.avif``: 10- and 12-bit colour, the
  first of odd size;
- ``cv2_g8_45x61.avif``, ``cv2_g10.avif``, ``cv2_g12_depth.avif``: 8-,
  10- and 12-bit gray (4:0:0), the last a depth map's top 12 bits;
- ``cv2_text_intrabc_s2.avif``, ``cv2_text_c_s4.avif``: flat, text-like
  images that push libaom into its screen-content tools: 128 x 192 gray
  rows of a repeated word at speed 2 (palettes and intra block copy),
  colour text at speed 4 (palettes);
- ``cv2_noise_s6.avif``: noise at speed 6; ``cv2_alpha.avif``: BGRA (an
  alpha item, decoded and dropped);
- ``pillow_g8.avif``, ``pillow_g8_tiles.avif``: Pillow's 4:0:0 full-range
  gray, the second in 2 x 2 tiles;
- ``port_c8.avif``, ``port_g12.avif``, ``port_c10_alpha.avif``: the port's
  writer (``avif.encode_avif``), each read back by ``cv2.imread`` equal
  to its input before it is kept;

lossy files, read bit for bit (4:2:0 under BT.601 unless named
otherwise):

- ``cv2_lossy.avif``: ``cv2.imwrite`` at quality 90;
- ``cv2_lossy_q95_480x640.avif``, ``cv2_lossy_q50_480x640.avif``,
  ``cv2_lossy_c10_q80_480x640.avif``: a whole rendered 480 x 640 frame at
  OpenCV's default quality (95), at 50, and 10-bit at 80, which
  ``chip_smoke.py`` phase 20 decodes and times;
- ``cv2_lr_q30_s2_480x640.avif``, ``cv2_lr_q60_s2_480x640.avif``: that
  frame as cv2 reads the first, written at speed 2 and qualities 30
  (self-guided luma, Wiener chroma) and 60 (switchable luma), whose loop
  restoration ``chip_smoke.py`` phase 21 decodes and times;
- ``cv2_lossy_lr_s0.avif``: ``cv2.imwrite`` at speed 0, a 48 x 64 frame
  with a self-guided unit;
- ``pillow_c444.avif``: Pillow's lossless 4:4:4 colour under BT.601;
  ``pillow_c422.avif``: its lossy 4:2:2; ``pillow_limited.avif``: its
  lossy 4:2:0 at limited range; ``port_c420_bt709.avif``: the port's
  writer's lossless 4:2:0 under BT.709;

film grain, grids, sequences and scaled frames, read bit for bit (the
files of ``chip_smoke.py`` phase 22):

- ``pillow_grain_v1_420.avif``, ``pillow_grain_v10_444.avif``,
  ``pillow_grain_v16_400.avif``: Pillow's lossy files with libaom's film
  grain test vectors 1, 10 and 16 (4:2:0, 4:4:4 and 4:0:0 gray);
- ``port_grain_c10.avif``: the port's writer's lossy 10-bit 4:2:0 frame
  with test vector 4; ``port_grain_g12.avif``: its 12-bit gray (the
  depth's top 12 bits) with vector 6 at lag 1;
- ``port_grid_1x2.avif``: a 1 x 2 grid of the writer's 64 x 64 lossless
  tiles; ``port_grid_2x2_alpha.avif``: a 2 x 2 grid of lossy 4:2:0 tiles
  cropped to 120 x 100, with a 2 x 2 alpha grid;
- ``pillow_avis.avif``: Pillow's two-frame image sequence (its first
  frame);
- ``port_scaled_down.avif``: a 96 x 128 frame under an ``ispe`` of 60 x
  80, ``port_scaled_up_g12.avif``: a 12-bit gray 48 x 64 frame under 100
  x 80 (libavif scales both with libyuv);

intra block copy, segmentation, superres and items of several frames,
read bit for bit (the files of ``chip_smoke.py`` phase 23):

- ``pillow_screen_c420_s2.avif``, ``pillow_screen_c422_s2.avif``:
  Pillow's lossless screen content (speed 2) of a 192 x 256 text page at
  4:2:0 and 4:2:2, whose intra block copy predicts chroma at half
  samples (C7); ``pillow_screen_c444_q90.avif``: its lossy 4:4:4;
- ``cv2_page_q95_s2.avif``, ``cv2_page_c_q80_s2.avif``,
  ``cv2_page_c10_q95_s2.avif``: ``cv2.imwrite``'s lossy intra block copy
  of that page, gray at 95, colour at 80 and 10-bit colour at 95;
  ``port_intrabc_c422_12.avif``: the writer's lossy 12-bit 4:2:2 intra
  block copy;
- ``port_seg_lossless.avif``, ``port_seg_skip_g12.avif``: the writer's
  segmentation (a lossless segment and loop filter levels; skip in
  12-bit gray);
- ``port_superres_lr_tiles.avif``, ``port_superres_narrow.avif``: its
  superres with restoration in two tile columns, and of a frame 14
  samples wide (coded at its width);
- ``port_frames_existing.avif`` (a hidden key frame, an intra-only frame,
  show_existing_frame of the first), ``port_frames_sizes.avif`` (a key
  frame and a smaller intra-only frame shown last), and
  ``port_two_frames.avif`` (two AV1 frames in the item; OpenCV shows the
  second);

layered (progressive) items, written through cv2's own libavif 1.4.2
with ctypes (:func:`encode_layered`: ``extraLayerCount``, a quality and a
scaling fraction per layer; avifenc's ``--progressive``), read bit for
bit: AV1 inter frames, one reference each (the files of ``chip_smoke.py``
phase 24; 96 x 128 frames of the rendered TUM scene, two poses taking
turns as the layers):

- ``layered_l2_s6_c444.avif``: 2 layers at qualities 30 and 80, 4:4:4,
  speed 6 (local warp); ``layered_l2_s6_alpha.avif``: the same at 4:2:0
  with an alpha item of 2 layers;
- ``layered_l2_s0_half_c420.avif``: a base layer at half scale, then the
  full frame, 4:2:0, speed 0 (OBMC, inter-intra, scaled prediction);
- ``layered_l3_s2_c10.avif``: 3 quality layers, 10-bit 4:2:0, speed 2;
- ``layered_l3_s0_quarter.avif``: layers at a quarter, half and full
  scale, 4:2:0, speed 0 (a wedge inter-intra block);
- ``layered_l4_s0_c444.avif``, ``layered_l4_s0_g8.avif``: 4 quality
  layers at speed 0, 4:4:4 and gray (OBMC, local warp over 4-sample
  neighbours, inter-intra);
- ``layered_l4_s9_c12_quarter.avif``: 4 layers, 12-bit 4:4:4, speed 9,
  the first two at a quarter and half scale;
- ``layered_l3_s0_sub8x8_c420.avif``, ``layered_l3_s0_sub8x8_c422.avif``:
  3 quality layers of :func:`scene` (seed 25; the middle one moved by 2
  rows and 3 columns), speed 0, 4:2:0 and 4:2:2: chroma blocks over
  several 4-sample-wide or -high inter blocks, predicted from each one's
  vector;
- ``layered_lsel0_half.avif``: the half-scale item rebuilt with ``lsel``
  0 (libavif outputs the base layer, scaled to ispe);
  ``layered_a1op1_lsel1.avif``: the quarter-scale item under ``a1op`` 1
  with ``lsel`` 1;
- ``layered_tum0_480x640.avif`` ... ``layered_tum7_480x640.avif``: the
  eight rendered 480 x 640 frames of TUM seed 24 (:data:`LAYERED_TUM_SEED`),
  each a half-scale base layer at quality 30 and the full frame at 60,
  speed 6, which ``chip_smoke.py`` phase 24 times and tracks;

refused as ``cv2.imread`` refuses them (None: null hashes):
``layered_lsel3_absent.avif`` (``lsel`` names a layer the item lacks),
``layered_damaged.avif`` (bytes of the last layer's tile data changed),
``port_damaged.avif`` (three bytes of the tile data flipped),
``port_cut.avif`` (cut inside its tile).  A file read by OpenCV but
queued for a later reader would carry a ``queued`` key (the feature
``NotImplementedError`` names); none is left.

Beside them ``hashes.json``: the SHA-256 of ``cv2.imread``'s array in both
read modes (colour, ``IMREAD_ANYDEPTH``), its shape and dtype, which
``tests/test_torch_avif.py`` and ``chip_smoke.py`` phase 19 hold the port's
decoder to.  Needs OpenCV and Pillow.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lgu_slam_tpu_torch.data import avif  # noqa: E402
from lgu_slam_tpu_torch.data.avif import (  # noqa: E402
    ALPHA_URNS,
    _av1c,
    _box,
    _chroma,
    _full,
    default_colour,
    encode_av1,
    yuv_planes,
)
from lgu_slam_tpu_torch.data.fixtures import (  # noqa: E402
    TUM_FR1,
    render_sequence,
)

OUT = os.path.join(REPO, "tests", "data", "avif")
LIMIT = 128 * 1024
TOTAL = 900 * 1024
LOSSY_480X640 = 256 * 1024  # the 480 x 640 frames together
LAYERED_480X640 = 240 * 1024  # the layered 480 x 640 sequence together


def array_hash(a) -> dict:
    """The SHA-256, shape and dtype of an array; None for None."""
    if a is None:
        return None
    return dict(sha256=hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                      ).hexdigest(),
                shape=list(a.shape), dtype=str(a.dtype))


def text_image(rng, H: int, W: int, channels: int) -> np.ndarray:
    import cv2

    img = np.full((H, W, 3), 235, np.uint8)
    for k in range(10):
        color = tuple(int(v) for v in rng.integers(0, 200, 3))
        cv2.putText(img, f"LGU {k}", (int(rng.integers(0, W - 30)),
                                      int(rng.integers(12, H))),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
    return img if channels == 3 else img[..., 1].copy()


def repeated_text(H: int, W: int, step: int) -> np.ndarray:
    """Gray rows of one word repeated: libaom copies its glyphs with intra
    block copy."""
    import cv2

    img = np.full((H, W), 235, np.uint8)
    for y in range(14, H, step):
        for x in range(0, W - 40, 48):
            cv2.putText(img, "LGU", (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        20, 1)
    return img


def cv2_file(img, quality=100, speed=None, depth=None) -> bytes:
    import cv2

    params = [cv2.IMWRITE_AVIF_QUALITY, quality]
    if speed is not None:
        params += [cv2.IMWRITE_AVIF_SPEED, speed]
    if depth is not None:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.avif")
        assert cv2.imwrite(path, img, params)
        return open(path, "rb").read()


def pillow_file(img, frames=None, **kw) -> bytes:
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.avif")
        first = Image.fromarray(img)
        if frames:
            first.save(path, save_all=True, append_images=[
                Image.fromarray(f) for f in frames], **kw)
        else:
            first.save(path, **kw)
        return open(path, "rb").read()


def files() -> dict:
    """``{name: (bytes, queued feature or None)}``."""
    import cv2

    rng = np.random.default_rng(19)
    images, depths = render_sequence(19, 1, 96, 128, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0][24:72, 32:96].copy()
    d16 = np.clip(np.rint(depths[0] * 5000.0), 0, 65535).astype(np.uint16)
    top = np.minimum(d16 >> 4, 4095)[24:72, 32:96].astype(np.uint16)
    out = {}
    for speed in range(10):
        out[f"cv2_speed{speed}.avif"] = (cv2_file(img, speed=speed), None)
    c10 = (img[:37, :53].astype(np.uint16) << 2) | (img[:37, :53] >> 6)
    out["cv2_c10_37x53.avif"] = (cv2_file(c10, depth=10, speed=5), None)
    out["cv2_c12.avif"] = (cv2_file(img.astype(np.uint16) * 16 + 7,
                                    depth=12, speed=7), None)
    out["cv2_g8_45x61.avif"] = (cv2_file(img[:45, :61, 1].copy(), speed=6),
                                None)
    out["cv2_g10.avif"] = (cv2_file(img[..., 2].astype(np.uint16) * 4 + 1,
                                    depth=10, speed=8), None)
    out["cv2_g12_depth.avif"] = (cv2_file(top, depth=12, speed=9), None)
    out["cv2_text_intrabc_s2.avif"] = (cv2_file(repeated_text(128, 192, 20),
                                                speed=2), None)
    out["cv2_text_c_s4.avif"] = (cv2_file(text_image(rng, 64, 96, 3),
                                          speed=4), None)
    out["cv2_noise_s6.avif"] = (cv2_file(rng.integers(
        0, 256, (33, 47, 3), np.uint8), speed=6), None)
    bgra = np.concatenate([img, img[..., :1] // 2 + 64], -1)
    out["cv2_alpha.avif"] = (cv2_file(bgra, speed=6), None)
    gray = img[..., 1].copy()
    out["pillow_g8.avif"] = (pillow_file(gray, quality=100,
                                         subsampling="4:0:0"), None)
    big = np.repeat(np.repeat(images[0][..., 1], 2, 0), 2, 1)[:160, :256]
    out["pillow_g8_tiles.avif"] = (pillow_file(
        np.ascontiguousarray(big), quality=100, subsampling="4:0:0",
        tile_rows=1, tile_cols=1), None)
    out["port_c8.avif"] = (avif.encode_avif(img, 8, 1), None)
    out["port_g12.avif"] = (avif.encode_avif(top, 12, 2), None)
    out["port_c10_alpha.avif"] = (avif.encode_avif(
        c10, 10, 3, alpha=c10[..., 0]), None)
    damaged = bytearray(out["port_c8.avif"][0])
    for k in (60, 340, 1111):
        damaged[-k] ^= 0x24
    out["port_damaged.avif"] = (bytes(damaged), None)
    out["port_cut.avif"] = (out["port_c8.avif"][0][:-700], None)
    out["cv2_lossy.avif"] = (cv2_file(img, quality=90), None)
    out["pillow_c444.avif"] = (pillow_file(img[..., ::-1].copy(), quality=100,
                                           subsampling="4:4:4"), None)
    frame = frame_480x640()
    out["cv2_lossy_q95_480x640.avif"] = (cv2_file(frame, quality=95), None)
    out["cv2_lossy_q50_480x640.avif"] = (cv2_file(frame, quality=50), None)
    out["cv2_lossy_c10_q80_480x640.avif"] = (cv2_file(
        frame.astype(np.uint16) << 2, quality=80, depth=10), None)
    q95 = cv2_read(out["cv2_lossy_q95_480x640.avif"][0])
    for quality in (30, 60):
        out[f"cv2_lr_q{quality}_s2_480x640.avif"] = (cv2_file(
            q95, quality=quality, speed=2), None)
    out["cv2_lossy_lr_s0.avif"] = (cv2_file(scene(np.random.default_rng(50),
                                                  48, 64), quality=50,
                                            speed=0), None)
    out["pillow_c422.avif"] = (pillow_file(img[..., ::-1].copy(), quality=60,
                                           subsampling="4:2:2"), None)
    out["pillow_limited.avif"] = (pillow_file(img[..., ::-1].copy(),
                                              quality=60, range="limited"),
                                  None)
    out["port_c420_bt709.avif"] = (avif.encode_avif(
        img, 8, 4, subsampling="4:2:0", colour=(1, 1, 1, 1)), None)
    out["pillow_avis.avif"] = (pillow_file(img[..., ::-1].copy(), frames=[
        255 - img[..., ::-1]], quality=100, subsampling="4:4:4"), None)
    out.update(files_22(img, top))
    out.update(files_23(img))
    out.update(files_24())
    return out


def with_ispe(data: bytes, W: int, H: int, size: tuple) -> bytes:
    """A writer file whose ispe (W x H) names ``size`` (W, H) instead."""
    ispe = b"ispe" + bytes(4) + struct.pack(">II", W, H)
    assert data.count(ispe) == 1
    return data.replace(ispe, b"ispe" + bytes(4) + struct.pack(">II", *size))


def heif(items, stored=None) -> bytes:
    """An AVIF (HEIF) file of ``items``, the first the primary, in order
    (their data stored in the order of the indices ``stored``, by default
    theirs): dicts of ``id``, ``type`` (``b"av01"``, ``b"grid"``),
    ``data`` (bytes), ``props`` (a list of (property box, essential)),
    ``refs`` (a list of (kind, [to IDs])) and ``idat`` (the data in
    ``idat``, else in ``mdat``); ``ipco`` holds each distinct property
    once.  :func:`avif.encode_avif` writes its own still images."""
    full, box = _full, _box
    props, assoc = [], []
    for it in items:
        lst = []
        for b, essential in it.get("props", ()):
            if b not in props:
                props.append(b)
            lst.append((props.index(b) + 1) | (0x80 if essential else 0))
        assoc.append((it["id"], lst))
    ipma = struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", i, len(lst)) + bytes(lst) for i, lst in assoc)
    refs = b"".join(box(kind, struct.pack(">HH", it["id"], len(to)) +
                        b"".join(struct.pack(">H", k) for k in to))
                    for it in items for kind, to in it.get("refs", ()))
    infe = b"".join(full(b"infe", 2, 0, struct.pack(">HH", it["id"], 0)
                         + it["type"] + b"\0") for it in items)
    idat = b"".join(items[k]["data"] for k in (
        range(len(items)) if stored is None else stored)
        if items[k].get("idat"))

    def meta(offsets):
        iloc = struct.pack(">HH", 0x4400, len(items)) + b"".join(
            struct.pack(">HHHHII", it["id"], 1 if it.get("idat") else 0, 0,
                        1, off, len(it["data"]))
            for it, off in zip(items, offsets))
        return full(b"meta", 0, 0, full(b"hdlr", 0, 0, bytes(4) + b"pict"
                                        + bytes(13))
                    + full(b"pitm", 0, 0, struct.pack(">H", items[0]["id"]))
                    + full(b"iloc", 1, 0, iloc)
                    + full(b"iinf", 0, 0, struct.pack(">H", len(items))
                           + infe)
                    + (full(b"iref", 0, 0, refs) if refs else b"")
                    + (box(b"idat", idat) if idat else b"")
                    + box(b"iprp", box(b"ipco", b"".join(props))
                          + full(b"ipma", 0, 0, ipma)))

    ftyp = box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")
    start = len(ftyp) + len(meta([0] * len(items))) + 8
    offsets, pos, ipos = [0] * len(items), start, 0
    order = list(range(len(items))) if stored is None else list(stored)
    for k in order:
        it = items[k]
        if it.get("idat"):
            offsets[k] = ipos
            ipos += len(it["data"])
        else:
            offsets[k] = pos
            pos += len(it["data"])
    return ftyp + meta(offsets) + box(b"mdat", b"".join(
        items[k]["data"] for k in order if not items[k].get("idat")))


def grid_box(rows: int, cols: int, W: int, H: int, wide: bool = False
             ) -> bytes:
    """An ImageGrid (version 0; 32-bit sizes with ``wide`` or where a side
    needs them)."""
    wide = wide or W > 0xFFFF or H > 0xFFFF
    return struct.pack(">BBBB", 0, int(wide), rows - 1, cols - 1) + \
        struct.pack(">II" if wide else ">HH", W, H)


def encode_grid(tiles, cols: int, size=None, depth: int = 8,
                alpha_tiles=None, seed: int = 0, idat: bool = True,
                wide: bool = False, tile_size=None, nclx: bool = True,
                stored=None, **kw) -> bytes:
    """An AVIF grid image (item 1) of the writer's ``tiles`` (arrays of one
    shape, :func:`avif.encode_avif`'s images, in raster order over ``cols``
    columns), output ``size`` (W, H: by default the tiles' span),
    ``alpha_tiles`` (an alpha grid over them), its ImageGrid in ``idat``
    (else in ``mdat``), with 32-bit sizes (``wide``); ``tile_size`` (W, H):
    the tiles' ``ispe``, where it is not their frames' (libavif scales
    each); ``nclx``: the grid's colr (else none); ``stored``: the order
    of the items' data (:func:`heif`); ``kw``: :func:`avif.encode_av1`'s
    ``subsampled``, ``lossy``, ``colour``, ``grain``."""
    H, W = np.asarray(tiles[0]).shape[:2]
    W, H = tile_size or (W, H)
    rows = len(tiles) // cols
    size = size or (W * cols, H * rows)
    mono = np.asarray(tiles[0]).ndim == 2
    sub = 0 if mono else _chroma(kw.get("subsampled"))
    colour = kw.pop("colour", None) or default_colour(1 if mono else 3, sub)
    ispe = _full(b"ispe", 0, 0, struct.pack(">II", W, H))
    av1c = _av1c(depth, mono, sub)
    colr = _box(b"colr", b"nclx" + struct.pack(">HHHB", *colour[:3],
                                               0x80 * bool(colour[3])))
    items = [dict(id=1, type=b"grid", data=grid_box(rows, cols, *size, wide),
                  idat=idat, props=[(_full(b"ispe", 0, 0, struct.pack(
                      ">II", *size)), False)] + ([(colr, False)] if nclx
                                                 else []),
                  refs=[(b"dimg", list(range(2, 2 + len(tiles))))])]
    for k, t in enumerate(tiles):
        t = np.asarray(t)
        planes = [t] if mono else yuv_planes(t, depth, sub, colour[2],
                                             colour[3]) if sub else \
            [t[..., 1], t[..., 0], t[..., 2]]
        items.append(dict(id=2 + k, type=b"av01", data=encode_av1(
            planes, depth, seed + k, colour=colour, **kw),
            props=[(ispe, False), (av1c, True)]))
    if alpha_tiles is not None:
        n = len(items) + 1
        aux = _full(b"auxC", 0, 0, ALPHA_URNS[0] + b"\0")
        items.append(dict(id=n, type=b"grid", data=grid_box(
            rows, cols, *size, wide), idat=idat, props=[(_full(
                b"ispe", 0, 0, struct.pack(">II", *size)), False),
                (aux, False)], refs=[(b"auxl", [1]), (b"dimg", list(range(
                    n + 1, n + 1 + len(alpha_tiles))))]))
        for k, a in enumerate(alpha_tiles):
            items.append(dict(id=n + 1 + k, type=b"av01", data=encode_av1(
                np.asarray(a)[None], depth, seed + k), props=[
                (ispe, False), (_av1c(depth, True), True), (aux, False)]))
    return heif(items, stored=stored)


def _sample_entry(W: int, H: int, props: bytes) -> bytes:
    """An ``av01`` VisualSampleEntry of a W x H track and its property
    boxes."""
    return _box(b"av01", bytes(6) + struct.pack(">H", 1) + bytes(16)
                + struct.pack(">HHIIIH", W, H, 0x480000, 0x480000, 0, 1)
                + bytes(32) + struct.pack(">Hh", 0x18, -1) + props)


def _trak(tid: int, W: int, H: int, entry: bytes, sizes: list,
          offsets: list, per_chunk: int, co64: bool, tref: bytes) -> bytes:
    """A video ``trak``: its samples ``sizes``, ``per_chunk`` to a chunk at
    ``offsets`` (``co64``: 64-bit offsets)."""
    full, box = _full, _box
    n = len(sizes)
    tkhd = full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, tid, 0, n)
                + bytes(16) + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000,
                                          0, 0, 0, 0x40000000)
                + struct.pack(">II", W << 16, H << 16))
    mdhd = full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, 1000, n, 0x55C4,
                                           0))
    hdlr = full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    dinf = box(b"dinf", full(b"dref", 0, 0, struct.pack(">I", 1)
                             + full(b"url ", 0, 1, b"")))
    chunks = len(offsets)
    stbl = box(b"stbl", full(b"stsd", 0, 0, struct.pack(">I", 1) + entry)
               + full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
               + full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, per_chunk,
                                                 1))
               + full(b"stsz", 0, 0, struct.pack(">II", 0, n) + b"".join(
                   struct.pack(">I", k) for k in sizes))
               + full(b"co64" if co64 else b"stco", 0, 0, struct.pack(
                   ">I", chunks) + b"".join(struct.pack(
                       ">Q" if co64 else ">I", o) for o in offsets)))
    minf = box(b"minf", full(b"vmhd", 0, 1, bytes(8)) + dinf + stbl)
    return box(b"trak", tkhd + tref + box(b"mdia", mdhd + hdlr + minf))


def encode_avis(frames, depth: int = 8, alpha=None, size=None,
                per_chunk: int = 1, co64: bool = False, seed: int = 0,
                **kw) -> bytes:
    """An AVIF image sequence (major brand ``avis``, no ``meta``) of the
    writer's frames (:func:`avif.encode_avif`'s images, one AV1 still each;
    ``kw``: :func:`avif.encode_av1`'s ``subsampled``, ``lossy``, ``colour``,
    ``grain``), ``per_chunk`` samples to a chunk (``co64``: 64-bit chunk
    offsets), an alpha track of ``alpha`` (images like the frames) whose
    sample entry's ``auxi`` names alpha, the tracks' ``tkhd`` size
    ``size`` (W, H; the frames' by default)."""
    frames = [np.asarray(f) for f in frames]
    H, W = frames[0].shape[:2]
    mono = frames[0].ndim == 2
    sub = 0 if mono else _chroma(kw.get("subsampled"))
    colour = kw.pop("colour", None) or default_colour(1 if mono else 3, sub)
    tW, tH = size or (W, H)
    colr = _box(b"colr", b"nclx" + struct.pack(">HHHB", *colour[:3],
                                               0x80 * bool(colour[3])))
    tracks = [([encode_av1([f] if mono else yuv_planes(
        f, depth, sub, colour[2], colour[3]) if sub else
        [f[..., 1], f[..., 0], f[..., 2]], depth, seed + k, colour=colour,
        **kw) for k, f in enumerate(frames)], _sample_entry(
            tW, tH, _av1c(depth, mono, sub) + colr), b"")]
    if alpha is not None:
        aux = _full(b"auxi", 0, 0, ALPHA_URNS[0] + b"\0")
        tracks.append(([encode_av1(np.asarray(a)[None], depth, seed + k)
                        for k, a in enumerate(alpha)], _sample_entry(
            tW, tH, _av1c(depth, True) + aux), _box(b"tref", _box(
                b"auxl", struct.pack(">I", 1)))))
    ftyp = _box(b"ftyp", b"avis" + bytes(4) + b"avismsf1miafMA1B")

    def moov(base):
        pos, traks = base, []
        for tid, (samples, entry, tref) in enumerate(tracks, 1):
            offsets = []
            for k, smp in enumerate(samples):
                if k % per_chunk == 0:
                    offsets.append(pos)
                pos += len(smp)
            traks.append(_trak(tid, tW, tH, entry, [len(x) for x in samples],
                               offsets, per_chunk, co64, tref))
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                                len(frames))
                     + struct.pack(">IH", 0x10000, 0x100) + bytes(10)
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                   0x40000000) + bytes(24)
                     + struct.pack(">I", len(tracks) + 1))
        return _box(b"moov", mvhd + b"".join(traks))

    base = len(ftyp) + len(moov(0)) + 8
    mdat = b"".join(x for samples, _, _ in tracks for x in samples)
    return ftyp + moov(base) + _box(b"mdat", mdat)


def two_frames(img: np.ndarray) -> bytes:
    """A writer file whose colour item holds two AV1 frames (the second of
    the negative image)."""
    first = avif.encode_av1(np.stack([img[..., 1], img[..., 0],
                                      img[..., 2]]), 8, 0)
    second = avif.encode_av1(np.stack([255 - img[..., 1], img[..., 0],
                                       img[..., 2]]), 8, 1)
    return heif([dict(id=1, type=b"av01", data=first + second, props=[
        (avif._full(b"ispe", 0, 0, struct.pack(">II", img.shape[1],
                                                img.shape[0])), False),
        (avif._av1c(8, False), True)])])


def files_22(img: np.ndarray, top: np.ndarray) -> dict:
    """Slice 22's files: film grain, grids, a sequence, scaled frames."""
    rgb = img[..., ::-1].copy()
    out = {}
    for v, sub in ((1, "4:2:0"), (10, "4:4:4"), (16, "4:0:0")):
        src = img[..., 1].copy() if sub == "4:0:0" else rgb
        out[f"pillow_grain_v{v}_{sub.replace(':', '')}.avif"] = (
            pillow_file(src, quality=60, subsampling=sub, advanced=[
                ("film-grain-test", str(v))]), None)
    c10 = img.astype(np.uint16) << 2
    out["port_grain_c10.avif"] = (avif.encode_avif(
        c10, 10, 5, lossy=dict(base_q=60, lf=(8, 8, 4, 4)), grain=4), None)
    out["port_grain_g12.avif"] = (avif.encode_avif(
        top, 12, 6, grain=dict(vector=6, ar_coeff_lag=1)), None)
    big = scene(np.random.default_rng(22), 128, 128)
    out["port_grid_1x2.avif"] = (encode_grid(
        [big[:64, :64], big[:64, 64:]], 2), None)
    tiles = [big[:64, :64], big[:64, 64:], big[64:, :64], big[64:, 64:]]
    out["port_grid_2x2_alpha.avif"] = (encode_grid(
        tiles, 2, size=(120, 100), subsampled="4:2:0", lossy=dict(
            base_q=80, lf=(8, 8, 4, 4)), alpha_tiles=[
            t[..., 0] for t in tiles]), None)
    frame = scene(np.random.default_rng(23), 96, 128)
    out["port_scaled_down.avif"] = (with_ispe(avif.encode_avif(
        frame, 8, 7, lossy=dict(base_q=40)), 128, 96, (80, 60)), None)
    out["port_scaled_up_g12.avif"] = (with_ispe(avif.encode_avif(
        top, 12, 8), 64, 48, (100, 80)), None)
    out["port_two_frames.avif"] = (two_frames(img[:24, :32]), None)
    return out


def text_page(H: int, W: int, seed: int) -> np.ndarray:
    """Gray lines of words of a few kinds at two sizes, jittered: libaom
    copies most of its blocks with intra block copy and codes a residual,
    splitting their transforms and using the inter transform types."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.full((H, W), 235, np.uint8)
    words = ["LGU", "SLAM", "TPU", "AV1", "copy"]
    for y in range(16, H, 18):
        x = int(rng.integers(0, 6))
        while x < W - 50:
            word = words[int(rng.integers(0, len(words)))]
            cv2.putText(img, word, (x, y), cv2.FONT_HERSHEY_SIMPLEX,
                        0.45 + 0.05 * int(rng.integers(0, 2)),
                        int(rng.integers(0, 60)), 1)
            x += 44 + int(rng.integers(0, 12))
    return img


def two_colour(gray: np.ndarray) -> np.ndarray:
    """A gray text image as BGR dark blue ink on a light ground."""
    a = (235 - gray.astype(np.float64)) / 235.0
    ink, ground = np.array([160, 40, 20]), np.array([230, 240, 235])
    return np.clip(np.rint(ground * (1 - a[..., None]) + ink * a[..., None]),
                   0, 255).astype(np.uint8)


def av1_frame(planes, depth: int = 8, seed: int = 0, sequence=False,
              **kw) -> bytes:
    """The writer's frame OBU (``avif.encode_av1``'s keywords; ``frame``
    for full headers), with its sequence header OBU first where
    ``sequence``."""
    return b"".join(o for t, o in avif.split_obus(avif.encode_av1(
        planes, depth, seed, **kw)) if sequence or t != 1)


def av1_item(data: bytes, W: int, H: int, depth: int = 8,
             mono: bool = False, sub: int = 0) -> bytes:
    """An AVIF file of one colour item of AV1 data ``data`` under an ispe
    of W x H."""
    return heif([dict(id=1, type=b"av01", data=data, props=[
        (avif._full(b"ispe", 0, 0, struct.pack(">II", W, H)), False),
        (avif._av1c(depth, mono, sub), True)])])


def gbr(img: np.ndarray) -> np.ndarray:
    """The writer's identity planes (G, B, R) of BGR."""
    return np.stack([img[..., 1], img[..., 0], img[..., 2]])


def frames_items(img: np.ndarray, img2: np.ndarray) -> dict:
    """Items of several intra frames (full headers): a hidden key frame, a
    shown intra-only frame and show_existing_frame of the key frame; a key
    frame and a smaller intra-only frame (frame_size_override) shown
    last."""
    key = dict(type="key", show=False, showable=True, refresh=1)
    a = av1_frame(gbr(img), sequence=True, frame=key)
    b = av1_frame(gbr(img2), 8, 1, frame=dict(type="intra", refresh=2))
    H, W = img.shape[:2]
    big = np.concatenate([img, img2], 1)
    c = av1_frame(gbr(big), sequence=True, frame=dict(
        type="key", max_size=(2 * W, H)))
    d = av1_frame(gbr(img2), 8, 2, frame=dict(type="intra", refresh=2,
                                                max_size=(2 * W, H)))
    return {"port_frames_existing.avif": (av1_item(
                a + b + avif.show_existing_obu(0), W, H), None),
            "port_frames_sizes.avif": (av1_item(c + d, 2 * W, H), None)}


def files_23(img: np.ndarray) -> dict:
    """Slice 23's files: lossless intra block copy at 4:2:0 and 4:2:2
    (Pillow's screen content, speed 2), lossy intra block copy (cv2's
    text pages, gray and colour, 8 and 10 bits; Pillow's 4:4:4 screen
    content; the writer's 12-bit 4:2:2), segmentation, superres and items
    of several frames (the writer's)."""
    page = text_page(192, 256, 1)
    colour = two_colour(page)
    rgb = colour[..., ::-1].copy()
    out = {}
    for sub in ("4:2:0", "4:2:2"):
        out[f"pillow_screen_c{sub.replace(':', '')}_s2.avif"] = (pillow_file(
            rgb, quality=100, speed=2, subsampling=sub,
            advanced=[("tune-content", "screen")]), None)
    out["cv2_page_q95_s2.avif"] = (cv2_file(page, quality=95, speed=2), None)
    out["cv2_page_c_q80_s2.avif"] = (cv2_file(colour, quality=80, speed=2),
                                     None)
    out["cv2_page_c10_q95_s2.avif"] = (cv2_file(
        colour.astype(np.uint16) * 4 + 1, quality=95, speed=2, depth=10),
        None)
    out["pillow_screen_c444_q90.avif"] = (pillow_file(
        rgb, quality=90, subsampling="4:4:4",
        advanced=[("tune-content", "screen")]), None)
    wide = two_colour(text_page(192, 384, 3)).astype(np.uint16) << 4
    out["port_intrabc_c422_12.avif"] = (avif.encode_avif(
        wide, 12, 5, lossy=dict(base_q=90, block=16), subsampling="4:2:2",
        intrabc=True), None)
    frame = scene(np.random.default_rng(24), 96, 200)
    out["port_seg_lossless.avif"] = (avif.encode_avif(
        frame, 8, 9, lossy=dict(base_q=80, lf=(10, 12, 6, 5), segments=[
            dict(lf_y_v=-8), dict(alt_q=-80), dict(alt_q=40, lf_u=9)])),
        None)
    out["port_seg_skip_g12.avif"] = (avif.encode_avif(
        frame[..., 1].astype(np.uint16) << 4, 12, 10, lossy=dict(
            base_q=70, lf=(10, 10, 0, 0), segments=[
                dict(alt_q=-30), dict(skip=True), dict(lf_y_h=20)])), None)
    lr = dict(types=("switchable", "sgrproj", "wiener"), units=[
        [("wiener", (1, -3, 8), (2, -5, 10)), ("sgrproj", 5, (-10, 30))],
        [("sgrproj", 3, (-20, 40))], [("wiener", (0, -2, 5), (0, 3, -7))]])
    out["port_superres_lr_tiles.avif"] = (avif.encode_avif(
        frame, 8, 11, lossy=dict(base_q=90, lf=(8, 8, 4, 4),
                                 cdef=[(4, 1, 2, 1), (8, 2, 0, 4)], lr=lr),
        superres=12, tile_cols_log2=1), None)
    out["port_superres_narrow.avif"] = (avif.encode_avif(
        frame[:, :14].copy(), 8, 12, lossy=dict(base_q=70, lr=lr),
        superres=14), None)
    out.update(frames_items(img, 255 - img))
    return out


# -- layered (progressive) items through cv2's own libavif ------------------

LIBAVIF_VERSION = b"1.4.2"
# avifEncoder's fields this script sets (libavif 1.4.2's avif.h): speed,
# extraLayerCount, quality, qualityAlpha, scalingMode (horizontal then
# vertical fraction); each write is checked by parsing what it wrote
ENC_SPEED, ENC_EXTRA_LAYERS, ENC_QUALITY, ENC_QUALITY_ALPHA = 8, 28, 32, 36
ENC_SCALING = 68
# avifImage's: width, height, depth, yuvFormat, yuvPlanes[3], yuvRowBytes[3],
# alphaPlane, alphaRowBytes
IMG_PLANES, IMG_ROWBYTES, IMG_ALPHA, IMG_ALPHA_ROWBYTES = 24, 48, 64, 72
# avifPixelFormat of each subsampling
AVIF_FORMATS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}
# the seed of the rendered TUM fr1 frames of the committed 480 x 640
# layered sequence (chip_smoke.py phase 24 renders its depth and poses)
LAYERED_TUM_SEED, LAYERED_TUM_FRAMES = 24, 8


def libavif():
    """cv2's bundled libavif (``opencv_python.libs/libavif-*.so``) through
    ctypes, its version checked first."""
    import ctypes
    import glob

    import cv2

    site = os.path.dirname(os.path.dirname(os.path.abspath(cv2.__file__)))
    found = sorted(glob.glob(os.path.join(site, "opencv_python.libs",
                                          "libavif-*.so*")))
    assert found, "no libavif beside cv2"
    lib = ctypes.CDLL(found[0])
    lib.avifVersion.restype = ctypes.c_char_p
    assert lib.avifVersion() == LIBAVIF_VERSION, lib.avifVersion()
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [u32, u32, u32, ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
    lib.avifImageDestroy.argtypes = [vp]
    lib.avifEncoderCreate.restype = vp
    lib.avifEncoderDestroy.argtypes = [vp]
    lib.avifEncoderAddImage.argtypes = [vp, vp, ctypes.c_uint64, u32]
    lib.avifEncoderFinish.argtypes = [vp, vp]
    lib.avifRWDataFree.argtypes = [vp]
    lib.avifEncoderSetCodecSpecificOption.argtypes = [vp, ctypes.c_char_p,
                                                      ctypes.c_char_p]
    return lib


def _fill(lib, image: int, planes, alpha, depth: int) -> None:
    import ctypes

    dt = np.uint16 if depth > 8 else np.uint8
    targets = [(IMG_PLANES + 8 * k, IMG_ROWBYTES + 4 * k, p)
               for k, p in enumerate(planes)]
    if alpha is not None:
        targets.append((IMG_ALPHA, IMG_ALPHA_ROWBYTES, alpha))
    for ptr_off, rb_off, p in targets:
        ptr = ctypes.c_void_p.from_address(image + ptr_off).value
        rb = ctypes.c_uint32.from_address(image + rb_off).value
        h, w = p.shape
        assert ptr and rb >= w * np.dtype(dt).itemsize
        dst = np.ctypeslib.as_array((ctypes.c_uint8 * (rb * h)).from_address(
            ptr)).view(dt).reshape(h, -1)
        dst[:, :w] = p


def layer_planes(img: np.ndarray, depth: int = 8, sub: str = "4:2:0"):
    """BT.601 full-range planes of BGR ``img`` (cv2's YUV), widened to
    ``depth`` bits, at ``sub``."""
    import cv2

    y = cv2.cvtColor(img, cv2.COLOR_BGR2YUV).astype(np.uint16)
    if depth > 8:
        y = (y << (depth - 8)) | (y >> (16 - depth))
    if sub == "4:0:0":
        return [y[..., 0]]
    if sub == "4:2:0":
        return [y[..., 0], y[::2, ::2, 1], y[::2, ::2, 2]]
    if sub == "4:2:2":
        return [y[..., 0], y[:, ::2, 1], y[:, ::2, 2]]
    return [y[..., k] for k in range(3)]


def a1lx_layers(data: bytes) -> int:
    """The layers an item's ``a1lx`` counts: the sizes of all but the last,
    each nonzero, and the last."""
    k = data.index(b"a1lx")
    large = data[k + 4] & 1
    n = 4 if large else 2
    sizes = [int.from_bytes(data[k + 5 + n * i:k + 5 + n * (i + 1)], "big")
             for i in range(3)]
    return sum(1 for v in sizes if v) + 1


def encode_layered(layers, depth: int = 8, sub: str = "4:2:0",
                   speed: int = 6, qualities=None, scales=None,
                   alpha=None, options=None) -> bytes:
    """A layered (progressive) AVIF of ``layers`` (BGR images, one per
    layer) written by cv2's libavif (``extraLayerCount``; a quality and a
    scaling fraction per layer), the avifenc ``--progressive`` path;
    ``alpha``: one plane per layer; ``options``: libaom's options by name
    (avifEncoderSetCodecSpecificOption, avifenc's ``-a``).  The layer
    count is checked in ``a1lx`` and each frame's size in its AV1
    headers."""
    import ctypes

    lib = libavif()
    enc = lib.avifEncoderCreate()
    ints = {off: ctypes.c_int32.from_address(enc + off) for off in (
        ENC_SPEED, ENC_EXTRA_LAYERS, ENC_QUALITY, ENC_QUALITY_ALPHA,
        ENC_SCALING, ENC_SCALING + 4, ENC_SCALING + 8, ENC_SCALING + 12)}
    # the defaults of avifEncoderCreate where this script writes
    assert [ints[o].value for o in sorted(ints)] == [-1, 0, -1, -1, 1, 1, 1,
                                                     1]
    ints[ENC_SPEED].value = speed
    ints[ENC_EXTRA_LAYERS].value = len(layers) - 1
    for key, value in (options or {}).items():
        assert lib.avifEncoderSetCodecSpecificOption(
            enc, key.encode(), str(value).encode()) == 0, key
    images = []
    try:
        for i, img in enumerate(layers):
            if qualities:
                ints[ENC_QUALITY].value = ints[ENC_QUALITY_ALPHA].value = \
                    qualities[i]
            num, den = scales[i] if scales else (1, 1)
            for off in (0, 8):
                ints[ENC_SCALING + off].value = num
                ints[ENC_SCALING + off + 4].value = den
            planes = layer_planes(img, depth, sub)
            H, W = planes[0].shape
            image = lib.avifImageCreate(W, H, depth, AVIF_FORMATS[sub])
            images.append(image)
            assert lib.avifImageAllocatePlanes(
                image, 1 | (2 if alpha is not None else 0)) == 0
            _fill(lib, image, planes, None if alpha is None else alpha[i],
                  depth)
            assert lib.avifEncoderAddImage(enc, image, 1, 0) == 0
        out = (ctypes.c_uint8 * 16)()
        assert lib.avifEncoderFinish(enc, out) == 0
        ptr = ctypes.c_void_p.from_buffer(out).value
        data = ctypes.string_at(ptr, ctypes.c_size_t.from_buffer(out,
                                                                 8).value)
        lib.avifRWDataFree(out)
    finally:
        for image in images:
            lib.avifImageDestroy(image)
        lib.avifEncoderDestroy(enc)
    assert a1lx_layers(data) == len(layers)
    box = avif.parse(data)
    obus = avif._payload(data, box, box["color"])
    sizes = [(f["width"], f["height"]) for f in frame_headers(obus)]
    H, W = layers[0].shape[:2]
    # libaom scales a layer's size by the fraction, rounding up
    assert sizes == [(-(-W * n // d), -(-H * n // d)) for n, d in (
        scales or [(1, 1)] * len(layers))], sizes
    return data


def frame_ends(obus: bytes) -> list:
    """Where each frame (a frame OBU, or a frame header and its tile
    groups) of an item's OBUs ends."""
    out, pos = [], 0
    while pos < len(obus):
        h = obus[pos]
        kind, ext = (h >> 3) & 15, (h >> 2) & 1
        p, size, shift = pos + 1 + ext, 0, 0
        while True:
            byte = obus[p]
            p += 1
            size |= (byte & 127) << shift
            shift += 7
            if not byte & 128:
                break
        pos = p + size
        if kind in (4, 6):
            out.append(pos)
    return out


def frame_headers(obus: bytes) -> list:
    """:func:`avif.av1_info` of each frame of an item's OBUs (its data up
    to the end of that frame)."""
    return [avif.av1_info(obus[:end]) for end in frame_ends(obus)]


def with_props(data: bytes, extra: list) -> bytes:
    """A layered file's colour item rebuilt (ispe, av1C) with the extra
    (property, essential) pairs, such as ``lsel`` or ``a1op``."""
    box = avif.parse(data)
    obus = avif._payload(data, box, box["color"])
    info = avif.av1_info(obus)
    return heif([dict(id=1, type=b"av01", data=obus, props=[
        (avif._full(b"ispe", 0, 0, struct.pack(">II", info["width"],
                                                info["height"])), False),
        (avif._av1c(info["depth"], bool(info["mono"]),
                    bool(info["ssx"] and info["ssy"])), True)] + extra)])


def layered_tum_frames() -> list:
    """The rendered 480 x 640 TUM fr1 frames of the committed layered
    sequence."""
    return render_sequence(LAYERED_TUM_SEED, LAYERED_TUM_FRAMES, 480, 640,
                           TUM_FR1, 0.02, 0.004)[0]


def files_24() -> dict:
    """Slice 24's layered items (see the module docstring)."""
    a, b = render_sequence(19, 2, 96, 128, TUM_FR1, 0.05, 0.01)[0]
    out = {}
    cases = {
        "layered_l2_s6_c444.avif": dict(sub="4:4:4", speed=6,
                                         qualities=[30, 80]),
        "layered_l2_s0_half_c420.avif": dict(speed=0, qualities=[20, 80],
                                             scales=[(1, 2), (1, 1)]),
        "layered_l3_s2_c10.avif": dict(depth=10, speed=2,
                                       qualities=[20, 50, 80]),
        "layered_l3_s0_quarter.avif": dict(speed=0, qualities=[20, 50, 80],
                                           scales=[(1, 4), (1, 2), (1, 1)]),
        "layered_l4_s0_c444.avif": dict(sub="4:4:4", speed=0,
                                        qualities=[20, 40, 60, 80]),
        "layered_l4_s0_g8.avif": dict(sub="4:0:0", speed=0,
                                      qualities=[20, 40, 60, 80]),
        "layered_l4_s9_c12_quarter.avif": dict(
            depth=12, sub="4:4:4", speed=9, qualities=[20, 40, 60, 80],
            scales=[(1, 4), (1, 2), (1, 1), (1, 1)]),
        "layered_l2_s6_alpha.avif": dict(speed=6, qualities=[30, 80],
                                         alpha=[a[..., 1], a[..., 1]]),
    }
    for name, kw in cases.items():
        n = len(kw["qualities"])
        out[name] = (encode_layered([(a, b)[k % 2] for k in range(n)], **kw),
                     None)
    img = scene(np.random.default_rng(25), 96, 128)
    moved = np.roll(img, (2, 3), (0, 1))
    for sub in ("4:2:0", "4:2:2"):
        name = f"layered_l3_s0_sub8x8_c{sub.replace(':', '')[:3]}.avif"
        out[name] = (encode_layered([img, moved, img], sub=sub, speed=0,
                                    qualities=[30, 50, 70]), None)
    half = out["layered_l2_s0_half_c420.avif"][0]
    out["layered_lsel0_half.avif"] = (with_props(half, [
        (avif._box(b"lsel", struct.pack(">H", 0)), True)]), None)
    out["layered_a1op1_lsel1.avif"] = (with_props(
        out["layered_l3_s0_quarter.avif"][0], [
            (avif._box(b"a1op", bytes([1])), True),
            (avif._box(b"lsel", struct.pack(">H", 1)), True)]), None)
    # refused by cv2 (None): a layer selected that the item lacks, bytes of
    # the last layer's tile data changed
    out["layered_lsel3_absent.avif"] = (with_props(half, [
        (avif._box(b"lsel", struct.pack(">H", 3)), True)]), None)
    damaged = bytearray(half)
    for k in (30, 90, 150):
        damaged[-k] ^= 0x5A
    out["layered_damaged.avif"] = (bytes(damaged), None)
    for k, img in enumerate(layered_tum_frames()):
        out[f"layered_tum{k}_480x640.avif"] = (encode_layered(
            [img, img], speed=6, qualities=[30, 60],
            scales=[(1, 2), (1, 1)]), None)
    return out


def cv2_read(data: bytes) -> np.ndarray:
    """cv2.imread of a file of ``data``."""
    import cv2

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.avif")
        with open(path, "wb") as fh:
            fh.write(data)
        return cv2.imread(path)


def scene(rng, H: int, W: int) -> np.ndarray:
    """Sines, a checker and noise: libaom restores this one's loop at
    speed 0."""
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([np.sin(x / (5.0 + c)) * 60 + np.cos(y / (4.0 + c)) * 50
                     + 120 + ((x // 9 + y // 7) % 2) * 30 for c in range(3)],
                    -1)
    return np.clip(base + rng.normal(0, 4, base.shape), 0,
                   255).astype(np.uint8)


def frame_480x640() -> np.ndarray:
    """The rendered frame of the 480 x 640 lossy fixtures."""
    return render_sequence(20, 1, 480, 640, TUM_FR1, 0.02, 0.004)[0][0]


def check_writer(name: str, path: str, want) -> None:
    """A writer file reads back through cv2 as its input."""
    import cv2

    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got is not None and got.shape[:2] == want.shape[:2], name
    if got.ndim == 3 and got.shape[2] == 4:
        got = got[..., :3]
    assert np.array_equal(got, want), name


def main(argv=None) -> dict:
    import cv2

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    made = files()
    hashes = {}
    for name, (data, queued) in made.items():
        assert len(data) <= LIMIT, (name, len(data))
        path = os.path.join(args.out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        entry = dict(bytes=len(data),
                     color=array_hash(cv2.imread(path, cv2.IMREAD_COLOR)),
                     anydepth=array_hash(cv2.imread(path,
                                                    cv2.IMREAD_ANYDEPTH)))
        if queued:
            assert entry["color"] is not None, name
            try:
                avif.decode_avif(data)
                raise AssertionError(f"{name} is read")
            except NotImplementedError as e:
                assert queued in str(e), (name, str(e))
            entry["queued"] = queued
        hashes[name] = entry
    images = render_sequence(19, 1, 96, 128, TUM_FR1, 0.02, 0.004)[:2]
    img = images[0][0][24:72, 32:96]
    d16 = np.clip(np.rint(images[1][0] * 5000.0), 0, 65535).astype(np.uint16)
    top = np.minimum(d16 >> 4, 4095)[24:72, 32:96]
    c10 = (img[:37, :53].astype(np.uint16) << 2) | (img[:37, :53] >> 6)
    for name, want in (("port_c8.avif", img), ("port_g12.avif", top),
                       ("port_c10_alpha.avif", c10)):
        check_writer(name, os.path.join(args.out, name), want)
    for name in ("port_damaged.avif", "port_cut.avif"):
        assert hashes[name]["color"] is None, name
    assert sum(len(d) for d, _ in made.values()) <= TOTAL
    assert sum(len(d) for n, (d, _) in made.items()
               if "480x640" in n and not n.startswith("layered")
               ) <= LOSSY_480X640
    assert sum(len(d) for n, (d, _) in made.items()
               if "480x640" in n and n.startswith("layered")
               ) <= LAYERED_480X640
    with open(os.path.join(args.out, "hashes.json"), "w") as fh:
        json.dump(hashes, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return hashes


if __name__ == "__main__":
    print(json.dumps({k: v["bytes"] for k, v in main().items()}, indent=1))
