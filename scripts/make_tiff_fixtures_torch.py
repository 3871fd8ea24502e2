#!/usr/bin/env python
"""Write the committed TIFF fixtures of ``tests/data/tiff/``: files of the
kinds the port reads since its CCITT, colour-space and SGI LogL readers,
written by PIL (whose TIFF writer is libtiff's own, an encoder
independent of the port's ``tiff.encode_tiff``), for the tests and for
machines that have no PIL and no OpenCV (the card machine of
``chip_smoke.py``).

    python scripts/make_tiff_fixtures_torch.py [--out tests/data/tiff]

Each is a 96 x 128 crop of a rendered frame (LZW where the scheme is not
the file's point):

- ``ccitt_rle.tif``, ``ccitt_rlew.tif``, ``group3.tif``, ``group4.tif``:
  the frame's green channel thresholded, as 1-bit modified Huffman rows,
  word-aligned rows, T.4 and T.6;
- ``gray_alpha.tif`` (PIL "LA": unassociated alpha), ``cmyk.tif``
  ("CMYK"), ``ycbcr.tif`` ("YCbCr", 1 x 1), ``cielab.tif`` ("LAB");
- ``logl.tif``: SGI LogL of float luminances (PIL "F", compression
  SGILog, photometric LogL).

and, written by the port's ``tiff.encode_tiff`` from a 48 x 64 crop (the
layouts no library here writes), the kinds libtiff reads in its own way:

- ``short_strip.tif``: one uncompressed strip whose StripByteCounts says
  5/8 of its bytes (libtiff recounts it from ImageLength);
- ``jpeg_separate.tif``: JPEG of separate R, G, B planes, 16-row strips;
- ``ycbcr_tiles_predictor.tif``: LZW YCbCr 2 x 2 data units in 16 x 16
  tiles under the horizontal predictor;
- ``jpeg_short_strip.tif``: JPEG strips of 12 rows where RowsPerStrip
  says 16 (the rest zeros);
- ``logluv32.tif``: SGI LogLuv32 (photometric 32845 under SGI Log, 3
  samples) of the crop's luminance and chromaticity codes;

- ``logluv24_codes.tif``: SGI LogLuv24 codes of the crop's top-left 32 x
  48 (10-bit log luminance of the green channel, uv indices from the red
  and blue, the last columns past libtiff's uv table), strips of 8 rows;
- ``twelve_bit_gray_lzw.tif``, ``twelve_bit_rgb.tif``,
  ``twelve_bit_signed_tiles.tif``: 12-bit samples of that 32 x 48 (its 8
  bits times 16 plus its row): LZW gray, RGB, signed gray in 16 x 16
  tiles;

and ``logluv24_cv2.tif``: ``cv2.imwrite``'s SGI LogLuv24 of that 32 x 48
as float (its values / 64);

and one file of each kind cv2.imread returns None for that the port once
refused as NotImplementedError (``c2_<kind>.tif``, 32 x 48,
``tests/torch_port.c2_tiff``).

Beside them ``hashes.json``: the SHA-256 of ``cv2.imread``'s array in both
read modes (colour, ``IMREAD_ANYDEPTH``), its shape and dtype (null where
cv2 returns None), which ``tests/test_torch_tiff.py`` and
``chip_smoke.py`` phases 15 and 17 hold the port's decoder to.  Needs
OpenCV and PIL.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 64 * 1024  # bytes per file


def array_hash(a) -> dict:
    """The SHA-256, shape and dtype of an array; None for None."""
    if a is None:
        return None
    return dict(sha256=hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                      ).hexdigest(),
                shape=list(a.shape), dtype=str(a.dtype))


def port_files(rgb: np.ndarray) -> dict:
    """The files of the port's encoder (module docstring) from ``rgb``
    (``uint8`` RGB, at least 48 x 64)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from lgu_slam_tpu_torch.data.image_io import encode_jpeg
    from lgu_slam_tpu_torch.data.tiff import encode_tiff, logl_encode
    from torch_port import C2_KINDS, c2_tiff

    bgr = np.ascontiguousarray(rgb[::2, ::2][:48, :64, ::-1])
    raw = np.ascontiguousarray(bgr[..., ::-1]).tobytes()
    one = bytearray(encode_tiff(bgr, chunks=[raw]))
    count = struct.pack("<HHII", 279, 4, 1, len(raw))
    at = one.index(count)
    one[at:at + 12] = struct.pack("<HHII", 279, 4, 1, len(raw) * 5 // 8)
    files = {
        "short_strip.tif": bytes(one),
        "jpeg_separate.tif": encode_tiff(bgr, "jpeg", planar=2,
                                         photometric=2, rows_per_strip=16),
        "ycbcr_tiles_predictor.tif": encode_tiff(
            bgr, "lzw", predictor=2, photometric=6, subsampling=(2, 2),
            tile=(16, 16)),
        "jpeg_short_strip.tif": encode_tiff(
            bgr, "jpeg", photometric=2, rows_per_strip=16,
            jpeg_tables=False, chunks=[encode_jpeg(
                np.ascontiguousarray(bgr[y:y + 12]), 90, "444",
                adobe_transform=0) for y in range(0, 48, 16)]),
    }
    # LogLuv32 codes: log luminance of the green channel around Y = 1/4,
    # u and v from the red and blue
    g, r, b = (bgr[..., k].astype(np.uint32) for k in (1, 2, 0))
    codes = (15872 + 4 * g) << 16 | (r // 2 + 40) << 8 | (b // 2 + 80)
    luv = bytearray(encode_tiff(np.zeros(bgr.shape, np.uint16), chunks=[
        logl_encode(codes, planes=4)]))
    for tag, value in ((259, 34676), (262, 32845)):
        at = luv.index(struct.pack("<HHI", tag, 3, 1))
        struct.pack_into("<H", luv, at + 8, value)
    files["logluv32.tif"] = bytes(luv)
    small = np.ascontiguousarray(bgr[:32, :48])
    g, r, b = (small[..., k].astype(np.uint32) for k in (1, 2, 0))
    lum = np.uint32(200) + g * 3
    uv = np.minimum(r * 40 + b // 4, 16383)
    uv[:, -6:] = 16289 + np.arange(6)  # past the table: the neutral colour
    files["logluv24_codes.tif"] = encode_tiff(lum << 14 | uv, "sgilog24",
                                              rows_per_strip=8)
    twelve = small.astype(np.uint16) * 16 + np.arange(32, dtype=np.uint16)[
        :, None, None]
    files["twelve_bit_gray_lzw.tif"] = encode_tiff(
        twelve[..., 1], "lzw", rows_per_strip=16, twelve_bit=True)
    files["twelve_bit_rgb.tif"] = encode_tiff(twelve, twelve_bit=True)
    files["twelve_bit_signed_tiles.tif"] = encode_tiff(
        twelve[..., 2], tile=(16, 16), twelve_bit=True,
        tags={339: (3, [2])})
    for kind in C2_KINDS:
        files[f"c2_{kind}.tif"] = c2_tiff(kind, small)
    return files


def main(argv=None) -> dict:
    import cv2
    from PIL import Image, TiffImagePlugin

    sys.path.insert(0, REPO)
    from lgu_slam_tpu_torch.data.fixtures import TUM_FR1, render_sequence

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "tiff"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    frame = render_sequence(8, 1, 480, 640, TUM_FR1, 0.02, 0.004)[0][0]
    rgb = np.ascontiguousarray(frame[::4, ::4][20:116, :128, ::-1])
    bits = rgb[..., 1] > 110

    def save(image, **kw) -> bytes:
        buf = io.BytesIO()
        image.save(buf, "TIFF", **kw)
        return buf.getvalue()

    files = {f"{name}.tif": save(Image.fromarray(bits), compression=scheme)
             for name, scheme in (("ccitt_rle", "tiff_ccitt"),
                                  ("ccitt_rlew", "tiff_raw_16"),
                                  ("group3", "group3"),
                                  ("group4", "group4"))}
    image = Image.fromarray(rgb)
    alpha = Image.fromarray((np.add.outer(np.arange(96), np.arange(128)) * 2
                             % 256).astype(np.uint8))
    gray = image.convert("L")
    gray.putalpha(alpha)
    files["gray_alpha.tif"] = save(gray, compression="tiff_lzw")
    for name, mode in (("cmyk", "CMYK"), ("ycbcr", "YCbCr"),
                       ("cielab", "LAB")):
        files[f"{name}.tif"] = save(image.convert(mode),
                                    compression="tiff_lzw")
    luminance = (rgb.astype(np.float32) @ np.float32([0.2126, 0.7152,
                                                      0.0722])) / 200
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[262] = 32844
    files["logl.tif"] = save(Image.fromarray(luminance),
                             compression="tiff_sgilog", tiffinfo=info)
    files.update(port_files(rgb))
    luv = os.path.join(args.out, "logluv24_cv2.tif")
    crop = rgb[::2, ::2][:32, :48, ::-1].astype(np.float32) / 64
    assert cv2.imwrite(luv, crop, [
        cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_SGILOG24])
    with open(luv, "rb") as fh:
        files["logluv24_cv2.tif"] = fh.read()
    hashes = {}
    for name, data in files.items():
        assert len(data) <= LIMIT, (name, len(data))
        path = os.path.join(args.out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        hashes[name] = dict(
            bytes=len(data),
            color=array_hash(cv2.imread(path, cv2.IMREAD_COLOR)),
            anydepth=array_hash(cv2.imread(path, cv2.IMREAD_ANYDEPTH)))
    assert sum(len(d) for d in files.values()) <= 320 * 1024
    with open(os.path.join(args.out, "hashes.json"), "w") as fh:
        json.dump(hashes, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return hashes


if __name__ == "__main__":
    print(json.dumps(main(), indent=1))
