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

Beside them ``hashes.json``: the SHA-256 of ``cv2.imread``'s array in both
read modes (colour, ``IMREAD_ANYDEPTH``), its shape and dtype, which
``tests/test_torch_tiff.py`` and ``chip_smoke.py`` phase 15 hold the
port's decoder to.  Needs OpenCV and PIL.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 64 * 1024  # bytes per file


def array_hash(a: np.ndarray) -> dict:
    return dict(sha256=hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                      ).hexdigest(),
                shape=list(a.shape), dtype=str(a.dtype))


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
    assert sum(len(d) for d in files.values()) <= 256 * 1024
    with open(os.path.join(args.out, "hashes.json"), "w") as fh:
        json.dump(hashes, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return hashes


if __name__ == "__main__":
    print(json.dumps(main(), indent=1))
