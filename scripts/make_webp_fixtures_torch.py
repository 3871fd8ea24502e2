#!/usr/bin/env python
"""Write the committed WebP fixtures of ``tests/data/webp/``: the files the
port has no encoder for (lossy VP8, VP8X with ALPH, animations), written
by OpenCV and PIL (libwebp), for the tests and for machines that have
neither (the card machine of ``chip_smoke.py``).

    python scripts/make_webp_fixtures_torch.py [--out tests/data/webp]

- ``lossy_480x640.webp``: a rendered TUM-size frame, lossy (cv2.imwrite,
  quality 75: segments, the normal loop filter);
- ``lossy_alpha.webp``: lossy with a lossy-compressed, filtered ALPH
  chunk (PIL);
- ``lossless_alpha.webp``: VP8L with alpha (PIL);
- ``animated.webp``: three frames (PIL), frame 0 the one cv2.imread
  returns.

Beside them ``hashes.json``: the SHA-256 of ``cv2.imread``'s array in both
read modes (colour, ``IMREAD_ANYDEPTH``), its shape and dtype, which
``tests/test_torch_webp.py`` and ``chip_smoke.py`` phase 14 hold the
port's decoder to.  Needs OpenCV (with its WebP codec) and PIL.
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
    from PIL import Image

    sys.path.insert(0, REPO)
    from lgu_slam_tpu_torch.data.fixtures import TUM_FR1, render_sequence

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "webp"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    images = render_sequence(7, 4, 480, 640, TUM_FR1, 0.02, 0.004)[0]
    rng = np.random.default_rng(7)
    frame = images[0]
    small = [np.ascontiguousarray(im[::5, ::5][:96, :128]) for im in images]
    alpha = (np.add.outer(np.arange(96), np.arange(128)) * 2 % 256
             ).astype(np.uint8)
    alpha[20:40, 30:70] = 0
    files = {}
    ok, buf = cv2.imencode(".webp", frame, [cv2.IMWRITE_WEBP_QUALITY, 75])
    files["lossy_480x640.webp"] = buf.tobytes()
    rgba = np.dstack([small[1][..., ::-1], alpha])
    b = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(b, "WEBP", quality=70,
                                       alpha_quality=60)
    files["lossy_alpha.webp"] = b.getvalue()
    b = io.BytesIO()
    noisy = rgba.copy()
    noisy[..., :3] = noisy[..., :3] // 8 * 8 + rng.integers(0, 3, (96, 128,
                                                                    3))
    Image.fromarray(noisy, "RGBA").save(b, "WEBP", lossless=True)
    files["lossless_alpha.webp"] = b.getvalue()
    b = io.BytesIO()
    frames = [Image.fromarray(im[..., ::-1]) for im in small[1:4]]
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, quality=80)
    files["animated.webp"] = b.getvalue()
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
    assert sum(len(d) for d in files.values()) <= 512 * 1024
    with open(os.path.join(args.out, "hashes.json"), "w") as fh:
        json.dump(hashes, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return hashes


if __name__ == "__main__":
    print(json.dumps(main(), indent=1))
