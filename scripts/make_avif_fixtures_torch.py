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

refused as ``cv2.imread`` refuses them (None: null hashes):
``port_damaged.avif`` (three bytes of the tile data flipped),
``port_cut.avif`` (cut inside its tile); and read by OpenCV but queued for
a later reader (``NotImplementedError`` naming the feature, the ``queued``
key): ``pillow_avis.avif`` (an image sequence).

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
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lgu_slam_tpu_torch.data import avif  # noqa: E402
from lgu_slam_tpu_torch.data.fixtures import (  # noqa: E402
    TUM_FR1,
    render_sequence,
)

OUT = os.path.join(REPO, "tests", "data", "avif")
LIMIT = 128 * 1024
TOTAL = 640 * 1024
LOSSY_480X640 = 256 * 1024  # the 480 x 640 frames together


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
        255 - img[..., ::-1]], quality=100, subsampling="4:4:4"),
        "image sequence")
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
               if "480x640" in n) <= LOSSY_480X640
    with open(os.path.join(args.out, "hashes.json"), "w") as fh:
        json.dump(hashes, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return hashes


if __name__ == "__main__":
    print(json.dumps({k: v["bytes"] for k, v in main().items()}, indent=1))
