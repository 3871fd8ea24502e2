"""The port's AVIF reader on frames that use AV1 loop restoration
(lgu_slam_tpu_torch/csrc/host/av1_core.h: the units' coefficients read
with the tile syntax, the Wiener and self-guided filters over 64-row
stripes after CDEF) against OpenCV's (libavif 1.4.2 over libaom 3.14):
cv2.imwrite's files at speeds 0-4, 8- and 10-bit colour, gray and alpha,
odd sizes, the rendered TUM frame and a natural scene, read bit for bit in
both read modes, each case asserting the restoration it reaches; the two
committed 480 x 640 frames of chip_smoke.py phase 21.  libaom's encoder
enables no restoration at 12 bits: the port's writer covers that depth
(tests/test_torch_avif_lossy.py, ``WRITER``, which also holds the damaged
files of a frame that restores, ``test_restoration_damage``)."""

import os

import cv2
import numpy as np
import pytest
from test_torch_avif_lossy import _natural
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif

DATA = os.path.join(os.path.dirname(__file__), "data", "avif")
TYPES = ("none", "wiener", "sgrproj")


def _tum(H: int, W: int) -> np.ndarray:
    """The committed 480 x 640 rendered frame as cv2 reads it, resized."""
    src = cv2.imread(os.path.join(DATA, "cv2_lossy_q95_480x640.avif"))
    return cv2.resize(src, (W, H), interpolation=cv2.INTER_AREA)


def _cv2_avif(path, img, quality, speed, depth=None):
    params = [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_SPEED,
              speed]
    if depth:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    assert cv2.imwrite(str(path), img, params)
    return path


def _used(path) -> set:
    """{(plane, type)} of the restoration units of a file's colour item
    that filter: plane "luma" or "chroma", type "wiener" or "sgrproj"."""
    data = open(str(path), "rb").read()
    box = avif.parse(data)
    counts = avif.lr_stats(avif._payload(data, box, box["color"]))[0]
    return {("luma" if p == 0 else "chroma", TYPES[t])
            for p in range(3) for t in (1, 2) if counts[p, t]}


def _cases(speed: int) -> list:
    """(name, image, quality, depth) of one speed: the rendered frame at
    8 and 10 bits, colour, gray and with alpha, an odd-sized crop, the
    natural scene."""
    tum = _tum(96, 128) if speed < 2 else _tum(120, 160)
    nat = _natural(np.random.default_rng(40 + speed), 64, 96)
    bgra = np.concatenate([tum, tum[..., :1] // 2 + 60], -1)
    odd = cv2.imread(os.path.join(DATA, "cv2_lossy_q95_480x640.avif"))[
        100:217, 200:357].copy()
    return [("c8", tum, 20, None), ("c8", tum, 50, None),
            ("c10", tum.astype(np.uint16) << 2, 85, 10),
            ("g8", tum[..., 1].copy(), 40, None),
            ("g10", tum[..., 1].astype(np.uint16) << 2, 85, 10),
            ("a10", bgra.astype(np.uint16) << 2, 50, 10),
            ("odd", odd, 85, None), ("nat", nat, 80, None)] + [
                ("c12", tum.astype(np.uint16) << 4, 50, 12)] * (speed >= 2)


# the restoration each speed's cases reach together, as measured with
# OpenCV 5.0.0 (libavif 1.4.2, libaom 3.14.1)
REACHED = {
    0: {("luma", "wiener"), ("luma", "sgrproj"), ("chroma", "wiener"),
        ("chroma", "sgrproj")},
    1: {("luma", "wiener"), ("chroma", "wiener"), ("chroma", "sgrproj")},
    2: {("luma", "wiener"), ("luma", "sgrproj"), ("chroma", "wiener")},
    3: {("luma", "wiener"), ("luma", "sgrproj"), ("chroma", "wiener")},
    4: {("luma", "wiener"), ("luma", "sgrproj"), ("chroma", "wiener")},
}


@pytest.mark.parametrize("speed", range(5))
def test_cv2_restoration_at_slow_speeds(speed, tmp_path):
    """cv2.imwrite at a speed of 0-4 (where libaom restores the loop):
    every case reads equal to cv2.imread in both modes, and together they
    reach the measured Wiener and self-guided units on luma and chroma
    (``REACHED``); 12-bit frames (speeds 2-4) carry no restoration."""
    used = set()
    for k, (name, img, quality, depth) in enumerate(_cases(speed)):
        path = _cv2_avif(tmp_path / f"{k}_{name}.avif", img, quality, speed,
                         depth)
        same_as_cv2(path)
        got = _used(path)
        if name == "c12":
            assert not got
        used |= got
    assert used == REACHED[speed]


@pytest.mark.parametrize("name, reached", [
    ("cv2_lr_q30_s2_480x640.avif", {("luma", "sgrproj"),
                                    ("chroma", "wiener")}),
    ("cv2_lr_q60_s2_480x640.avif", {("luma", "wiener"), ("luma", "sgrproj"),
                                    ("chroma", "wiener")}),
    ("cv2_lossy_lr_s0.avif", {("luma", "sgrproj")})])
def test_committed_restoration_frames(name, reached):
    """The committed frames that use restoration (the 480 x 640 rendered
    frame at speed 2, qualities 30 and 60, which chip_smoke.py phase 21
    decodes; a 48 x 64 frame at speed 0): the frame types of the header
    and the units that filter, and cv2.imread's result in both modes."""
    path = os.path.join(DATA, name)
    data = open(path, "rb").read()
    box = avif.parse(data)
    info = avif.av1_info(avif._payload(data, box, box["color"]))
    assert any(info["lr_types"])
    assert _used(path) == reached
    same_as_cv2(path)
