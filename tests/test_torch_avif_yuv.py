"""libavif's YUV to RGB paths beyond BT.601 full range, as OpenCV's reader
(libavif 1.4.2) takes them and the port's AVIF reader
(lgu_slam_tpu_torch/data/avif.py ``_yuv_to_bgr``) repeats them: 4:4:4,
4:2:2 and 4:2:0 under BT.709, BT.2020 and the other matrices, full and
limited range, 8 to 12 bits, with and without alpha, every sample value of
each plane through cv2.imread in both read modes; the colour descriptions
libavif refuses.  BT.601 at full range, the path of cv2.imwrite's and
Pillow's files: tests/test_torch_avif_lossy.py
(``test_yuv_to_rgb_every_sample_value``)."""

import cv2
import numpy as np
import pytest
from test_torch_avif_lossy import _natural
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif

# (matrix, full range, primaries) of the sweep below: libyuv's BT.709 and
# BT.2020 constants, full and limited; BT.601 limited; libavif's float path
# under FCC, SMPTE 240, YCgCo, chroma-derived NCL under primaries libyuv
# has constants for (BT.709, unspecified, BT.601, BT.2020) and under
# others (BT.470M, EBU 3213), YCgCo-Ro, YCgCo-Re (10 bits, read to 8);
# identity at limited range (4:4:4)
COLOURS = [(1, 1, 1), (1, 0, 1), (9, 1, 9), (9, 0, 9), (2, 0, 2), (5, 0, 5),
           (6, 0, 1), (4, 1, 4), (4, 0, 4), (7, 1, 7), (7, 0, 7), (8, 1, 1),
           (12, 1, 1), (12, 1, 2), (12, 0, 6), (12, 1, 9), (12, 1, 4),
           (12, 0, 22), (15, 1, 1), (15, 0, 1), (16, 1, 1), (0, 0, 2)]


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("chroma", ["4:4:4", "4:2:2", "4:2:0"])
def test_yuv_to_rgb_matrices_every_sample_value(chroma, depth, alpha,
                                                tmp_path):
    """The writer's lossless files whose Y, U and V each take every sample
    value of their depth, under each matrix, range and primaries of
    ``COLOURS`` (in the sequence header and the colr box), 4:4:4, 4:2:2
    and 4:2:0, with and without alpha: libavif's libyuv paths (BT.709 and
    BT.2020 constants, limited-range BT.601; 4:2:2 chroma upsampled along
    rows; 12-bit 4:2:2 with alpha shifted to 8 bits) and its float paths
    (FCC, SMPTE 240, YCgCo, chroma-derived coefficients from the
    primaries, YCgCo-Re's integers, identity at limited range) through
    cv2.imread in both read modes, equal bit for bit, or refused where cv2
    refuses (YCgCo-Re at any depth but two bits above the output's)."""
    n = 1 << depth
    side = 128 if depth == 12 else 64  # every value in each plane
    H, W = side + 1, side + 3
    k = np.arange(H * W).reshape(H, W)
    Y = (k % n).astype(np.uint16)
    sub = {"4:4:4": 0, "4:2:0": 1, "4:2:2": 2}[chroma]
    Hc, Wc = ((H + 1) // 2 if sub == 1 else H), ((W + 1) // 2 if sub else W)
    c = np.arange(Hc * Wc).reshape(Hc, Wc)
    U = ((c // 3 if sub == 0 else c) % n).astype(np.uint16)
    V = ((c * 5 + 1) % n).astype(np.uint16)
    dtype = np.uint8 if depth == 8 else np.uint16
    a = ((k * 3) % n).astype(dtype) if alpha else None
    zero = np.zeros((H, W, 3), dtype)
    path = tmp_path / "p.avif"
    for matrix, full, primaries in COLOURS:
        if matrix == 0 and sub:
            continue
        path.write_bytes(avif.encode_avif(
            zero, depth, subsampling=chroma if sub else None, alpha=a,
            colour=(primaries, 13, matrix, full), planes=[Y, U, V]))
        same_as_cv2(path)


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_refused_matrices_follow_cv2(depth, tmp_path):
    """The colour descriptions libavif's YUV to RGB refuses, re-measured
    through cv2.imread: reserved and unsupported matrices (3, 10, 11, 13,
    14, 17 and up), YCgCo at limited range, YCgCo-Re but two bits above
    the output, subsampled colour labelled identity in its colr box:
    ValueError in both modes where cv2 returns None."""
    img = _natural(np.random.default_rng(depth), 24, 36)
    if depth > 8:
        img = img.astype(np.uint16) << (depth - 8)
    path = tmp_path / "r.avif"
    for matrix, full in ((3, 1), (10, 1), (11, 0), (13, 1), (14, 1),
                         (17, 1), (255, 0), (8, 0), (16, 1), (16, 0)):
        path.write_bytes(avif.encode_avif(img, depth, subsampling="4:2:0",
                                          colour=(1, 13, matrix, full)))
        same_as_cv2(path)
    data = avif.encode_avif(img, depth, subsampling="4:2:0")
    old = b"nclx" + bytes([0, 1, 0, 13, 0, 6, 0x80])
    assert old in data
    path.write_bytes(data.replace(old, b"nclx" + bytes([0, 2, 0, 13, 0, 0,
                                                        0x80])))
    assert cv2.imread(str(path)) is None
    same_as_cv2(path)


def _swap_obus(data: bytes, old: bytes, new: bytes) -> bytes:
    """The file with its colour item's OBUs ``old`` replaced by ``new``:
    the iloc extent's length and the mdat size updated."""
    import struct

    at = data.index(old)
    data = data[:at] + new + data[at + len(old):]
    k = data.index(struct.pack(">I", len(old)), data.index(b"iloc"))
    data = data[:k] + struct.pack(">I", len(new)) + data[k + 4:]
    m = data.index(b"mdat") - 4
    return data[:m] + struct.pack(">I", len(data) - m) + data[m + 4:]


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_monochrome_frame_in_a_colour_item(depth, tmp_path):
    """A colour item (its av1C and colr say 4:2:0 colour) whose AV1 frame
    is monochrome: libavif converts Y alone (R = G = B from Y, through its
    float path but at 8-bit full range under libyuv's constants), under
    each matrix and range, identity and YCgCo-Re included: equal to
    cv2.imread in both modes, or refused where cv2 refuses."""
    rng = np.random.default_rng(depth)
    H, W = 33, 47
    dtype = np.uint8 if depth == 8 else np.uint16
    img = rng.integers(0, 1 << depth, (H, W, 3)).astype(dtype)
    gray = rng.integers(0, 1 << depth, (H, W)).astype(np.uint16)
    path = tmp_path / "m.avif"
    for matrix, full in ((6, 1), (1, 1), (1, 0), (6, 0), (4, 1), (4, 0),
                         (9, 0), (8, 1), (12, 1), (15, 1), (16, 1), (0, 1),
                         (0, 0)):
        colour = (2 if matrix == 0 else 1, 13, matrix, full)
        sub = None if matrix == 0 else "4:2:0"
        planes = avif.yuv_planes(img, depth, sub, matrix, full) if sub else \
            [img[..., 1], img[..., 0], img[..., 2]]
        data = avif.encode_avif(img, depth, subsampling=sub, colour=colour,
                                planes=planes)
        old = avif.encode_av1(planes, depth, 0, sub or 0, colour=colour)
        new = avif.encode_av1([gray], depth, 0, colour=(
            colour[0], 13, matrix or 2, full))
        path.write_bytes(_swap_obus(data, old, new))
        same_as_cv2(path)
