"""The port's Radiance HDR reader (lgu_slam_tpu_torch/data/hdr.py,
scanlines and the float gray in csrc/host/hdr_rgbe.c) and Sun raster
reader (data/sunras.py) against cv2.imread (OpenCV 5.0), bit for bit in
both read modes: HDR files of cv2.imwrite and of the port's encoder in
run-length, flat and old-style run-length form, values above 1 and at the
exponents' extremes, header variants, HDR read with IMREAD_ANYDEPTH as
float32; Sun raster at depths 1, 8, 24 and 32, types 0-3 (byte-encoded
and RGB-order files are refused, as OpenCV refuses them), with and
without colour maps; odd sizes; every prefix and 200 mutations of small
files of each."""

import cv2
import numpy as np
import pytest
from torch_port import damaged_same_as_cv2, same_as_cv2

from lgu_slam_tpu_torch.data import hdr, image_io, sunras

HDR_SIZES = ((1, 1), (17, 33), (9, 8), (5, 7), (6, 40))


def _check(data: bytes, tmp_path, readable=True, name="a.img"):
    path = tmp_path / name
    path.write_bytes(data)
    assert (cv2.imread(str(path)) is not None) == readable
    same_as_cv2(path)


@pytest.mark.parametrize("form", ["cv2", "new", "flat", "old"])
def test_hdr_matches_cv2(form, tmp_path):
    """Random float images (values to 3, a pixel above 255, one of 1e-3)
    written by cv2.imwrite or by the port's encoder in each scanline form:
    cv2.imread's arrays exactly (uint8 colour, float32 gray with
    IMREAD_ANYDEPTH)."""
    rng = np.random.default_rng(len(form))
    for H, W in HDR_SIZES:
        f = (rng.random((H, W, 3)) * 3).astype(np.float32)
        f[0, 0] = (300.0, 1e-3, 5.0)
        if form == "cv2":
            path = str(tmp_path / "c.hdr")
            assert cv2.imwrite(path, f)
            data = open(path, "rb").read()
        else:
            data = hdr.encode_hdr(f, rle=form)
        _check(data, tmp_path)
        (tmp_path / "a.img").write_bytes(data)
        assert image_io.imread(str(tmp_path / "a.img"),
                               anydepth=True).dtype == np.float32


def test_hdr_extremes_and_gray_rows(tmp_path):
    """Exponents 0 (black) and 255, denormal results, values whose 255 f
    overflows (OpenCV reads 0 for them), and rows of every width from 1
    to 40 (the float gray's row loop): cv2's arrays."""
    f = np.array([[[1e30, 2, 3], [1e-40, 0, 1], [0.5, 0.5, 0.5],
                   [255, 255, 255], [8.4e6, 0, 0], [1e10, 0, 0],
                   [1e38, 1, 1], [1, 1, 1]]], np.float32)
    _check(hdr.encode_hdr(f, rle="flat"), tmp_path)
    rng = np.random.default_rng(1)
    for W in range(1, 41):
        _check(hdr.encode_hdr((rng.random((3, W, 3)) * 4
                               ).astype(np.float32)), tmp_path)


@pytest.mark.parametrize("header, readable", [
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 +X 9\n", True),
    (b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 +X 9\n", True),
    (b"#?RADIANCE\nGAMMA=2.2\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=2\n\n"
     b"-Y 3 +X 9\n", True),
    (b"#?RADIANCE\n# " + b"x" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n"
     b"-Y 3 +X 9\n", True),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y  3 +X  9 tail\n", True),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y3+X9\n", True),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 3 +X 9\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n-Y 3 +X 9\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 3 +X 9\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 -X 9\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+X 9 -Y 3\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 3 -X 9\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+X 9 +Y 3\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-X 9 +Y 3\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-X 9 -Y 3\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 0 +X 9\n", False),
    (b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 3 +X 9\n", False),
    (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\0\n-Y 3 +X 9\n", False),
])
def test_hdr_headers_follow_cv2(header, readable, tmp_path):
    """Header lines as OpenCV's RGBE_ReadHeader takes them: either magic,
    other lines around the format line, long lines (fgets' 128 bytes),
    spacing in the size line; XYZE, no blank line, the other seven
    orientations, a zero size, CR LF ends and a NUL byte are no image."""
    rng = np.random.default_rng(2)
    f = (rng.random((3, 9, 3)) * 2).astype(np.float32)
    body = hdr.encode_hdr(f)
    pixels = body[body.index(b"+X 9\n") + 5:]
    _check(header + pixels, tmp_path, readable)


def test_hdr_damage_follows_cv2(tmp_path):
    """Every prefix and 200 mutations of a small run-length HDR file of
    cv2.imwrite and of a flat one of the port's."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "c.hdr")
    assert cv2.imwrite(path, (rng.random((4, 11, 3)) * 2).astype(np.float32))
    damaged_same_as_cv2(open(path, "rb").read(), tmp_path, 200, seed=5)
    damaged_same_as_cv2(hdr.encode_hdr(
        (rng.random((3, 5, 3)) * 2).astype(np.float32), rle="flat"),
        tmp_path, 200, seed=6)


def _sun_cases(rng, H, W):
    im = rng.integers(0, 256, (H, W, 3), np.uint8)
    g = rng.integers(0, 256, (H, W), np.uint8)
    bits = rng.integers(0, 2, (H, W), np.uint8)
    cmap = rng.integers(0, 256, (256, 3), np.uint8)
    gray_map = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    readable = [
        sunras.encode_sunras(im), sunras.encode_sunras(im, depth=32),
        sunras.encode_sunras(im, kind=sunras.RT_OLD), sunras.encode_sunras(g),
        sunras.encode_sunras(g, colormap=cmap),
        sunras.encode_sunras(g, colormap=gray_map),
        sunras.encode_sunras(g % 16, colormap=cmap[:16]),
        sunras.encode_sunras(g, colormap=cmap[:16]),
        sunras.encode_sunras(bits, depth=1),
        sunras.encode_sunras(bits, depth=1, colormap=cmap[:2])]
    refused = [
        sunras.encode_sunras(g, kind=sunras.RT_BYTE_ENCODED),
        sunras.encode_sunras(bits, depth=1, kind=sunras.RT_BYTE_ENCODED),
        sunras.encode_sunras(im, kind=sunras.RT_FORMAT_RGB),
        sunras.encode_sunras(im, depth=32, kind=sunras.RT_FORMAT_RGB),
        sunras.encode_sunras(im, colormap=cmap[:4]),
        sunras.encode_sunras(g, colormap=cmap, maptype=2)]
    return readable, refused


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (17, 33), (4, 16)])
def test_sunras_matches_cv2(size, tmp_path):
    """Depths 1, 8, 24 and 32 of the old and standard types, with colour
    maps (full, 16 entries, gray) and without, and cv2.imwrite's files:
    cv2.imread's arrays (a depth-1 or depth-8 file without a map reads as
    zeros in gray, as OpenCV reads it); the byte-encoded and RGB-order
    types, a map beside 24-bit pixels and a raw map type: refused."""
    rng = np.random.default_rng(size[1])
    readable, refused = _sun_cases(rng, *size)
    for data in readable:
        _check(data, tmp_path)
    for data in refused:
        _check(data, tmp_path, readable=False)
    for img in (rng.integers(0, 256, size + (3,), np.uint8),
                rng.integers(0, 256, size, np.uint8)):
        path = str(tmp_path / "c.ras")
        assert cv2.imwrite(path, img)
        same_as_cv2(path)


def test_sunras_damage_follows_cv2(tmp_path):
    """Every prefix and 200 mutations of a small colour-map file and of a
    32-bit one."""
    rng = np.random.default_rng(8)
    damaged_same_as_cv2(sunras.encode_sunras(
        rng.integers(0, 256, (3, 5), np.uint8),
        colormap=rng.integers(0, 256, (16, 3), np.uint8)), tmp_path, 200,
        seed=7)
    damaged_same_as_cv2(sunras.encode_sunras(
        rng.integers(0, 256, (3, 5, 3), np.uint8), depth=32), tmp_path,
        200, seed=8)
