"""The port's PNG and BMP codecs (lgu_slam_tpu_torch/data/image_io.py)
against OpenCV: PNGs written by ``cv2.imwrite`` decode bit-identically to
``cv2.imread`` (with and without ``IMREAD_ANYDEPTH``, colour files then
converting to gray as OpenCV's PNG reader does), ``cv2.imread`` reads the
port's PNGs under every filter type bit-identically, the modes that
``cv2.imwrite`` does not write (palette with and without tRNS, gray at bit
depths 1, 2 and 4, Adam7 interlacing at every depth and colour type) decode
as ``cv2.imread`` decodes the port's own fixtures of them and equal their
pixels, uncompressed BMPs (8-bit palette, 24- and 32-bit, bottom-up and
top-down) decode as ``cv2.imread`` decodes them, the C row unfilter equals
its numpy version, and what the port does not read raises."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from torch_port import torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data import image_io
from lgu_slam_tpu_torch.ops import _build


def _images(kind, rng):
    """Fixtures of one kind, at odd and even widths, random and smooth."""
    out = []
    for H, W in ((5, 7), (17, 33), (24, 1), (31, 64)):
        noise = rng.integers(0, 256, (H, W, 4))
        smooth = np.cumsum(rng.integers(-3, 4, (H, W, 4)), axis=1) + 128
        for im in (noise, smooth):
            im8 = (im % 256).astype(np.uint8)
            out.append({
                "bgr8": im8[..., :3],
                "gray8": im8[..., 0],
                "bgra8": im8,
                "gray16": (im8[..., 0].astype(np.uint16) * 257 + 3),
                "bgr16": (im8[..., :3].astype(np.uint16) * 251 + 7),
                "bgra16": (im8.astype(np.uint16) * 255 + 11),
            }[kind])
    return out


@pytest.mark.parametrize("kind", ["bgr8", "gray8", "bgra8", "gray16",
                                  "bgr16", "bgra16"])
def test_decodes_cv2_pngs_bit_identically(kind, tmp_path):
    """cv2.imwrite at compression levels 0, 1, 9 and every zlib strategy
    (libpng picks its filters per row): the port's imread equals
    cv2.imread exactly (dtype, shape, values); with anydepth it equals
    IMREAD_ANYDEPTH, which converts colour files to gray (libpng's
    rgb_to_gray).  16-bit samples read without anydepth keep their high
    byte, as OpenCV's decoder does (16-bit RGB(A) fixtures)."""
    rng = np.random.default_rng(1)
    for k, im in enumerate(_images(kind, rng)):
        for level in (0, 1, 9):
            for strategy in range(4):
                path = str(tmp_path / f"{k}_{level}_{strategy}.png")
                assert cv2.imwrite(path, im, [
                    cv2.IMWRITE_PNG_COMPRESSION, level,
                    cv2.IMWRITE_PNG_STRATEGY, strategy])
                ref = cv2.imread(path)
                got = image_io.imread(path)
                assert got.dtype == ref.dtype and got.shape == ref.shape
                np.testing.assert_array_equal(got, ref)
                ref = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
                got = image_io.imread(path, anydepth=True)
                assert got.dtype == ref.dtype and got.shape == ref.shape
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("filter_type", range(5))
def test_cv2_reads_the_port_png(filter_type, tmp_path):
    """Every row filtered with one type: cv2.imread(IMREAD_UNCHANGED) gives
    back the array written, bit for bit, and so does the port."""
    rng = np.random.default_rng(2)
    for kind in ("bgr8", "gray8", "bgra8", "gray16", "bgr16"):
        for k, im in enumerate(_images(kind, rng)):
            path = str(tmp_path / f"{kind}_{k}.png")
            image_io.imwrite(path, im, filter_type=filter_type)
            np.testing.assert_array_equal(
                cv2.imread(path, cv2.IMREAD_UNCHANGED), im)
            back = image_io.decode_png(open(path, "rb").read())
            order = [2, 1, 0, 3][:im.shape[-1]] if im.ndim == 3 else [0]
            np.testing.assert_array_equal(
                back[..., np.argsort(order)].reshape(im.shape), im)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_c_unfilter_equals_numpy(bpp):
    """Random bytes with a random filter type per row (rows shorter than
    a pixel included): the C unfilter equals the numpy one exactly."""
    rng = np.random.default_rng(bpp)
    for height, rowbytes in ((1, bpp), (7, 5 * bpp), (9, 37 * bpp),
                             (3, 1)):
        rows = rng.integers(0, 256, (height, rowbytes + 1), dtype=np.uint8)
        rows[:, 0] = rng.integers(0, 5, height)
        raw = rows.tobytes()
        np.testing.assert_array_equal(
            image_io.unfilter(raw, height, rowbytes, bpp),
            image_io.unfilter_plain(raw, height, rowbytes, bpp))


def test_bad_filter_type_raises():
    raw = bytes([0, 1, 2, 5, 3, 4])
    with pytest.raises(ValueError, match="row 1"):
        image_io.unfilter(raw, 2, 2, 1)
    with pytest.raises(ValueError, match="row 1"):
        image_io.unfilter_plain(raw, 2, 2, 1)


def _patch_ihdr(png: bytes, offset: int, value: int) -> bytes:
    """Set one byte of the IHDR body (offset from its start) and refresh
    the chunk's CRC."""
    body = bytearray(png[16:29])
    body[offset] = value
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
    return png[:16] + bytes(body) + crc + png[33:]


def test_what_the_port_does_not_read_raises(tmp_path):
    """Formats other than PNG, JPEG and BMP (TIFF, WebP, which cv2 reads
    here): NotImplementedError (JPEG's own refusals:
    tests/test_torch_jpeg.py), as for RLE-compressed and 16-bit BMPs and
    OS/2 BMP headers;
    a PNG whose header names a palette but holds no PLTE, Adam7 passes
    that the data does not hold, or a bit depth its colour type does not
    allow: ValueError; a missing file: FileNotFoundError (OpenCV returns
    None)."""
    im = np.random.default_rng(3).integers(0, 256, (8, 12, 3), np.uint8)
    for ext in (".tiff", ".webp"):
        other = str(tmp_path / f"a{ext}")
        assert cv2.imwrite(other, im) and cv2.imread(other) is not None
        with pytest.raises(NotImplementedError,
                           match="only PNG, JPEG and BMP"):
            image_io.imread(other)
        with pytest.raises(NotImplementedError,
                           match="only PNG and JPEG files are written"):
            image_io.imwrite(other, im)
    bmp = bytearray(image_io.encode_bmp(im[..., 0]))
    for value, words in ((1, "RLE8"), (2, "RLE4")):
        bmp[30] = value
        (tmp_path / "rle.bmp").write_bytes(bytes(bmp))
        with pytest.raises(NotImplementedError, match=words):
            image_io.imread(str(tmp_path / "rle.bmp"))
    bmp[30], bmp[28] = 0, 16
    (tmp_path / "b16.bmp").write_bytes(bytes(bmp))
    with pytest.raises(NotImplementedError, match="16-bit BMP"):
        image_io.imread(str(tmp_path / "b16.bmp"))
    bmp[14] = 12  # the OS/2 core header's size
    (tmp_path / "os2.bmp").write_bytes(bytes(bmp))
    with pytest.raises(NotImplementedError, match="header of 12 bytes"):
        image_io.imread(str(tmp_path / "os2.bmp"))
    png = image_io.encode_png(im)
    for offset, value, match in ((9, 3, "PLTE"), (12, 1, "image data"),
                                 (8, 4, "bit depth")):
        path = tmp_path / f"bad{offset}.png"
        path.write_bytes(_patch_ihdr(png, offset, value))
        with pytest.raises(ValueError, match=match):
            image_io.imread(str(path))
    corrupt = bytearray(png)
    corrupt[40] ^= 0xFF
    (tmp_path / "corrupt.png").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="corrupt"):
        image_io.imread(str(tmp_path / "corrupt.png"))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.png"))


SIZES = ((1, 1), (3, 5), (9, 17), (33, 40))


def _same_as_cv2(path, source=None):
    """imread equals cv2.imread with and without IMREAD_ANYDEPTH (dtype,
    shape, values), and the colour read equals ``source`` (BGR)."""
    for anydepth in (False, True):
        ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                         else cv2.IMREAD_COLOR)
        got = image_io.imread(str(path), anydepth=anydepth)
        assert ref is not None
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    if source is not None:
        np.testing.assert_array_equal(image_io.imread(str(path)), source)


@pytest.mark.parametrize("mode", ["gray", "palette", "palette_trns"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_and_low_depth_pngs(mode, depth, tmp_path):
    """The port's fixtures (``encode_png`` with ``bit_depth``,
    ``palette``, ``trns``; Adam7 and not, every filter type): cv2.imread
    reads them as the port does, and their colour read is the pixels they
    were written from: gray expanded as libpng expands it (x 255, 85, 17 at
    1, 2, 4 bits), palette entries by PLTE, tRNS dropped with the alpha."""
    rng = np.random.default_rng(depth)
    path = tmp_path / "p.png"
    for H, W in SIZES:
        idx = rng.integers(0, 1 << depth, (H, W), np.uint8)
        pal = rng.integers(0, 256, (1 << depth, 3), np.uint8)
        trns = rng.integers(0, 256, min(5, 1 << depth), np.uint8)
        if mode == "gray":
            kw = dict(bit_depth=depth)
            scale = np.uint8(255 // ((1 << depth) - 1))
            source = np.repeat((idx * scale)[..., None], 3, -1)
        else:
            kw = dict(bit_depth=depth, palette=pal,
                      trns=trns if mode == "palette_trns" else None)
            source = pal[idx]
        for interlace in (False, True):
            for filter_type in range(5):
                path.write_bytes(image_io.encode_png(
                    idx, filter_type, interlace=interlace, **kw))
                _same_as_cv2(path, source)


@pytest.mark.parametrize("kind", ["bgr8", "gray8", "bgra8", "gray16",
                                  "bgr16", "bgra16"])
def test_adam7_pngs(kind, tmp_path):
    """Adam7 interlacing at every bit depth and colour type read before
    (the Adam7 passes of images from 1 x 1, where six passes are empty, to
    33 x 40), every filter type: as cv2.imread reads them, with and
    without anydepth."""
    rng = np.random.default_rng(7)
    path = tmp_path / "i.png"
    for H, W in SIZES:
        im = _images(kind, rng)[0]
        im = np.resize(im, (H, W) + im.shape[2:]).astype(im.dtype)
        for filter_type in range(5):
            path.write_bytes(image_io.encode_png(im, filter_type,
                                                 interlace=True))
            _same_as_cv2(path)
            if im.dtype == np.uint8:
                src = im if im.ndim == 3 else np.repeat(im[..., None], 3, -1)
                np.testing.assert_array_equal(image_io.imread(str(path)),
                                              src[..., :3])


def test_cv2_bilevel_png(tmp_path):
    """cv2.imwrite's 1-bit gray files (IMWRITE_PNG_BILEVEL)."""
    rng = np.random.default_rng(8)
    for H, W in SIZES:
        path = tmp_path / "b.png"
        im = rng.integers(0, 256, (H, W), np.uint8)
        assert cv2.imwrite(str(path), im, [cv2.IMWRITE_PNG_BILEVEL, 1])
        assert path.read_bytes()[24] == 1  # IHDR bit depth
        _same_as_cv2(path)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmps(channels, tmp_path):
    """Uncompressed BMPs with rows padded to 4 bytes: cv2.imwrite's
    (bottom-up; 8-bit gray palette, 24-bit, 32-bit with BGRA bit masks and
    a 124-byte header) and the port's ``encode_bmp`` (40-byte header,
    bottom-up and top-down; 8-bit with a colour palette of 40 entries):
    as cv2.imread reads them, with and without anydepth, and the pixels
    written."""
    rng = np.random.default_rng(channels)
    path = tmp_path / "a.bmp"
    for H, W in SIZES:
        im = rng.integers(0, 256, (H, W, channels), np.uint8)
        if channels == 1:
            im = im[..., 0]
        source = im[..., :3] if im.ndim == 3 else np.repeat(im[..., None],
                                                            3, -1)
        assert cv2.imwrite(str(path), im)
        _same_as_cv2(path, source)
        for top_down in (False, True):
            path.write_bytes(image_io.encode_bmp(im, top_down))
            _same_as_cv2(path, source)
            if channels == 1:
                pal = rng.integers(0, 256, (40, 3), np.uint8)
                idx = rng.integers(0, 40, (H, W), np.uint8)
                path.write_bytes(image_io.encode_bmp(idx, top_down, pal))
                _same_as_cv2(path, pal[idx])


def test_failed_c_build_raises(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and raises: nothing falls
    back to the numpy unfilter."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="png_unfilter.c"):
        image_io.unfilter(bytes([0, 1]), 1, 1, 1)
    assert not os.path.exists(tmp_path / "libpng_unfilter.so")
