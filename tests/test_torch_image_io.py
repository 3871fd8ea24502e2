"""The port's PNG and BMP codecs (lgu_slam_tpu_torch/data/image_io.py)
against OpenCV: PNGs written by ``cv2.imwrite`` decode bit-identically to
``cv2.imread`` (with and without ``IMREAD_ANYDEPTH``, colour files then
converting to gray as OpenCV's PNG reader does), ``cv2.imread`` reads the
port's PNGs under every filter type bit-identically, the modes that
``cv2.imwrite`` does not write (palette with and without tRNS, gray at bit
depths 1, 2 and 4, Adam7 interlacing at every depth and colour type) decode
as ``cv2.imread`` decodes the port's own fixtures of them and equal their
pixels, BMPs (1-, 4- and 8-bit palettes, RLE8 and RLE4, 16-, 24- and
32-bit, bottom-up and top-down, OS/2 headers) decode as ``cv2.imread``
decodes them, the C row unfilter equals its numpy version, ``imread``
picks its decoder by the file's signature, and what the port does not
read raises."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from torch_port import (  # noqa: F401
    C2_KINDS,
    same_as_cv2,
    torch_single_thread,
)

from lgu_slam_tpu_torch.data import avif, image_io
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


def test_what_the_port_does_not_read_raises(tmp_path, monkeypatch):
    """The format this OpenCV build reads that the port does not read
    (an AVIF frame larger than its ispe, which cv2.imread reads scaled
    down and the port does not decode past ``avif.SCALED_PIXELS``, lowered
    here; items of two AV1 frames, image sequences, film grain, grids
    and scaled frames read;
    cv2.imwrite's default AVIF reads since lossy AV1 does, and its files at
    speed 0, whose frames use loop restoration, since restoration does):
    NotImplementedError naming the format, whatever the file's extension;
    a
    signature no decoder of cv2's claims, and an empty file: ValueError
    (cv2 returns None); imwrite writes PNG and JPEG only.  The files the
    port's first decoders refused and now reads (JPEG 2000 as JP2 and as a
    codestream, under its own extension and another, TIFF, RLE-compressed
    and 16-bit BMPs, a header patched to OS/2's size) read as cv2 reads
    them; a PNG whose header names a palette but holds no PLTE, Adam7
    passes that the data does not hold, or a bit depth its colour type
    does not allow: ValueError; a missing file: FileNotFoundError (OpenCV
    returns None).  (WebP, GIF, Radiance HDR, Sun raster and JPEG 2000
    read now: tests/test_torch_webp.py, test_torch_gif.py,
    test_torch_hdr_sunras.py, test_torch_jp2.py.)"""
    im = np.random.default_rng(3).integers(0, 256, (64, 64, 3), np.uint8)
    assert cv2.imwrite(str(tmp_path / "d.avif"), im)
    assert np.array_equal(image_io.imread(str(tmp_path / "d.avif")),
                          cv2.imread(str(tmp_path / "d.avif")))
    y, x = np.mgrid[0:48, 0:64]
    scene = np.clip(np.stack([
        np.sin(x / (5.0 + c)) * 60 + np.cos(y / (4.0 + c)) * 50 + 120
        + ((x // 9 + y // 7) % 2) * 30 for c in range(3)], -1)
        + np.random.default_rng(50).normal(0, 4, (48, 64, 3)), 0,
        255).astype(np.uint8)
    restored = str(tmp_path / "r.avif")
    assert cv2.imwrite(restored, scene, [cv2.IMWRITE_AVIF_QUALITY, 50,
                                         cv2.IMWRITE_AVIF_SPEED, 0])
    assert np.array_equal(image_io.imread(restored), cv2.imread(restored))
    formats = {".avif": "AVIF"}
    ispe = b"ispe" + bytes(4) + struct.pack(">II", 64, 48)
    larger = avif.encode_avif(scene).replace(
        ispe, b"ispe" + bytes(4) + struct.pack(">II", 32, 24))
    monkeypatch.setattr(avif, "SCALED_PIXELS", 1000)
    for ext, name in formats.items():
        other = str(tmp_path / f"a{ext}")
        with open(other, "wb") as fh:
            fh.write(larger)
        assert cv2.imread(other) is not None
        for path in (other, other + ".png"):
            os.replace(other if path != other else other, path)
            with pytest.raises(NotImplementedError, match=name):
                image_io.imread(path)
            os.replace(path, other)
        with pytest.raises(NotImplementedError,
                           match="only PNG and JPEG files are written"):
            image_io.imwrite(other, im)
    assert cv2.imwrite(str(tmp_path / "a.jp2"), im)
    jp2 = (tmp_path / "a.jp2").read_bytes()
    (tmp_path / "a.j2k").write_bytes(jp2[jp2.index(b"\xff\x4f\xff\x51"):])
    assert cv2.imread(str(tmp_path / "a.j2k")) is not None
    for name in ("a.jp2", "a.j2k"):
        same_as_cv2(tmp_path / name)
        (tmp_path / "b.png").write_bytes((tmp_path / name).read_bytes())
        same_as_cv2(tmp_path / "b.png")
    for data in (b"", b"hello, world", b"\x76\x2f\x31\x01" + bytes(60)):
        (tmp_path / "x.png").write_bytes(data)
        assert cv2.imread(str(tmp_path / "x.png")) is None
        with pytest.raises(ValueError, match="signature"):
            image_io.imread(str(tmp_path / "x.png"))
    tif = str(tmp_path / "a.tiff")
    assert cv2.imwrite(tif, im)
    same_as_cv2(tif)
    bmp = bytearray(image_io.encode_bmp(im[..., 0]))
    for value in (1, 2):  # RLE8, RLE4 over uncompressed rows
        bmp[30] = value
        (tmp_path / "rle.bmp").write_bytes(bytes(bmp))
        same_as_cv2(tmp_path / "rle.bmp")
    bmp[30], bmp[28] = 0, 16
    (tmp_path / "b16.bmp").write_bytes(bytes(bmp))
    same_as_cv2(tmp_path / "b16.bmp")
    bmp[14] = 12  # the OS/2 core header's size
    (tmp_path / "os2.bmp").write_bytes(bytes(bmp))
    same_as_cv2(tmp_path / "os2.bmp")
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


@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_bmp_palettes_and_rle(bpp, tmp_path):
    """1-, 4- and 8-bit palette BMPs (a colour palette and the gray ramp,
    40-byte and OS/2 12-byte headers, bottom-up and top-down) and the
    port's RLE4 / RLE8 of them (encoded runs, absolute runs padded to a
    word, end-of-line, end-of-bitmap): as cv2.imread reads them, and the
    pixels written."""
    rng = np.random.default_rng(bpp)
    path = tmp_path / "p.bmp"
    for H, W in SIZES:
        idx = rng.integers(0, 1 << bpp, (H, W), np.uint8)
        idx[:, W // 3:] = idx[:, W // 3:W // 3 + 1]  # runs for RLE
        pal = rng.integers(0, 256, (1 << bpp, 3), np.uint8)
        for top_down in (False, True):
            for os2 in (False, True)[:2 - top_down]:  # OS/2: bottom-up
                for palette in (pal, None):
                    path.write_bytes(image_io.encode_bmp(
                        idx, top_down, palette, bpp=bpp, os2=os2))
                    same_as_cv2(path)
                path.write_bytes(image_io.encode_bmp(idx, top_down, pal,
                                                     bpp=bpp, os2=os2))
                np.testing.assert_array_equal(image_io.imread(str(path)),
                                              pal[idx])
            if bpp > 1:
                path.write_bytes(image_io.encode_bmp(idx, top_down, pal,
                                                     bpp=bpp, rle=True))
                same_as_cv2(path)
                np.testing.assert_array_equal(image_io.imread(str(path)),
                                              pal[idx])


# RLE data of a 6 x 3 image: (name, RLE8 data, RLE4 data)
RLE_STREAMS = {
    "end_of_line_each_row": (b"\x06\x05\0\0\x06\x06\0\0\x06\x07\0\x01",
                             b"\x06\x12\0\0\x06\x34\0\0\x06\x56\0\x01"),
    "rows_filled_exactly": (b"\x06\x05\x06\x06\x06\x07",
                            b"\x06\x12\x06\x34\x06\x56"),
    "end_of_line_after_full_rows": (
        b"\x06\x05\0\0\x06\x06\0\0\x06\x07\0\0",
        b"\x06\x12\0\0\x06\x34\0\0\x06\x56\0\0"),
    "run_past_row_end": (b"\x08\x05\0\x01", b"\x08\x12\0\x01"),
    "short_rows": (b"\x02\x05\0\0\x03\x06\0\x01",
                   b"\x02\x12\0\0\x03\x34\0\x01"),
    "end_of_bitmap_early": (b"\x02\x05\0\x01", b"\x02\x12\0\x01"),
    "delta": (b"\x02\x05\0\x02\x02\x01\x01\x09\0\x01",
              b"\x02\x12\0\x02\x02\x01\x01\x39\0\0\0\0\0\x01"),
    "delta_rows_only": (b"\0\x02\0\x01\x06\x07\0\x01",
                        b"\0\x02\0\x01\x06\x77\0\0\0\0"),
    "absolute": (b"\0\x03\x01\x02\x03\0\x02\x05\0\0\0\x01",
                 b"\0\x03\x12\x30\0\0\0\0\0\x01"),
    "absolute_odd": (b"\0\x05\x01\x02\x03\x04\x05\0\0\0\0\0\0\x01",
                     b"\0\x05\x12\x34\x50\0\0\0\0\0\0\x01"),
    "absolute_past_row_end": (b"\0\x07\x01\x02\x03\x04\x05\x06\x07\0",
                              b"\0\x07\x12\x34\x56\x70\0\0"),
    "absolute_fills_row": (
        b"\0\x06\x01\x02\x03\x04\x05\x06\0\0\x02\x03\0\x01",
        b"\0\x06\x12\x34\x56\0\0\0\0\0\0\x01"),
    "data_ends_early": (b"\x06\x05\x06\x06", b"\x06\x12\x06\x34"),
    "absolute_cut_short": (b"\0\x05\x01\x02", b"\0\x05\x12"),
    "end_of_line_first": (b"\0\0\x06\x05\0\x01", b"\0\0\x06\x12\0\x01"),
    "two_end_of_lines": (b"\x06\x05\0\0\0\0\0\x01",
                         b"\x06\x12\0\0\0\0\0\x01"),
}


@pytest.mark.parametrize("name", list(RLE_STREAMS))
def test_bmp_rle_streams(name, tmp_path):
    """Hand-written RLE8 and RLE4 data of one case each (runs that fill a
    row exactly or pass its end, end-of-line after a full row, deltas,
    absolute runs of odd length or past the row end, data that ends
    early), bottom-up and top-down: as cv2.imread reads them, ValueError
    where it returns None."""
    rng = np.random.default_rng(21)
    path = tmp_path / "r.bmp"
    z = np.zeros((3, 6), np.uint8)
    for bpp, data in zip((8, 4), RLE_STREAMS[name]):
        pal = rng.integers(0, 256, (1 << bpp, 3), np.uint8)
        for top_down in (False, True):
            path.write_bytes(image_io.encode_bmp(z, top_down, pal, bpp=bpp,
                                                 rle_data=data))
            same_as_cv2(path)


@pytest.mark.parametrize("mode", ["555", "565", "555_bitfields"])
def test_bmp_16bit(mode, tmp_path):
    """16-bit BMPs (5-5-5 without masks, 5-5-5 and 5-6-5 bit masks): each
    field shifted left to 8 bits as OpenCV shifts it, as cv2.imread reads
    them; other 16-bit masks: ValueError (cv2 returns None)."""
    rng = np.random.default_rng(4)
    path = tmp_path / "s.bmp"
    masks = {"555": None, "565": "565", "555_bitfields": "555"}[mode]
    for H, W in SIZES:
        im = rng.integers(0, 256, (H, W, 3), np.uint8)
        for top_down in (False, True):
            path.write_bytes(image_io.encode_bmp(im, top_down, bpp=16,
                                                 masks16=masks))
            same_as_cv2(path)
    if masks:
        data = bytearray(path.read_bytes())
        data[54:58] = struct.pack("<I", 0xF00)
        path.write_bytes(bytes(data))
        same_as_cv2(path)


def test_cv2_bitfield_bmps(tmp_path):
    """cv2.imwrite with IMWRITE_BMP_COMPRESSION_BITFIELDS and RGB, gray,
    BGR and BGRA: as cv2.imread reads them."""
    rng = np.random.default_rng(6)
    path = tmp_path / "c.bmp"
    for H, W in SIZES:
        for ch in (1, 3, 4):
            im = rng.integers(0, 256, (H, W, ch), np.uint8)
            for comp in (cv2.IMWRITE_BMP_COMPRESSION_RGB,
                         cv2.IMWRITE_BMP_COMPRESSION_BITFIELDS):
                assert cv2.imwrite(str(path), im[..., 0] if ch == 1 else im,
                                   [cv2.IMWRITE_BMP_COMPRESSION, comp])
                same_as_cv2(path)


# 32-bit bit masks (red, green, blue[, alpha]): BGRA bytes, RGBA order,
# 10-10-10, 5-6-5 in 32 bits, overlapping, odd places, one mask zero
BMP_MASKS32 = {
    "bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    "rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
    "10_10_10": (0x3FF00000, 0xFFC00, 0x3FF),
    "5_6_5": (0xF800, 0x7E0, 0x1F),
    "overlapping": (0xFFFF00, 0xFFFF, 0xFF),
    "odd": (0x1F0, 0x7, 0xE0000),
    "red_zero": (0, 0xFF00, 0xFF),
}


@pytest.mark.parametrize("header", [40, 56, 108, 124])
@pytest.mark.parametrize("masks", list(BMP_MASKS32))
def test_bmp_32bit_masks(masks, header, tmp_path):
    """32-bit BI_BITFIELDS BMPs with every kind of mask, under 40-byte
    headers (the masks follow and OpenCV ignores them: BGRA bytes, the
    colour read's gray) and the V3 / V4 / V5 headers (the masks are
    applied, each field scaled to 8 bits in float32 and truncated, the gray
    in float32; with a zero mask none is), bottom-up and top-down: as
    cv2.imread reads them in both modes.  A 480 x 640 frame with BGRA masks
    reads exactly too (the case whose gray differed in 153,611 pixels
    before the gray was chosen by header size)."""
    rng = np.random.default_rng(header)
    path = tmp_path / "m.bmp"
    for H, W in SIZES + ((480, 640),) * (masks == "bgra"):
        im = rng.integers(0, 256, (H, W, 4), np.uint8)
        for top_down in (False, True):
            path.write_bytes(image_io.encode_bmp(
                im, top_down, masks32=BMP_MASKS32[masks], header=header))
            same_as_cv2(path)
    if header == 40 or masks == "red_zero":  # the bytes as they are
        np.testing.assert_array_equal(image_io.imread(str(path)),
                                      im[..., :3])


@pytest.mark.parametrize("fmt", ["png", "jpeg", "bmp", "tiff", "pgm", "ppm",
                                 "pam", "pfm"])
def test_decoder_picked_by_signature(fmt, tmp_path):
    """A file named for another format (each written by cv2.imwrite,
    stored under ``.jpg`` or ``.png``) reads by its signature, as cv2
    reads it; a file cut to its first 3 bytes: as cv2 reads it
    (ValueError)."""
    rng = np.random.default_rng(7)
    im = rng.integers(0, 256, (9, 13, 3), np.uint8)
    src = {"pgm": im[..., 0], "pfm": im.astype(np.float32)}.get(fmt, im)
    ext = {"jpeg": "jpg", "tiff": "tif"}.get(fmt, fmt)
    path = tmp_path / f"a.{ext}"
    assert cv2.imwrite(str(path), src)
    data = path.read_bytes()
    for name in ("b.jpg", "b.png", "b"):
        (tmp_path / name).write_bytes(data)
        same_as_cv2(tmp_path / name)
    (tmp_path / "c").write_bytes(data[:3])
    same_as_cv2(tmp_path / "c")


@pytest.mark.parametrize("mode", ["1-bit", "4-bit", "os2", "rle8", "rle4",
                                  "16-bit"])
def test_bmp_truncated(mode, tmp_path):
    """The new BMP modes cut at a dozen points (header, palette, pixel
    data, the last byte): as cv2.imread reads them, ValueError where it
    returns None."""
    rng = np.random.default_rng(9)
    H, W = 9, 17
    bpp = {"1-bit": 1, "4-bit": 4, "os2": 8, "rle8": 8, "rle4": 4}.get(mode)
    if bpp is None:
        data = image_io.encode_bmp(rng.integers(0, 256, (H, W, 3), np.uint8),
                                   bpp=16, masks16="565")
    else:
        idx = rng.integers(0, 1 << bpp, (H, W), np.uint8)
        idx[:, 5:] = idx[:, 5:6]
        data = image_io.encode_bmp(
            idx, palette=rng.integers(0, 256, (1 << bpp, 3), np.uint8),
            bpp=bpp, os2=mode == "os2", rle=mode.startswith("rle"))
    path = tmp_path / "t.bmp"
    for cut in sorted({2, 14, 20, 30, 54, 60, 70, len(data) // 2,
                       len(data) - 3, len(data) - 1}):
        path.write_bytes(data[:cut])
        same_as_cv2(path)


# -- which class each refusal takes --------------------------------------

def _tiff_patch(data: bytes, tag: int, value: int) -> bytes:
    """A classic little-endian TIFF with one SHORT tag's value set."""
    off, = struct.unpack_from("<I", data, 4)
    n, = struct.unpack_from("<H", data, off)
    raw = bytearray(data)
    for k in range(n):
        if struct.unpack_from("<H", data, off + 2 + 12 * k)[0] == tag:
            struct.pack_into("<H", raw, off + 2 + 12 * k + 8, value)
            return bytes(raw)
    raise KeyError(tag)


def _pil_tiff(compression: str, img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def _cv2_file(ext: str, img, tmp_path) -> bytes:
    path = str(tmp_path / f"w{ext}")
    src = img.astype(np.float32) / 255 if ext == ".hdr" else img
    assert cv2.imwrite(path, src)
    return open(path, "rb").read()


def _kind(name: str, tmp_path) -> bytes:
    """The bytes of one file kind of the classification below."""
    from lgu_slam_tpu_torch.data import tiff

    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (19, 27, 3), np.uint8)
    img[:, 12:] = np.arange(15, dtype=np.uint8)[None, :, None] * 9
    gray = img[..., 0]
    enc = image_io.encode_jpeg
    if name == "jpeg_12bit":
        raw = bytearray(enc(img))
        raw[raw.index(b"\xff\xc0") + 4] = 12
        return bytes(raw)
    if name.startswith("jpeg_lossless_") and name.endswith("bit"):
        p = int(name.split("_")[-1][:-3])
        return enc(gray.astype(np.uint16) << (p - 8), lossless=True,
                   precision=p)
    if name == "jpeg_lossless_gray8":
        return enc(gray, lossless=True, predictor=4)
    if name == "jpeg_lossless_rgb8":
        return enc(img, lossless=True, predictor=7)
    if name == "jpeg_sof11":
        return enc(gray, lossless=True).replace(b"\xff\xc3", b"\xff\xcb")
    if name == "jpeg_arithmetic":
        return enc(img, arithmetic=True)
    if name == "jpeg_arithmetic_progressive":
        return enc(img, arithmetic=True, progressive=True)
    if name == "jpeg_fractional":
        raw = bytearray(enc(img, subsampling="444"))
        sof = raw.index(b"\xff\xc0")
        raw[sof + 11], raw[sof + 14], raw[sof + 17] = 0x31, 0x21, 0x11
        return bytes(raw)
    if name == "jpeg_hierarchical":
        return enc(img).replace(b"\xff\xc0", b"\xff\xc5")
    if name.startswith("tiff_scheme_"):
        code, bits = (int(v) for v in name.split("_")[2:4])
        base = tiff.encode_tiff(gray >> 7, bilevel=True) if bits == 1 \
            else tiff.encode_tiff(gray)
        return _tiff_patch(base, 259, code)
    if name == "tiff_sgilog_gray":
        return _tiff_patch(tiff.encode_tiff(gray), 259, 34677)
    if name in ("tiff_group3", "tiff_group4", "tiff_ccitt"):
        return _pil_tiff(name[5:].replace("ccitt", "tiff_ccitt"),
                         gray > 128)
    if name == "tiff_old_style_lzw":
        raw = bytearray(tiff.encode_tiff(gray, "lzw"))
        tags = tiff._ifd(bytes(raw), "")[0]
        at, n = tags["strip_offsets"][0], tags["strip_counts"][0]
        raw[at:at + n] = b"\x00\x01" + rng.integers(0, 256, n - 2,
                                                    np.uint8).tobytes()
        return bytes(raw)
    if name == "tiff_gray_alpha":
        return tiff.encode_tiff(img[..., :2])
    if name == "tiff_logl":
        return tiff.encode_tiff(gray.astype(np.int16) * 60 + 9000, "sgilog")
    if name == "tiff_cmyk_16":
        return tiff.encode_tiff(np.concatenate(
            [img, gray[..., None]], -1).astype(np.uint16) * 257,
            photometric=5)
    if name == "tiff_ycbcr_2x4":
        return _tiff_patch(tiff.encode_tiff(img, photometric=6,
                                            subsampling=(2, 4)), 262, 6)
    if name == "tiff_palette_1":
        return tiff.encode_tiff(gray >> 7, bilevel=True, palette=rng.integers(
            0, 256, (2, 3), np.uint8))
    if name == "tiff_palette_16":
        return tiff.encode_tiff(gray.astype(np.uint16) * 199, palette=rng.
                                integers(0, 65536, (1 << 16, 3), np.uint16))
    if name == "tiff_old_jpeg_tags":
        jpg = enc(img, 90)
        return tiff.encode_tiff(img, photometric=6, chunks=[jpg], tags={
            259: (3, [6]), 513: (4, [8]), 514: (4, [len(jpg)])})
    if name.startswith("tiff_photometric_"):
        ph = int(name.split("_")[-1])
        src = np.concatenate([img, gray[..., None]], -1) if ph == 5 else \
            (gray if ph == 4 else img)
        return _tiff_patch(tiff.encode_tiff(src), 262, ph)
    if name == "tiff_no_photometric":
        return _tiff_patch(tiff.encode_tiff(gray), 262, 1).replace(
            b"\x06\x01\x03\x00", b"\x06\x7f\x03\x00")
    if name == "tiff_palette_without_colormap":
        return _tiff_patch(tiff.encode_tiff(gray), 262, 3)
    if name == "tiff_jpeg":
        return tiff.encode_tiff(img, "jpeg", rows_per_strip=8)
    if name == "tiff_bigtiff":
        return tiff.encode_tiff(img, bigtiff=True)
    if name.startswith("tiff_orientation_"):
        return tiff.encode_tiff(img, orientation=int(name[-1]))
    if name.startswith("tiff_format_"):
        fmt, bits = (int(v) for v in name.split("_")[2:4])
        base = tiff.encode_tiff(gray.astype({8: np.uint8, 16: np.uint16,
                                             32: np.uint32,
                                             64: np.uint64}[bits]))
        return _tiff_patch(base, 339, fmt)
    if name.startswith("tiff_c2_"):
        from torch_port import c2_tiff

        return c2_tiff(name[8:], img)
    if name == "tiff_predictor_3_uint32":
        return tiff.encode_tiff(gray.astype(np.uint32), "lzw", predictor=3)
    if name == "tiff_mixed_sample_format":
        return tiff.encode_tiff(img, tags={339: (3, [1, 1, 2])})
    if name == "tiff_short_strip":
        raw = img[..., ::-1].tobytes()
        return _tiff_patch(tiff.encode_tiff(img, chunks=[raw]), 279,
                           len(raw) // 2)
    if name == "tiff_jpeg_separate":
        return tiff.encode_tiff(img, "jpeg", planar=2, photometric=2,
                                rows_per_strip=8)
    if name == "tiff_ycbcr_tiles_predictor":
        return tiff.encode_tiff(img, "lzw", predictor=2, photometric=6,
                                tile=(16, 16))
    if name == "tiff_jpeg_short_strip":
        return tiff.encode_tiff(img, "jpeg", rows_per_strip=16,
                                jpeg_tables=False, chunks=[
                                    enc(img[:12]), enc(img[16:])])
    if name == "tiff_jpeg_16bit_lossless":
        g16 = gray.astype(np.uint16) * 257
        return tiff.encode_tiff(g16, chunks=[enc(g16, lossless=True,
                                                 precision=16)],
                                tags={259: (3, [7])})
    if name == "tiff_12bit":
        v = gray.astype(np.uint16) * 16
        bits = np.unpackbits((v << 4).astype(">u2").view(np.uint8).reshape(
            v.shape[0], -1, 2), axis=2)[..., :12].reshape(v.shape[0], -1)
        return tiff.encode_tiff(v, chunks=[np.packbits(bits, 1).tobytes()],
                                tags={258: (3, [12])})
    if name == "tiff_12bit_rgb":
        return tiff.encode_tiff((img.astype(np.uint16) * 16), twelve_bit=True)
    if name == "tiff_12bit_separate":
        return tiff.encode_tiff((img.astype(np.uint16) * 16), planar=2,
                                twelve_bit=True)
    if name == "tiff_logluv24_float_samples":
        return tiff.encode_tiff(rng.integers(0, 1 << 24, gray.shape).astype(
            np.uint32), "sgilog24", tags={258: (3, [32] * 3),
                                          339: (3, [3] * 3)})
    if name == "tiff_logluv24":
        return _tiff_patch(_tiff_patch(tiff.encode_tiff(img), 259, 34677),
                           262, 32845)
    if name == "tiff_logluv32":
        codes = rng.integers(0, 1 << 32, gray.shape, dtype=np.uint64)
        return _tiff_patch(_tiff_patch(tiff.encode_tiff(
            img.astype(np.uint16), chunks=[tiff.logl_encode(
                codes.astype(np.uint32), planes=4)]), 259, 34676), 262,
            32845)
    if name.startswith("jp2_ht"):
        from lgu_slam_tpu_torch.data import jp2

        return jp2.encode_jp2(img, ht=True, **{
            "jp2_ht": {}, "jp2_ht_97_magref": dict(irreversible=True,
                                                   refine=2),
            "jp2_ht_four_passes": dict(refine=2, placeholder=1)}[name])
    if name.startswith("avif_"):
        from lgu_slam_tpu_torch.data import avif

        if name == "avif_avis":
            from PIL import Image

            path = tmp_path / "s.avif"
            Image.fromarray(img).save(path, save_all=True, quality=100,
                                      append_images=[Image.fromarray(img)])
            return path.read_bytes()
        if name == "avif_grain":
            return avif.encode_avif(img, lossy=dict(base_q=60), grain=3)
        if name == "avif_grid":
            big = np.tile(img, (4, 5, 1))[:64, :128]
            from test_torch_avif import encode_grid

            return encode_grid([big[:, :64], big[:, 64:]], 2,
                               size=(120, 64))
        if name == "avif_scaled":
            H, W = img.shape[:2]
            return avif.encode_avif(img).replace(
                b"ispe" + bytes(4) + struct.pack(">II", W, H),
                b"ispe" + bytes(4) + struct.pack(">II", W + 9, H - 7))
        if name == "avif_two_frames":
            from test_torch_avif import two_frames

            return two_frames(img)
        if name == "avif_layered":
            import test_torch_avif  # noqa: F401 (puts scripts/ on the path)
            from make_avif_fixtures_torch import encode_layered

            return encode_layered([img, np.roll(img, 3, 1)], speed=6,
                                  qualities=[30, 70],
                                  scales=[(1, 2), (1, 1)])
        data = avif.encode_avif(gray.astype(np.uint16) * 16, 12) if \
            name == "avif_gray12" else avif.encode_avif(img)
        return data[:-300] if name == "avif_cut" else data
    if name == "pam_alpha":
        from lgu_slam_tpu_torch.data import pnm

        return pnm.encode_pam(np.concatenate([img, gray[..., None]], -1),
                              "RGB_ALPHA")
    ext = {"webp": ".webp", "jp2": ".jp2", "avif": ".avif", "gif": ".gif",
           "hdr": ".hdr", "sun_raster": ".ras"}[name]
    return _cv2_file(ext, rng.integers(0, 256, (64, 64, 3), np.uint8),
                     tmp_path)


# each file kind -> what cv2.imread does in its colour and its
# IMREAD_ANYDEPTH read: "read" (the port returns the same array), "queued"
# (an image the port does not read yet: NotImplementedError), "none"
# (cv2 returns None: ValueError)
CLASSES = {
    "jpeg_12bit": ("none", "none"),
    "jpeg_lossless_12bit": ("none", "none"),
    "jpeg_lossless_16bit": ("none", "none"),
    "jpeg_lossless_gray8": ("none", "read"),
    "jpeg_lossless_rgb8": ("read", "none"),
    "jpeg_sof11": ("none", "none"),
    "jpeg_arithmetic": ("read", "read"),
    "jpeg_arithmetic_progressive": ("read", "read"),
    "jpeg_fractional": ("none", "read"),
    "jpeg_hierarchical": ("none", "none"),
    "tiff_scheme_34925_8": ("none", "none"),  # LZMA
    "tiff_scheme_50000_8": ("none", "none"),  # ZSTD
    "tiff_scheme_50001_8": ("none", "none"),  # WebP
    "tiff_scheme_34887_8": ("none", "none"),  # LERC
    "tiff_scheme_34661_8": ("none", "none"),  # JBIG
    "tiff_scheme_32766_8": ("none", "none"),  # NeXT
    "tiff_scheme_32809_8": ("none", "none"),  # ThunderScan
    "tiff_scheme_32909_8": ("none", "none"),  # PixarLog
    "tiff_scheme_3_8": ("none", "none"),  # CCITT Group 3 of 8-bit samples
    "tiff_scheme_6_8": ("none", "none"),  # old-style JPEG, no JPEG tags
    "tiff_scheme_50002_8": ("read", "read"),  # JPEG XL: unknown, zeros
    "tiff_scheme_34712_1": ("read", "read"),  # JPEG 2000: unknown, zeros
    "tiff_scheme_32771_1": ("read", "read"),  # CCITT RLEW over raw bits
    "tiff_sgilog_gray": ("none", "none"),
    "tiff_group3": ("read", "read"),
    "tiff_group4": ("read", "read"),
    "tiff_ccitt": ("read", "read"),
    "tiff_old_style_lzw": ("read", "read"),
    "tiff_gray_alpha": ("read", "read"),
    "tiff_photometric_4": ("none", "none"),  # transparency mask
    "tiff_photometric_5": ("read", "read"),  # CMYK
    "tiff_photometric_6": ("read", "read"),  # YCbCr, uncompressed
    "tiff_photometric_8": ("read", "read"),  # CIE L*a*b*
    "tiff_logl": ("read", "read"),  # SGI LogL
    "tiff_cmyk_16": ("none", "none"),
    "tiff_ycbcr_2x4": ("none", "none"),  # no put function of libtiff's
    "tiff_palette_1": ("read", "read"),
    "tiff_palette_16": ("none", "none"),
    "tiff_old_jpeg_tags": ("none", "none"),  # not configured in libtiff
    "tiff_no_photometric": ("none", "none"),
    "tiff_palette_without_colormap": ("read", "read"),
    "tiff_jpeg": ("read", "read"),
    "tiff_bigtiff": ("read", "read"),
    **{f"tiff_orientation_{k}": ("read", "read") for k in (2, 3, 4)},
    **{f"tiff_orientation_{k}": ("none", "none") for k in (5, 6, 7, 8)},
    "tiff_format_2_8": ("read", "read"),  # int8
    "tiff_format_2_16": ("read", "read"),  # int16
    "tiff_format_1_32": ("none", "read"),  # uint32
    "tiff_format_2_32": ("none", "read"),  # int32
    "tiff_format_3_64": ("none", "read"),  # float64
    "tiff_format_1_64": ("none", "read"),  # uint64
    "tiff_format_4_8": ("none", "none"),  # void
    "tiff_format_3_16": ("none", "none"),  # float16
    "tiff_format_5_32": ("none", "none"),  # complex integer
    **{f"tiff_c2_{k}": ("none", "none") for k in C2_KINDS},
    "tiff_predictor_3_uint32": ("none", "none"),
    "tiff_mixed_sample_format": ("none", "none"),
    "tiff_short_strip": ("read", "read"),  # byte count recounted
    "tiff_jpeg_separate": ("read", "read"),
    "tiff_ycbcr_tiles_predictor": ("read", "read"),
    "tiff_jpeg_short_strip": ("read", "read"),  # the rest zeros
    "tiff_jpeg_16bit_lossless": ("read", "none"),  # zeros in colour
    "tiff_12bit": ("none", "read"),
    "tiff_12bit_rgb": ("none", "read"),  # the gray of the 12-bit samples
    # interleaved samples from memory cv2 never wrote
    "tiff_12bit_separate": ("none", "queued"),
    "tiff_logluv24": ("read", "none"),
    "tiff_logluv24_float_samples": ("none", "none"),
    "tiff_logluv32": ("read", "none"),
    **{k: ("read", "read") for k in ("webp", "gif", "hdr", "sun_raster",
                                     "jp2", "jp2_ht", "jp2_ht_97_magref")},
    "jp2_ht_four_passes": ("none", "none"),  # OpenJPEG decodes one HT set
    # cv2 returns memory it never wrote for an alpha PAM; cv2.imwrite's
    # default AVIF is lossy AV1, read since slice 20
    "avif": ("read", "read"),
    "pam_alpha": ("queued", "queued"),
    # film grain, grids, sequences, scaled frames and items of two AV1
    # frames: read
    **{k: ("read", "read") for k in ("avif_avis", "avif_grain", "avif_grid",
                                     "avif_scaled", "avif_two_frames",
                                     "avif_layered")},
    "avif_lossless": ("read", "read"),
    "avif_gray12": ("read", "read"),
    "avif_cut": ("none", "none"),
}


@pytest.mark.parametrize("name", list(CLASSES))
def test_refusals_follow_cv2(name, tmp_path):
    """For each file kind the port ever refused, in both read modes:
    cv2.imread returns None exactly where the port raises ValueError (the
    class the EuRoC stream skips a frame for), and an array exactly where
    the port returns the same array or, for what stays queued, raises
    NotImplementedError naming it.  The class each kind takes is written
    in CLASSES, and the test holds cv2 to it too."""
    path = tmp_path / "k.img"
    path.write_bytes(_kind(name, tmp_path))
    for anydepth, want in zip((False, True), CLASSES[name]):
        ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                         else cv2.IMREAD_COLOR)
        assert (ref is None) == (want == "none"), (name, anydepth)
        if want == "read":
            got = image_io.imread(str(path), anydepth=anydepth)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert got.tobytes() == ref.tobytes()
        else:
            with pytest.raises(ValueError if want == "none"
                               else NotImplementedError):
                image_io.imread(str(path), anydepth=anydepth)


def _exif(orientation: int, order: str = "II", typ: int = 3) -> bytes:
    """A TIFF-structured EXIF block of one IFD holding one Orientation
    entry of type ``typ`` (3 SHORT, 4 LONG, 1 BYTE)."""
    e = "<" if order == "II" else ">"
    value = struct.pack(e + "I", orientation) if typ == 4 else \
        struct.pack(e + "HH", orientation, 0)
    return (order.encode() + struct.pack(e + "HIH", 42, 8, 1)
            + struct.pack(e + "HHI", 0x112, typ, 1) + value
            + struct.pack(e + "I", 0))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png_with(png: bytes, extra: dict) -> bytes:
    """``png`` with chunks inserted: ``extra`` maps a place ("before" the
    first IDAT, "after" the last, "iend" after IEND, "first" before
    IHDR) to a list of chunks."""
    pos, chunks = 8, []
    while pos < len(png):
        n, = struct.unpack(">I", png[pos:pos + 4])
        chunks.append(png[pos:pos + 12 + n])
        pos += 12 + n
    first_idat = next(k for k, c in enumerate(chunks) if c[4:8] == b"IDAT")
    out = (extra.get("first", []) + chunks[:first_idat]
           + extra.get("before", []) + chunks[first_idat:-1]
           + extra.get("after", []) + chunks[-1:] + extra.get("iend", []))
    return png[:8] + b"".join(out)


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("place", ["before", "after"])
@pytest.mark.parametrize("kind", ["bgr8", "gray16", "bgra16"])
def test_png_exif_orientation(order, place, kind, tmp_path):
    """An eXIf chunk before or after the image data, in either byte order,
    at Orientation 0-10: the port flips and transposes as cv2.imread does
    (2-8; 0, 1, 9 and 10 leave the image as it is) in both read modes,
    after the gray or 16-bit depth conversion; a 16-bit gray PNG (a depth
    map) under anydepth comes back transposed as cv2 returns it."""
    rng = np.random.default_rng(61)
    im = _images(kind, rng)[3]  # 17 x 33, not square
    png = image_io.encode_png(im)
    for orientation in range(11):
        path = tmp_path / f"o{orientation}.png"
        path.write_bytes(_png_with(png, {place: [
            _png_chunk(b"eXIf", _exif(orientation, order))]}))
        same_as_cv2(path)
        if orientation in (5, 6, 7, 8):
            assert image_io.imread(str(path), anydepth=True).shape == \
                im.shape[1::-1]


def _bad_crc(chunk: bytes) -> bytes:
    return chunk[:-1] + bytes([chunk[-1] ^ 1])


def test_png_exif_edge_cases(tmp_path):
    """How cv2.imread (libpng 1.6 keeping the eXIf chunk, OpenCV's
    ExifReader reading it) treats the cases around the tag, each pinned:
    a LONG-typed tag reads its first two bytes (little-endian: the value;
    big-endian: 0, no change), a BYTE-typed one likewise; an IFD cut
    anywhere (the entry's value must be whole); an IFD that starts past
    the header, or past the block's end; an entry count larger than the
    block; the first of two Orientation entries; the first eXIf chunk
    whose CRC holds and that starts with a TIFF header (``Exif\\0\\0``, a
    short block, a bad CRC or a bad magic number are skipped for the next
    one); an eXIf after IEND is not read; a chunk before IHDR: None; an
    ancillary chunk whose CRC fails is dropped, the image read."""
    rng = np.random.default_rng(62)
    im = rng.integers(0, 256, (20, 30, 3), np.uint8)
    png = image_io.encode_png(im)
    ex = lambda *a: _png_chunk(b"eXIf", _exif(*a))  # noqa: E731
    six = _exif(6)
    ifd16 = b"II" + struct.pack("<HI", 42, 16) + bytes(8) + struct.pack(
        "<HHHIHH", 1, 0x112, 3, 1, 8, 0)
    two = six[:8] + struct.pack("<H", 2) + struct.pack(
        "<HHIHH", 0x100, 3, 1, 30, 0) + struct.pack(
        "<HHIHH", 0x112, 3, 1, 3, 0) + bytes(4)
    cases = {
        **{f"long_{o}_{k}": {"before": [ex(k, o, 4)]}
           for o in ("II", "MM") for k in (3, 6, 8)},
        "byte_6": {"before": [ex(6, "II", 1)]},
        **{f"cut_{n}": {"before": [_png_chunk(b"eXIf", six[:n])]}
           for n in range(0, len(six) + 1, 3)},
        "cut_19": {"before": [_png_chunk(b"eXIf", six[:19])]},
        "cut_20": {"before": [_png_chunk(b"eXIf", six[:20])]},
        "ifd_at_16": {"before": [_png_chunk(b"eXIf", ifd16)]},
        "ifd_past_end": {"before": [_png_chunk(
            b"eXIf", b"II" + struct.pack("<HI", 42, 200) + bytes(30))]},
        "many_entries": {"before": [_png_chunk(
            b"eXIf", six[:8] + struct.pack("<H", 60000) + six[10:])]},
        "second_entry": {"before": [_png_chunk(b"eXIf", two)]},
        "two_tags": {"before": [_png_chunk(b"eXIf", six[:8] + struct.pack(
            "<H", 2) + six[10:22] + six[10:18] + struct.pack(
            "<HH", 3, 0) + bytes(4))]},
        "dup_before": {"before": [ex(6), ex(3)]},
        "dup_around": {"before": [ex(6)], "after": [ex(3)]},
        "exif_prefix_then_6": {"before": [
            _png_chunk(b"eXIf", b"Exif\0\0" + _exif(3)), ex(6)]},
        "short_then_6": {"before": [_png_chunk(b"eXIf", b"II*"), ex(6)]},
        "bad_crc": {"before": [_bad_crc(ex(6))]},
        "bad_crc_then_3": {"before": [_bad_crc(ex(6)), ex(3)]},
        "bad_magic_then_6": {"before": [
            _png_chunk(b"eXIf", b"II\x2b\0" + _exif(3)[4:]), ex(6)]},
        "magic_then_6": {"before": [
            _png_chunk(b"eXIf", b"II*\0" + bytes(4)), ex(6)]},
        "mixed_order": {"before": [_png_chunk(b"eXIf", b"IM" + six[2:])]},
        "after_iend": {"iend": [ex(6)]},
        "before_ihdr": {"first": [ex(6)]},
        "bad_crc_text": {"before": [_bad_crc(_png_chunk(b"tEXt",
                                                        b"k\0v")), ex(6)]},
    }
    for name, extra in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(_png_with(png, extra))
        same_as_cv2(path)
    assert cv2.imread(str(tmp_path / "before_ihdr.png")) is None
    assert image_io.imread(str(tmp_path / "cut_20.png")).shape == (30, 20, 3)
    assert image_io.imread(str(tmp_path / "cut_19.png")).shape == (20, 30, 3)


@pytest.mark.parametrize("mode", ["gray1", "gray2", "gray4", "palette",
                                  "apng"])
def test_png_exif_other_modes(mode, tmp_path):
    """Gray at 1, 2 and 4 bits and palette PNGs, and an APNG (Pillow, its
    eXIf before acTL): every orientation is applied as cv2 applies it."""
    rng = np.random.default_rng(63)
    for orientation in range(1, 9):
        path = tmp_path / f"{mode}{orientation}.png"
        if mode == "apng":
            from PIL import Image

            frames = [Image.fromarray(rng.integers(0, 256, (20, 30, 3),
                                                   np.uint8))
                      for _ in range(2)]
            exif = Image.Exif()
            exif[0x112] = orientation
            frames[0].save(path, save_all=True, append_images=frames[1:],
                           exif=exif.tobytes())
            assert b"acTL" in path.read_bytes()
        else:
            if mode == "palette":
                png = image_io.encode_png(
                    rng.integers(0, 16, (20, 30), np.uint8),
                    palette=rng.integers(0, 256, (16, 3), np.uint8))
            else:
                depth = int(mode[-1])
                png = image_io.encode_png(
                    rng.integers(0, 1 << depth, (20, 30), np.uint8),
                    bit_depth=depth)
            path.write_bytes(_png_with(png, {"before": [
                _png_chunk(b"eXIf", _exif(orientation, "MM"))]}))
        same_as_cv2(path)


def _riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _webp_chunk(tag: bytes, body: bytes) -> bytes:
    return (tag + struct.pack("<I", len(body)) + body
            + (b"\0" if len(body) & 1 else b""))


@pytest.mark.parametrize("lossless", [True, False])
def test_webp_exif_orientation(lossless, tmp_path):
    """Pillow's WebP files (VP8X with the EXIF flag, lossless and lossy)
    at Orientation 1-8: flipped and transposed as cv2.imread does it, in
    both read modes."""
    from PIL import Image

    im = np.random.default_rng(64).integers(0, 256, (20, 30, 3), np.uint8)
    for orientation in range(1, 9):
        exif = Image.Exif()
        exif[0x112] = orientation
        path = tmp_path / f"o{orientation}.webp"
        Image.fromarray(im).save(path, lossless=lossless, quality=90,
                                 exif=exif.tobytes())
        same_as_cv2(path)
        if orientation >= 5:
            assert image_io.imread(str(path)).shape == (30, 20, 3)


def test_webp_exif_edge_cases(tmp_path):
    """The cases around the WebP EXIF chunk, each pinned against
    cv2.imread: read before or after the image chunk, only where the VP8X
    EXIF flag is set, only as a bare TIFF block (no ``Exif\\0\\0``), the
    first of two, every orientation value 0-10 in big-endian order, an IFD
    cut anywhere; not where a chunk runs past the RIFF size (the demuxer
    refuses the list, the image still reads), nor in an animation (Pillow's,
    EXIF flag set)."""
    from PIL import Image

    from lgu_slam_tpu_torch.data import webp

    rng = np.random.default_rng(65)
    im = rng.integers(0, 256, (20, 30, 3), np.uint8)
    vp8l = webp.encode_webp_lossless(im)[12:]

    def vp8x(flags):
        return _webp_chunk(b"VP8X", struct.pack("<I", flags)
                           + (29).to_bytes(3, "little")
                           + (19).to_bytes(3, "little"))
    ex = lambda *a: _webp_chunk(b"EXIF", _exif(*a))  # noqa: E731
    cases = {
        "after": [vp8x(8), vp8l, ex(6)],
        "before": [vp8x(8), ex(6), vp8l],
        "no_flag": [vp8x(0), vp8l, ex(6)],
        "prefix": [vp8x(8), vp8l, _webp_chunk(b"EXIF",
                                              b"Exif\0\0" + _exif(6))],
        "bad_magic": [vp8x(8), vp8l, _webp_chunk(
            b"EXIF", b"II\x2b\0" + _exif(6)[4:])],
        "two": [vp8x(8), vp8l, ex(6), ex(3)],
        "long_II": [vp8x(8), vp8l, ex(7, "II", 4)],
        "long_MM": [vp8x(8), vp8l, ex(7, "MM", 4)],
        **{f"mm_{o}": [vp8x(8), vp8l, ex(o, "MM")] for o in range(11)},
        **{f"cut_{n}": [vp8x(8), vp8l, _webp_chunk(b"EXIF", _exif(6)[:n])]
           for n in (0, 8, 14, 19, 20, 26)},
    }
    for name, chunks in cases.items():
        (tmp_path / f"{name}.webp").write_bytes(_riff(chunks))
        same_as_cv2(tmp_path / f"{name}.webp")
    over = bytearray(_riff([vp8x(8), vp8l, ex(6)]))
    at = over.rindex(b"EXIF")
    over[at + 4:at + 8] = struct.pack("<I", 100)
    (tmp_path / "over.webp").write_bytes(bytes(over))
    same_as_cv2(tmp_path / "over.webp")
    assert image_io.imread(str(tmp_path / "over.webp")).shape == (20, 30, 3)
    frames = [Image.fromarray(im), Image.fromarray(255 - im)]
    exif = Image.Exif()
    exif[0x112] = 6
    frames[0].save(tmp_path / "anim.webp", save_all=True,
                   append_images=frames[1:], lossless=True,
                   exif=exif.tobytes())
    same_as_cv2(tmp_path / "anim.webp")
