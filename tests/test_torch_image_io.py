"""The port's PNG codec (lgu_slam_tpu_torch/data/image_io.py) against
OpenCV: PNGs written by ``cv2.imwrite`` decode bit-identically to
``cv2.imread`` (with and without ``IMREAD_ANYDEPTH``), ``cv2.imread`` reads
the port's PNGs under every filter type bit-identically, the C row unfilter
equals its numpy version, and what the port does not read raises."""

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
    IMREAD_ANYDEPTH on gray files and refuses colour ones (OpenCV would
    convert them to gray).  16-bit samples read without anydepth keep their
    high byte, as OpenCV's decoder does (16-bit RGB(A) fixtures)."""
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
                if im.ndim == 3:
                    with pytest.raises(ValueError, match="gray"):
                        image_io.imread(path, anydepth=True)
                    continue
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
    """Formats other than PNG and JPEG: NotImplementedError (JPEG's own
    refusals: tests/test_torch_jpeg.py); palette, interlaced and sub-byte
    PNGs: ValueError; a missing file: FileNotFoundError (OpenCV returns
    None)."""
    im = np.random.default_rng(3).integers(0, 256, (8, 12, 3), np.uint8)
    bmp = str(tmp_path / "a.bmp")
    cv2.imwrite(bmp, im)
    with pytest.raises(NotImplementedError, match="only PNG and JPEG"):
        image_io.imread(bmp)
    with pytest.raises(NotImplementedError, match="only PNG and JPEG"):
        image_io.imwrite(bmp, im)
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, im)
    with pytest.raises(ValueError, match="gray PNGs only"):
        image_io.imread(jpg, anydepth=True)
    png = image_io.encode_png(im)
    for offset, value, match in ((9, 3, "palette"), (12, 1, "interlaced"),
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


def test_failed_c_build_raises(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and raises: nothing falls
    back to the numpy unfilter."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="png_unfilter.c"):
        image_io.unfilter(bytes([0, 1]), 1, 1, 1)
    assert not os.path.exists(tmp_path / "libpng_unfilter.so")
