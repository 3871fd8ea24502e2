"""The port's TIFF decoder (lgu_slam_tpu_torch/data/tiff.py, with the LZW
and PackBits decoders and the predictors in csrc/host/tiff_lzw.c) against
``cv2.imread``, which is what the JAX package's data layer calls: for
every file, ``imread(path)`` and ``imread(path, anydepth=True)`` equal
``cv2.imread(path)`` and ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` bit for
bit (dtype, shape, bytes; tolerance 0), and files cv2 returns None for
raise ValueError.  Fixtures: ``cv2.imwrite`` under each compression,
predictor and strip height it writes, and the port's ``encode_tiff`` for
the layouts cv2 does not write (big-endian, tiles, separate planes,
palettes, bilevel, min-is-white, alpha)."""

import struct

import cv2
import numpy as np
import pytest
from torch_port import same_as_cv2, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data import image_io, tiff

H, W = 21, 35  # odd sizes: partial strips and tiles at both edges
KINDS = ("gray8", "bgr8", "bgra8", "gray16", "bgr16", "bgra16", "float32")


def _image(kind, rng):
    """Noise in the left half, a smooth ramp (long LZW strings, PackBits
    runs) in the right."""
    if kind == "float32":
        return (rng.standard_normal((H, W)) * 100).astype(np.float32)
    dt = np.uint16 if kind.endswith("16") else np.uint8
    ch = {"gray": (), "bgr": (3,), "bgra": (4,)}[kind.rstrip("0123456789")]
    top = np.iinfo(dt).max + 1
    noise = rng.integers(0, top, (H, W // 2) + ch)
    smooth = np.cumsum(rng.integers(-3, 4, (H, W - W // 2) + ch), axis=1)
    return np.concatenate([noise, (smooth * 97) % top], axis=1).astype(dt)


COMPRESSION = {"none": 1, "lzw": 5, "adobe_deflate": 8, "deflate": 32946,
               "packbits": 32773}


@pytest.mark.parametrize("kind", KINDS)
def test_decodes_cv2_tiffs(kind, tmp_path):
    """cv2.imwrite under every compression it writes, the horizontal and
    (float) floating-point predictor and strips of 1, 7 and all rows:
    16-bit colour reads as round(x / 257), 16-bit gray keeps its high
    byte, colour reads to gray as (4899 R + 9617 G + 1868 B + 8192) >> 14,
    float reads only with anydepth and only as one channel."""
    rng = np.random.default_rng(KINDS.index(kind))
    im = _image(kind, rng)
    path = tmp_path / "a.tif"
    predictors = (1, 3) if kind == "float32" else (1, 2)
    for name, code in COMPRESSION.items():
        for predictor in predictors:
            for rows in (1, 7, H):
                assert cv2.imwrite(str(path), im, [
                    cv2.IMWRITE_TIFF_COMPRESSION, code,
                    cv2.IMWRITE_TIFF_PREDICTOR, predictor,
                    cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows])
                same_as_cv2(path)
    assert cv2.imread(str(path), cv2.IMREAD_ANYDEPTH) is not None


LAYOUTS = {
    "strips": dict(rows_per_strip=7),
    "big_endian": dict(big_endian=True, rows_per_strip=5),
    "tiles": dict(tile=(16, 32)),
    "tiles_big_endian": dict(tile=(16, 16), big_endian=True),
    "planar": dict(planar=2, rows_per_strip=8),
    "planar_tiles": dict(planar=2, tile=(16, 16)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encoder_layouts(layout, tmp_path):
    """The port's encode_tiff in the layouts cv2.imwrite does not write,
    every sample kind, compression and predictor: as cv2.imread reads
    them (a 16-bit gray tile cut by the right edge as libtiff's RGBA
    interface skews it), and the colour read of 8-bit files is the pixels
    written."""
    rng = np.random.default_rng(len(layout))
    path = tmp_path / "e.tif"
    for kind in KINDS:
        im = _image(kind, rng)
        for name in COMPRESSION:
            for predictor in ((1, 3) if kind == "float32" else (1, 2)):
                if kind in ("bgr16", "bgra16") and "planar" in layout:
                    continue  # test_refusals: cv2 reads uninitialised memory
                path.write_bytes(tiff.encode_tiff(
                    im, name, predictor, **LAYOUTS[layout]))
                same_as_cv2(path)
                if kind in ("bgr8", "gray8"):
                    src = im if im.ndim == 3 else \
                        np.repeat(im[..., None], 3, -1)
                    np.testing.assert_array_equal(
                        image_io.imread(str(path)), src)


@pytest.mark.parametrize("mode", ["palette8", "palette16", "bilevel",
                                  "bilevel_white", "min_is_white8",
                                  "min_is_white16", "alpha0", "alpha1",
                                  "alpha2"])
def test_photometric_modes(mode, tmp_path):
    """Palettes (8-bit entries used as they are, 16-bit ones shifted right
    by 8), 1-bit gray (min-is-black and min-is-white), min-is-white 8- and
    16-bit gray, and RGBA at 8 and 16 bits whose ExtraSamples says
    unspecified (0), associated (1) or unassociated alpha (2, multiplied
    in by libtiff), in strips and tiles: as cv2.imread reads them."""
    rng = np.random.default_rng(11)
    path = tmp_path / "m.tif"
    for layout in (dict(), dict(tile=(16, 16)), dict(rows_per_strip=4),
                   dict(big_endian=True)):
        for comp in ("none", "lzw", "packbits"):
            kw = dict(compression=comp, **layout)
            if mode.startswith("palette"):
                dt = np.uint8 if mode == "palette8" else np.uint16
                pal = rng.integers(0, np.iinfo(dt).max + 1, (256, 3)
                                   ).astype(dt)
                idx = rng.integers(0, 256, (H, W)).astype(np.uint8)
                files = [tiff.encode_tiff(idx, palette=pal, **kw)]
                if mode == "palette8":
                    np.testing.assert_array_equal(
                        tiff.decode_tiff(files[0]), pal[idx])
            elif mode.startswith("bilevel"):
                bits = rng.integers(0, 2, (H, W)).astype(np.uint8)
                files = [tiff.encode_tiff(bits, bilevel=True, photometric=(
                    0 if mode == "bilevel_white" else 1), **kw)]
            elif mode.startswith("min_is_white"):
                im = _image("gray" + mode[12:], rng)
                files = [tiff.encode_tiff(im, photometric=0, **kw)]
            else:  # the gray read of 16-bit planes: test_refusals
                files = [(tiff.encode_tiff(_image(kind, rng), planar=planar,
                                           extra_samples=int(mode[-1]),
                                           **kw),
                          (False,) if kind == "bgra16" and planar == 2
                          else (False, True))
                         for kind in ("bgra8", "bgra16")
                         for planar in (1, 2)]
            for data in files:
                data, modes = data if isinstance(data, tuple) else \
                    (data, (False, True))
                path.write_bytes(data)
                same_as_cv2(path, modes)


def test_multipage_reads_page_zero(tmp_path):
    """cv2.imwritemulti's two pages: imread reads page 0, as cv2.imread
    does; decode_tiff(page=1) is not read."""
    rng = np.random.default_rng(5)
    pages = [_image("bgr8", rng), _image("bgr8", rng)]
    path = tmp_path / "multi.tif"
    assert cv2.imwritemulti(str(path), pages)
    same_as_cv2(path)
    np.testing.assert_array_equal(image_io.imread(str(path)), pages[0])
    with pytest.raises(NotImplementedError, match="page 1"):
        tiff.decode_tiff(path.read_bytes(), page=1)


def _patch(data: bytes, tag: int, value: int, index: int = 0) -> bytes:
    """Set value ``index`` of a SHORT or LONG tag of a little-endian
    file."""
    raw = bytearray(data)
    at, = struct.unpack_from("<I", raw, 4)
    n, = struct.unpack_from("<H", raw, at)
    for k in range(n):
        e = at + 2 + 12 * k
        t, typ, count = struct.unpack_from("<HHI", raw, e)
        if t == tag:
            size = 2 if typ == 3 else 4
            where = e + 8 if count * size <= 4 else \
                struct.unpack_from("<I", raw, e + 8)[0]
            struct.pack_into("<H" if typ == 3 else "<I", raw,
                             where + size * index, value)
            return bytes(raw)
    raise KeyError(tag)


def test_refusals(tmp_path):
    """What cv2 returns None for raises ValueError (float read without
    anydepth, float colour, 2- and 4-bit samples, a strip past the end, a
    file cut short); what cv2 reads and the port does not, or reads only
    from memory it never wrote, raises NotImplementedError naming it
    (the compressions left, BigTIFF, 16-bit separate colour planes read to
    gray)."""
    rng = np.random.default_rng(9)
    path = tmp_path / "r.tif"

    def read(data, anydepth=False):
        path.write_bytes(data)
        return image_io.imread(str(path), anydepth=anydepth)

    for data, anydepth in (
            (tiff.encode_tiff(_image("float32", rng)), False),
            (tiff.encode_tiff(rng.standard_normal((H, W, 3)).astype(
                np.float32)), True)):
        path.write_bytes(data)
        assert cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth else
                          cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            read(data, anydepth)
    base = tiff.encode_tiff(_image("gray8", rng), rows_per_strip=7)
    offsets = tiff._ifd(base, "")[0]["strip_offsets"]
    for data in (_patch(base, 258, 4), _patch(base, 258, 2),
                 _patch(base, 273, len(base) + 8, index=1),
                 _patch(base, 279, len(base), index=2),
                 base[:offsets[2] + 10], base[:7]):
        path.write_bytes(data)
        assert cv2.imread(str(path)) is None
        with pytest.raises(ValueError):
            read(data)
    for code, name in ((7, "JPEG"), (34925, "LZMA"), (50000, "ZSTD"),
                       (50001, "WebP"), (34887, "LERC"), (3, "CCITT"),
                       (50002, "JPEG XL")):
        with pytest.raises(NotImplementedError, match=name):
            read(_patch(base, 259, code))
    with pytest.raises(NotImplementedError, match="BigTIFF"):
        read(b"II+\0\x08\0\0\0" + bytes(16))
    sep = tiff.encode_tiff(_image("bgr16", rng), planar=2)
    path.write_bytes(sep)
    assert cv2.imread(str(path), cv2.IMREAD_ANYDEPTH) is not None
    with pytest.raises(NotImplementedError, match="uninitialised"):
        read(sep, anydepth=True)


@pytest.mark.parametrize("compression", ["lzw", "deflate", "packbits",
                                         "none"])
def test_damaged_strips(compression, tmp_path):
    """A strip whose data is cut short (its byte count halved, or a tenth
    of a byte left) or overwritten, in strips of 5, 7 and 8 rows: the
    8-bit read goes on as libtiff's RGBA interface does (the strip as far
    as it decodes, then zeros), the 16-bit and float reads are refused as
    cv2 refuses them, and uncompressed strips whose first two byte counts
    differ are re-counted as libtiff re-counts them (H // strips rows
    each, which may run past the file's end): each as cv2.imread reads
    it (float: the bytes, NaN payloads included)."""
    rng = np.random.default_rng(13)
    path = tmp_path / "d.tif"
    for kind in ("bgr8", "gray8", "gray16", "float32"):
        im = _image(kind, rng)
        predictor = 3 if kind == "float32" and compression in (
            "lzw", "deflate") else 1
        for rows in (5, 7, 8):
            base = tiff.encode_tiff(im, compression, predictor,
                                    rows_per_strip=rows)
            ifd = tiff._ifd(base, "")[0]
            o, n = ifd["strip_offsets"][1], ifd["strip_counts"][1]
            garbage = bytearray(base)
            garbage[o + 3:o + 9] = b"\xff" * 6
            for data in (_patch(base, 279, n // 2, index=1),
                         _patch(base, 279, 1, index=0), bytes(garbage)):
                path.write_bytes(data)
                same_as_cv2(path)


def test_lzw_and_packbits_round_trip():
    """The fixtures' LZW and PackBits encoders against the C decoders on
    data that fills the LZW table past its clear code and runs of every
    length PackBits takes; a stream cut short leaves zeros and is
    damaged; an old-style (LSB-first) LZW stream is refused."""
    rng = np.random.default_rng(17)
    raw = np.concatenate([rng.integers(0, 256, 6000),
                          np.repeat(rng.integers(0, 4, 300), 7),
                          np.zeros(500, int)]).astype(np.uint8).tobytes()
    lzw = tiff.lzw_encode(raw)
    np.testing.assert_array_equal(
        tiff._decompress(lzw, len(raw), 5, "", partial=False),
        np.frombuffer(raw, np.uint8))
    with pytest.raises(ValueError, match="LZW"):
        tiff._decompress(lzw[:len(lzw) // 2], len(raw), 5, "", False)
    part = tiff._decompress(lzw[:len(lzw) // 2], len(raw), 5, "", True)
    assert part[-500:].max() == 0 and part[:100].tobytes() == raw[:100]
    pb = tiff.packbits_encode(raw)
    assert tiff._decompress(pb, len(raw), 32773, "", False).tobytes() == raw
    with pytest.raises(NotImplementedError, match="old-style"):
        tiff._decompress(b"\x00\x01" + lzw, len(raw), 5, "", False)
