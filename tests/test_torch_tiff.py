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

import io
import struct

import cv2
import numpy as np
import pytest
from torch_port import (  # noqa: F401
    C2_KINDS,
    c2_tiff,
    same_as_cv2,
    torch_single_thread,
)

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
    file cut short, an 8-bit file's compression tag set to JPEG over raw
    data, to LZMA, ZSTD, WebP or LERC, which this libtiff does not decode,
    or to CCITT, which codes 1-bit images only; a BigTIFF header pointing
    at no directory); a scheme libtiff does not know (JPEG XL) reads as
    its zeroed buffers, as cv2 reads it; what cv2 reads only from memory
    it never wrote raises NotImplementedError naming it (16-bit separate
    colour planes read to gray)."""
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
    for code, name, refused in (
            (7, "JPEG", True), (34925, "LZMA", True), (50000, "ZSTD", True),
            (50001, "WebP", True), (34887, "LERC", True),
            (3, "CCITT", True), (50002, "JPEG XL", False)):
        data = _patch(base, 259, code)
        path.write_bytes(data)
        assert (cv2.imread(str(path)) is None) == refused
        if refused:
            with pytest.raises(ValueError, match=name):
                read(data)
        else:
            same_as_cv2(path)
            assert read(data).max() == 0
    data = b"II+\0\x08\0\0\0" + bytes(16)
    path.write_bytes(data)
    assert cv2.imread(str(path)) is None
    with pytest.raises(ValueError, match="TIFF"):
        read(data)
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
    damaged; an old-style (LSB-first, pre-6.0) LZW stream of the same data
    decodes to it, and read as a 6.0 stream is damaged from its first
    code (libtiff: "Using code not yet in table")."""
    rng = np.random.default_rng(17)
    raw = np.concatenate([rng.integers(0, 256, 6000),
                          np.repeat(rng.integers(0, 4, 300), 7),
                          np.zeros(500, int)]).astype(np.uint8).tobytes()
    lzw = tiff.lzw_encode(raw)
    out, failed = tiff._decoded(lzw, len(raw), 5, "")
    np.testing.assert_array_equal(out, np.frombuffer(raw, np.uint8))
    assert not failed
    part, failed = tiff._decoded(lzw[:len(lzw) // 2], len(raw), 5, "")
    assert failed
    assert part[-500:].max() == 0 and part[:100].tobytes() == raw[:100]
    with pytest.raises(ValueError, match="LZW"):
        tiff._decode_failed(5, len(lzw) // 2, len(raw), "")
    pb, failed = tiff._decoded(tiff.packbits_encode(raw), len(raw), 32773,
                               "")
    assert pb.tobytes() == raw and not failed
    old = tiff.lzw_encode(raw, old_style=True)
    assert old[0] == 0 and old[1] & 1  # libtiff's test for old-style codes
    out, failed = tiff._decoded(old, len(raw), 5, "", old_lzw=True)
    assert out.tobytes() == raw and not failed
    out, failed = tiff._decoded(old, len(raw), 5, "")
    assert failed and out.max() == 0


def _same(data: bytes, tmp_path, modes=(False, True)):
    path = tmp_path / "t.tif"
    path.write_bytes(data)
    same_as_cv2(path, modes)
    return path


JPEG_LAYOUTS = {"strips": dict(rows_per_strip=16),
                "strips_one": {},
                "tiles": dict(tile=(16, 32)),
                "no_tables": dict(rows_per_strip=8, jpeg_tables=False)}
JPEG_PHOTOMETRIC = {"ycbcr22": dict(subsampling=(2, 2)),
                    "ycbcr21": dict(subsampling=(2, 1)),
                    "ycbcr11": dict(subsampling=(1, 1)),
                    "rgb": dict(photometric=2), "gray": {}}


@pytest.mark.parametrize("photometric", list(JPEG_PHOTOMETRIC))
@pytest.mark.parametrize("layout", list(JPEG_LAYOUTS))
def test_jpeg_compression(layout, photometric, tmp_path):
    """JPEG-compressed TIFF (compression 7) as libtiff's codec writes it:
    strips (the last one shorter) and tiles (edge tiles padded), the
    quantisation and Huffman tables in JPEGTables with abbreviated
    per-strip streams, or whole streams; YCbCr at 2 x 2, 2 x 1 and 1 x 1
    subsampling (libjpeg's RGB, JPEGCOLORMODE_RGB), RGB stored as it is,
    gray; at 37 x 45 and quality 75 and 90: bit for bit as cv2.imread
    reads it, in both modes."""
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (37, 45, 3), np.uint8)
    img[:, 20:] = np.linspace(0, 255, 25, dtype=np.uint8)[None, :, None]
    if photometric == "gray":
        img = img[..., 0]
    for quality in (75, 90):
        data = tiff.encode_tiff(img, "jpeg", quality=quality,
                                **JPEG_LAYOUTS[layout],
                                **JPEG_PHOTOMETRIC[photometric])
        _same(data, tmp_path)


def test_jpeg_compression_damage(tmp_path):
    """JPEG strips whose byte count is cut (read as libjpeg reads a
    truncated stream, fake EOI markers after it), cut to 3 bytes or
    overwritten (libtiff's JPEGPreDecode fails: cv2 returns None,
    ValueError); strips that hold more rows than RowsPerStrip says
    (ValueError), or fewer (libtiff warns and reads them short, the rows
    they lack zeros: as cv2 reads them); a JPEG strip of 3 components in a
    file of 1 sample (cv2 returns None)."""
    img = np.random.default_rng(22).integers(0, 256, (37, 45, 3), np.uint8)
    good = tiff.encode_tiff(img, "jpeg", rows_per_strip=16)
    counts = tiff._ifd(good, "")[0]["strip_counts"]
    offsets = tiff._ifd(good, "")[0]["strip_offsets"]
    _same(_patch(good, 279, counts[1] // 2, index=1), tmp_path)
    _same(_patch(good, 279, 3, index=1), tmp_path)
    raw = bytearray(good)
    raw[offsets[1] + 40:offsets[1] + 60] = b"\xff\x00" * 10
    _same(bytes(raw), tmp_path)
    path = _same(_patch(good, 278, 8), tmp_path)
    assert cv2.imread(str(path)) is None
    path = _same(_patch(good, 278, 24), tmp_path)
    assert cv2.imread(str(path)) is not None
    one = _patch(good, 277, 1)
    assert cv2.imread(str(_same(one, tmp_path))) is None


BIG_LAYOUTS = {"rgb8": dict(), "gray16_lzw_tiles_be": dict(
    compression="lzw", predictor=2, tile=(16, 16), big_endian=True),
    "float32_deflate": dict(compression="deflate", predictor=3),
    "float64_deflate": dict(compression="deflate", predictor=3),
    "int16_packbits": dict(compression="packbits", rows_per_strip=5),
    "jpeg_ycbcr": dict(compression="jpeg", rows_per_strip=16)}


@pytest.mark.parametrize("layout", list(BIG_LAYOUTS))
def test_bigtiff(layout, tmp_path):
    """BigTIFF (the 0x2B header, 8-byte counts and offsets, LONG8 strip
    and tile arrays) of 8-bit colour, 16-bit tiles big-endian, float32 and
    float64 depth with the floating-point predictor, int16 PackBits
    strips and JPEG strips: bit for bit as cv2.imread reads them, in both
    modes, and equal to the classic TIFF of the same samples."""
    rng = np.random.default_rng(23)
    depth = rng.uniform(0.3, 9.0, (H, W))
    img = {"rgb8": _image("bgr8", rng), "gray16": _image("gray16", rng),
           "float32": depth.astype(np.float32),
           "float64": depth, "int16": (depth * 1000 - 4000).astype(np.int16),
           "jpeg": _image("bgr8", rng)}[layout.split("_")[0]]
    big = tiff.encode_tiff(img, bigtiff=True, **BIG_LAYOUTS[layout])
    assert big[:4] in tiff.BIGTIFF
    _same(big, tmp_path)
    classic = tiff.encode_tiff(img, **BIG_LAYOUTS[layout])
    for anydepth in (False, True):
        try:
            want = tiff.decode_tiff(classic, gray=anydepth)
        except ValueError:
            continue
        np.testing.assert_array_equal(tiff.decode_tiff(big, gray=anydepth),
                                      want)


ORIENT_KINDS = ("bgr8", "gray8", "gray16", "float32")


@pytest.mark.parametrize("orientation", range(0, 10))
def test_orientations(orientation, tmp_path):
    """The Orientation tag over 8-bit colour and gray, 16-bit gray and
    float32 files: 2, 3 and 4 flip the image left-right, by 180 degrees
    and upside down, in both modes, as cv2.imread does; 5-8 (transposes):
    cv2 returns None, ValueError; 0 and 9, which libtiff ignores: read as
    1."""
    rng = np.random.default_rng(24)
    for kind in ORIENT_KINDS:
        img = _image(kind, rng)
        data = tiff.encode_tiff(img, orientation=orientation)
        path = _same(data, tmp_path)
        if orientation in (2, 3, 4):
            flip = {2: np.s_[:, ::-1], 3: np.s_[::-1, ::-1],
                    4: np.s_[::-1]}[orientation]
            plain = tiff.decode_tiff(tiff.encode_tiff(img), gray=True)
            np.testing.assert_array_equal(
                image_io.imread(str(path), anydepth=True), plain[flip])
        if orientation in (5, 6, 7, 8):
            with pytest.raises(ValueError, match="transpose"):
                image_io.imread(str(path), anydepth=True)


SAMPLE_KINDS = ("int8", "int16", "uint32", "int32", "float64", "uint64",
                "int64")


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("dtype", SAMPLE_KINDS)
def test_sample_formats(dtype, channels, tmp_path):
    """Signed 8- and 16-bit (SampleFormat 2), 32- and 64-bit integer and
    64-bit float samples, one channel or three, uncompressed and under
    LZW with the horizontal predictor (Deflate with the floating-point one
    for float64): cv2.imread with IMREAD_ANYDEPTH returns the samples'
    dtype (colour to gray by OpenCV's formula on the bits read as
    unsigned) for 8/16-bit and one channel of 32/64-bit, and None for
    32/64-bit colour; without it, 8/16-bit through libtiff's RGBA
    interface, the bits read as unsigned, and None for 32/64-bit.  Bit
    for bit, in both modes."""
    rng = np.random.default_rng(25)
    info = np.iinfo(dtype) if dtype != "float64" else None
    shape = (H, W) if channels == 1 else (H, W, 3)
    if info is None:
        img = rng.standard_normal(shape) * 1e3
    else:
        img = rng.integers(max(info.min, -2 ** 40), min(info.max, 2 ** 40),
                           shape, endpoint=True)
    img = img.astype(dtype)
    for kw in ({}, dict(compression="lzw", predictor=2) if info else
               dict(compression="deflate", predictor=3)):
        path = _same(tiff.encode_tiff(img, **kw), tmp_path)
        if channels == 1:
            got = image_io.imread(str(path), anydepth=True)
            assert got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got, img)


# -- old-style LZW, extra samples, CMYK, YCbCr, CIE L*a*b*, palettes, LogL,
# -- unknown schemes, FillOrder ----------------------------------------------

NEW_LAYOUTS = {"strips": dict(rows_per_strip=4), "one_strip": {},
               "tiles": dict(tile=(16, 16)), "big_endian": dict(
                   big_endian=True), "planar": dict(planar=2),
               "planar_tiles": dict(planar=2, tile=(16, 16)),
               "lzw": dict(compression="lzw", rows_per_strip=8),
               "lzw_predictor": dict(compression="lzw", predictor=2)}


def _strip_damage(data: bytes, tmp_path, rng, mutations: int = 60):
    """Each strip's byte count cut, and copies with 1-3 bytes of the strips
    replaced or bit-flipped: as cv2.imread reads them."""
    tags = tiff._ifd(data, "")[0]
    for k, count in enumerate(tags["strip_counts"]):
        for cut in range(1, count, max(1, count // 8)):
            _same(_patch(data, 279, cut, index=k), tmp_path)
    start = tags["strip_offsets"][0]
    end = tags["strip_offsets"][-1] + tags["strip_counts"][-1]
    for _ in range(mutations):
        raw = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start, end))
            raw[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else \
                raw[i] ^ 1 << int(rng.integers(0, 8))
        _same(bytes(raw), tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_old_style_lzw(kind, tmp_path):
    """Pre-6.0 LZW (codes least significant bit first, the code width
    growing on time) in strips, tiles and big-endian files, with the
    horizontal or floating-point predictor, and damaged (byte counts cut,
    bytes overwritten): as cv2.imread reads it; libtiff decodes every
    strip in the coding of the first one it reads."""
    rng = np.random.default_rng(40 + KINDS.index(kind))
    im = _image(kind, rng)
    for layout in ("strips", "one_strip", "tiles", "big_endian"):
        for predictor in ((1, 3) if kind == "float32" else (1, 2)):
            _same(tiff.encode_tiff(im, "lzw_old", predictor,
                                   **NEW_LAYOUTS[layout]), tmp_path)
    if kind in ("bgr8", "gray16"):
        data = tiff.encode_tiff(im, "lzw_old", rows_per_strip=8)
        _strip_damage(data, tmp_path, rng)
        # the first strip's first bytes decide the coding of every strip
        for coding, first in (("lzw_old", b"\x80\x00"),
                              ("lzw", b"\x00\x01")):
            raw = bytearray(tiff.encode_tiff(im, coding, rows_per_strip=8))
            at = tiff._ifd(bytes(raw), "")[0]["strip_offsets"]
            raw[at[0]:at[0] + 2] = first
            _same(bytes(raw), tmp_path)
            raw = bytearray(tiff.encode_tiff(im, coding, rows_per_strip=8))
            raw[at[1]:at[1] + 2] = first
            _same(bytes(raw), tmp_path)
    big = rng.integers(0, 256, (150, 200), np.uint8)  # fills the table
    path = _same(tiff.encode_tiff(big, "lzw_old"), tmp_path)
    np.testing.assert_array_equal(image_io.imread(str(path),
                                                  anydepth=True), big)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int8, np.int16])
def test_gray_extra_samples(dtype, tmp_path):
    """Gray with 1-3 extra samples, ExtraSamples absent, unspecified,
    associated or unassociated alpha, min-is-black and min-is-white, in
    every layout: as cv2.imread reads it, through libtiff's RGBA interface
    in both modes (16-bit too): contiguous samples read as the gray of
    the first (alpha dropped; a tile cut by the right edge skewed by
    bytes); separate planes read as RGB of plane 0 (not inverted, 16
    bits rounded), an unassociated alpha multiplied in."""
    rng = np.random.default_rng(50)
    info = np.iinfo(dtype)
    for spp in (2, 4):
        im = rng.integers(info.min, info.max, (H, W, spp), endpoint=True
                          ).astype(dtype)
        for extra in (None, 0, 1, 2):
            for photometric in (0, 1):
                for name, layout in NEW_LAYOUTS.items():
                    # anydepth of 16-bit planes of 3+ samples: test_refusals
                    modes = (False,) if dtype().itemsize == 2 and spp > 2 \
                        and name.startswith("planar") else (False, True)
                    _same(tiff.encode_tiff(
                        im, photometric=photometric, extra_samples=None if
                        extra is None else [extra] * (spp - 1), **layout),
                        tmp_path, modes)
    if dtype == np.uint8:
        path = _same(tiff.encode_tiff(im[..., :2], extra_samples=2),
                     tmp_path)
        np.testing.assert_array_equal(image_io.imread(str(path),
                                                      anydepth=True),
                                      im[..., 0])


def test_cmyk(tmp_path):
    """Separated (photometric 5) 8-bit CMYK, contiguous and in planes, in
    strips and tiles, LZW: libtiff's RGB of it (255 - K) * (255 - C) / 255
    ... truncated, bit for bit as cv2.imread reads it in both modes;
    16-bit CMYK, inks other than CMYK and 3 or 5 samples: cv2 returns
    None, ValueError."""
    rng = np.random.default_rng(51)
    cmyk = rng.integers(0, 256, (H, W, 4), np.uint8)
    for layout in NEW_LAYOUTS.values():
        _same(tiff.encode_tiff(cmyk, photometric=5, **layout), tmp_path)
    path = _same(tiff.encode_tiff(cmyk, photometric=5), tmp_path)
    k = 255 - cmyk[..., 3:].astype(int)
    np.testing.assert_array_equal(image_io.imread(str(path)),
                                  (k * (255 - cmyk[..., 2::-1])) // 255)
    for data in (tiff.encode_tiff(cmyk.astype(np.uint16) * 257,
                                  photometric=5),
                 tiff.encode_tiff(cmyk.astype(np.uint16) * 257,
                                  photometric=5, planar=2),
                 tiff.encode_tiff(cmyk[..., :3], photometric=5),
                 tiff.encode_tiff(np.concatenate([cmyk, cmyk[..., :1]], -1),
                                  photometric=5),
                 tiff.encode_tiff(cmyk, photometric=5, tags={332: (3, [2])})):
        path = _same(data, tmp_path)
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path))


YCBCR_SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("sub", YCBCR_SUBSAMPLINGS)
def test_ycbcr(sub, tmp_path):
    """Uncompressed and LZW YCbCr (photometric 6, not JPEG) in data units
    at each subsampling libtiff's RGBA interface reads, in strips of 4 v
    rows, one strip, tiles and big-endian files, the horizontal predictor,
    other YCbCrCoefficients and ReferenceBlackWhite: libtiff's fixed-point
    YCbCr -> RGB, bit for bit as cv2.imread reads it in both modes (a strip
    read as its rows rounded up to v, in scanlines; 4 x 4 tiles cut by the
    right edge skipped as 10-byte units)."""
    rng = np.random.default_rng(52 + YCBCR_SUBSAMPLINGS.index(sub))
    ycc = rng.integers(0, 256, (H, W, 3), np.uint8)
    ycc[:, 20:] = 128
    for name, layout in NEW_LAYOUTS.items():
        if name.startswith("planar") and sub != (1, 1):
            continue
        layout = dict(rows_per_strip=4 * sub[1]) if name == "strips" \
            else layout
        _same(tiff.encode_tiff(ycc, photometric=6, subsampling=sub,
                               **layout), tmp_path)
    for coefficients, black_white in (
            ((0.2126, 0.7152, 0.0722), None),
            (None, (16, 235, 128, 240, 128, 240)),
            ((0.299, 0.587, 0.114), (10, 200, 100, 220, 90, 250))):
        tags = {529: (5, coefficients), 532: (5, black_white)}
        _same(tiff.encode_tiff(ycc, photometric=6, subsampling=sub, tags={
            k: v for k, v in tags.items() if v[1] is not None}), tmp_path)
    if sub == (2, 2):
        for bad in ((2, 4), (1, 4), (3, 3)):  # no put function: None
            data = tiff.encode_tiff(ycc, photometric=6, subsampling=(2, 2))
            path = _same(_patch(_patch(data, 530, bad[0]), 530, bad[1], 1),
                         tmp_path)
            with pytest.raises(ValueError):
                image_io.imread(str(path))
        path = _same(tiff.encode_tiff(ycc, photometric=6, planar=2,
                                      subsampling=(2, 2)), tmp_path)
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path))


def test_cielab(tmp_path):
    """CIE L*a*b* (photometric 8) of 8 and 16 bits in strips, tiles and
    big-endian files, other white points, and every 8-bit L* over a grid
    of a*, b*: cv2.imread converts through libtiff (TIFFCIELabToXYZ, then
    TIFFXYZToRGB to sRGB) and the port in its float32 steps, bit for bit
    in both modes; separate planes, 2 or 4 samples: None, ValueError."""
    rng = np.random.default_rng(60)
    for dtype in (np.uint8, np.uint16, np.int16):
        info = np.iinfo(dtype)
        lab = rng.integers(info.min, info.max, (H, W, 3), endpoint=True
                           ).astype(dtype)
        for name, layout in NEW_LAYOUTS.items():
            if not name.startswith("planar"):
                _same(tiff.encode_tiff(lab, photometric=8, **layout),
                      tmp_path)
        for white in ((0.3127, 0.329), (0.25, 0.4)):
            _same(tiff.encode_tiff(lab, photometric=8,
                                   tags={318: (5, white)}),
                  tmp_path)
        path = _same(tiff.encode_tiff(lab, photometric=8, planar=2),
                     tmp_path)
        with pytest.raises(ValueError):
            image_io.imread(str(path))
    a, b = np.meshgrid(np.arange(0, 256, 3), np.arange(0, 256, 3))
    grid = np.stack([np.broadcast_to(np.arange(256)[:, None, None],
                                     (256,) + a.shape),
                     np.broadcast_to(a, (256,) + a.shape),
                     np.broadcast_to(b, (256,) + a.shape)], -1)
    _same(tiff.encode_tiff(grid.reshape(-1, a.size, 3).astype(np.uint8),
                           photometric=8), tmp_path)
    for spp in (2, 4):
        path = _same(tiff.encode_tiff(rng.integers(
            0, 256, (H, W, spp), np.uint8), photometric=8), tmp_path)
        with pytest.raises(ValueError):
            image_io.imread(str(path))


def test_palettes(tmp_path):
    """A 1-bit palette (its two entries looked up, 16-bit entries shifted),
    8-bit palettes of 2-4 samples (the first indexes; a tile cut by the
    right edge skewed by bytes), bit for bit as cv2.imread reads them;
    16-bit palettes and palettes in separate planes: None, ValueError."""
    rng = np.random.default_rng(61)
    bits = rng.integers(0, 2, (H, W), np.uint8)
    for pal in (np.array([[12, 34, 56], [200, 100, 0]], np.uint8),
                np.array([[65535, 0, 12345], [0, 54321, 65535]], np.uint16)):
        for layout in ({}, dict(tile=(16, 16)), dict(compression="group4")):
            path = _same(tiff.encode_tiff(bits, palette=pal, bilevel=True,
                                          **layout), tmp_path)
            np.testing.assert_array_equal(image_io.imread(str(path)), (
                pal >> 8 if pal.dtype == np.uint16 else pal)[bits])
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    for spp in (2, 3, 4):
        idx = rng.integers(0, 256, (H, W, spp), np.uint8)
        for layout in ({}, dict(tile=(16, 16)), dict(rows_per_strip=4)):
            _same(tiff.encode_tiff(idx, palette=pal, **layout), tmp_path)
        path = _same(tiff.encode_tiff(idx, palette=pal, planar=2), tmp_path)
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path))
    for pal_dtype in (np.uint8, np.uint16):
        pal16 = rng.integers(0, np.iinfo(pal_dtype).max, (1 << 16, 3)
                             ).astype(pal_dtype)
        idx = rng.integers(0, 1 << 16, (H, W)).astype(np.uint16)
        path = _same(tiff.encode_tiff(idx, palette=pal16), tmp_path)
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path), anydepth=True)


def test_sgi_logl(tmp_path):
    """SGI LogL (photometric 32844 under compression 34676): libtiff's
    RGBA interface has the codec return 8-bit gray, 256 sqrt(Y) of each
    16-bit log luminance, which cv2.imread reads (as int8 with anydepth
    where the samples are signed): written by the port's ``logl_encode``
    (runs and literals, strips, tiles, FillOrder 2, damaged data) and by
    PIL (libtiff's own LogL encoder of float luminances), bit for bit;
    LogL under SGI Log24, or of 2 samples, and LogLuv (32845) of one
    sample: None, ValueError (LogLuv of three samples:
    test_logluv32_reads_as_cv2_reads)."""
    from PIL import Image, TiffImagePlugin

    rng = np.random.default_rng(62)
    codes = np.cumsum(rng.integers(-3, 4, (H, W)), 1) + 16000
    codes[:3, :10] = rng.integers(-32768, 32767, (3, 10))
    codes = codes.astype(np.int16)
    for layout in ({}, dict(rows_per_strip=4), dict(tile=(16, 16)),
                   dict(fill_order=2), dict(big_endian=True)):
        _same(tiff.encode_tiff(codes, "sgilog", **layout), tmp_path)
    data = tiff.encode_tiff(codes, "sgilog", rows_per_strip=8)
    _strip_damage(data, tmp_path, rng)
    for scale in (1e-6, 0.3, 10.0):
        y = (rng.random((H, W)) * scale).astype(np.float32)
        y[0, :2] = (0, -scale)
        info = TiffImagePlugin.ImageFileDirectory_v2()
        info[262] = 32844
        buf = io.BytesIO()
        Image.fromarray(y).save(buf, "TIFF", compression="tiff_sgilog",
                                tiffinfo=info)
        path = _same(buf.getvalue(), tmp_path)
        assert image_io.imread(str(path), anydepth=True).dtype == np.int8
    for bad in (_patch(data, 259, 34677),
                tiff.encode_tiff(np.stack([codes, codes], -1), "sgilog"),
                _patch(data, 262, 32845)):
        path = _same(bad, tmp_path)
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path))


def test_unknown_and_unconfigured_schemes(tmp_path):
    """A scheme libtiff does not know (JPEG 2000: a J2K codestream of
    cv2.imwrite's in each strip; JPEG XL; any other code) decodes nothing:
    libtiff's RGBA interface reads zeroed buffers (white where min-is-
    white), as cv2.imread does, and the 16-bit read of the samples as
    stored is refused (cv2 returns None); old-style JPEG with its
    JPEGInterchangeFormat tags is not configured in OpenCV's libtiff:
    None, ValueError."""
    rng = np.random.default_rng(63)
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    j2k = tmp_path / "c.jp2"
    assert cv2.imwrite(str(j2k), np.repeat(np.repeat(img, 4, 0), 4, 1))
    jp2 = j2k.read_bytes()
    codestream = jp2[jp2.index(b"\xff\x4f\xff\x51"):]
    j2k_tiff = tiff.encode_tiff(img, chunks=[codestream],
                                tags={259: (3, [34712])})
    base = tiff.encode_tiff(img)
    for data in (j2k_tiff, _patch(base, 259, 50002),
                 _patch(tiff.encode_tiff(img[..., 0], photometric=0), 259,
                        40000),
                 _patch(tiff.encode_tiff((img[..., 0] > 100).astype(np.uint8),
                                         bilevel=True),
                        259, 52546)):
        path = _same(data, tmp_path)
        assert cv2.imread(str(path)) is not None
    path = _same(_patch(tiff.encode_tiff(img[..., 0].astype(np.uint16)),
                        259, 34712), tmp_path)
    with pytest.raises(ValueError, match="cv2.imread returns None"):
        image_io.imread(str(path), anydepth=True)
    jpg = image_io.encode_jpeg(img, 90)  # JPEGInterchangeFormat: at 8
    ojpeg = tiff.encode_tiff(img, photometric=6, subsampling=(2, 2),
                             chunks=[jpg], tags={259: (3, [6]), 513: (4, [8]),
                                                 514: (4, [len(jpg)])})
    path = _same(ojpeg, tmp_path)
    with pytest.raises(ValueError, match="old-style JPEG"):
        image_io.imread(str(path))


def test_fill_order(tmp_path):
    """FillOrder 2 (the bits of each byte reversed): libtiff reverses them
    back before decoding uncompressed, LZW, PackBits, Deflate and LogL
    data, and leaves JPEG's alone (cv2 returns None for the reversed JPEG,
    ValueError): as cv2.imread reads each; other values read as 1."""
    rng = np.random.default_rng(64)
    for kind in ("bgr8", "gray16"):
        im = _image(kind, rng)
        for compression in ("none", "lzw", "packbits", "deflate",
                            "lzw_old"):
            for fill_order in (2, 3):
                path = _same(tiff.encode_tiff(im, compression,
                                              fill_order=fill_order,
                                              rows_per_strip=8), tmp_path)
                if fill_order == 2:
                    np.testing.assert_array_equal(
                        image_io.imread(str(path), anydepth=True),
                        tiff.decode_tiff(tiff.encode_tiff(im), gray=True))
    path = _same(tiff.encode_tiff(_image("bgr8", rng), "jpeg",
                                  fill_order=2), tmp_path)
    with pytest.raises(ValueError):
        image_io.imread(str(path))


def test_uncompressed_strip_counts(tmp_path):
    """libtiff re-counts uncompressed strips whose first two byte counts
    differ only where there are more than two strips of contiguous
    samples: two strips of 16 and 5 rows, or separate planes, are read as
    their counts say."""
    rng = np.random.default_rng(65)
    im = _image("bgr8", rng)
    for layout in (dict(rows_per_strip=16), dict(rows_per_strip=16,
                                                 planar=2),
                   dict(rows_per_strip=5, planar=2)):
        path = _same(tiff.encode_tiff(im, **layout), tmp_path)
        np.testing.assert_array_equal(image_io.imread(str(path)), im)


def test_committed_fixtures_decode_to_cv2_hashes():
    """tests/data/tiff (scripts/make_tiff_fixtures_torch.py: PIL's, that is
    libtiff's own, CCITT RLE / RLEW / Group 3 / Group 4, gray with alpha,
    CMYK, YCbCr, CIE L*a*b* and SGI LogL files of a rendered frame; the
    port's encoder's short strip, JPEG of separate planes, predicted YCbCr
    tiles, short JPEG strips, LogLuv32, LogLuv24 codes and 12-bit gray,
    RGB and signed tiles; cv2.imwrite's LogLuv24; one file of each refused
    kind of torch_port.C2_KINDS): the port's arrays hash as cv2.imread's
    do (the hashes written beside them, which chip_smoke.py phases 15, 17
    and 18 check on machines without OpenCV), or both refuse (null:
    ValueError), and cv2 still agrees; each file at most 64 KB, the set at
    most 320 KB."""
    import hashlib
    import json
    import os

    folder = os.path.join(os.path.dirname(__file__), "data", "tiff")
    hashes = json.load(open(os.path.join(folder, "hashes.json")))
    assert len(hashes) == 19 + len(C2_KINDS)
    total = 0
    for name, want in hashes.items():
        path = os.path.join(folder, name)
        total += os.path.getsize(path)
        assert os.path.getsize(path) <= 64 * 1024
        for mode, flag in (("color", cv2.IMREAD_COLOR),
                           ("anydepth", cv2.IMREAD_ANYDEPTH)):
            ref = cv2.imread(path, flag)
            if want[mode] is None:
                assert ref is None
                with pytest.raises(ValueError, match="returns None"):
                    image_io.imread(path, anydepth=mode == "anydepth")
                continue
            got = image_io.imread(path, anydepth=mode == "anydepth")
            for a in (got, ref):
                assert hashlib.sha256(a.tobytes()).hexdigest() == \
                    want[mode]["sha256"]
                assert list(a.shape) == want[mode]["shape"]
                assert str(a.dtype) == want[mode]["dtype"]
    assert total <= 320 * 1024


# -- ValueError where cv2 returns None, and the leftovers cv2 reads ----------

def _image_32x48(seed=70):
    """``uint8 [32, 48, 3]``: noise on the left, smooth ramps on the right
    (JPEG's and the predictors' two regimes)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (32, 48, 3), np.uint8)
    img[:, 24:] = np.cumsum(rng.integers(-3, 4, (32, 24, 3)), 1) % 256
    return img


def _drop_tag(data: bytes, tag: int, count: int = None) -> bytes:
    """A little-endian file whose ``tag`` entry is renamed to an unknown
    tag (65000), so that libtiff reads it as missing; with ``count``, the
    unknown entry's count set to it."""
    raw = bytearray(data)
    at, = struct.unpack_from("<I", raw, 4)
    n, = struct.unpack_from("<H", raw, at)
    for k in range(n):
        if struct.unpack_from("<H", raw, at + 2 + 12 * k)[0] == tag:
            struct.pack_into("<H", raw, at + 2 + 12 * k, 65000)
            if count is not None:
                struct.pack_into("<I", raw, at + 6 + 12 * k, count)
            return bytes(raw)
    raise KeyError(tag)


def _twelve_bit(v: np.ndarray) -> bytes:
    """``uint16`` samples below 4096 ([H, W] or [H, W, spp]) packed as
    TIFF rows of 12-bit samples (most significant bit first, each row
    padded to a byte)."""
    v = v.reshape(v.shape[0], -1).astype(np.uint16)
    bits = np.unpackbits((v << 4).astype(">u2").view(np.uint8).reshape(
        v.shape[0], -1, 2), axis=2)[..., :12].reshape(v.shape[0], -1)
    return np.packbits(bits, axis=1).tobytes()


NAN, INF = float("nan"), float("inf")
RBW = [0, 255, 128, 255, 128, 255]


def _rbw(k, v):
    r = list(RBW)
    r[k] = v
    return {532: (11, r)}


def _refused(name: str) -> bytes:
    """The refused kinds of test_refused_where_cv2_returns_none."""
    from lgu_slam_tpu_torch.data.image_io import encode_jpeg

    img = _image_32x48()
    gray = np.ascontiguousarray(img[..., 1])
    enc = tiff.encode_tiff
    if name in C2_KINDS:
        return c2_tiff(name, img)
    ycc = dict(photometric=6, subsampling=(1, 1))
    cases = {
        "predictor_0": lambda: enc(gray, "lzw", tags={317: (3, [0])}),
        "predictor_3_8bit": lambda: enc(gray, "lzw", tags={317: (3, [3])}),
        "predictor_3_uint32": lambda: enc(gray.astype(np.uint32) * 99991,
                                          "lzw", predictor=3),
        "predictor_3_int16": lambda: enc(gray.astype(np.int16), "deflate",
                                         predictor=3),
        "predictor_2_1bit": lambda: enc(gray >> 7, "lzw", bilevel=True,
                                        tags={317: (3, [2])}),
        "mixed_depths_gray_alpha": lambda: enc(img[..., :2], tags={
            258: (3, [16, 8])}),
        "mixed_sample_format": lambda: enc(img, tags={339: (3, [1, 1, 2])}),
        "mixed_min_sample": lambda: enc(img, tags={280: (3, [0, 1, 0])}),
        "mixed_max_sample": lambda: enc(img, tags={281: (3, [9, 9, 8])}),
        "bits_two_values_of_three": lambda: enc(img, tags={258: (3, [8, 8])}),
        **{f"luma_nan_{k}": (lambda k=k: enc(img, **ycc, tags={529: (11, [
            NAN if i == k else v for i, v in enumerate((0.299, 0.587,
                                                        0.114))])}))
           for k in range(3)},
        "luma_green_negative_zero": lambda: enc(img, **ycc, tags={
            529: (11, [0.299, -0.0, 0.114])}),
        "luma_nan_subsampled": lambda: enc(img, photometric=6, tags={
            529: (11, [0.299, NAN, 0.114])}),
        "rbw_nan": lambda: enc(img, **ycc, tags=_rbw(3, NAN)),
        "rbw_infinite": lambda: enc(img, **ycc, tags=_rbw(1, INF)),
        **{f"rbw_{k}_{side}": (lambda k=k, v=v: enc(
            img, **ycc, tags=_rbw(k, v)))
           for k in (0, 2, 5) for side, v in (("above", 2147483648.0),
                                              ("below", -2147483520.0))},
        "short_strip_cut_gray16": lambda: enc(
            gray.astype(np.uint16) * 257, chunks=[
                (gray.astype(np.uint16) * 257).tobytes()[:1000]]),
        "lzw_strip_past_end": lambda: _patch(enc(img, "lzw"), 279, 10 ** 6),
        "missing_counts_two_strips": lambda: _drop_tag(
            enc(img, rows_per_strip=16), 279),
        "jpeg_separate_ycbcr_1x2": lambda: enc(
            img, "jpeg", planar=2, photometric=6, subsampling=(1, 2),
            rows_per_strip=16),
        "jpeg_12bit_lossless": lambda: enc(
            gray.astype(np.uint16), chunks=[encode_jpeg(
                gray.astype(np.uint16) << 4, lossless=True, precision=12)],
            tags={259: (3, [7]), 258: (3, [12])}),
        "jpeg_16bit_dct": lambda: enc(
            gray.astype(np.uint16), chunks=[encode_jpeg(gray)],
            tags={259: (3, [7])}),
        "jpeg_1bit": lambda: _patch(enc(gray, "jpeg"), 258, 1),
        "twelve_bit_gray_alpha": lambda: enc(
            img[..., :2].astype(np.uint16), chunks=[_twelve_bit(
                img[..., :2].astype(np.uint16) * 16)],
            tags={258: (3, [12, 12])}),
        "twelve_bit_predictor_2": lambda: enc(
            gray.astype(np.uint16), "lzw", chunks=[tiff.lzw_encode(
                _twelve_bit(gray.astype(np.uint16) * 16))],
            tags={258: (3, [12]), 317: (3, [2])}),
        **{f"twelve_bit_photometric_{ph}": (lambda ph=ph: enc(
            img.astype(np.uint16), chunks=[_twelve_bit(
                img.astype(np.uint16) * 16)],
            tags={258: (3, [12] * 3), 262: (3, [ph])})) for ph in (6, 8)},
        "twelve_bit_float": lambda: enc(
            gray.astype(np.uint16), chunks=[_twelve_bit(
                gray.astype(np.uint16) * 16)],
            tags={258: (3, [12]), 339: (3, [3])}),
    }
    return cases[name]()


REFUSED = C2_KINDS + (
    "predictor_0", "predictor_3_8bit", "predictor_3_uint32",
    "predictor_3_int16", "predictor_2_1bit", "mixed_depths_gray_alpha",
    "mixed_sample_format", "mixed_min_sample", "mixed_max_sample",
    "bits_two_values_of_three", "luma_nan_0", "luma_nan_1", "luma_nan_2",
    "luma_green_negative_zero", "luma_nan_subsampled", "rbw_nan",
    "rbw_infinite", *(f"rbw_{k}_{side}" for k in (0, 2, 5)
                      for side in ("above", "below")),
    "short_strip_cut_gray16", "lzw_strip_past_end",
    "missing_counts_two_strips", "jpeg_separate_ycbcr_1x2",
    "jpeg_12bit_lossless", "jpeg_16bit_dct", "jpeg_1bit",
    "twelve_bit_gray_alpha", "twelve_bit_predictor_2",
    "twelve_bit_photometric_6", "twelve_bit_photometric_8",
    "twelve_bit_float")


@pytest.mark.parametrize("name", REFUSED)
def test_refused_where_cv2_returns_none(name, tmp_path):
    """Files cv2.imread returns None for in both read modes raise
    ValueError in both, decided where the file is parsed: the six kinds
    the decoder refused as NotImplementedError before (a predictor other
    than 1-3, the floating-point predictor of 16-bit integers, samples of
    mixed depths, a green YCbCr coefficient 0, a short uncompressed
    strip the file cannot fill, JPEG of separate YCbCr planes:
    tests/torch_port.c2_tiff) and their neighbours: the predictor 0, the
    floating-point one of any integer samples, the horizontal one of 1-bit
    samples; SampleFormat, Min- and MaxSampleValue of different values per
    sample, BitsPerSample of 2 values for 3 samples; a NaN coefficient,
    -0.0 for green, subsampled too; a reference black or white NaN,
    infinite or outside (-2147483520, 2147483648) (the values inside read:
    test_ycbcr_fields_cv2_reads); a short 16-bit strip; a compressed strip
    past the file's end; two strips without StripByteCounts; JPEG of
    separate YCbCr planes at 1 x 2, of 12-bit (this libjpeg decodes no
    12-bit data) or 1-bit samples, or of 8-bit data in a 16-bit file;
    12-bit gray with alpha, 12-bit YCbCr, L*a*b* or floating-point
    samples, and 12-bit samples under the horizontal predictor."""
    path = tmp_path / "r.tif"
    path.write_bytes(_refused(name))
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH):
        try:
            assert cv2.imread(str(path), flag) is None
        except cv2.error:
            pass
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path), anydepth=flag == cv2.IMREAD_ANYDEPTH)


def _read_case(name: str) -> bytes:
    """The kinds of test_leftovers_read_as_cv2_reads."""
    from lgu_slam_tpu_torch.data.image_io import encode_jpeg

    img = _image_32x48()
    gray = np.ascontiguousarray(img[..., 1])
    enc = tiff.encode_tiff
    raw = np.ascontiguousarray(img[..., ::-1]).tobytes()
    one = enc(img, chunks=[raw])
    sep = dict(planar=2, photometric=2, rows_per_strip=16)

    def jpeg(px, **kw):
        return encode_jpeg(np.ascontiguousarray(px), 90, **kw)

    def short_jpeg(chunks, **kw):
        return enc(img, "jpeg", photometric=2, rows_per_strip=16,
                   jpeg_tables=False, chunks=chunks, **kw)

    rgb = dict(subsampling="444", adobe_transform=0)
    cases = {
        # a single uncompressed strip: libtiff recounts a byte count that
        # "looks bad" from ImageLength, and reads the data that is there
        "short_strip_present": lambda: _patch(one, 279, len(raw) * 5 // 8),
        "short_strip_zero": lambda: _patch(one, 279, 0),
        "short_strip_past_end": lambda: _patch(one, 279, 10 ** 6),
        "short_strip_gray16": lambda: _patch(
            enc(gray.astype(np.uint16) * 257), 279, 1000),
        "short_strip_planar_one_sample": lambda: _patch(
            enc(gray, planar=2), 279, 500),
        "lzw_strip_zero": lambda: _patch(enc(img, "lzw"), 279, 0),
        "missing_counts": lambda: _drop_tag(one, 279),
        "missing_counts_lzw": lambda: _drop_tag(enc(img, "lzw"), 279),
        "missing_counts_planar": lambda: _drop_tag(enc(img, planar=2), 279),
        "missing_counts_planar_lzw": lambda: _drop_tag(
            enc(img, "lzw", planar=2), 279),
        "missing_counts_tile": lambda: _drop_tag(
            enc(img, "deflate", tile=(32, 48)), 325),
        # the unknown entry's values count more bytes than the file holds:
        # libtiff sizes each chunk from the whole file
        "missing_counts_room_past_end": lambda: _drop_tag(
            enc(img, "lzw"), 279, count=10 ** 6),
        "missing_counts_planar_room_past_end": lambda: _drop_tag(
            enc(img, "lzw", planar=2), 279, count=10 ** 6),
        # JPEG of separate planes: each plane's strips one-component JPEG
        "jpeg_separate_rgb": lambda: enc(img, "jpeg", **sep),
        "jpeg_separate_rgb_one_strip": lambda: enc(img, "jpeg", planar=2,
                                                   photometric=2),
        "jpeg_separate_rgb_tiles": lambda: enc(img, "jpeg", planar=2,
                                               photometric=2,
                                               tile=(16, 32)),
        "jpeg_separate_rgb_no_tables": lambda: enc(
            img, "jpeg", jpeg_tables=False, **sep),
        "jpeg_separate_rgb_odd": lambda: enc(
            np.ascontiguousarray(img[:21, :35]), "jpeg", planar=2,
            photometric=2, rows_per_strip=8),
        "jpeg_separate_rgb_subsampling_tag": lambda: enc(
            img, "jpeg", tags={530: (3, [2, 2])}, **sep),
        "jpeg_separate_gray": lambda: enc(gray, "jpeg", planar=2,
                                          rows_per_strip=16),
        "jpeg_separate_gray_alpha": lambda: enc(
            img[..., :2], "jpeg", planar=2, rows_per_strip=16,
            extra_samples=2),
        "jpeg_separate_rgba": lambda: enc(
            np.dstack([img, gray[::-1]]), "jpeg", extra_samples=2, **sep),
        "jpeg_separate_ycbcr_1x1": lambda: enc(
            img, "jpeg", planar=2, photometric=6, subsampling=(1, 1),
            rows_per_strip=16),
        # JPEG strips and tiles the data does not fill: the rest zeros
        "jpeg_strip_short": lambda: short_jpeg(
            [jpeg(img[:12], **rgb), jpeg(img[16:], **rgb)]),
        "jpeg_strip_narrow": lambda: short_jpeg(
            [jpeg(img[:16, :40], **rgb), jpeg(img[16:], **rgb)]),
        "jpeg_last_strip_short": lambda: short_jpeg(
            [jpeg(img[:16], **rgb), jpeg(img[16:26], **rgb)]),
        "jpeg_ycbcr_strip_short": lambda: enc(
            img, "jpeg", rows_per_strip=16, jpeg_tables=False, chunks=[
                jpeg(img[:12]), jpeg(img[16:])]),
        "jpeg_tile_short": lambda: enc(
            gray, "jpeg", tile=(16, 16), jpeg_tables=False, chunks=[
                jpeg(gray[:8, :16])] + [jpeg(gray[:16, :16])] * 5),
        "jpeg_separate_plane_short": lambda: enc(
            img, "jpeg", jpeg_tables=False, chunks=[
                jpeg(img[:16, :, 2]), jpeg(img[16:, :, 2]),
                jpeg(img[:9, :, 1]), jpeg(img[16:, :, 1]),
                jpeg(img[:16, :, 0]), jpeg(img[16:, :30, 0])], **sep),
        # a 16-bit lossless stream passes libtiff's checks and fails in
        # libjpeg's 8-bit reader: zeros in the colour read, None in the
        # 16-bit one
        "jpeg_16bit_lossless": lambda: enc(
            gray.astype(np.uint16), chunks=[encode_jpeg(
                gray.astype(np.uint16) * 257, lossless=True, precision=16)],
            tags={259: (3, [7])}),
        "jpeg_16bit_lossless_min_is_white": lambda: enc(
            gray.astype(np.uint16), chunks=[encode_jpeg(
                gray.astype(np.uint16) * 257, lossless=True, precision=16)],
            tags={259: (3, [7]), 262: (3, [0])}),
        # per-sample values past the samples are not read
        "bits_extra_value_differs": lambda: enc(img, tags={
            258: (3, [8, 8, 8, 16])}),
        "min_sample_one_value": lambda: enc(img, tags={280: (3, [3])}),
    }
    return cases[name]()


READ = ("short_strip_present", "short_strip_zero", "short_strip_past_end",
        "short_strip_gray16", "short_strip_planar_one_sample",
        "lzw_strip_zero", "missing_counts", "missing_counts_lzw",
        "missing_counts_planar", "missing_counts_planar_lzw",
        "missing_counts_tile", "missing_counts_room_past_end",
        "missing_counts_planar_room_past_end", "jpeg_separate_rgb",
        "jpeg_separate_rgb_one_strip", "jpeg_separate_rgb_tiles",
        "jpeg_separate_rgb_no_tables", "jpeg_separate_rgb_odd",
        "jpeg_separate_rgb_subsampling_tag", "jpeg_separate_gray",
        "jpeg_separate_gray_alpha", "jpeg_separate_rgba",
        "jpeg_separate_ycbcr_1x1", "jpeg_strip_short", "jpeg_strip_narrow",
        "jpeg_last_strip_short", "jpeg_ycbcr_strip_short", "jpeg_tile_short",
        "jpeg_separate_plane_short", "jpeg_16bit_lossless",
        "jpeg_16bit_lossless_min_is_white", "bits_extra_value_differs",
        "min_sample_one_value")
# the readable kinds whose strips are also cut and overwritten
DAMAGED = ("short_strip_present", "missing_counts_lzw", "jpeg_separate_rgb",
           "jpeg_separate_rgb_tiles", "jpeg_strip_short")


def _chunk_damage(data: bytes, tmp_path, rng, mutations: int):
    """Each strip's or tile's byte count cut to a few lengths, and copies
    with 1-3 bytes of the data replaced or bit-flipped: as cv2.imread
    reads them."""
    tags = tiff._ifd(data, "")[0]
    tag, name = (325, "tile_counts") if "tile_counts" in tags else (
        279, "strip_counts")
    offsets = tags["tile_offsets" if tag == 325 else "strip_offsets"]
    counts = tags.get(name, ())
    for k, count in enumerate(counts):
        for cut in (1, count // 3, count - 5):
            _same(_patch(data, tag, max(cut, 1), index=k), tmp_path)
    start, end = offsets[0], offsets[-1] + (counts[-1] if counts else 64)
    for _ in range(mutations):
        raw = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start, min(end, len(raw))))
            raw[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else \
                raw[i] ^ 1 << int(rng.integers(0, 8))
        _same(bytes(raw), tmp_path)


@pytest.mark.parametrize("name", READ)
def test_leftovers_read_as_cv2_reads(name, tmp_path):
    """The TIFF files the decoder refused and cv2.imread reads, bit for bit
    with it in both read modes: a single uncompressed strip whose byte
    count libtiff takes for wrong (short of the image, 0, past the file's
    end) and recounts from ImageLength, a compressed one of count 0 sized
    from the file, StripByteCounts missing where there is one strip per
    plane (or TileByteCounts of one tile), also where the directory's
    values count more bytes than the file holds; JPEG of separate planes (RGB in
    strips, one strip, tiles, without JPEGTables, at odd sizes, beside a
    2 x 2 subsampling tag that planes of RGB do not take; gray, gray with
    alpha, RGBA, YCbCr at 1 x 1); JPEG strips, tiles and planes shorter
    or narrower than their place (libtiff warns, the rest zeros), a
    16-bit lossless JPEG strip (zeros in the colour read: libjpeg's 8-bit
    scanline reader fails after libtiff's checks pass; None in the 16-bit
    one), BitsPerSample values past the samples; and, cut and overwritten
    (DAMAGED), as cv2 reads those."""
    data = _read_case(name)
    path = _same(data, tmp_path)
    assert cv2.imread(str(path)) is not None
    if name in DAMAGED:
        _chunk_damage(data, tmp_path, np.random.default_rng(
            READ.index(name)), mutations=40)


@pytest.mark.parametrize("sub", YCBCR_SUBSAMPLINGS)
def test_ycbcr_tile_predictor(sub, tmp_path):
    """LZW YCbCr data units in tiles under the horizontal predictor:
    libtiff undoes it three bytes apart over rows of the tile's width in
    pixels times 3 (TIFFTileRowSize, blind to the subsampling), where
    those rows divide the tile's bytes, and not at all where they do not
    (its error, passed over by the RGBA interface): as cv2.imread reads
    each tile shape, in both read modes; ``encode_tiff`` writes the
    differences over the same rows, so where libtiff undoes them the
    image is the one written (the 2 x 2 file also cut and overwritten)."""
    img = _image_32x48(71 + YCBCR_SUBSAMPLINGS.index(sub))
    for tile in ((16, 16), (16, 32), (32, 16), (16, 48)):
        data = tiff.encode_tiff(img, "lzw", predictor=2, photometric=6,
                                subsampling=sub, tile=tile)
        _same(data, tmp_path)
        plain = tiff.encode_tiff(img, "lzw", photometric=6, subsampling=sub,
                                 tile=tile)
        rows = 3 * tile[1]
        units = -(-tile[0] // sub[1]) * -(-tile[1] // sub[0]) * (
            sub[0] * sub[1] + 2)
        if sub != (1, 1) and units % rows == 0:
            np.testing.assert_array_equal(tiff.decode_tiff(data),
                                          tiff.decode_tiff(plain))
        if sub == (2, 2) and tile == (16, 16):
            _chunk_damage(data, tmp_path, np.random.default_rng(72), 30)


@pytest.mark.parametrize("fields", [
    {529: (11, [0.299, 1e-30, 0.114])}, {529: (11, [INF, 0.587, 0.114])},
    {529: (11, [INF, INF, 0.114])}, {529: (11, [-0.5, 0.587, 3.0])},
    {529: (11, [0.2, 0.7])}, {529: (11, [0.2, 0.7, 0.1, 0.5])},
    {529: (12, [0.2126, 0.7152, 0.0722])}, {532: (11, [0] * 6)},
    {532: (11, [7, 7, 128, 128, 3, 3])}, {532: (11, RBW[:5])},
    *({532: _rbw(k, v)[532]} for k in (0, 2, 5)
      for v in (2147483520.0, -2147483392.0))],
    ids=lambda f: "_".join(f"{t}_{len(v[1])}" for t, v in f.items()))
def test_ycbcr_fields_cv2_reads(fields, tmp_path):
    """YCbCrCoefficients and ReferenceBlackWhite libtiff takes: a green
    coefficient near 0 (only 0 and NaN are refused), infinite ones (a
    NaN they make clamps to 0), negative ones, fields of other than 3
    and 6 values (ignored: the defaults), DOUBLE values, a reference
    black equal to its white (divided by 1), and reference values at
    either end of the range (test_refused_where_cv2_returns_none holds
    the values just past it): as cv2.imread reads them."""
    img = _image_32x48(73)
    _same(tiff.encode_tiff(img, photometric=6, subsampling=(1, 1),
                           tags=fields), tmp_path)


def _queued_cases() -> dict:
    """The files test_twelve_bit_and_logluv24_are_queued once held to
    NotImplementedError: 12-bit samples (gray, min-is-white, LZW, odd
    widths in strips, RGBA, separate RGB planes, signed, palette) and SGI
    LogLuv24 over an 8-bit file's bytes."""
    rng = np.random.default_rng(74)
    v = rng.integers(0, 4096, (32, 48)).astype(np.uint16)
    v35 = rng.integers(0, 4096, (21, 35)).astype(np.uint16)
    v3 = rng.integers(0, 4096, (32, 48, 3)).astype(np.uint16)
    v4 = rng.integers(0, 4096, (32, 48, 4)).astype(np.uint16)
    enc = tiff.encode_tiff
    img = _image_32x48(75)
    img[..., 2] = rng.integers(100, 140, (32, 48))
    return {
        "gray": lambda: enc(v, chunks=[_twelve_bit(v)],
                            tags={258: (3, [12])}),
        "min_is_white": lambda: enc(v, chunks=[_twelve_bit(v)], tags={
            258: (3, [12]), 262: (3, [0])}),
        "lzw": lambda: enc(v, "lzw", chunks=[tiff.lzw_encode(_twelve_bit(v))],
                           tags={258: (3, [12])}),
        "odd_strips": lambda: enc(v35, rows_per_strip=8, chunks=[
            _twelve_bit(v35[i:i + 8]) for i in range(0, 21, 8)],
            tags={258: (3, [12])}),
        "rgba": lambda: enc(v4, chunks=[_twelve_bit(v4)],
                            tags={258: (3, [12] * 4)}),
        "separate_rgb": lambda: enc(v3, planar=2, chunks=[
            _twelve_bit(v3[..., k]) for k in range(3)],
            tags={258: (3, [12] * 3)}),
        "signed": lambda: enc(v, chunks=[_twelve_bit(v)], tags={
            258: (3, [12]), 339: (3, [2])}),
        "palette": lambda: enc(v, chunks=[_twelve_bit(v)], tags={
            258: (3, [12]), 262: (3, [3])}),
        "logluv24": lambda: _patch(_patch(enc(img), 259, 34677), 262, 32845),
    }


@pytest.mark.parametrize("name", list(_queued_cases()))
def test_twelve_bit_and_logluv24_are_queued(name, tmp_path):
    """What cv2.imread reads and the decoder once refused as
    NotImplementedError, now read bit for bit: 12-bit samples with
    IMREAD_ANYDEPTH (OpenCV widens them to 16 bits: one sample shifted up
    by 4, colour to the gray of the 12-bit samples, then shifted; signed
    samples saturated to int16), whose colour read cv2 refuses
    (ValueError), but for separate RGB planes, which cv2 reads partly from
    memory it never wrote (NotImplementedError, on purpose); SGI LogLuv24
    (photometric 32845 under SGI Log24) read in colour through libtiff's
    uv table, whose IMREAD_ANYDEPTH read cv2 refuses (ValueError)."""
    path = tmp_path / "q.tif"
    path.write_bytes(_queued_cases()[name]())
    if name == "logluv24":
        same_as_cv2(path, (False,))
        try:
            assert cv2.imread(str(path), cv2.IMREAD_ANYDEPTH) is None
        except cv2.error:
            pass
        with pytest.raises(ValueError, match="LogLuv"):
            image_io.imread(str(path), anydepth=True)
        return
    assert cv2.imread(str(path)) is None, name
    with pytest.raises(ValueError, match="12-bit"):
        image_io.imread(str(path))
    ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH)
    assert ref is not None and ref.dtype.itemsize == 2, name
    if name == "separate_rgb":
        with pytest.raises(NotImplementedError, match="12-bit"):
            image_io.imread(str(path), anydepth=True)
    else:
        same_as_cv2(path, (True,))


def _twelve_files() -> dict:
    """12-bit files of every layout cv2.imread reads with
    IMREAD_ANYDEPTH: one and three or four samples, signed, min-is-white,
    palette (neither inverted nor looked up), strips, tiles, LZW and
    Deflate, big-endian, FillOrder 2, orientation 3."""
    rng = np.random.default_rng(79)
    v = rng.integers(0, 4096, (21, 35)).astype(np.uint16)
    v3 = rng.integers(0, 4096, (21, 35, 3)).astype(np.uint16)
    v4 = rng.integers(0, 4096, (21, 35, 4)).astype(np.uint16)
    enc = tiff.encode_tiff
    return {
        "gray_tiles": enc(v, tile=(16, 16), twelve_bit=True),
        "gray_big_endian": enc(v, big_endian=True, twelve_bit=True),
        "gray_fill_order_2": enc(v, fill_order=2, twelve_bit=True),
        "gray_deflate_strips": enc(v, "deflate", rows_per_strip=4,
                                   twelve_bit=True),
        "gray_orientation_3": enc(v, orientation=3, twelve_bit=True),
        "rgb": enc(v3, twelve_bit=True),
        "rgb_lzw_tiles": enc(v3, "lzw", tile=(16, 16), twelve_bit=True),
        "rgb_signed": enc(v3, twelve_bit=True, tags={339: (3, [2] * 3)}),
        "rgba_signed": enc(v4, twelve_bit=True, tags={339: (3, [2] * 4)}),
        "gray_of_3_samples": enc(v3, photometric=1, twelve_bit=True),
        "palette_of_3_samples": enc(v3, photometric=3, twelve_bit=True),
        "signed_min_is_white": enc(v, photometric=0, twelve_bit=True,
                                   tags={339: (3, [2])}),
        "one_plane_separate": enc(v, planar=2, twelve_bit=True),
    }


@pytest.mark.parametrize("name", list(_twelve_files()))
def test_twelve_bit_samples_read_as_cv2_reads(name, tmp_path):
    """12-bit samples (module docstring of data/tiff.py, _twelve_bits):
    each layout bit for bit with cv2.imread in both modes (colour: None,
    ValueError), and LZW strips cut or overwritten refused where cv2
    returns None."""
    data = _twelve_files()[name]
    path = _same(data, tmp_path)
    assert cv2.imread(str(path), cv2.IMREAD_ANYDEPTH) is not None
    if name == "rgb_lzw_tiles":
        _chunk_damage(data, tmp_path, np.random.default_rng(80), 10)


def _logluv24_cv2(img: np.ndarray, tmp_path) -> bytes:
    """``cv2.imwrite``'s SGI LogLuv24 file of float ``img`` ([H, W, 3]
    BGR)."""
    path = tmp_path / "w.tif"
    assert cv2.imwrite(str(path), img, [
        cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_SGILOG24])
    return path.read_bytes()


def test_logluv24_reads_as_cv2_reads(tmp_path):
    """SGI LogLuv24 (photometric 32845 under SGI Log24: three bytes a
    pixel, a 10-bit log luminance and a 14-bit index into libtiff's uv
    table, csrc/host/tiff_uvtable.h), read in colour as libtiff's RGBA
    interface reads it (LogLuv24toXYZ, XYZtoRGB24): cv2.imwrite's files
    of random, saturating, zero, negative and very large values, and the
    port's encoder's codes over the whole 24-bit range with uv indices
    past the table (libtiff's uv_decode fails there and the neutral
    colour is taken), in one strip, strips of 5 rows, 16 x 16 tiles and
    big-endian; each strip cut and overwritten; bit for bit with
    cv2.imread, whose IMREAD_ANYDEPTH read fails (ValueError); separate
    planes refused as cv2 refuses them."""
    rng = np.random.default_rng(81)
    shape = (21, 35, 3)
    for img in (rng.random(shape), rng.random(shape) * 50,
                np.zeros(shape), rng.random(shape) - 0.5,
                rng.random(shape) * 1e20):
        _same(_logluv24_cv2(img.astype(np.float32), tmp_path), tmp_path)
    codes = rng.integers(0, 1 << 24, shape[:2]).astype(np.uint32)
    codes[:, :6] = (codes[:, :6] & np.uint32(0xffc000)) | rng.integers(
        16280, 16384, (21, 6)).astype(np.uint32)
    for layout in ({}, dict(rows_per_strip=5), dict(tile=(16, 16)),
                   dict(big_endian=True)):
        _same(tiff.encode_tiff(codes, "sgilog24", **layout), tmp_path)
    data = tiff.encode_tiff(codes, "sgilog24", rows_per_strip=5)
    _strip_damage(data, tmp_path, rng, mutations=20)
    path = _same(tiff.encode_tiff(codes, "sgilog24", planar=2), tmp_path)
    assert cv2.imread(str(path)) is None


@pytest.mark.parametrize("scheme", [34676, 34677])
@pytest.mark.parametrize("bits,fmt", [(1, 1), (4, 2), (8, 4), (16, 1),
                                      (16, 3), (12, 1), (32, 1), (32, 3),
                                      (64, 2)])
def test_logluv_sample_fields(scheme, bits, fmt, tmp_path):
    """LogLuv's BitsPerSample and SampleFormat, which libtiff's codec
    overrides and OpenCV checks: read at 1, 2, 4, 8 and 16 bits of any
    format but floating point, refused (cv2 returns None) at 12, 24, 32
    and 64 bits and of floating-point samples, for LogLuv24 and LogLuv32
    alike (probed with cv2.imread)."""
    rng = np.random.default_rng(82)
    data = tiff.encode_tiff(rng.integers(0, 1 << 24, (9, 13)).astype(
        np.uint32), "sgilog24")
    if scheme == 34676:
        data = _patch(data, 259, 34676)
    for k in range(3):
        data = _patch(_patch(data, 258, bits, k), 339, fmt, k)
    path = _same(data, tmp_path, (False,))
    assert (cv2.imread(str(path)) is None) == (
        bits not in (1, 2, 4, 8, 16) or fmt == 3)


def _logluv32(codes: np.ndarray, **layout) -> bytes:
    """A TIFF of 32-bit LogLuv ``codes`` ([H, W]: 16-bit signed log
    luminance, then 8-bit u and v) under SGI Log, 3 samples per pixel as
    libtiff writes LogLuv, each strip or tile coded by ``logl_encode``."""
    H, W = codes.shape
    tile = layout.get("tile")
    ch, cw = tile if tile else (layout.get("rows_per_strip") or H, W)
    full = np.zeros((-(-H // ch) * ch, -(-W // cw) * cw), np.uint32)
    full[:H, :W] = codes
    chunks = [tiff.logl_encode(full[y:y + (ch if tile else min(ch, H - y)),
                                    x:x + cw], planes=4)
              for y in range(0, H, ch) for x in range(0, W, cw)]
    data = tiff.encode_tiff(np.zeros((H, W, 3), np.uint16), chunks=chunks,
                            **layout)
    return _patch(_patch(data, 259, 34676), 262, 32845)


def test_logluv32_reads_as_cv2_reads(tmp_path):
    """SGI LogLuv32 (photometric 32845 under SGI Log, 3 samples), read in
    colour as libtiff's RGBA interface reads it (tif_luv.c LogLuvDecode32,
    LogLuv32toXYZ, XYZtoRGB24: CCIR-709 primaries, a gamma of 2, in C):
    random codes over the whole 32-bit range and over luminances near 1,
    with runs, in one strip, strips of 5 rows and 16 x 16 tiles, and each
    strip cut and overwritten, bit for bit with cv2.imread (whose
    IMREAD_ANYDEPTH read fails: ValueError); separate planes and one
    sample per pixel refused as cv2 refuses them."""
    rng = np.random.default_rng(78)
    codes = rng.integers(0, 2 ** 32, (21, 35), dtype=np.uint64).astype(
        np.uint32)
    near = (codes & 0x8000FFFF) | (rng.integers(
        15000, 18500, codes.shape).astype(np.uint32) << 16)
    near[:, 20:] = near[:, 20:21]  # runs
    for c in (codes, near):
        for layout in ({}, dict(rows_per_strip=5), dict(tile=(16, 16))):
            _same(_logluv32(c, **layout), tmp_path)
    data = _logluv32(near, rows_per_strip=5)
    _strip_damage(data, tmp_path, rng, mutations=30)
    for bad in (_logluv32(near, planar=2), _patch(
            _patch(tiff.encode_tiff(near.astype(np.uint16), chunks=[
                tiff.logl_encode(near, planes=4)]), 259, 34676), 262,
            32845)):
        path = _same(bad, tmp_path)
        assert cv2.imread(str(path)) is None
@pytest.mark.parametrize("compression", ["lzw", "deflate"])
@pytest.mark.parametrize("layout", [dict(rows_per_strip=8),
                                    dict(tile=(16, 16))],
                         ids=["strips", "tiles"])
def test_damaged_chunks_keep_their_differences(compression, layout,
                                               tmp_path):
    """A strip or tile under the horizontal predictor whose data fails to
    decode (cut short, overwritten): libtiff's predictor undoes nothing of
    it (PredictorDecodeTile returns on the codec's failure), and its RGBA
    interface shows the differences as decoded: as cv2.imread reads
    them, in both read modes, 8-bit gray and RGB."""
    img = _image_32x48(76)
    for im in (img, np.ascontiguousarray(img[..., 1])):
        data = tiff.encode_tiff(im, compression, predictor=2, **layout)
        _chunk_damage(data, tmp_path, np.random.default_rng(77), 20)
