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
    np.testing.assert_array_equal(
        tiff._decompress(lzw, len(raw), 5, "", partial=False),
        np.frombuffer(raw, np.uint8))
    with pytest.raises(ValueError, match="LZW"):
        tiff._decompress(lzw[:len(lzw) // 2], len(raw), 5, "", False)
    part = tiff._decompress(lzw[:len(lzw) // 2], len(raw), 5, "", True)
    assert part[-500:].max() == 0 and part[:100].tobytes() == raw[:100]
    pb = tiff.packbits_encode(raw)
    assert tiff._decompress(pb, len(raw), 32773, "", False).tobytes() == raw
    old = tiff.lzw_encode(raw, old_style=True)
    assert old[0] == 0 and old[1] & 1  # libtiff's test for old-style codes
    assert tiff._decompress(old, len(raw), 5, "", False,
                            old_lzw=True).tobytes() == raw
    with pytest.raises(ValueError, match="LZW"):
        tiff._decompress(old, len(raw), 5, "", False)
    assert tiff._decompress(old, len(raw), 5, "", True).max() == 0


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
    (ValueError), or fewer (libtiff warns and reads them short:
    NotImplementedError); a JPEG strip of 3 components in a file of 1
    sample (cv2 returns None)."""
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
    path = tmp_path / "t.tif"
    path.write_bytes(_patch(good, 278, 24))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(NotImplementedError, match="reads it short"):
        image_io.imread(str(path))
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
    LogL under SGI Log24, or of 2 samples: None, ValueError; LogLuv
    (32845), which no writer here makes: NotImplementedError."""
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
                tiff.encode_tiff(np.stack([codes, codes], -1), "sgilog")):
        path = _same(bad, tmp_path)
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path))
    with pytest.raises(NotImplementedError, match="LogLuv"):
        tiff.decode_tiff(_patch(data, 262, 32845))


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
    CMYK, YCbCr, CIE L*a*b* and SGI LogL files of a rendered frame): the
    port's arrays hash as cv2.imread's do (the hashes written beside them,
    which chip_smoke.py phase 15 checks on machines without OpenCV), and
    cv2 still agrees; each file at most 64 KB, the set at most 256 KB."""
    import hashlib
    import json
    import os

    folder = os.path.join(os.path.dirname(__file__), "data", "tiff")
    hashes = json.load(open(os.path.join(folder, "hashes.json")))
    assert len(hashes) == 9
    total = 0
    for name, want in hashes.items():
        path = os.path.join(folder, name)
        total += os.path.getsize(path)
        assert os.path.getsize(path) <= 64 * 1024
        for mode, flag in (("color", cv2.IMREAD_COLOR),
                           ("anydepth", cv2.IMREAD_ANYDEPTH)):
            got = image_io.imread(path, anydepth=mode == "anydepth")
            ref = cv2.imread(path, flag)
            for a in (got, ref):
                assert hashlib.sha256(a.tobytes()).hexdigest() == \
                    want[mode]["sha256"]
                assert list(a.shape) == want[mode]["shape"]
                assert str(a.dtype) == want[mode]["dtype"]
    assert total <= 256 * 1024
