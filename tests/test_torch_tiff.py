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
    file cut short, an 8-bit file's compression tag set to JPEG over raw
    data, to LZMA, ZSTD, WebP or LERC, which this libtiff does not decode,
    or to CCITT, which codes 1-bit images only; a BigTIFF header pointing
    at no directory); what cv2 reads and the port does not, or reads only
    from memory it never wrote, raises NotImplementedError naming it (a
    scheme libtiff does not know, JPEG XL, whose zeroed buffers cv2 reads;
    16-bit separate colour planes read to gray)."""
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
        with pytest.raises(ValueError if refused else NotImplementedError,
                           match=name):
            read(data)
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
