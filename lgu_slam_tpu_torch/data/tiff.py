"""TIFF files for the port's data layer: a decoder that returns what
``cv2.imread`` (OpenCV 5.0 over libtiff 4.7) returns, and an encoder of
the files it reads, for fixtures.

:func:`decode_tiff` reads page 0 of a classic TIFF (``II*\\0`` or
``MM\\0*``) or a BigTIFF (``II+\\0`` / ``MM\\0+``): strips or tiles,
``PlanarConfiguration`` 1 or 2, compression none, LZW, Deflate (8 and
32946), PackBits or JPEG (7: libtiff's codec, ``JPEGTables``, YCbCr
subsampling; each strip through the port's C JPEG decoder), the
horizontal and the floating-point predictor; 1-, 8- and 16-bit unsigned
gray (min-is-black or min-is-white), RGB and RGBA, 8-bit palette, and
the other sample formats OpenCV reads (``int8``, ``int16``, ``uint32``,
``int32``, ``uint64``, ``int64``, ``float32``, ``float64``);
orientations 1-4.  The LZW and PackBits decoders and the predictors run
in C (``csrc/host/tiff_lzw.c``, built by the host compiler at first use).

OpenCV reads a TIFF along one of two paths, and the decoder takes the same:

- an 8-bit result (``cv2.imread(path)``, or ``cv2.IMREAD_ANYDEPTH`` of a
  1- or unsigned 8-bit file) goes through libtiff's RGBA interface
  (``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``): 16-bit gray keeps its
  high byte, 16-bit colour becomes ``(x * 255 + 32767) // 65535`` (that is
  ``round(x / 257)``), signed samples are read as their unsigned bits,
  min-is-white is inverted, a palette is looked up (its entries shifted
  right by 8 unless every one is below 256), an unassociated alpha is
  multiplied in, JPEG's YCbCr comes out as libjpeg's RGB; then BGR, or
  gray by OpenCV's own ``(4899 R + 9617 G + 1868 B + 8192) >> 14``;
- a result of another dtype (``cv2.IMREAD_ANYDEPTH`` of a 16-, 32- or
  64-bit or signed file) is the samples as stored: one channel as it is,
  8/16-bit colour to gray by the same formula on the bits read as
  unsigned; 32/64-bit colour and any 32/64-bit read without
  ``IMREAD_ANYDEPTH`` are refused (cv2 returns None: ``ValueError``).

Orientations 2-4 flip the result as cv2.imread does; 5-8 (transposes) it
refuses.  Files OpenCV reads and this decoder does not (the CCITT schemes,
old-style JPEG and LZW, SGI Log, schemes libtiff does not know, other
photometric interpretations and layouts) raise ``NotImplementedError``
naming what they hold; files OpenCV refuses (among them the compressions
this libtiff build lacks: LZMA, ZSTD, WebP, LERC, JBIG and others) raise
``ValueError``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from lgu_slam_tpu_torch.data.pnm import gray14
from lgu_slam_tpu_torch.ops import _build

TIFF_II = b"II*\0"
TIFF_MM = b"MM\0*"
BIGTIFF = (b"II+\0", b"MM\0+")

COMPRESSION = {1: "none", 5: "LZW", 7: "JPEG", 8: "Deflate",
               32946: "Deflate", 32773: "PackBits"}
# compressions OpenCV's libtiff reads and the decoder does not: the CCITT
# schemes of 1-bit images, old-style JPEG with its JPEG tags, SGI Log of
# LogL / LogLuv images (cv2.imread returns None for the others)
CCITT = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
         32771: "CCITT RLEW"}
SGILOG = {34676: "SGI LogLuv", 34677: "SGI LogL"}
# compressions this libtiff build does not decode (not configured, or
# for no depth cv2.imread reads): cv2.imread returns None
REFUSED_COMPRESSION = {32766: "NeXT", 32809: "ThunderScan",
                       32909: "PixarLog", 34661: "JBIG", 34887: "LERC",
                       34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
# schemes libtiff does not know: its RGBA interface reads their zeroed
# buffers, so cv2.imread returns an image
UNKNOWN_COMPRESSION = {34712: "JPEG 2000", 50002: "JPEG XL",
                       52546: "JPEG XL"}
# tag -> name of the tags read
TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
        262: "photometric", 273: "strip_offsets", 274: "orientation",
        277: "spp", 278: "rows_per_strip", 279: "strip_counts",
        284: "planar", 317: "predictor", 320: "colormap",
        322: "tile_width", 323: "tile_length", 324: "tile_offsets",
        325: "tile_counts", 338: "extra_samples", 339: "sample_format",
        347: "jpeg_tables", 513: "ojpeg_interchange", 519: "ojpeg_qtables",
        530: "ycbcr_subsampling"}
# TIFF field type -> (struct code, bytes); 16-18 are BigTIFF's
TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
         7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 11: ("f", 4), 12: ("d", 8),
         13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
# (SampleFormat, BitsPerSample) -> the dtype of the samples as stored
SAMPLE_DTYPES = {(1, 8): np.uint8, (2, 8): np.int8, (1, 16): np.uint16,
                 (2, 16): np.int16, (1, 32): np.uint32, (2, 32): np.int32,
                 (3, 32): np.float32, (1, 64): np.uint64, (2, 64): np.int64,
                 (3, 64): np.float64}
# the photometric interpretations libtiff's RGBA interface takes (others:
# cv2.imread returns None for an 8-bit read)
RGBA_PHOTOMETRIC = (0, 1, 2, 3, 5, 6, 8, 32844, 32845)
# Orientation -> the flips cv2.imread applies (through libtiff's RGBA
# interface, or OpenCV's own for the samples as stored); 5-8 transpose,
# which it refuses
ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
          4: lambda a: a[::-1]}
# OpenCV's CV_IO_MAX_IMAGE_PIXELS and _WIDTH / _HEIGHT
MAX_PIXELS = 1 << 30
MAX_SIDE = 1 << 20


def _ifd(data: bytes, path) -> tuple:
    """The tags of the first image file directory (classic TIFF, or
    BigTIFF with its 8-byte counts and offsets): name -> tuple of values,
    and the byte order."""
    if data[:4] not in (TIFF_II, TIFF_MM) + BIGTIFF:
        raise ValueError(f"{path}: not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    big = data[:4] in BIGTIFF
    # the directory's offset, entry count, entry and inline value sizes
    head, count, entry, inline = ("HHQ", "Q", "HHQ8s", 8) if big else (
        "I", "H", "HHI4s", 4)
    if len(data) < 4 + struct.calcsize(bo + head):
        raise ValueError(f"{path}: TIFF header cut short")
    off = struct.unpack_from(bo + head, data, 4)
    if big and off[:2] != (8, 0):
        raise ValueError(f"{path}: BigTIFF offsets of {off[0]} bytes")
    off = off[-1]
    esize, csize = struct.calcsize(bo + entry), struct.calcsize(bo + count)
    if off < 4 + struct.calcsize(bo + head) or off + csize > len(data):
        raise ValueError(f"{path}: TIFF directory offset {off} is outside "
                         "the file")
    n, = struct.unpack_from(bo + count, data, off)
    if n == 0 or off + csize + esize * n > len(data):
        raise ValueError(f"{path}: TIFF directory of {n} entries cut short")
    tags = {}
    for k in range(n):
        tag, typ, count_k, value = struct.unpack_from(
            bo + entry, data, off + csize + esize * k)
        if tag not in TAGS or typ not in TYPES:
            continue
        code, size = TYPES[typ]
        nbytes = size * count_k
        if nbytes <= inline:
            raw = value[:nbytes]
        else:
            at, = struct.unpack(bo + ("Q" if big else "I"), value)
            if at + nbytes > len(data):
                raise ValueError(f"{path}: TIFF tag {tag} runs past the end "
                                 "of the file")
            raw = data[at:at + nbytes]
        tags[TAGS[tag]] = struct.unpack(f"{bo}{count_k}{code}", raw)
    return tags, bo


def _one(tags, name, default=None):
    v = tags.get(name)
    return default if v is None else int(v[0])


def _lib():
    lib = _build.load("tiff_lzw")
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, i64, ptr, i64]
        fn.restype = cint
    lib.tiff_hpredict.argtypes = [ptr, i64, i64, i64, cint, cint]
    lib.tiff_hpredict.restype = None
    lib.tiff_fpredict.argtypes = [ptr, i64, i64, i64, cint]
    lib.tiff_fpredict.restype = cint
    return lib


def _inflate(raw: bytes, size: int) -> tuple:
    """zlib's output of ``raw`` up to ``size`` bytes, and whether the data
    was damaged; on damage, the output up to it (fed byte by byte)."""
    try:
        return zlib.decompressobj().decompress(raw, size), False
    except zlib.error:
        pass
    d, got = zlib.decompressobj(), b""
    try:
        for i in range(len(raw)):
            got += d.decompress(raw[i:i + 1], size - len(got))
            if len(got) >= size:
                break
    except zlib.error:
        pass
    return got, True


def _decompress(raw: bytes, size: int, compression: int, path,
                partial: bool) -> np.ndarray:
    """One strip or tile of ``size`` bytes as libtiff decodes it (the data
    may hold more).  Where the data is damaged or ends early, libtiff
    reports an error: with ``partial`` (its RGBA interface, which goes on)
    the bytes decoded up to there and zeros, else ``ValueError``."""
    out = np.zeros(size, np.uint8)
    if compression == 1:
        if len(raw) >= size:
            out[:] = np.frombuffer(raw, np.uint8, size)
        elif not partial:  # libtiff copies nothing of a short strip
            raise ValueError(f"{path}: an uncompressed TIFF strip of "
                             f"{len(raw)} bytes for {size}")
        return out
    if compression in (8, 32946):
        got, damaged = _inflate(raw, size)
        out[:len(got)] = np.frombuffer(got, np.uint8)
        status = 1 if damaged or len(got) < size else 0
    else:
        lib = _lib()
        fn = lib.tiff_lzw_decode if compression == 5 else \
            lib.tiff_packbits_decode
        status = fn(raw, len(raw), out.ctypes.data, size)
        if status == 2:
            raise NotImplementedError(f"{path}: old-style (pre-6.0) TIFF "
                                      "LZW")
    if status == 3:
        raise MemoryError(f"{path}: out of memory")
    if status and not partial:
        raise ValueError(f"{path}: TIFF {COMPRESSION[compression]} data is "
                         "damaged or cut short")
    return out


def _unpredict(buf: np.ndarray, rows: int, rowbytes: int, stride: int,
               bits: int, predictor: int, swap: bool) -> None:
    """Undo the predictor of a decompressed chunk in place (C)."""
    lib = _lib()
    if predictor == 2:
        lib.tiff_hpredict(buf.ctypes.data, rows, rowbytes, stride, bits // 8,
                          int(swap))
    elif lib.tiff_fpredict(buf.ctypes.data, rows, rowbytes, stride,
                           bits // 8):
        raise MemoryError("tiff_fpredict: out of memory")


def _skewed_rows(buf: np.ndarray, h: int, w: int, cw: int) -> np.ndarray:
    """The 16-bit gray samples libtiff's RGBA interface reads from a tile
    clipped by the image's right edge (tif_getimage.c put16bitbwtile): it
    steps from one row to the next by ``w`` samples and ``cw - w`` bytes,
    not samples, so row ``i`` starts ``i * (w + cw)`` bytes into the tile,
    at an odd byte where ``w + cw`` is odd."""
    at = (np.arange(h)[:, None] * (w + cw) + 2 * np.arange(w)[None])
    lo, hi = buf[at].astype(np.uint16), buf[at + 1].astype(np.uint16)
    return (lo | hi << 8)[..., None]


def _uncompressed_counts(counts, H: int, down: int, rowbytes: int,
                         path) -> tuple:
    """The strip byte counts libtiff reads an uncompressed image with
    (tif_dirread.c): where the first two of several differ, it takes them
    for wrong and sets every one to ``H // down`` rows (then a strip may
    run past the file's end, or hold fewer rows than it should)."""
    if len(counts) > 1 and counts[0] != counts[1] and counts[0] and \
            counts[1]:
        return ((H // down) * rowbytes,) * len(counts)
    if len(counts) == 1 and counts[0] < rowbytes * H:
        raise NotImplementedError(
            f"{path}: a single uncompressed TIFF strip of {counts[0]} bytes "
            f"for {rowbytes * H} (libtiff estimates its size anew)")
    return counts


def _check_compression(tags: dict, compression: int, bits: int, path
                       ) -> None:
    """Refuse what the decoder does not read: ``ValueError`` where
    cv2.imread returns None (probed with files of each scheme: the codecs
    this libtiff build lacks, the CCITT schemes of more than 1 bit,
    old-style JPEG without its JPEG tags, SGI Log of other photometric
    interpretations), ``NotImplementedError`` where it reads an image."""
    photometric = _one(tags, "photometric", 1)
    name = None
    if compression in REFUSED_COMPRESSION:
        raise ValueError(f"{path}: TIFF {REFUSED_COMPRESSION[compression]} "
                         "compression, which this OpenCV's libtiff does not "
                         "decode (cv2.imread returns None)")
    if compression in CCITT:
        if bits != 1:
            raise ValueError(f"{path}: TIFF {CCITT[compression]} of "
                             f"{bits}-bit samples (cv2.imread returns None)")
        name = CCITT[compression]
    elif compression == 6:
        if "ojpeg_interchange" not in tags and "ojpeg_qtables" not in tags:
            raise ValueError(f"{path}: old-style JPEG TIFF without its JPEG "
                             "tags (cv2.imread returns None)")
        name = "old-style JPEG"
    elif compression in SGILOG:
        if photometric not in (32844, 32845):
            raise ValueError(f"{path}: TIFF {SGILOG[compression]} of "
                             f"photometric interpretation {photometric} "
                             "(cv2.imread returns None)")
        name = SGILOG[compression]
    elif compression not in COMPRESSION:
        name = UNKNOWN_COMPRESSION.get(compression, f"scheme {compression}")
        name += " (unknown to libtiff: cv2.imread reads zeroed buffers)"
    if name is not None:
        raise NotImplementedError(f"{path}: TIFF {name} compression")
    if compression == 7 and bits != 8:
        raise NotImplementedError(f"{path}: JPEG TIFF of {bits}-bit "
                                  "samples")


def _jpeg_tables(tags: dict) -> bytes:
    """The DQT, DHT and DAC segments of the JPEGTables field (an
    abbreviated stream that libtiff reads before each strip's)."""
    raw, out, pos = bytes(tags.get("jpeg_tables", ())), [], 2
    while pos + 4 <= len(raw) and raw[pos] == 0xFF:
        n, = struct.unpack_from(">H", raw, pos + 2)
        if raw[pos + 1] in (0xDB, 0xC4, 0xCC):
            out.append(raw[pos:pos + 2 + n])
        pos += 2 + n
    return b"".join(out)


def _jpeg_chunk_samples(raw: bytes, tables: bytes, seg_h: int, seg_w: int,
                        last_strip: bool, photometric: int, sub: tuple,
                        spp: int, k: int, path) -> np.ndarray:
    """One JPEG strip or tile as libtiff's JPEG codec decodes it
    (tif_jpeg.c JPEGPreDecode, JPEGDecode): the tables read first, its
    size and sampling checked against the strip's (a last strip may hold
    more rows, which are dropped), YCbCr taken to RGB by libjpeg
    (JPEGCOLORMODE_RGB), other components as stored."""
    from lgu_slam_tpu_torch.data.image_io import (JPEG_OUT_RAW,
                                                  JPEG_OUT_YCC_RGB,
                                                  jpeg_info, jpeg_samples)

    stream = b"\xff\xd8" + tables + raw[2:] if raw[:2] == b"\xff\xd8" \
        else raw
    where = f"{path}: TIFF JPEG strip or tile {k}"
    # libtiff's JPEGPreDecode reads the header and starts the decompressor
    # (a progressive stream is absorbed there): a failure fails the strip
    # read, and cv2.imread returns None (ValueError)
    h, w, _, ncomp, h0, v0, rest_1x1 = jpeg_info(stream, where)
    ycc = photometric == 6
    want = (sub if ycc else (1, 1), 1)
    if ncomp != spp or ((h0, v0), rest_1x1) != want:
        raise ValueError(f"{where}: {ncomp} components sampled {h0}x{v0} "
                         f"(the TIFF's {spp} at {want[0]})")
    if w > seg_w or (h > seg_h and not (w == seg_w and last_strip)):
        raise ValueError(f"{where}: {w}x{h} exceeds the strip's "
                         f"{seg_w}x{seg_h}")
    if w < seg_w or h < seg_h:
        raise NotImplementedError(f"{where}: {w}x{h} for the strip's "
                                  f"{seg_w}x{seg_h} (libtiff warns and "
                                  "reads it short)")
    px = jpeg_samples(stream, JPEG_OUT_YCC_RGB if ycc else JPEG_OUT_RAW,
                      ncomp, where)
    return px[:seg_h]


def _samples(data: bytes, tags: dict, bo: str, path, partial: bool,
             bw16_skew: bool = False) -> np.ndarray:
    """The stored samples of page 0: ``[H, W, spp]`` of the dtype of
    :data:`SAMPLE_DTYPES` (1 bit: ``uint8`` 0 or 1) in the host's byte
    order; JPEG chunks decoded to ``uint8`` RGB (YCbCr converted) or
    gray.  ``partial``: damaged chunks as far as they decode (libtiff's
    RGBA interface); ``bw16_skew``: the samples of 16-bit gray tiles at the
    right edge as that interface reads them (:func:`_skewed_rows`)."""
    W, H = _one(tags, "width", 0), _one(tags, "height", 0)
    if W <= 0 or H <= 0:
        raise ValueError(f"{path}: TIFF of {W} x {H} pixels")
    if W > MAX_SIDE or H > MAX_SIDE or W * H > MAX_PIXELS:
        raise ValueError(f"{path}: TIFF of {W} x {H} pixels is more than "
                         "cv2.imread reads")
    spp = _one(tags, "spp", 1)
    bits = set(tags.get("bits", (1,)))
    if len(bits) != 1:
        raise NotImplementedError(f"{path}: TIFF samples of mixed depths")
    bits = bits.pop()
    compression = _one(tags, "compression", 1)
    _check_compression(tags, compression, bits, path)
    # libtiff applies a predictor only for the codecs that take one
    predictor = _one(tags, "predictor", 1) if compression in (5, 8, 32946) \
        else 1
    planar = _one(tags, "planar", 1)
    if planar not in (1, 2):
        raise ValueError(f"{path}: TIFF planar configuration {planar}")
    if compression == 7 and planar == 2:
        raise NotImplementedError(f"{path}: JPEG TIFF of separate planes")
    if predictor not in (1, 2, 3) or (predictor == 3 and bits < 32) or (
            predictor == 2 and bits not in (8, 16, 32, 64)):
        raise NotImplementedError(f"{path}: TIFF predictor {predictor} of "
                                  f"{bits}-bit samples")
    tiled = "tile_width" in tags
    if tiled:
        cw, ch = _one(tags, "tile_width"), _one(tags, "tile_length", 0)
        offsets, counts = tags.get("tile_offsets"), tags.get("tile_counts")
    else:
        cw = W
        ch = min(_one(tags, "rows_per_strip", H) or H, H)
        offsets, counts = tags.get("strip_offsets"), tags.get("strip_counts")
    if cw <= 0 or ch <= 0 or offsets is None or counts is None:
        raise ValueError(f"{path}: TIFF without its strips or tiles")
    planes = spp if planar == 2 else 1
    per = spp // planes  # samples per pixel in a chunk
    rowbytes = (cw * per * bits + 7) // 8
    across = -(-W // cw)
    down = -(-H // ch)
    if min(len(offsets), len(counts)) < planes * across * down:
        raise ValueError(f"{path}: TIFF lists {len(offsets)} of its "
                         f"{planes * across * down} strips or tiles")
    if compression == 1 and not tiled:
        counts = _uncompressed_counts(counts, H, down, rowbytes, path)
    dtype = np.uint8 if bits == 1 else SAMPLE_DTYPES[
        (_one(tags, "sample_format", 1), bits)]
    out = np.zeros((H, W, spp), dtype)
    swap = bo == ">"
    tables = _jpeg_tables(tags)
    photometric = _one(tags, "photometric", 1)
    sub = tuple(int(v) for v in tags.get("ycbcr_subsampling", (2, 2)))
    for p in range(planes):
        for cy in range(down):
            for cx in range(across):
                k = (p * down + cy) * across + cx
                rows = ch if tiled else min(ch, H - cy * ch)
                size = rows * rowbytes
                off, cnt = int(offsets[k]), int(counts[k])
                if off + cnt > len(data) or cnt == 0:
                    raise ValueError(f"{path}: TIFF strip or tile {k} runs "
                                     "past the end of the file")
                y0, x0 = cy * ch, cx * cw
                h, w = min(rows, H - y0), min(cw, W - x0)
                if compression == 7:
                    px = _jpeg_chunk_samples(
                        data[off:off + cnt], tables, rows, cw,
                        not tiled and cy == down - 1, photometric, sub, spp,
                        k, path)
                    out[y0:y0 + h, x0:x0 + w] = px[:h, :w]
                    continue
                buf = _decompress(data[off:off + cnt], size, compression,
                                  path, partial)
                if predictor > 1:
                    _unpredict(buf, rows, rowbytes, per, bits, predictor,
                               swap)
                elif bits > 8 and swap:
                    buf = buf.view(f">u{bits // 8}").byteswap().view(
                        np.uint8)
                if bits == 1:
                    px = np.unpackbits(buf.reshape(rows, rowbytes), axis=1
                                       )[:, :cw, None]
                elif bw16_skew and tiled and w < cw:
                    px = _skewed_rows(buf, h, w, cw)
                else:
                    px = buf.view(dtype).reshape(rows, cw, per)
                out[y0:y0 + h, x0:x0 + w, p * per:(p + 1) * per] = \
                    px[:h, :w]
    return out


def _rgba(s: np.ndarray, tags: dict, photometric: int, bits: int,
          path) -> np.ndarray:
    """libtiff's RGBA interface of the samples: ``uint8 [H, W, 4]``."""
    H, W, spp = s.shape
    if bits not in (1, 8, 16):
        raise NotImplementedError(f"{path}: TIFF {bits}-bit samples")
    rgba = np.full((H, W, 4), 255, np.uint8)
    if photometric in (0, 1):
        if spp != 1:
            raise NotImplementedError(f"{path}: TIFF gray with {spp - 1} "
                                      "extra samples")
        g = s[..., 0]
        g = g * np.uint8(255) if bits == 1 else (
            (g >> 8).astype(np.uint8) if bits == 16 else g)
        if photometric == 0:
            g = 255 - g
        rgba[..., :3] = g[..., None]
        return rgba
    if photometric == 3:
        cmap = tags.get("colormap")
        if bits != 8 or spp != 1:
            raise NotImplementedError(f"{path}: TIFF {bits}-bit palette")
        if cmap is None or len(cmap) != 3 << bits:
            raise ValueError(f"{path}: TIFF palette image without its "
                             "colour map")
        cmap = np.asarray(cmap, np.int64).reshape(3, 1 << bits)
        if cmap.max() >= 256:  # 16-bit entries (libtiff's checkcmap)
            cmap = cmap >> 8
        rgba[..., :3] = cmap.T[s[..., 0]].astype(np.uint8)
        return rgba
    if photometric != 2:
        raise NotImplementedError(f"{path}: TIFF photometric "
                                  f"interpretation {photometric}")
    if bits == 1 or spp not in (3, 4):
        raise NotImplementedError(f"{path}: TIFF RGB of {spp} {bits}-bit "
                                  "samples")
    if bits == 16:  # libtiff's Bitdepth16To8
        s = ((s.astype(np.int64) * 255 + 32767) // 65535).astype(np.uint8)
    rgba[..., :spp] = s
    extra = tags.get("extra_samples", (0,))
    if spp == 4 and extra[0] == 2:  # unassociated alpha: libtiff's UaToAa
        a = s[..., 3:4].astype(np.int64)
        rgba[..., :3] = (s[..., :3] * a + 127) // 255
    return rgba


def decode_tiff(data: bytes, path="<bytes>", gray: bool = False,
                page: int = 0) -> np.ndarray:
    """TIFF bytes -> what ``cv2.imread`` returns for a file of them (module
    docstring): ``uint8 [H, W, 3]`` BGR, or with ``gray`` what
    ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` returns: ``[H, W]`` of
    ``uint8`` (1- and unsigned 8-bit files, through libtiff's RGBA
    interface), or of the samples' own dtype (``int8``, ``uint16``,
    ``int16``, ``uint32``, ``int32``, ``uint64``, ``int64``, ``float32``
    or ``float64``).
    Orientations 2-4 flip the image as cv2.imread does.  Only page 0 is
    read, as ``cv2.imread`` reads it."""
    if page != 0:
        raise NotImplementedError(f"{path}: TIFF page {page} (page 0 is "
                                  "read)")
    tags, bo = _ifd(data, path)
    if "photometric" not in tags:
        raise ValueError(f"{path}: TIFF without a photometric "
                         "interpretation (cv2.imread returns None)")
    photometric = _one(tags, "photometric")
    bits = int(tags.get("bits", (1,))[0])
    fmt = _one(tags, "sample_format", 1)
    spp = _one(tags, "spp", 1)
    if photometric == 3 and "colormap" not in tags and bits >= 8:
        # tif_dirread.c: a palette image without its colour map is read
        # as gray, or with 3 samples as RGB
        photometric = 2 if spp == 3 else 1
        tags = dict(tags, photometric=(photometric,))
    orientation = _one(tags, "orientation", 1)
    if orientation in (5, 6, 7, 8):
        raise ValueError(f"{path}: TIFF orientation {orientation}, a "
                         "transpose (cv2.imread returns None)")
    if bits in (2, 4):
        raise ValueError(f"{path}: TIFF {bits}-bit samples (cv2.imread "
                         "returns None)")
    if not (fmt == 1 and bits == 1) and (fmt, bits) not in SAMPLE_DTYPES:
        raise ValueError(f"{path}: TIFF sample format {fmt} at {bits} bits "
                         "(cv2.imread returns None)")
    if photometric not in RGBA_PHOTOMETRIC and not (gray and bits >= 16):
        raise ValueError(f"{path}: TIFF photometric interpretation "
                         f"{photometric}, which libtiff's RGBA interface "
                         "does not read (cv2.imread returns None)")
    if bits >= 32 and not gray:
        raise ValueError(f"{path}: {bits}-bit TIFF read without "
                         "IMREAD_ANYDEPTH (cv2.imread returns None)")
    if bits >= 32 and spp != 1:
        raise ValueError(f"{path}: {bits}-bit TIFF of {spp} samples read as "
                         "one channel (cv2.imread returns None)")
    # the samples as stored where the result keeps their depth or sign,
    # else libtiff's RGBA interface
    raw = gray and (bits >= 16 or fmt == 2)
    if raw and bits == 16 and photometric not in (0, 1, 2):
        raise NotImplementedError(f"{path}: 16-bit TIFF photometric "
                                  f"interpretation {photometric}")
    if raw and spp not in (1, 3, 4):
        raise NotImplementedError(f"{path}: {bits}-bit TIFF of {spp} "
                                  "samples")
    if raw and spp > 1 and _one(tags, "planar", 1) == 2:
        raise NotImplementedError(
            f"{path}: a {bits}-bit TIFF of separate colour planes read as "
            "one channel (cv2.imread reads it as interleaved samples, "
            "partly from uninitialised memory)")
    s = _samples(data, tags, bo, path, partial=not raw,
                 bw16_skew=bits == 16 and not gray and photometric in (0, 1))
    if raw:
        out = s[..., 0] if spp == 1 else _gray_as_unsigned(s[..., :3])
    else:
        if fmt == 2:  # the RGBA interface reads the bits as unsigned
            s = s.view(s.dtype.str.replace("i", "u"))
        if _one(tags, "compression", 1) == 7 and photometric == 6:
            photometric = 2  # libjpeg's RGB of the YCbCr samples
        rgba = _rgba(s, tags, photometric, bits, path)
        out = gray14(rgba[..., :3]) if gray else rgba[..., 2::-1]
    if orientation in ORIENT:  # other values than 1-8: libtiff ignores them
        out = ORIENT[orientation](out)
    return np.ascontiguousarray(out)


def _gray_as_unsigned(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's gray (:func:`gray14`) of samples of any 8- or 16-bit
    integer dtype, computed on their bits read as unsigned."""
    u = rgb.view(rgb.dtype.str.replace("i", "u"))
    return gray14(u).view(rgb.dtype)


# -- encoder -----------------------------------------------------------------

ENCODE_COMPRESSION = {"none": 1, "lzw": 5, "jpeg": 7, "deflate": 32946,
                      "adobe_deflate": 8, "packbits": 32773}


def lzw_encode(raw: bytes) -> bytes:
    """TIFF LZW of ``raw`` (MSB-first codes, the width growing one code
    early, a clear code when the table fills)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = acc << nbits | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append(acc >> nacc & 0xFF)
        acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    put(256)
    nxt = 258
    w = b""
    for i in range(len(raw)):
        c = raw[i:i + 1]
        wc = w + c
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            put(256)
            table = {bytes([k]): k for k in range(256)}
            nxt, nbits = 258, 9
        w = c
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append(acc << (8 - nacc) & 0xFF)
    return bytes(out)


def packbits_encode(raw: bytes) -> bytes:
    """PackBits of ``raw``: runs of 3 or more equal bytes replicated, the
    rest literal (at most 128 bytes per header)."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j + 1 < n and raw[j + 1] == raw[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([(1 - (j - i + 1)) & 0xFF, raw[i]])
            i = j + 1
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and raw[k] == raw[k + 1] == raw[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + raw[i:k]
        i = k
    return bytes(out)


def _predicted(px: np.ndarray, predictor: int) -> np.ndarray:
    """Chunk rows ``[rows, cols, per]`` -> the bytes of the predictor's
    differences, in the file's byte order of ``px``'s dtype."""
    if predictor == 2:
        d = px.copy()
        d[:, 1:] = px[:, 1:] - px[:, :-1]  # wraps modulo the sample range
        return d
    rows, cols, per = px.shape
    n = px.dtype.itemsize
    b = np.ascontiguousarray(px, f">f{n}").view(np.uint8).reshape(
        rows, cols * per, n)
    planes = b.transpose(0, 2, 1).reshape(rows, -1)  # MSB plane first
    d = planes.copy()
    d[:, per:] = planes[:, per:] - planes[:, :-per]
    return d


def _jpeg_chunk(px: np.ndarray, photometric: int, quality: int,
                subsampling: tuple) -> bytes:
    """A strip or tile as libtiff's JPEG codec writes it: gray, YCbCr of
    RGB samples at ``subsampling`` (h, v), or the R, G, B samples as they
    are (photometric RGB, Adobe's transform 0)."""
    from lgu_slam_tpu_torch.data.image_io import SUBSAMPLING, encode_jpeg

    if px.shape[-1] == 1:
        return encode_jpeg(px[..., 0], quality)
    bgr = np.ascontiguousarray(px[..., ::-1])  # the file holds R, G, B
    if photometric == 2:
        return encode_jpeg(bgr, quality, adobe_transform=0)
    name = next(k for k, f in SUBSAMPLING.items() if f == tuple(subsampling))
    return encode_jpeg(bgr, quality, name)


def _split_tables(stream: bytes) -> tuple:
    """A JPEG stream -> (its tables as an abbreviated stream: SOI, DQT and
    DHT segments, EOI; the stream without them)."""
    pos, tables, rest = 2, [], []
    while stream[pos + 1] != 0xDA:
        n, = struct.unpack_from(">H", stream, pos + 2)
        (tables if stream[pos + 1] in (0xDB, 0xC4) else rest).append(
            stream[pos:pos + 2 + n])
        pos += 2 + n
    return (b"\xff\xd8" + b"".join(tables) + b"\xff\xd9",
            b"\xff\xd8" + b"".join(rest) + stream[pos:])


# dtype -> (BitsPerSample, SampleFormat)
SAMPLE_TYPES = {np.dtype(np.uint8): (8, 1), np.dtype(np.int8): (8, 2),
                np.dtype(np.uint16): (16, 1), np.dtype(np.int16): (16, 2),
                np.dtype(np.uint32): (32, 1), np.dtype(np.int32): (32, 2),
                np.dtype(np.float32): (32, 3), np.dtype(np.uint64): (64, 1),
                np.dtype(np.int64): (64, 2), np.dtype(np.float64): (64, 3)}


def encode_tiff(img, compression: str = "none", predictor: int = 1,
                rows_per_strip=None, tile=None, planar: int = 1,
                big_endian: bool = False, photometric=None, palette=None,
                bilevel: bool = False, extra_samples=None,
                bigtiff: bool = False, orientation=None, quality: int = 75,
                subsampling=(2, 2), jpeg_tables: bool = True) -> bytes:
    """``[H, W]`` gray, ``[H, W, 3]`` BGR or ``[H, W, 4]`` BGRA samples of
    a dtype of :data:`SAMPLE_TYPES` -> one-page TIFF bytes, as
    ``cv2.imwrite`` lays out the samples (RGB order in the file), for
    fixtures of what :func:`decode_tiff` reads:

    - ``compression``: a key of :data:`ENCODE_COMPRESSION`; "jpeg" codes
      each 8-bit strip or tile as libtiff's JPEG codec does (``quality``;
      gray, RGB as it is with ``photometric`` 2, else YCbCr (6) at
      ``subsampling`` (h, v)), the quantisation and Huffman tables in
      JPEGTables unless not ``jpeg_tables``;
    - ``predictor``: 1 (none), 2 (horizontal) or 3 (floating point), for
      LZW and Deflate (libtiff ignores it for the others);
    - ``rows_per_strip`` (default: all), or ``tile`` (length, width);
    - ``planar`` 2: one plane per sample; ``big_endian``: ``MM`` order;
      ``bigtiff``: the BigTIFF header and directory (8-byte counts and
      offsets);
    - ``photometric`` (default 1 for gray, 2 for colour), 0 min-is-white;
    - ``palette`` ([N, 3] BGR, ``uint8`` or ``uint16``): a palette image
      whose ``img`` holds [H, W] ``uint8`` indices;
    - ``bilevel``: 1-bit gray of ``img`` != 0;
    - ``extra_samples``: the ExtraSamples value of a 4-sample file (0
      unspecified, 1 associated, 2 unassociated alpha; default: no tag,
      as cv2.imwrite writes it);
    - ``orientation``: the Orientation tag (1-8) over the samples as
      given (the file's first row first)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, spp = img.shape
    if spp in (3, 4):
        img = img[..., [2, 1, 0, 3][:spp]]
    bits, fmt = SAMPLE_TYPES[img.dtype]
    bits = 1 if bilevel else bits
    code = ENCODE_COMPRESSION[compression]
    if photometric is None:
        photometric = 3 if palette is not None else (1 if spp < 3 else (
            6 if code == 7 else 2))
    bo = ">" if big_endian else "<"
    if tile is not None:
        ch, cw = tile
    else:
        ch, cw = min(rows_per_strip or H, H), W
    planes = spp if planar == 2 else 1
    per = spp // planes
    if code not in (5, 8, 32946):
        predictor = 1  # libtiff takes a predictor for these codecs only
    chunks, tables = [], None
    for p in range(planes):
        for y0 in range(0, H, ch):
            for x0 in range(0, W, cw):
                px = img[y0:y0 + ch, x0:x0 + cw, p * per:(p + 1) * per]
                if tile is not None:  # edge tiles padded to the full size
                    full = np.zeros((ch, cw, per), img.dtype)
                    full[:px.shape[0], :px.shape[1]] = px
                    px = full
                if code == 7:
                    raw = _jpeg_chunk(px, photometric, quality, subsampling)
                    if jpeg_tables:
                        tables, raw = _split_tables(raw)
                elif bilevel:
                    raw = np.packbits(px[..., 0] != 0, axis=1).tobytes()
                elif predictor > 1:
                    d = _predicted(px, predictor)
                    raw = d.tobytes() if predictor == 3 else \
                        d.astype(d.dtype.newbyteorder(bo)).tobytes()
                else:
                    raw = px.astype(px.dtype.newbyteorder(bo)).tobytes()
                if code == 5:
                    raw = lzw_encode(raw)
                elif code in (8, 32946):
                    raw = zlib.compress(raw)
                elif code == 32773:
                    rb = len(raw) // px.shape[0]  # PackBits codes by rows
                    raw = b"".join(packbits_encode(raw[r * rb:(r + 1) * rb])
                                   for r in range(px.shape[0]))
                chunks.append(raw)
    entries = []  # (tag, type, values)

    def add(tag, typ, values):
        entries.append((tag, typ, list(values)))

    add(256, 4, [W])
    add(257, 4, [H])
    add(258, 3, [bits] * spp)
    add(259, 3, [code])
    add(262, 3, [photometric])
    if orientation is not None:
        add(274, 3, [orientation])
    add(277, 3, [spp])
    add(284, 3, [planar])
    if predictor > 1:
        add(317, 3, [predictor])
    if palette is not None:
        pal = np.asarray(palette)
        table = np.zeros((256, 3), np.int64)
        table[:len(pal)] = pal[:, ::-1]  # BGR -> RGB
        add(320, 3, table.T.reshape(-1))
    if spp == 4 and extra_samples is not None:
        add(338, 3, [extra_samples])
    add(339, 3, [fmt] * spp)
    if tables is not None:
        add(347, 7, tables)
    if photometric == 6:
        add(530, 3, subsampling)
    offs_tag, counts_tag = (324, 325) if tile is not None else (273, 279)
    if tile is not None:
        add(322, 4, [cw])
        add(323, 4, [ch])
    else:
        add(278, 4, [ch])
    # layout: header, chunks, then the directory and its long values
    head_size = 16 if bigtiff else 8
    pos = head_size
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c) + (len(c) & 1)
    long_type = 16 if bigtiff else 4  # LONG8 in BigTIFF
    add(offs_tag, long_type, offsets)
    add(counts_tag, long_type, [len(c) for c in chunks])
    entries.sort()
    ifd_at = pos
    entry, count, nxt = ("HHQ8s", "Q", "Q") if bigtiff else ("HHI4s", "H",
                                                            "I")
    inline = 8 if bigtiff else 4
    extra_at = ifd_at + struct.calcsize(bo + count) + \
        struct.calcsize(bo + entry) * len(entries) + struct.calcsize(bo + nxt)
    ifd = struct.pack(bo + count, len(entries))
    extra = b""
    codes = {3: "H", 4: "I", 7: "B", 16: "Q"}
    for tag, typ, values in entries:
        body = struct.pack(f"{bo}{len(values)}{codes[typ]}", *values)
        if len(body) <= inline:
            ifd += struct.pack(bo + entry, tag, typ, len(values),
                               body.ljust(inline, b"\0"))
        else:
            at = struct.pack(bo + ("Q" if bigtiff else "I"),
                             extra_at + len(extra))
            ifd += struct.pack(bo + entry, tag, typ, len(values), at)
            extra += body + b"\0" * (len(body) & 1)
    ifd += bytes(struct.calcsize(bo + nxt))
    if bigtiff:
        head = (b"MM\0+" if big_endian else b"II+\0") + struct.pack(
            bo + "HHQ", 8, 0, ifd_at)
    else:
        head = (TIFF_MM if big_endian else TIFF_II) + struct.pack(bo + "I",
                                                                  ifd_at)
    return head + b"".join(c + b"\0" * (len(c) & 1) for c in chunks) + \
        ifd + extra
