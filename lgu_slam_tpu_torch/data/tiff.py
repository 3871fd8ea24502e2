"""TIFF files for the port's data layer: a decoder that returns what
``cv2.imread`` (OpenCV 5.0 over libtiff 4.7) returns, and an encoder of
the files it reads, for fixtures.

:func:`decode_tiff` reads page 0 of a classic TIFF (``II*\\0`` or
``MM\\0*``) or a BigTIFF (``II+\\0`` / ``MM\\0+``): strips or tiles,
``PlanarConfiguration`` 1 or 2, ``FillOrder`` 1 or 2, compression none,
LZW (and its pre-6.0 LSB-first coding), Deflate (8 and 32946), PackBits,
JPEG (7: libtiff's codec, ``JPEGTables``, YCbCr subsampling, separate
planes, strips the stream does not fill; each strip through the port's C
JPEG decoder), the CCITT schemes of 1-bit images (RLE, RLEW, Group 3 1-D
and 2-D, Group 4) and SGI Log of LogL, LogLuv32 and LogLuv24 images
(LogLuv in the colour read), the horizontal and the floating-point
predictor; 1-, 8- and 16-bit unsigned gray (min-is-black or min-is-white) with or without
extra samples, RGB and RGBA, 1- and 8-bit palettes, separated CMYK,
uncompressed YCbCr at each subsampling libtiff reads, CIE L*a*b*, and the
other sample formats OpenCV reads (``int8``, ``int16``, ``uint32``,
``int32``, ``uint64``, ``int64``, ``float32``, ``float64``); orientations
1-4; strip byte counts recounted where libtiff recounts them.  The LZW,
PackBits, LogL, LogLuv32 and LogLuv24 decoders and the predictors run in C
(``csrc/host/tiff_lzw.c``), the CCITT decoder too
(``csrc/host/ccitt_decode.c``), each built by the host compiler at first
use.  A scheme libtiff does not know decodes to zeros, as libtiff's RGBA
interface reads it.

OpenCV reads a TIFF along one of two paths, and the decoder takes the same:

- an 8-bit result (``cv2.imread(path)``, or ``cv2.IMREAD_ANYDEPTH`` of a
  1- or 8-bit file, or of a 16-bit one that is not gray, RGB or RGBA)
  goes through libtiff's RGBA interface (``TIFFReadRGBAStrip`` /
  ``TIFFReadRGBATile``): 16-bit gray keeps its high byte, 16-bit colour
  becomes ``(x * 255 + 32767) // 65535`` (that is ``round(x / 257)``),
  signed samples are read as their unsigned bits, min-is-white is
  inverted, a palette is looked up (its entries shifted right by 8 unless
  every one is below 256), an unassociated alpha is multiplied in (gray
  only from separate planes), CMYK, YCbCr and L*a*b* are converted by
  libtiff's own integer and float32 arithmetic, JPEG's YCbCr comes out as
  libjpeg's RGB; then BGR, or gray by OpenCV's own ``(4899 R + 9617 G +
  1868 B + 8192) >> 14`` (``int8`` where the samples are signed);
- a result of another dtype (``cv2.IMREAD_ANYDEPTH`` of a 16-bit gray or
  RGB file, or of a 32- or 64-bit one) is the samples as stored: one
  channel as it is, 16-bit colour to gray by the same formula on the bits
  read as unsigned; 32/64-bit colour and any 32/64-bit read without
  ``IMREAD_ANYDEPTH`` are refused (cv2 returns None: ``ValueError``).

Orientations 2-4 flip the result as cv2.imread does; 5-8 (transposes) it
refuses.  12-bit samples are read with ``IMREAD_ANYDEPTH`` as OpenCV
widens them to 16 bits (:func:`_twelve_bits`).  Files OpenCV reads and
this decoder does not (12- and 16-bit separate colour planes read to
gray, which OpenCV reads partly from memory it never wrote) raise
``NotImplementedError``;
files OpenCV refuses raise ``ValueError``: among them the compressions
this libtiff build lacks (old-style JPEG, LZMA, ZSTD, WebP, LERC, JBIG
and others), the layouts its RGBA interface cannot put (16-bit palettes
and CMYK, YCbCr subsampled 2 x 4, ...), the predictors and per-sample
fields libtiff does not set up, YCbCr fields its conversion refuses, and
strips the file cannot fill once libtiff has recounted their bytes.
"""

from __future__ import annotations

import bisect
import ctypes
import struct
import zlib

import numpy as np

from lgu_slam_tpu_torch.data.pnm import gray14
from lgu_slam_tpu_torch.ops import _build

TIFF_II = b"II*\0"
TIFF_MM = b"MM\0*"
BIGTIFF = (b"II+\0", b"MM\0+")

COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
               4: "CCITT Group 4", 5: "LZW", 7: "JPEG", 8: "Deflate",
               32771: "CCITT RLEW", 32946: "Deflate", 32773: "PackBits",
               34676: "SGI Log", 34677: "SGI Log24"}
# the CCITT schemes, of 1-bit images only
CCITT = (2, 3, 4, 32771)
# compressions this libtiff build does not decode (not configured, or
# for no depth cv2.imread reads): cv2.imread returns None
REFUSED_COMPRESSION = {6: "old-style JPEG", 32766: "NeXT",
                       32809: "ThunderScan", 32909: "PixarLog",
                       34661: "JBIG", 34887: "LERC", 34925: "LZMA",
                       50000: "ZSTD", 50001: "WebP"}
# the SGI Log schemes: LogL and LogLuv32 under 34676, LogLuv24 under 34677
# (its colour index through libtiff's table of the uv plane,
# csrc/host/tiff_uvtable.h); LogLuv only in colour (OpenCV's float read of
# it fails)
SGILOG = {34676: "SGI Log", 34677: "SGI Log24"}
# some schemes libtiff does not know (any code outside the above): it
# decodes nothing, so its RGBA interface reads zeroed buffers
UNKNOWN_COMPRESSION = {34712: "JPEG 2000", 50002: "JPEG XL",
                       52546: "JPEG XL"}
# tag -> name of the tags read
TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
        262: "photometric", 266: "fill_order", 273: "strip_offsets",
        274: "orientation", 277: "spp", 278: "rows_per_strip",
        279: "strip_counts", 280: "min_sample", 281: "max_sample",
        284: "planar", 292: "t4_options",
        317: "predictor", 318: "white_point", 320: "colormap",
        322: "tile_width", 323: "tile_length", 324: "tile_offsets",
        325: "tile_counts", 332: "ink_set", 338: "extra_samples",
        339: "sample_format", 347: "jpeg_tables", 513: "ojpeg_interchange",
        519: "ojpeg_qtables", 529: "ycbcr_coefficients",
        530: "ycbcr_subsampling", 532: "reference_black_white"}
# the SHORT tags libtiff reads one value of for every sample
# (TIFFReadDirEntryPersampleShort)
PER_SAMPLE = ("bits", "sample_format", "min_sample", "max_sample")
# TIFF field type -> (struct code, bytes); 16-18 are BigTIFF's; the
# rationals (5, 10) are read as pairs and become float32 quotients
TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 8),
         6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 8),
         11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
         17: ("q", 8), 18: ("Q", 8)}
# (SampleFormat, BitsPerSample) -> the dtype of the samples as stored
SAMPLE_DTYPES = {(1, 8): np.uint8, (2, 8): np.int8, (1, 16): np.uint16,
                 (2, 16): np.int16, (1, 32): np.uint32, (2, 32): np.int32,
                 (3, 32): np.float32, (1, 64): np.uint64, (2, 64): np.int64,
                 (3, 64): np.float64}
# the photometric interpretations libtiff's RGBA interface reads for
# cv2.imread (others: it returns None; LogL / LogLuv only under SGI Log)
RGBA_PHOTOMETRIC = (0, 1, 2, 3, 5, 6, 8, 32844)
# the YCbCr subsamplings (h, v) libtiff's RGBA interface reads from
# contiguous samples (tif_getimage.c putcontig8bitYCbCr44tile ... 11tile);
# from separate planes it reads 1 x 1 only
YCBCR_SUBSAMPLING = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2),
                     (1, 1))
# Orientation -> the flips cv2.imread applies (through libtiff's RGBA
# interface, or OpenCV's own for the samples as stored); 5-8 transpose,
# which it refuses
ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
          4: lambda a: a[::-1]}
# each byte with its bits in reverse order (FillOrder 2)
_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
# OpenCV's CV_IO_MAX_IMAGE_PIXELS and _WIDTH / _HEIGHT
MAX_PIXELS = 1 << 30
MAX_SIDE = 1 << 20


def _ifd(data: bytes, path) -> tuple:
    """The tags of the first image file directory (classic TIFF, or
    BigTIFF with its 8-byte counts and offsets): name -> tuple of values,
    and the byte order.  ``"dir_bytes"`` holds what libtiff counts as the
    directory's room in the file (header, entries and the values stored
    apart from them; None where an entry's type has no size), which its
    estimate of a compressed strip's size takes from the file's."""
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
    room = 4 + struct.calcsize(bo + head) + csize + esize * n + (
        8 if big else 4)
    for k in range(n):
        tag, typ, count_k, value = struct.unpack_from(
            bo + entry, data, off + csize + esize * k)
        if room is not None:  # tif_dirread.c EstimateStripByteCounts
            width = TYPES[typ][1] if typ in TYPES else 0
            room = None if width == 0 else room + (
                width * count_k if width * count_k > inline else 0)
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
        if typ in (5, 10):  # libtiff: (float)num / (float)den, 0 for /0
            v = np.array(struct.unpack(f"{bo}{2 * count_k}{code}", raw),
                         np.float32).reshape(-1, 2)
            with np.errstate(divide="ignore", invalid="ignore"):
                q = np.where(v[:, 1] != 0, v[:, 0] / v[:, 1], 0)
            tags[TAGS[tag]] = tuple(q.astype(np.float32))
        else:
            tags[TAGS[tag]] = struct.unpack(f"{bo}{count_k}{code}", raw)
    tags["dir_bytes"] = (room,)
    return tags, bo


def _one(tags, name, default=None):
    v = tags.get(name)
    return default if v is None else int(v[0])


def _lib():
    lib = _build.load("tiff_lzw")
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tiff_lzw_decode.argtypes = [ctypes.c_char_p, i64, ptr, i64, cint]
    lib.tiff_packbits_decode.argtypes = [ctypes.c_char_p, i64, ptr, i64]
    lib.tiff_lzw_old_style.argtypes = [ctypes.c_char_p, i64]
    for fn in (lib.tiff_logl_decode, lib.tiff_logluv32_decode,
               lib.tiff_logluv24_decode):
        fn.argtypes = [ctypes.c_char_p, i64, ptr, i64, i64]
        fn.restype = cint
    for fn in (lib.tiff_lzw_decode, lib.tiff_packbits_decode,
               lib.tiff_lzw_old_style):
        fn.restype = cint
    lib.tiff_hpredict.argtypes = [ptr, i64, i64, i64, cint, cint]
    lib.tiff_hpredict.restype = None
    lib.tiff_fpredict.argtypes = [ptr, i64, i64, i64, cint]
    lib.tiff_fpredict.restype = cint
    return lib


def _ccitt_lib():
    lib = _build.load("ccitt_decode")
    i64, cint = ctypes.c_int64, ctypes.c_int
    lib.ccitt_state_size.argtypes = [i64, cint]
    lib.ccitt_state_size.restype = i64
    lib.ccitt_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_void_p, i64,
                                 i64, i64, cint, cint, cint, cint,
                                 ctypes.c_void_p]
    lib.ccitt_decode.restype = cint
    return lib


class _Ccitt:
    """The CCITT decoder of one image (``csrc/host/ccitt_decode.c``): its
    run arrays carry over from strip to strip, as libtiff's do."""

    def __init__(self, tags: dict, compression: int, rowpixels: int):
        self.lib = _ccitt_lib()
        self.scheme = compression
        self.two_d = int(compression == 3 and
                         _one(tags, "t4_options", 0) & 1)
        # FillOrder 2 is read as it is; any other value as 1 (bit-reversed)
        self.reverse = int(_one(tags, "fill_order", 1) != 2)
        self.rowpixels = rowpixels
        self.state = np.zeros(self.lib.ccitt_state_size(
            rowpixels, int(compression == 4 or self.two_d)), np.uint32)

    def __call__(self, raw: bytes, offset: int, rows: int, rowbytes: int
                 ) -> np.ndarray:
        """One strip or tile: ``rows * rowbytes`` bytes of packed rows
        (rows the data does not reach are zeros)."""
        out = np.zeros(rows * rowbytes, np.uint8)
        self.lib.ccitt_decode(raw, len(raw), out.ctypes.data, rows,
                              self.rowpixels, rowbytes, self.scheme,
                              self.two_d, self.reverse, offset & 1,
                              self.state.ctypes.data)
        return out


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


def _decode_failed(compression: int, n: int, size: int, path):
    """``ValueError`` for a strip or tile of ``n`` bytes that libtiff's
    codec fails to decode to ``size`` (cv2.imread returns None where it
    reads the samples as stored)."""
    if compression == 1:
        raise ValueError(f"{path}: an uncompressed TIFF strip of {n} bytes "
                         f"for {size} (cv2.imread returns None)")
    name = COMPRESSION.get(compression) or UNKNOWN_COMPRESSION.get(
        compression, f"scheme {compression}")
    raise ValueError(f"{path}: TIFF {name} data is damaged or cut short, or "
                     "in a scheme libtiff does not know (cv2.imread returns "
                     "None)")


def _decoded(raw: bytes, size: int, compression: int, path,
             old_lzw: bool = False, width: int = 1, per: int = 1) -> tuple:
    """One strip or tile of ``size`` bytes as libtiff decodes it (the data
    may hold more), and whether libtiff's codec failed: the data is
    damaged or ends early, or the scheme is one libtiff does not know
    (then the bytes decoded up to there and zeros, and no predictor
    undone; its RGBA interface goes on, a raw read refuses:
    :func:`_decode_failed`).  ``old_lzw``: LZW in the pre-6.0 coding; SGI
    Log: LogL as 8-bit gray rows of ``width`` pixels, of ``per`` 3
    LogLuv32 (SGI Log24: LogLuv24) as 8-bit RGB rows."""
    out = np.zeros(size, np.uint8)
    if compression == 1:  # libtiff copies nothing of a short strip
        if len(raw) >= size:
            out[:] = np.frombuffer(raw, np.uint8, size)
        return out, len(raw) < size
    if compression in (8, 32946):
        got, damaged = _inflate(raw, size)
        out[:len(got)] = np.frombuffer(got, np.uint8)
        status = 1 if damaged or len(got) < size else 0
    elif compression == 5:
        status = _lib().tiff_lzw_decode(raw, len(raw), out.ctypes.data, size,
                                        int(old_lzw))
    elif compression == 32773:
        status = _lib().tiff_packbits_decode(raw, len(raw), out.ctypes.data,
                                             size)
    elif compression in SGILOG:  # LogL / LogLuv, 8-bit rows of `width`
        decode = _lib().tiff_logl_decode if per != 3 else \
            _lib().tiff_logluv24_decode if compression == 34677 else \
            _lib().tiff_logluv32_decode
        status = decode(raw, len(raw), out.ctypes.data,
                        size // (width * per), width)
    else:  # a scheme libtiff does not know: it decodes nothing
        status = 1
    if status == 3:
        raise MemoryError(f"{path}: out of memory")
    return out, bool(status)


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


def _skewed_rows(buf: np.ndarray, h: int, w: int, cw: int, per: int,
                 bits: int) -> np.ndarray:
    """The first sample of each pixel that libtiff's RGBA interface reads
    from a gray or palette tile clipped by the image's right edge
    (tif_getimage.c putgreytile, putagreytile, put16bitbwtile,
    put8bitcmaptile): it steps over a row's ``w`` pixels of ``per``
    samples, then ``cw - w`` bytes, not pixels, so row ``i`` starts
    ``i * (w * per * bits / 8 + cw - w)`` bytes into the tile (at an odd
    byte where that is odd): ``[h, w, 1]``."""
    size = per * bits // 8
    at = np.arange(h)[:, None] * (w * size + cw - w) + \
        size * np.arange(w)[None]
    if bits == 8:
        return buf[at][..., None]
    lo, hi = buf[at].astype(np.uint16), buf[at + 1].astype(np.uint16)
    return (lo | hi << 8)[..., None]


def _estimated_counts(tags: dict, offsets, n: int, chunk_bytes: int,
                      compression: int, planes: int, size: int,
                      path) -> tuple:
    """libtiff's estimate of ``n`` strip or tile byte counts
    (tif_dirread.c EstimateStripByteCounts): uncompressed, ``chunk_bytes``
    each; compressed, the file's bytes outside its directory (split over
    ``planes`` separate planes; the whole file where the directory counts
    more bytes than it holds), the last one cut to the file's end."""
    if compression == 1:
        return (chunk_bytes,) * n
    room = tags["dir_bytes"][0]
    if room is None:
        raise ValueError(f"{path}: TIFF directory entry of a type without "
                         "a size (cv2.imread returns None)")
    each = (size if size < room else size - room) // planes
    last = int(offsets[n - 1])
    if last + each > size:
        each_last = max(size - last, 0)
        return (each,) * (n - 1) + (each_last,)
    return (each,) * n


def _strip_counts(tags: dict, offsets, counts, compression: int, tiled: bool,
                  n: int, planes: int, H: int, down: int, rowbytes: int,
                  chunk_bytes: int, size: int, path) -> tuple:
    """The strip or tile byte counts libtiff reads the image with
    (tif_dirread.c TIFFReadDirectory):

    - without the StripByteCounts (TileByteCounts) field, estimated
      (:func:`_estimated_counts`) where there is one chunk of contiguous
      samples or one per separate plane, else refused;
    - a single strip whose count "looks bad" (ByteCountLooksBad: 0, or,
      uncompressed, past the file's end or short of ``H`` rows),
      estimated;
    - where the first two of more than two uncompressed strips of
      contiguous samples differ, every one set to ``H // down`` rows (then
      a strip may run past the file's end, or hold fewer rows than it
      should)."""
    if counts is None:
        if n != (1 if planes == 1 else planes):
            raise ValueError(f"{path}: TIFF without its StripByteCounts "
                             f"field, of {n} strips or tiles (cv2.imread "
                             "returns None)")
        return _estimated_counts(tags, offsets, n, chunk_bytes, compression,
                                 planes, size, path)
    if tiled:
        return counts
    off, count = int(offsets[0]), int(counts[0])
    if n == 1 and off != 0 and (count == 0 or compression == 1 and (
            off <= size and count > size - off or count < rowbytes * H)):
        return _estimated_counts(tags, offsets, 1, rowbytes * H, compression,
                                 1, size, path)
    if compression == 1 and planes == 1 and down > 2 and \
            counts[0] != counts[1] and counts[0] and counts[1]:
        return ((H // down) * rowbytes,) * len(counts)
    return counts


def _per_sample(tags: dict, path) -> dict:
    """``tags`` with one value of each :data:`PER_SAMPLE` field; refused
    (cv2.imread returns None: libtiff's "Cannot handle different values
    per sample") where the field lists fewer values than there are samples
    (but one), or different ones for them (values past the samples are
    not read)."""
    spp = _one(tags, "spp", 1)
    for name in PER_SAMPLE:
        v = tags.get(name)
        if v is None or len(v) == 1:
            continue
        if len(v) < spp or len(set(v[:spp])) > 1:
            raise ValueError(f"{path}: TIFF {name} of {len(v)} values "
                             f"{v[:spp]} for {spp} samples, which libtiff "
                             "cannot handle (cv2.imread returns None)")
        tags = dict(tags, **{name: v[:1]})
    return tags


def _check_predictor(predictor: int, bits: int, fmt: int, path) -> None:
    """Refuse (cv2.imread returns None) the predictors libtiff does not set
    up (tif_predict.c PredictorSetup): values other than 1-3, the
    horizontal predictor at other depths than 8, 16, 32 and 64 bits, the
    floating-point predictor of other than floating-point samples (of 16,
    24, 32 or 64 bits)."""
    why = None
    if predictor not in (1, 2, 3):
        why = f"predictor {predictor}"
    elif predictor == 2 and bits not in (8, 16, 32, 64):
        why = f"horizontal predictor of {bits}-bit samples"
    elif predictor == 3 and (fmt != 3 or bits not in (16, 24, 32, 64)):
        why = (f"floating-point predictor of {bits}-bit samples of sample "
               f"format {fmt}")
    if why:
        raise ValueError(f"{path}: TIFF {why}, which libtiff does not "
                         "decode (cv2.imread returns None)")


def _check_compression(tags: dict, compression: int, bits: int, path
                       ) -> None:
    """Refuse what the decoder does not read: ``ValueError`` where
    cv2.imread returns None (probed with files of each scheme: the codecs
    this libtiff build lacks, old-style JPEG even with its JPEG tags, the
    CCITT schemes of more than 1 bit, SGI Log of other photometric
    interpretations than LogL and LogLuv, LogL under SGI Log24)."""
    photometric = _one(tags, "photometric", 1)
    if compression in REFUSED_COMPRESSION:
        raise ValueError(f"{path}: TIFF {REFUSED_COMPRESSION[compression]} "
                         "compression, which this OpenCV's libtiff does not "
                         "decode (cv2.imread returns None)")
    if compression in CCITT and bits != 1:
        raise ValueError(f"{path}: TIFF {COMPRESSION[compression]} of "
                         f"{bits}-bit samples (cv2.imread returns None)")
    if compression in SGILOG and photometric != 32845 and (
            photometric != 32844 or compression != 34676):
        raise ValueError(f"{path}: TIFF {SGILOG[compression]} of "
                         f"photometric interpretation {photometric} "
                         "(cv2.imread returns None)")
    if compression == 7 and bits not in (8, 16):
        raise ValueError(f"{path}: JPEG TIFF of {bits}-bit samples, which "
                         "this libtiff's libjpeg does not decode (cv2.imread "
                         "returns None)")


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


# the start-of-frame markers (SOF0-SOF15 but DHT, JPG and DAC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _jpeg_frame(stream: bytes, where) -> tuple:
    """The frame header of a JPEG stream that reaches its first scan, as
    :func:`image_io.jpeg_info` gives it (height, width, 0, components,
    component 0's sampling, whether the rest are 1 x 1), with the
    precision and whether the frame is lossless (SOF3); ``ValueError``
    where the stream has no frame header before a scan."""
    pos, frame = 2, None
    while stream[:2] == b"\xff\xd8" and pos + 4 <= len(stream) and \
            stream[pos] == 0xFF:
        marker, = stream[pos + 1:pos + 2]
        if marker == 0xFF:
            pos += 1
            continue
        n, = struct.unpack_from(">H", stream, pos + 2)
        if marker == 0xDA and frame is not None:
            return frame
        if marker in _SOF and pos + 10 <= len(stream):
            p, h, w, nf = struct.unpack_from(">BHHB", stream, pos + 4)
            f = stream[pos + 11:pos + 11 + 3 * nf:3]
            if len(f) == nf and nf:
                frame = (h, w, 0, nf, f[0] >> 4, f[0] & 15,
                         int(all(b == 0x11 for b in f[1:])), p,
                         marker == 0xC3)
        pos += 2 + n
    raise ValueError(f"{where}: no JPEG frame header before a scan "
                     "(cv2.imread returns None)")


def _jpeg_chunk_samples(raw: bytes, tables: bytes, seg_h: int, seg_w: int,
                        last_strip: bool, ycc: bool, sub: tuple, ncomp: int,
                        bits: int, k: int, path) -> np.ndarray:
    """One JPEG strip or tile (or, of separate planes, one plane's) as
    libtiff's JPEG codec decodes it (tif_jpeg.c JPEGPreDecode,
    JPEGDecode) for its RGBA interface: the tables read first, its size,
    ``ncomp`` components and sampling checked against the strip's (a last
    strip may hold more rows, which are dropped), contiguous YCbCr
    (``ycc``) taken to RGB by libjpeg (JPEGCOLORMODE_RGB), other
    components as stored.  A stream narrower or shorter than the strip
    fills its top left corner, zeros the rest (libtiff warns and reads it
    short).  16 bits: a lossless 16-bit stream passes the header checks
    and fails in libjpeg's 8-bit scanline reader, so the strip reads as
    zeros (any other precision fails the checks)."""
    from lgu_slam_tpu_torch.data.image_io import (JPEG_OUT_RAW,
                                                  JPEG_OUT_YCC_RGB,
                                                  jpeg_info, jpeg_samples)

    stream = b"\xff\xd8" + tables + raw[2:] if raw[:2] == b"\xff\xd8" \
        else raw
    where = f"{path}: TIFF JPEG strip or tile {k}"
    # libtiff's JPEGPreDecode reads the header and starts the decompressor
    # (a progressive stream is absorbed there): a failure fails the strip
    # read, and cv2.imread returns None (ValueError)
    if bits == 16:
        h, w, _, nc, h0, v0, rest_1x1, precision, lossless = _jpeg_frame(
            stream, where)
        if precision != 16 or not lossless:
            raise ValueError(f"{where}: JPEG of {precision}-bit samples in "
                             "a 16-bit TIFF (cv2.imread returns None)")
    else:
        h, w, _, nc, h0, v0, rest_1x1 = jpeg_info(stream, where)
    want = (sub if ycc else (1, 1), 1)
    if nc != ncomp or ((h0, v0), rest_1x1) != want:
        raise ValueError(f"{where}: {nc} components sampled {h0}x{v0} "
                         f"(the TIFF's {ncomp} at {want[0]})")
    if w > seg_w or (h > seg_h and not (w == seg_w and last_strip)):
        raise ValueError(f"{where}: {w}x{h} exceeds the strip's "
                         f"{seg_w}x{seg_h}")
    out = np.zeros((seg_h, seg_w, ncomp), np.uint8 if bits == 8 else
                   np.uint16)
    if bits == 8:
        px = jpeg_samples(stream, JPEG_OUT_YCC_RGB if ycc else JPEG_OUT_RAW,
                          ncomp, where)
        out[:h, :w] = px[:seg_h]
    return out


def _samples(data: bytes, tags: dict, bo: str, path, partial: bool,
             skew: bool = False) -> np.ndarray:
    """The stored samples of page 0: ``[H, W, spp]`` of the dtype of
    :data:`SAMPLE_DTYPES` (1 bit: ``uint8`` 0 or 1) in the host's byte
    order; JPEG chunks decoded to ``uint8`` RGB (YCbCr converted) or
    gray.  ``partial``: damaged chunks as far as they decode (libtiff's
    RGBA interface); ``skew``: the samples of 16-bit or multi-sample gray
    and palette tiles at the right edge as that interface reads them
    (:func:`_skewed_rows`)."""
    W, H = _one(tags, "width", 0), _one(tags, "height", 0)
    if W <= 0 or H <= 0:
        raise ValueError(f"{path}: TIFF of {W} x {H} pixels")
    if W > MAX_SIDE or H > MAX_SIDE or W * H > MAX_PIXELS:
        raise ValueError(f"{path}: TIFF of {W} x {H} pixels is more than "
                         "cv2.imread reads")
    spp = _one(tags, "spp", 1)
    bits = _one(tags, "bits", 1)
    compression = _one(tags, "compression", 1)
    _check_compression(tags, compression, bits, path)
    # libtiff applies a predictor only for the codecs that take one
    predictor = _one(tags, "predictor", 1) if compression in (5, 8, 32946) \
        else 1
    _check_predictor(predictor, bits, _one(tags, "sample_format", 1), path)
    planar = _one(tags, "planar", 1)
    if planar not in (1, 2):
        raise ValueError(f"{path}: TIFF planar configuration {planar}")
    tiled = "tile_width" in tags
    if tiled:
        cw, ch = _one(tags, "tile_width"), _one(tags, "tile_length", 0)
        offsets, counts = tags.get("tile_offsets"), tags.get("tile_counts")
    else:
        cw = W
        ch = min(_one(tags, "rows_per_strip", H) or H, H)
        offsets, counts = tags.get("strip_offsets"), tags.get("strip_counts")
    if cw <= 0 or ch <= 0 or offsets is None:
        raise ValueError(f"{path}: TIFF without its strips or tiles")
    planes = spp if planar == 2 else 1
    per = spp // planes  # samples per pixel in a chunk
    rowbytes = (cw * per * bits + 7) // 8
    photometric = _one(tags, "photometric", 1)
    sub = _ycbcr_sub(tags)
    # subsampled YCbCr is stored in data units of h x v luma samples and
    # their Cb, Cr; libtiff's scanline is a row of units over v
    units = photometric == 6 and compression != 7 and planar == 1 and \
        sub != (1, 1)
    if units:
        unit = sub[0] * sub[1] + 2
        unit_row = -(-cw // sub[0]) * unit
        rowbytes = unit_row // sub[1]
    across = -(-W // cw)
    down = -(-H // ch)
    n = planes * across * down
    if min(len(offsets), len(counts or offsets)) < n:
        raise ValueError(f"{path}: TIFF lists {len(offsets)} of its {n} "
                         "strips or tiles")
    tile_bytes = -(-ch // sub[1]) * unit_row if units else ch * rowbytes
    counts = _strip_counts(
        tags, offsets, counts, compression, tiled, n, planes, H, down,
        rowbytes, tile_bytes if tiled else H * rowbytes, len(data), path)
    # 12-bit samples are widened to uint16, unshifted (signed ones too)
    dtype = np.uint8 if bits == 1 else np.uint16 if bits == 12 else \
        SAMPLE_DTYPES[(_one(tags, "sample_format", 1), bits)]
    out = np.zeros((H, W, spp), dtype)
    swap = bo == ">"
    tables = _jpeg_tables(tags)
    ccitt = _Ccitt(tags, compression, cw) if compression in CCITT else None
    # libtiff reverses the bits of FillOrder 2 data, but for the codecs that
    # ask it not to: JPEG, and CCITT, whose decoder reads either order
    reverse = _one(tags, "fill_order", 1) == 2 and \
        compression not in CCITT + (7,)
    # libtiff decodes every LZW strip in the coding of the first it reads
    first = data[int(offsets[0]):int(offsets[0]) + int(counts[0])]
    if reverse:
        first = first.translate(_REVERSED)
    old_lzw = compression == 5 and bool(_lib().tiff_lzw_old_style(
        first, len(first)))

    def chunk(k: int, rows: int, size: int, h: int, w: int, last: bool,
              unit_rows: int) -> np.ndarray:
        """The samples of strip or tile ``k``: ``[rows, cw or w, per]``
        (``last``: the last strip of a plane)."""
        off, cnt = int(offsets[k]), int(counts[k])
        if off + cnt > len(data) or cnt == 0:
            raise ValueError(f"{path}: TIFF strip or tile {k} of {cnt} bytes "
                             f"at {off} runs past the end of the file "
                             "(cv2.imread returns None)")
        raw = data[off:off + cnt]
        if reverse:  # FillOrder 2: libtiff reverses the bits first
            raw = raw.translate(_REVERSED)
        if compression == 7:
            if not partial:  # never read in 16 bits (_check_compression)
                raise ValueError(f"{path}: JPEG TIFF of {bits}-bit samples "
                                 "read as they are stored (cv2.imread "
                                 "returns None)")
            return _jpeg_chunk_samples(
                raw, tables, rows, cw, last, photometric == 6 and planes == 1,
                sub, per, bits, k, path)
        undo = predictor
        if ccitt is not None:
            buf = ccitt(raw, off, rows, rowbytes)
        else:
            buf, failed = _decoded(raw, size, compression, path, old_lzw, cw,
                                   per)
            if failed:  # libtiff's predictor undoes nothing of a failed chunk
                if not partial:
                    _decode_failed(compression, len(raw), size, path)
                undo = 1
        if units:
            return _ycbcr_chunk(buf, rows, w, cw, sub, unit_rows, undo, tiled)
        if bits == 12:  # packed most significant bit first, in either order
            b = np.unpackbits(buf.reshape(rows, rowbytes), axis=1)[
                :, :cw * per * 12].reshape(rows, cw * per, 12)
            weights = (1 << np.arange(11, -1, -1)).astype(np.uint16)
            return (b * weights).sum(-1, dtype=np.uint16).reshape(
                rows, cw, per)
        if undo > 1:
            _unpredict(buf, rows, rowbytes, per, bits, undo, swap)
        elif bits > 8 and swap:
            buf = buf.view(f">u{bits // 8}").byteswap().view(np.uint8)
        if bits == 1:
            return np.unpackbits(buf.reshape(rows, rowbytes), axis=1)[
                :, :cw, None]
        if skew and tiled and w < cw and (bits == 16 or per > 1):
            return _skewed_rows(buf, h, w, cw, per, bits)
        return buf.view(dtype).reshape(rows, cw, per)

    for p in range(planes):
        for cy in range(down):
            for cx in range(across):
                k = (p * down + cy) * across + cx
                rows = ch if tiled else min(ch, H - cy * ch)
                size, unit_rows = rows * rowbytes, 0
                if units:
                    # libtiff's RGBA interface reads a tile whole and a strip
                    # as its rows rounded up to v, in scanlines (a row of
                    # units over v, rounded down: 4 x 4 units lose bytes)
                    unit_rows = -(-rows // sub[1])
                    size = unit_rows * (unit_row if tiled else
                                        sub[1] * rowbytes)
                y0, x0 = cy * ch, cx * cw
                h, w = min(rows, H - y0), min(cw, W - x0)
                try:
                    px = chunk(k, rows, size, h, w,
                               not tiled and cy == down - 1, unit_rows)
                except ValueError:
                    # libtiff's RGBA interface reads the planes after the
                    # first into the buffer it made for the first, and
                    # passes over their failures (tif_getimage.c
                    # gtStripSeparate, gtTileSeparate): they stay zeros
                    if not partial or p == 0:
                        raise
                    continue
                out[y0:y0 + h, x0:x0 + w, p * per:(p + 1) * per] = \
                    px[:h, :w]
    return out


def _check_rgba(photometric: int, bits: int, spp: int, tags: dict,
                path) -> None:
    """Refuse, as ``ValueError`` (cv2.imread returns None), the layouts
    libtiff's RGBA interface does not read (TIFFRGBAImageOK and its
    PickContigCase / PickSeparateCase, probed per photometric
    interpretation, depth, sample count and planar configuration)."""
    planar = _one(tags, "planar", 1)
    # contiguous JPEG YCbCr comes out of libjpeg as RGB
    converts = photometric == 6 and not (
        _one(tags, "compression", 1) == 7 and planar == 1)
    why = None
    if bits == 1 and spp > 1:
        why = f"1-bit image of {spp} samples"
    elif photometric == 2 and spp < 3:
        why = f"RGB of {spp} samples"
    elif photometric == 3 and (bits not in (1, 8) or (planar == 2 and
                                                     spp > 1)):
        why = f"{bits}-bit palette of {spp} samples, planar {planar}"
    elif photometric == 5 and (bits != 8 or spp != 4 or
                               _one(tags, "ink_set", 1) != 1):
        why = (f"separated {bits}-bit image of {spp} samples, inks "
               f"{_one(tags, 'ink_set', 1)}")
    elif photometric == 6 and (bits != 8 or spp != 3):
        why = f"YCbCr of {spp} {bits}-bit samples"
    elif converts and _ycbcr_sub(tags) not in (
            ((1, 1),) if planar == 2 else YCBCR_SUBSAMPLING):
        why = f"YCbCr subsampled {_ycbcr_sub(tags)}, planar {planar}"
    elif converts and _bad_ycbcr_fields(tags):
        why = ("YCbCr of coefficients or reference black and white "
               f"{_ycbcr_fields(tags)} (initYCbCrConversion)")
    elif photometric == 8 and (bits not in (8, 16) or spp != 3 or
                               planar == 2):
        why = f"CIE L*a*b* of {spp} {bits}-bit samples, planar {planar}"
    elif photometric == 32844 and (_one(tags, "compression", 1) != 34676
                                   or spp != 1):
        why = f"LogL of {spp} samples, not under SGI Log"
    elif photometric not in RGBA_PHOTOMETRIC:
        why = f"photometric interpretation {photometric}"
    if why is not None:
        raise ValueError(f"{path}: TIFF {why}, which libtiff's RGBA "
                         "interface does not read (cv2.imread returns None)")


def _ycbcr_sub(tags: dict) -> tuple:
    return tuple(int(v) for v in tags.get("ycbcr_subsampling", (2, 2)))


def _ycbcr_fields(tags: dict) -> tuple:
    """The YCbCrCoefficients and ReferenceBlackWhite libtiff converts with,
    in float32: each field's own values, or its default where it lists
    other than 3 and 6 values (libtiff ignores such a field)."""
    f = np.float32
    luma = tags.get("ycbcr_coefficients", ())
    rbw = tags.get("reference_black_white", ())
    return ([f(v) for v in (luma if len(luma) == 3 else (0.299, 0.587,
                                                          0.114))],
            [f(v) for v in (rbw if len(rbw) == 6 else (0, 255, 128, 255,
                                                        128, 255))])


def _bad_ycbcr_fields(tags: dict) -> bool:
    """Whether libtiff's initYCbCrConversion refuses the fields: a NaN
    coefficient or a green one of 0, a reference value outside
    (-2147483520, 2147483648) in float32 (NaN among them)."""
    luma, rbw = _ycbcr_fields(tags)
    lo, hi = np.float32(-0x7FFFFFFF + 128), np.float32(0x7FFFFFFF)
    return bool(np.isnan(luma).any() or luma[1] == 0 or not all(
        lo < v < hi for v in rbw))


def _code2v(c, rb, rw, cr):
    """libtiff's Code2V in float32, clamped to +-4096 and truncated (the
    ``int32_t`` of CLAMPw): ``(c - (int)rb) * cr / (rw - rb)``."""
    f = np.float32
    span = f(rw) - f(rb)
    v = (np.asarray(c, np.int64) - int(f(rb))).astype(f) * f(cr) / (
        span if span != 0 else f(1))
    return np.clip(v, f(-4096), f(4096)).astype(np.int64)


def _ycbcr_to_rgb(ycc: np.ndarray, tags: dict) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB of 8-bit samples
    ``[..., 3]`` (Y, Cb, Cr): the YCbCrCoefficients (default 0.299,
    0.587, 0.114) and ReferenceBlackWhite (default 0 255 128 255 128 255)
    in float32, the fixed-point tables of 16 fraction bits."""
    f = np.float32
    luma, rbw = _ycbcr_fields(tags)  # checked by _check_rgba

    def fix(x):  # FIX(CLAMP(x, 0, 2)), NaN to 0: float * 65536, + 0.5
        x = f(0) if not x >= f(0) else (f(2) if x > f(2) else x)
        return int(float(f(x * f(65536))) + 0.5)

    f1 = f(2) - f(2) * luma[0]
    f3 = f(2) - f(2) * luma[2]
    d1, d3 = fix(f1), fix(f3)
    with np.errstate(invalid="ignore", over="ignore"):
        d2, d4 = -fix(luma[0] * f1 / luma[1]), -fix(luma[2] * f3 / luma[1])
    x = np.arange(256) - 128
    cr = _code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127)
    cb = _code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y_tab = _code2v(x + 128, rbw[0], rbw[1], 255)
    tables = np.concatenate([y_tab, cr_r, cb_b, cr_g, cb_g]).astype(np.int32)
    src = np.ascontiguousarray(ycc, np.uint8)
    rgb = np.empty(ycc.shape, np.uint8)
    _color_lib().tiff_ycbcr_to_rgb(src.ctypes.data, src.size // 3,
                                   tables.ctypes.data, rgb.ctypes.data)
    return rgb


def _ycbcr_chunk(buf: np.ndarray, rows: int, w: int, cw: int, sub: tuple,
                 unit_rows: int, predictor: int, tiled: bool) -> np.ndarray:
    """A decoded chunk of subsampled YCbCr data units (h * v luma samples,
    row by row, then Cb and Cr, for each h x v block) -> the ``[rows, w,
    3]`` samples libtiff's RGBA interface converts (tif_getimage.c
    putcontig8bitYCbCr44tile ... 12tile), the chroma of each block
    repeated over it, for the ``w`` columns it shows of a chunk ``cw``
    wide.  Past the shown columns it skips ``(cw - w) // h`` units of its
    own size, but of 10 bytes at 4 x 4; bytes it did not read are zeros.
    The horizontal predictor is undone three samples apart over libtiff's
    rows (tif_predict.c PredictorDecodeTile, horAcc8): a strip's
    scanlines (a row of units over v) where they divide into threes, a
    tile's rows of ``cw`` pixels of 3 samples (TIFFTileRowSize, blind to
    the subsampling) where the tile's bytes divide into them; else not at
    all (libtiff's error, which its RGBA interface passes over)."""
    h, v = sub
    unit = h * v + 2
    full = np.zeros(unit_rows * -(-cw // h) * unit, np.uint8)
    full[:len(buf)] = buf
    if predictor == 2:
        row = 3 * cw if tiled else -(-cw // h) * unit // v
        if (len(buf) % row if tiled else row % 3) == 0:
            _unpredict(full, len(buf) // row, row, 3, 8, 2, False)
    shown = -(-w // h)
    step = shown * unit + (cw - w) // h * (10 if sub == (4, 4) else unit)
    at = np.arange(unit_rows)[:, None] * step + \
        np.arange(shown * unit)[None]
    units = np.take(full, at, mode="clip").reshape(unit_rows, shown, unit)
    luma = units[..., :h * v].reshape(unit_rows, shown, v, h).transpose(
        0, 2, 1, 3)
    out = np.empty((unit_rows * v, shown * h, 3), np.uint8)
    out[..., 0] = luma.reshape(unit_rows * v, shown * h)
    for k in (1, 2):
        out[..., k] = np.repeat(np.repeat(units[..., h * v + k - 1], v, 0),
                                h, 1)
    return out[:rows, :w]


def _lab_to_rgb(lab: np.ndarray, bits: int, tags: dict) -> np.ndarray:
    """libtiff's CIE L*a*b* -> RGB (tif_color.c TIFFCIELabToXYZ /
    TIFFCIELab16ToXYZ, then TIFFXYZToRGB for tif_getimage.c's sRGB
    display, 1500-step gamma tables; in C, ``csrc/host/tiff_color.c``, in
    libtiff's float32 steps): ``[..., 3]`` samples (L unsigned, a* and b*
    signed, 8 or 16 bits) to ``uint8`` RGB.  The reference white is the
    WhitePoint tag's (default D50)."""
    f = np.float32
    if "white_point" in tags:
        wx, wy = (f(v) for v in tags["white_point"][:2])
    else:
        total = f(96.425) + f(100) + f(82.468)
        wx, wy = f(96.425) / total, f(100) / total
    if wy == 0:
        raise ValueError("TIFF CIE L*a*b* with a white point of y 0 "
                         "(cv2.imread returns None)")
    x0, z0 = wx / wy * f(100), (f(1) - wx - wy) / wy * f(100)
    ramp = (f(255) * np.power(np.arange(1501) / 1500.0,
                              1.0 / float(f(2.4))).astype(f))
    src = np.ascontiguousarray(lab, np.uint8 if bits == 8 else np.uint16)
    rgb = np.empty(lab.shape, np.uint8)
    _color_lib().tiff_lab_to_rgb(src.ctypes.data, src.size // 3, bits, x0,
                                 f(100), z0, ramp.ctypes.data,
                                 rgb.ctypes.data)
    return rgb


def _color_lib():
    lib = _build.load("tiff_color")
    fl, ptr, i64 = ctypes.c_float, ctypes.c_void_p, ctypes.c_int64
    lib.tiff_lab_to_rgb.argtypes = [ptr, i64, ctypes.c_int, fl, fl, fl, ptr,
                                    ptr]
    lib.tiff_cmyk_to_rgb.argtypes = [ptr, i64, ptr]
    lib.tiff_ycbcr_to_rgb.argtypes = [ptr, i64, ptr, ptr]
    for fn in (lib.tiff_lab_to_rgb, lib.tiff_cmyk_to_rgb,
               lib.tiff_ycbcr_to_rgb):
        fn.restype = None
    return lib


def _alpha(tags: dict, spp: int) -> int:
    """libtiff's RGBA alpha (TIFFRGBAImageBegin): the first ExtraSamples
    value, 1 (associated) or 2 (unassociated); 0 (unspecified) counts as
    associated in files of more than 3 samples."""
    extra = tags.get("extra_samples")
    if not extra:
        return 0
    return 1 if extra[0] == 0 and spp > 3 else int(extra[0]) % 3


def _rgb(s: np.ndarray, tags: dict, photometric: int, bits: int,
         path) -> np.ndarray:
    """What libtiff's RGBA interface makes of the samples, its alpha
    dropped as OpenCV drops it: ``uint8 [H, W, 3]`` RGB."""
    H, W, spp = s.shape
    if photometric in (0, 1) and spp > 1 and _one(tags, "planar", 1) == 2:
        # separate planes: libtiff reads gray as RGB (putRGB*separate*tile):
        # plane 0, not inverted, 16 bits rounded; an unassociated alpha in
        # plane 1 multiplied in
        if bits == 16:
            s = ((s.astype(np.int64) * 255 + 32767) // 65535).astype(
                np.uint8)
        g = s[..., 0]
        if _alpha(tags, spp) == 2:
            g = ((g.astype(np.int64) * s[..., 1] + 127) // 255).astype(
                np.uint8)
        return np.stack([g, g, g], -1)
    if photometric in (0, 1):  # extra samples (alpha or not) are dropped
        g = s[..., 0]
        g = g * np.uint8(255) if bits == 1 else (
            (g >> 8).astype(np.uint8) if bits == 16 else g)
        if photometric == 0:
            g = 255 - g
        return np.stack([g, g, g], -1)
    if photometric == 3:  # the first sample indexes the map
        cmap = tags.get("colormap")
        if cmap is None or len(cmap) != 3 << bits:
            raise ValueError(f"{path}: TIFF palette image without its "
                             "colour map")
        cmap = np.asarray(cmap, np.int64).reshape(3, 1 << bits)
        if cmap.max() >= 256:  # 16-bit entries (libtiff's checkcmap)
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[s[..., 0]]
    if photometric == 5:  # putRGBcontig8bitCMYKtile, in C
        src = np.ascontiguousarray(s[..., :4], np.uint8)
        rgb = np.empty((H, W, 3), np.uint8)
        _color_lib().tiff_cmyk_to_rgb(src.ctypes.data, src.size // 4,
                                      rgb.ctypes.data)
        return rgb
    if photometric == 6:
        return _ycbcr_to_rgb(s, tags)
    if photometric == 8:
        return _lab_to_rgb(s, bits, tags)
    if bits == 16:  # libtiff's Bitdepth16To8
        s = ((s.astype(np.int64) * 255 + 32767) // 65535).astype(np.uint8)
    extra = tags.get("extra_samples", (0,))
    if spp == 4 and extra[0] == 2:  # unassociated alpha: libtiff's UaToAa
        a = s[..., 3:4].astype(np.int64)
        return ((s[..., :3] * a + 127) // 255).astype(np.uint8)
    return s[..., :3]


def _raw(tags: dict, photometric: int, bits: int, fmt: int, spp: int,
         compression: int, gray: bool, path) -> bool:
    """Whether cv2.imread returns the samples as stored (True) or what
    libtiff's RGBA interface makes of them (False), as probed for each
    photometric interpretation, depth and sample count; ``ValueError``
    where it returns None."""
    if compression in SGILOG:
        if gray and photometric == 32845:
            raise ValueError(f"{path}: TIFF LogLuv read with IMREAD_ANYDEPTH "
                             "(OpenCV's one-channel read of its three "
                             "channels fails: cv2.imread returns None)")
        _check_compression(tags, compression, bits, path)
    if bits >= 32:
        if not gray:
            raise ValueError(f"{path}: {bits}-bit TIFF read without "
                             "IMREAD_ANYDEPTH (cv2.imread returns None)")
        if spp != 1:
            raise ValueError(f"{path}: {bits}-bit TIFF of {spp} samples read "
                             "as one channel (cv2.imread returns None)")
        if photometric not in (0, 1, 2, 3):
            raise ValueError(f"{path}: {bits}-bit TIFF of photometric "
                             f"interpretation {photometric} (cv2.imread "
                             "returns None)")
        return True
    if spp > 4:
        raise ValueError(f"{path}: TIFF of {spp} samples per pixel (OpenCV "
                         "reads 1 to 4 channels: cv2.imread returns None)")
    if gray and bits == 16 and photometric in (0, 1, 2) and spp != 2:
        return True
    _check_rgba(photometric, bits, spp, tags, path)
    return False


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
    tags = _per_sample(tags, path)
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
    compression = _one(tags, "compression", 1)
    if photometric == 32845 and compression in SGILOG and not gray:
        # LogLuv: libtiff's RGBA interface has its codec return 8-bit RGB
        # ("a little white lie", tif_getimage.c), of contiguous samples
        # only; OpenCV refuses the file's own samples where they are
        # floating-point or of 12 or more bits but 16 (probed)
        _check_compression(tags, compression, bits, path)
        if _one(tags, "planar", 1) != 1:
            raise ValueError(f"{path}: TIFF LogLuv of separate planes "
                             "(cv2.imread returns None)")
        if bits not in (1, 2, 4, 8, 16) or fmt == 3:
            raise ValueError(f"{path}: TIFF LogLuv of {bits}-bit samples "
                             f"of sample format {fmt} (cv2.imread returns "
                             "None)")
        tags = dict(tags, bits=(8,), sample_format=(1,))
        bits, fmt, photometric = 8, 1, 2
    if bits in (2, 4):
        raise ValueError(f"{path}: TIFF {bits}-bit samples (cv2.imread "
                         "returns None)")
    if bits == 12:
        out = _twelve_bits(data, tags, bo, compression, photometric, fmt,
                           spp, gray, path)
        return np.ascontiguousarray(ORIENT[orientation](out)) \
            if orientation in ORIENT else out
    if not (fmt == 1 and bits == 1) and (fmt, bits) not in SAMPLE_DTYPES:
        raise ValueError(f"{path}: TIFF sample format {fmt} at {bits} bits "
                         "(cv2.imread returns None)")
    # the samples as stored where the result keeps their depth, else
    # libtiff's RGBA interface
    raw = _raw(tags, photometric, bits, fmt, spp, compression, gray, path)
    if raw and spp > 1 and _one(tags, "planar", 1) == 2:
        raise NotImplementedError(
            f"{path}: a {bits}-bit TIFF of separate colour planes read as "
            "one channel (cv2.imread reads it as interleaved samples, "
            "partly from uninitialised memory)")
    if photometric == 32844:
        # LogL: libtiff's RGBA interface has its codec return 8-bit gray
        # and reads it as min-is-black
        tags = dict(tags, bits=(8,), sample_format=(1,))
        bits, photometric = 8, 1
    s = _samples(data, tags, bo, path, partial=not raw,
                 skew=not raw and photometric in (0, 1, 3) and
                 (spp == 1 or _one(tags, "planar", 1) == 1))
    if raw:
        out = s[..., 0] if spp == 1 else _gray_as_unsigned(s[..., :3])
    else:
        if fmt == 2:  # the RGBA interface reads the bits as unsigned
            s = s.view(s.dtype.str.replace("i", "u"))
        if compression == 7 and photometric == 6 and \
                _one(tags, "planar", 1) == 1:
            photometric = 2  # libjpeg's RGB of the YCbCr samples
        rgb = _rgb(s, tags, photometric, bits, path)
        out = gray14(rgb) if gray else np.stack(
            [rgb[..., 2], rgb[..., 1], rgb[..., 0]], -1)  # BGR
        if gray and fmt == 2:  # OpenCV's signed 8-bit result of the bytes
            out = out.view(np.int8)
    if orientation in ORIENT:  # other values than 1-8: libtiff ignores them
        out = ORIENT[orientation](out)
    return np.ascontiguousarray(out)


def _twelve_bits(data: bytes, tags: dict, bo: str, compression: int,
                 photometric: int, fmt: int, spp: int, gray: bool,
                 path) -> np.ndarray:
    """12-bit samples: libtiff's RGBA interface refuses them, and so do the
    predictors, JPEG (this libtiff's libjpeg decodes no 12-bit data),
    gray with one extra sample (which OpenCV reads through that
    interface), other photometric interpretations than gray, RGB and
    palette, and other sample formats than unsigned and signed integers
    (probed: ``ValueError``, cv2.imread returns None).  The rest OpenCV
    reads with ``IMREAD_ANYDEPTH`` as 16-bit samples, as probed: one
    sample per pixel as it is, three or four (RGB, RGBA, and gray or
    palette of three samples alike) to the gray of the first three
    (:func:`gray14` of the 12-bit values, alpha ignored), then shifted up
    by 4 (``uint16``); where the samples are signed, the same values read
    as unsigned and saturated to ``int16``.  Min-is-white is not
    inverted, a palette not looked up.  Separate planes of several
    samples it reads as interleaved samples, the most of them from memory
    it never wrote (a fresh process reads the same file otherwise):
    ``NotImplementedError``, as the 16-bit case."""
    predictor = _one(tags, "predictor", 1) if compression in (5, 8, 32946) \
        else 1
    _check_predictor(predictor, 12, fmt, path)
    if not gray or spp not in (1, 3, 4) or compression == 7 or \
            photometric not in (0, 1, 2, 3) or fmt not in (1, 2):
        raise ValueError(f"{path}: TIFF of {spp} 12-bit samples, "
                         f"compression {compression}, read "
                         f"{'with' if gray else 'without'} IMREAD_ANYDEPTH "
                         "(cv2.imread returns None)")
    if spp > 1 and _one(tags, "planar", 1) == 2:
        raise NotImplementedError(
            f"{path}: a 12-bit TIFF of separate colour planes read as one "
            "channel (cv2.imread reads it as interleaved samples, partly "
            "from uninitialised memory)")
    s = _samples(data, tags, bo, path, partial=False)
    out = (gray14(s[..., :3]) if spp > 1 else s[..., 0]).astype(np.int64) \
        << 4
    return np.minimum(out, 32767).astype(np.int16) if fmt == 2 else \
        out.astype(np.uint16)


def _gray_as_unsigned(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's gray (:func:`gray14`) of samples of any 8- or 16-bit
    integer dtype, computed on their bits read as unsigned."""
    u = rgb.view(rgb.dtype.str.replace("i", "u"))
    return gray14(u).view(rgb.dtype)


# -- encoder -----------------------------------------------------------------

ENCODE_COMPRESSION = {"none": 1, "lzw": 5, "jpeg": 7, "deflate": 32946,
                      "adobe_deflate": 8, "packbits": 32773, "lzw_old": 5,
                      "ccitt_rle": 2, "group3": 3, "group4": 4,
                      "ccitt_rlew": 32771, "sgilog": 34676,
                      "sgilog24": 34677}


def lzw_encode(raw: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW of ``raw`` (MSB-first codes, the width growing one code
    early, a clear code when the table fills); ``old_style``: the pre-6.0
    coding (LSB-first codes, the width growing on time)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9
    late = 1 if old_style else 0

    def put(code):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
        else:
            acc = acc << nbits | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            if old_style:
                out.append(acc & 0xFF)
                acc >>= 8
            else:
                out.append(acc >> nacc & 0xFF)
        if not old_style:
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
        if nxt > (1 << nbits) - 1 + late and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            put(256)
            table = {bytes([k]): k for k in range(256)}
            nxt, nbits = 258, 9
        w = c
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << nbits) - 1 + late and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append(acc & 0xFF if old_style else acc << (8 - nacc) & 0xFF)
    return bytes(out)


# the T.4 modified Huffman code words (most significant bit first): the
# terminating codes of runs 0-63 and the make-up codes of 64-1728 per
# colour, then the make-up codes of 1792-2560 both colours share
_TERM = {0: (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100"),
    1: (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111")}
_MAKEUP = {0: (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011"),
    1: (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")}
_MAKEUP_X = ("00000001000 00000001100 00000001101 000000010010 000000010011 "
             "000000010100 000000010101 000000010110 000000010111 "
             "000000011100 000000011101 000000011110 000000011111").split()
_VERTICAL = {-3: "0000010", -2: "000010", -1: "010", 0: "1", 1: "011",
             2: "000011", 3: "0000011"}  # a1 - b1
EOL = "000000000001"


def _run_code(run: int, colour: int) -> str:
    """The make-up and terminating code words of one run (0 white, 1
    black)."""
    term, makeup = _TERM[colour].split(), _MAKEUP[colour].split()
    words = []
    while run >= 2560 + 64:
        words.append(_MAKEUP_X[-1])
        run -= 2560
    if run >= 64:
        m = run // 64
        words.append(makeup[m - 1] if m <= 27 else _MAKEUP_X[m - 28])
    return "".join(words) + term[run % 64]


def _changes(row: np.ndarray) -> np.ndarray:
    """The changing elements of a row of 0 (white) / 1 (black) pixels: the
    columns whose colour differs from the one before (white before the
    first)."""
    return np.flatnonzero(np.diff(row.astype(np.int8), prepend=0))


def _mh_row(row: np.ndarray) -> str:
    """One row in modified Huffman (1-D) code: runs from white."""
    edges = np.concatenate([[0], _changes(row), [len(row)]])
    return "".join(_run_code(int(r), k & 1)
                   for k, r in enumerate(np.diff(edges)))


def _read_row(row: np.ndarray, ref: np.ndarray) -> str:
    """One row in 2-D READ code against the reference row (T.4 4.2.1:
    pass, vertical and horizontal modes)."""
    W = len(row)
    a = list(_changes(row)) + [W, W]
    b = list(_changes(ref)) + [W, W]
    colour, a0, out = 0, -1, []

    def after(ch, x, col):
        """The first change right of x to colour col (changes alternate
        colour, the first to black; the row's end stands for any)."""
        k = bisect.bisect_right(ch, x)
        if ch[k] < W and (k & 1) != 1 - col:
            k += 1
        return k

    while True:
        ka = after(a, a0, 1 - colour)
        a1 = a[ka]
        kb = after(b, a0, 1 - colour)
        b1, b2 = b[kb], b[min(kb + 1, len(b) - 1)]
        if b2 < a1:
            out.append("0001")
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(_VERTICAL[a1 - b1])
            a0, colour = a1, 1 - colour
        else:
            a2 = a[min(ka + 1, len(a) - 1)]
            out.append("001" + _run_code(a1 - max(a0, 0), colour) +
                       _run_code(a2 - a1, 1 - colour))
            a0 = a2
        if a0 >= W:
            return "".join(out)


def ccitt_encode(bits: np.ndarray, scheme: int, t4_options: int = 0,
                 k: int = 2) -> bytes:
    """``[rows, cols]`` pixels (non-zero black) -> one strip of CCITT code,
    as a TIFF holds it with FillOrder 1: ``scheme`` 2 (modified Huffman
    rows, each padded to a byte), 32771 (each padded to 16 bits), 3 (T.4:
    each row after an EOL, 1-D, or with ``t4_options`` bit 0 one row in
    ``k`` 1-D and the rest 2-D after a tag bit; bit 2: EOLs ending on a
    byte boundary; RTC at the end) or 4 (T.6: 2-D rows from an all-white
    reference, EOFB at the end)."""
    bits = np.asarray(bits) != 0
    out, ref = [], np.zeros(bits.shape[1], bool)
    pos = 0
    for y, row in enumerate(bits):
        two_d = scheme == 4 or (scheme == 3 and t4_options & 1 and y % k)
        code = _read_row(row, ref) if two_d else _mh_row(row)
        if scheme == 3:
            eol = EOL
            if t4_options & 4:  # fill so that the EOL ends a byte
                eol = "0" * (-(pos + len(eol)) % 8) + eol
            if t4_options & 1:
                eol += "0" if two_d else "1"
            code = eol + code
        elif scheme in (2, 32771):
            code += "0" * (-(pos + len(code)) % (8 if scheme == 2 else 16))
        out.append(code)
        pos += len(code)
        ref = row
    if scheme == 3:
        out.append((EOL + ("1" if t4_options & 1 else "")) * 6)
    elif scheme == 4:
        out.append(EOL * 2)
    stream = "".join(out)
    stream += "0" * (-len(stream) % 8)
    return int(stream, 2).to_bytes(len(stream) // 8, "big") if stream \
        else b""


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


def logl_encode(codes: np.ndarray, planes: int = 2) -> bytes:
    """``[rows, cols]`` 16-bit LogL codes (``planes`` 4: 32-bit LogLuv
    codes) -> one strip of SGI Log data (tif_luv.c LogL16Encode's and
    LogLuvEncode32's layout): per row each byte of the codes, most
    significant first, as runs (a byte 126 + n, n >= 4 copies of the next
    byte) and literal stretches (a count of at most 127, then the
    bytes)."""
    out = bytearray()
    for row in np.asarray(codes).astype(np.uint32):
        for plane in (((row >> sh) & 0xFF).astype(np.uint8).tobytes()
                      for sh in range(8 * planes - 8, -1, -8)):
            i, lit = 0, bytearray()
            while i <= len(plane):
                j = i
                while j < len(plane) and plane[j] == plane[i] and j - i < 129:
                    j += 1
                if j - i >= 4 or i == len(plane):
                    for k in range(0, len(lit), 127):
                        out += bytes([len(lit[k:k + 127])]) + lit[k:k + 127]
                    lit = bytearray()
                    if i == len(plane):
                        break
                    out += bytes([126 + j - i, plane[i]])
                    i = j
                else:
                    lit.append(plane[i])
                    i += 1
    return bytes(out)


def _ycbcr_units(px: np.ndarray, sub: tuple) -> np.ndarray:
    """``[rows, cols, 3]`` Y, Cb, Cr samples -> their data units at
    subsampling ``sub`` (h, v): per h x v block (edge blocks padded by
    repeating the last row and column) the h * v luma samples row by row,
    then the block's mean Cb and Cr."""
    h, v = sub
    rows, cols = px.shape[:2]
    px = np.pad(px, ((0, -rows % v), (0, -cols % h), (0, 0)), mode="edge")
    bh, bw = px.shape[0] // v, px.shape[1] // h
    blocks = px.reshape(bh, v, bw, h, 3).transpose(0, 2, 1, 3, 4)
    luma = blocks[..., 0].reshape(bh, bw, v * h)
    chroma = np.round(blocks[..., 1:].reshape(bh, bw, v * h, 2).mean(2))
    return np.concatenate([luma, chroma.astype(np.uint8)], -1)


def _unit_differences(units: np.ndarray, row: int, tiled: bool
                      ) -> np.ndarray:
    """YCbCr data units (bytes) -> their horizontal differences three
    bytes apart over the rows libtiff undoes them over (see
    :func:`_ycbcr_chunk`: a strip's scanlines of ``row`` bytes where they
    divide into threes, a tile's rows of ``row`` bytes where they divide
    the tile); the bytes past the last whole row, or every byte where
    libtiff undoes nothing, as they are."""
    out = units.copy()
    n = len(units) // row
    if n == 0 or (len(units) % row if tiled else row % 3):
        return out
    rows = units[:n * row].reshape(n, row)
    d = rows.copy()
    d[:, 3:] = rows[:, 3:] - rows[:, :-3]  # modulo 256
    out[:n * row] = d.reshape(-1)
    return out


def _rational(values) -> list:
    """Floats -> (numerator, denominator) pairs of the RATIONAL type."""
    from fractions import Fraction

    return [(f.numerator, f.denominator) for f in (
        Fraction(float(v)).limit_denominator(1 << 16) for v in values)]


def encode_tiff(img, compression: str = "none", predictor: int = 1,
                rows_per_strip=None, tile=None, planar: int = 1,
                big_endian: bool = False, photometric=None, palette=None,
                bilevel: bool = False, extra_samples=None,
                bigtiff: bool = False, orientation=None, quality: int = 75,
                subsampling=(2, 2), jpeg_tables: bool = True,
                t4_options: int = 0, fill_order: int = 1,
                twelve_bit: bool = False, tags=None, chunks=None) -> bytes:
    """``[H, W]`` gray, ``[H, W, 3]`` BGR or ``[H, W, 4]`` BGRA samples of
    a dtype of :data:`SAMPLE_TYPES` -> one-page TIFF bytes, as
    ``cv2.imwrite`` lays out the samples (RGB order in the file), for
    fixtures of what :func:`decode_tiff` reads:

    - ``compression``: a key of :data:`ENCODE_COMPRESSION`; "jpeg" codes
      each 8-bit strip or tile as libtiff's JPEG codec does (``quality``;
      gray, RGB as it is with ``photometric`` 2, else YCbCr (6) at
      ``subsampling`` (h, v)), the quantisation and Huffman tables in
      JPEGTables unless not ``jpeg_tables``; "lzw_old" is LZW in the
      pre-6.0 coding; "ccitt_rle", "ccitt_rlew", "group3" (T4Options
      ``t4_options``) and "group4" code ``bilevel`` images
      (:func:`ccitt_encode`); "sgilog" codes ``int16`` LogL values
      (photometric 32844, :func:`logl_encode`); "sgilog24" stores
      ``uint32`` [H, W] 24-bit LogLuv codes (10-bit log luminance, 14-bit
      uv index) as three bytes each, most significant first (photometric
      32845, three ``int16`` samples per pixel in the tags, as
      ``cv2.imwrite`` writes LogLuv24);
    - ``twelve_bit``: ``uint16`` (or ``int16``) samples below 4096 stored
      as 12-bit samples, each row packed most significant bit first and
      padded to a byte;
    - ``predictor``: 1 (none), 2 (horizontal) or 3 (floating point), for
      LZW and Deflate (libtiff ignores it for the others); over YCbCr data
      units, horizontal differences over the rows libtiff undoes them over
      (:func:`_unit_differences`);
    - ``rows_per_strip`` (default: all), or ``tile`` (length, width);
    - ``planar`` 2: one plane per sample; ``big_endian``: ``MM`` order;
      ``bigtiff``: the BigTIFF header and directory (8-byte counts and
      offsets); ``fill_order`` 2: the bits of each byte of the coded data
      stored in reverse;
    - ``photometric`` (default 1 for gray, 2 for colour), 0 min-is-white;
      5 (CMYK), 6 (YCbCr) and 8 (CIE L*a*b*) store the samples in the
      order given; YCbCr other than JPEG in data units at
      ``subsampling``;
    - ``palette`` ([N, 3] BGR, ``uint8`` or ``uint16``): a palette image
      whose ``img`` holds [H, W] ``uint8`` or ``uint16`` indices;
    - ``bilevel``: 1-bit gray of ``img`` != 0;
    - ``extra_samples``: the ExtraSamples value(s) of a file of 2 or more
      samples (0 unspecified, 1 associated, 2 unassociated alpha; default:
      no tag, as cv2.imwrite writes it);
    - ``orientation``: the Orientation tag (1-8) over the samples as
      given (the file's first row first);
    - ``tags``: {tag: (type 3, 4, 5, 11 or 12, values)} written over the
      file's own (InkSet, the JPEGInterchangeFormat of old-style JPEG;
      RATIONAL, FLOAT and DOUBLE values as floats: WhitePoint,
      YCbCrCoefficients, ReferenceBlackWhite, NaN only as FLOAT or
      DOUBLE);
      ``chunks``: the strips' or tiles' data as given (bytes each) in place
      of the coded samples."""
    img = np.asarray(img)
    code = ENCODE_COMPRESSION[compression]
    luv24 = None
    if code == 34677:
        luv24 = img.astype(np.uint32)
        img = np.zeros(img.shape + (3,), np.int16)
        photometric = 32845
    if img.ndim == 2:
        img = img[..., None]
    H, W, spp = img.shape
    bits, fmt = SAMPLE_TYPES[img.dtype]
    bits = 1 if bilevel else 12 if twelve_bit else bits
    if photometric is None:
        photometric = 3 if palette is not None else (1 if spp < 3 else (
            6 if code == 7 else 2))
        photometric = 32844 if code == 34676 else photometric
    if spp in (3, 4) and (photometric == 2 or code == 7):
        img = img[..., [2, 1, 0, 3][:spp]]  # BGR -> the file's RGB
    units = photometric == 6 and code != 7 and planar == 1 and \
        tuple(subsampling) != (1, 1)
    bo = ">" if big_endian else "<"
    if tile is not None:
        ch, cw = tile
    else:
        ch, cw = min(rows_per_strip or H, H), W
    planes = spp if planar == 2 else 1
    per = spp // planes
    if code not in (5, 8, 32946):
        predictor = 1  # libtiff takes a predictor for these codecs only
    coded, tables = [], None
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
                elif code in (2, 3, 4, 32771):
                    raw = ccitt_encode(px[..., 0], code, t4_options)
                elif code == 34676:
                    raw = logl_encode(px[..., 0])
                elif code == 34677:
                    full = np.zeros(px.shape[:2], np.uint32)
                    part = luv24[y0:y0 + ch, x0:x0 + cw]
                    full[:part.shape[0], :part.shape[1]] = part
                    raw = (full.astype(">u4").view(np.uint8).reshape(
                        full.shape + (4,))[..., 1:]).tobytes()
                elif twelve_bit:
                    v = px.reshape(px.shape[0], -1).astype(np.uint16) & 0xfff
                    b = np.unpackbits((v << 4).astype(">u2").view(
                        np.uint8).reshape(v.shape + (2,)), axis=2)[..., :12]
                    raw = np.packbits(b.reshape(v.shape[0], -1),
                                      axis=1).tobytes()
                elif bilevel:
                    raw = np.packbits(px[..., 0] != 0, axis=1).tobytes()
                elif units:
                    u = _ycbcr_units(px, tuple(subsampling))
                    if predictor == 2:
                        row = 3 * cw if tile is not None else \
                            u.shape[1] * u.shape[2] // subsampling[1]
                        u = _unit_differences(u.reshape(-1), row,
                                              tile is not None)
                    raw = u.tobytes()
                elif predictor > 1:
                    d = _predicted(px, predictor)
                    raw = d.tobytes() if predictor == 3 else \
                        d.astype(d.dtype.newbyteorder(bo)).tobytes()
                else:
                    raw = px.astype(px.dtype.newbyteorder(bo)).tobytes()
                if code == 5:
                    raw = lzw_encode(raw, compression == "lzw_old")
                elif code in (8, 32946):
                    raw = zlib.compress(raw)
                elif code == 32773:
                    rb = len(raw) // px.shape[0]  # PackBits codes by rows
                    raw = b"".join(packbits_encode(raw[r * rb:(r + 1) * rb])
                                   for r in range(px.shape[0]))
                if fill_order == 2:
                    raw = raw.translate(_REVERSED)
                coded.append(raw)
    chunks = coded if chunks is None else list(chunks)
    entries = []  # (tag, type, values)

    def add(tag, typ, values):
        entries.append((tag, typ, list(values)))

    add(256, 4, [W])
    add(257, 4, [H])
    add(258, 3, [bits] * spp)
    add(259, 3, [code])
    add(262, 3, [photometric])
    if fill_order != 1:
        add(266, 3, [fill_order])
    if orientation is not None:
        add(274, 3, [orientation])
    add(277, 3, [spp])
    add(284, 3, [planar])
    if code == 3 and t4_options:
        add(292, 4, [t4_options])
    if predictor > 1:
        add(317, 3, [predictor])
    if palette is not None:
        pal = np.asarray(palette)
        table = np.zeros((1 << bits, 3), np.int64)
        table[:len(pal)] = pal[:, ::-1]  # BGR -> RGB
        add(320, 3, table.T.reshape(-1))
    if extra_samples is not None:
        add(338, 3, np.atleast_1d(extra_samples))
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
    given = dict(tags or {})
    entries = [e for e in entries if e[0] not in given] + [
        (tag, typ, _rational(values) if typ == 5 else list(values))
        for tag, (typ, values) in given.items()]
    entries.sort()
    ifd_at = pos
    entry, count, nxt = ("HHQ8s", "Q", "Q") if bigtiff else ("HHI4s", "H",
                                                            "I")
    inline = 8 if bigtiff else 4
    extra_at = ifd_at + struct.calcsize(bo + count) + \
        struct.calcsize(bo + entry) * len(entries) + struct.calcsize(bo + nxt)
    ifd = struct.pack(bo + count, len(entries))
    extra = b""
    codes = {3: "H", 4: "I", 5: "I", 7: "B", 11: "f", 12: "d", 16: "Q"}
    for tag, typ, values in entries:
        flat = [v for pair in values for v in pair] if typ == 5 else values
        body = struct.pack(f"{bo}{len(flat)}{codes[typ]}", *flat)
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
