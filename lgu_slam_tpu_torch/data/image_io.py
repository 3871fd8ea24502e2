"""Image files for the port's data layer: PNG, JPEG and BMP decoders and
encoders of its own, in place of the ``cv2.imread`` / ``cv2.imwrite`` calls
of the JAX package's data layer (the port runs where OpenCV is not
installed).

:func:`imread` returns what ``cv2.imread`` returns for these files:

- ``imread(path)``: ``uint8 [H, W, 3]`` in BGR order; a gray image comes
  back as three equal channels, alpha is dropped, and 16-bit samples keep
  their high byte (libpng's ``png_set_strip_16``, which OpenCV's decoder
  calls);
- ``imread(path, anydepth=True)`` (``cv2.IMREAD_ANYDEPTH``): one channel,
  ``uint16`` for 16-bit PNGs, ``uint8`` otherwise; colour files convert to
  gray as OpenCV's readers convert them (libpng's ``rgb_to_gray`` for PNG,
  libjpeg's ``JCS_GRAYSCALE`` output for JPEG, OpenCV's own for BMP).

PNG decoding (:func:`decode_png`) covers every colour type and bit depth
of the standard (gray at 1, 2, 4, 8 and 16 bits, palette with ``PLTE`` and
``tRNS``, gray + alpha, RGB, RGBA), all five row filters and Adam7
interlacing.  The row unfilter, sequential along a row for the Average and
Paeth filters, runs in C (``csrc/host/png_unfilter.c``, built by the host
compiler at first use); :func:`unfilter_plain` is its numpy version, for
the tests.  :func:`encode_png` writes fixtures of every mode it reads.

JPEG decoding (:func:`decode_jpeg`) runs in C (``csrc/host/jpeg_decode.c``,
built the same way): baseline and progressive Huffman JPEG of 8-bit gray or
3-component files, every sampling factor OpenCV writes, restart intervals
and the EXIF orientation, bit for bit as ``cv2.imread`` (libjpeg-turbo 3.1)
decodes them, truncated and damaged streams included (libjpeg's warnings:
the data's end padded, bad codes read as zero, block smoothing of
incomplete progressive coefficients); a stream for which OpenCV returns
None raises ``ValueError``.  Arithmetic coding, 12-bit, lossless,
hierarchical and CMYK / YCCK files raise ``NotImplementedError``.
:func:`encode_jpeg` is a baseline encoder in numpy for writing fixtures.

BMP decoding (:func:`decode_bmp`) covers uncompressed 8-bit palette, 24-
and 32-bit files with the 40-byte header or its extensions, bottom-up and
top-down; RLE compression, other depths and OS/2 headers raise
``NotImplementedError``, as every other format (TIFF, WebP) does.
:func:`encode_bmp` writes fixtures.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from lgu_slam_tpu_torch.ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel (a palette index is one)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
BMP_MAGIC = b"BM"
JPEG_SOI = b"\xff\xd8\xff"


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _unpack(rows: np.ndarray, width: int, depth: int,
            channels: int) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] -> samples [h, width, channels]
    (``uint8`` for bit depths 1-8, MSB-first within a byte; ``uint16`` at
    16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows.reshape(h, width, channels)
    per = 8 // depth  # samples per byte (one channel below 8 bits)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(h, -1)[:, :width, None].astype(np.uint8)


# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# the bit depths PNG allows per colour type
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """PNG bytes -> ``[H, W, C]`` samples as libpng hands them to OpenCV
    (RGB(A) or gray(+alpha) order; ``uint8``, or ``uint16`` at bit depth
    16): gray at bit depths 1, 2 and 4 expanded to 8 bits
    (``png_set_expand_gray_1_2_4_to_8``: x 255, 85, 17), a palette image
    expanded through ``PLTE`` to RGB, or RGBA where ``tRNS`` gives its
    entries alpha (``png_set_palette_to_rgb``; an index past the palette
    reads black, as libpng's zeroed 256-entry palette gives it), Adam7
    passes put back in place."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body[:len(body) // 3 * 3],
                                 np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, method, interlace = header
    if ctype not in DEPTHS:
        raise ValueError(f"{path}: PNG colour type {ctype}")
    if depth not in DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG bit depth {depth} of colour type "
                         f"{ctype}")
    if method != 0 or interlace not in (0, 1):
        raise ValueError(f"{path}: PNG filter method {method}, interlace "
                         f"method {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: a palette PNG without a PLTE chunk")
    channels = CHANNELS[ctype]
    bits = channels * depth
    raw = zlib.decompress(b"".join(idat))
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [((width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy)
             for x0, y0, dx, dy in passes]
    need = sum(h * ((w * bits + 7) // 8 + 1) for w, h in sizes if w and h)
    if len(raw) != need:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not "
                         f"{need}")
    px = np.zeros((height, width, channels),
                  np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (w, h) in zip(passes, sizes):
        if w == 0 or h == 0:
            continue
        rowbytes = (w * bits + 7) // 8
        n = h * (rowbytes + 1)
        rows = unfilter(raw[pos:pos + n], h, rowbytes, max(1, bits // 8))
        pos += n
        px[y0::dy, x0::dx] = _unpack(rows.reshape(h, rowbytes), w, depth,
                                     channels)
    if ctype == 3:
        table = np.zeros((256, 4), np.uint8)  # libpng's zeroed palette
        table[:len(plte), :3] = plte[:256]
        table[:, 3] = 255
        if trns is not None:
            table[:min(len(trns), 256), 3] = trns[:256]
        return table[px[..., 0], :4 if trns is not None else 3]
    if depth < 8:
        return px * np.uint8(255 // ((1 << depth) - 1))
    return px


def png_gray(px: np.ndarray) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``, which
    OpenCV's PNG reader asks for a gray read of a colour file: coefficients
    9797 / 19234 / 3737 over 2^15; 8-bit samples truncate, 16-bit ones
    round; a pixel with R = G = B keeps its value."""
    r, g, b = (px[..., c].astype(np.int64) for c in range(3))
    acc = 9797 * r + 19234 * g + 3737 * b
    if px.dtype == np.uint16:
        acc += 16384
    return np.where((r == g) & (r == b), r, acc >> 15).astype(px.dtype)


def imread(path, anydepth: bool = False) -> np.ndarray:
    """``cv2.imread(path)``, or with ``anydepth`` ``cv2.imread(path,
    cv2.IMREAD_ANYDEPTH)``, for PNG, JPEG and BMP files (module
    docstring).  A missing file raises ``FileNotFoundError``, and a file
    of another format ``NotImplementedError`` (OpenCV returns None for
    both where it cannot read them)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data, path, gray=anydepth)
    if data.startswith(BMP_MAGIC):
        return decode_bmp(data, path, gray=anydepth)
    if not data.startswith(SIGNATURE):
        raise NotImplementedError(f"{path}: only PNG, JPEG and BMP files "
                                  "are read")
    px = decode_png(data, path)
    if px.shape[-1] in (2, 4):  # alpha is dropped (png_set_strip_alpha)
        px = px[..., :-1]
    if anydepth:
        return px[..., 0] if px.shape[-1] == 1 else png_gray(px)
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if px.shape[-1] == 1:
        return np.repeat(px, 3, axis=-1)
    return np.ascontiguousarray(px[..., ::-1])


def unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``raw`` (``height`` rows of a filter-type
    byte and ``rowbytes`` bytes) in C; returns the ``height * rowbytes``
    bytes as ``uint8``."""
    if len(raw) != height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not "
                         f"{height} rows of {rowbytes + 1}")
    lib = _build.load("png_unfilter")
    fn = lib.png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int
    out = np.empty(height * rowbytes, np.uint8)
    status = fn(raw, out.ctypes.data, height, rowbytes, bpp)
    if status < 0:
        raise MemoryError("png_unfilter: out of memory")
    if status > 0:
        raise ValueError(f"PNG row {status - 1}: unknown filter type")
    return out


def unfilter_plain(raw: bytes, height: int, rowbytes: int,
                   bpp: int) -> np.ndarray:
    """numpy version of :func:`unfilter` (Average and Paeth loop over the
    bytes of a row in Python: for tests on small images)."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    up = np.zeros(rowbytes, np.int64)
    for y in range(height):
        ft, x = rows[y, 0], rows[y, 1:].astype(np.int64)
        if ft == 0:
            row = x
        elif ft == 1:  # running sum along each byte lane of a pixel
            pad = -rowbytes % bpp
            lanes = np.concatenate([x, np.zeros(pad, np.int64)])
            row = np.cumsum(lanes.reshape(-1, bpp), axis=0).reshape(-1)
            row = row[:rowbytes]
        elif ft == 2:
            row = x + up
        elif ft in (3, 4):
            row = np.zeros(rowbytes, np.int64)
            for i in range(rowbytes):
                a = row[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i] = (x[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y}: unknown filter type")
        up = row & 0xFF
        out[y] = up
    return out.reshape(-1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Rows of bytes [h, rowbytes] -> [h, 1 + rowbytes], each row
    filtered with ``filter_type`` (0-4) over pixels of ``bpp`` bytes."""
    h, n = rows.shape
    raw = np.empty((h, n + 1), np.uint8)
    raw[:, 0] = filter_type
    # the predictor from the unfiltered left / up / up-left bytes (int16)
    if filter_type == 0:
        pred = 0
    else:
        x = rows.astype(np.int16)
        left = np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
        up = np.zeros_like(x)
        up[1:] = x[:-1]
        if filter_type == 1:
            pred = left
        elif filter_type == 2:
            pred = up
        elif filter_type == 3:
            pred = (left + up) >> 1
        else:
            upleft = np.zeros_like(x)
            upleft[:, bpp:] = up[:, :-bpp]
            pred = _paeth(left, up, upleft)
    # uint8 arithmetic wraps modulo 256, as the filters are defined
    np.subtract(rows, np.asarray(pred).astype(np.uint8), out=raw[:, 1:],
                casting="unsafe")
    return raw


def _packed(px: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, c] -> rows of bytes [h, rowbytes] at ``depth`` bits
    (MSB first below 8 bits, big-endian at 16)."""
    h, w, c = px.shape
    if depth >= 8:
        return np.ascontiguousarray(px.astype(f">u{depth // 8}")).view(
            np.uint8).reshape(h, w * c * depth // 8)
    per = 8 // depth
    x = np.zeros((h, -(-w // per) * per), np.uint8)
    x[:, :w] = px[..., 0]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(x.reshape(h, -1, per) << shifts, axis=2)


def encode_png(img: np.ndarray, filter_type: int = 4, bit_depth=None,
               palette=None, trns=None, interlace: bool = False) -> bytes:
    """``[H, W]`` or ``[H, W, C]`` (C = 1 gray, 3 BGR, 4 BGRA) ``uint8`` or
    ``uint16`` -> PNG bytes, every row filtered with ``filter_type``
    (0-4).  For fixtures of the modes :func:`decode_png` reads:
    ``palette`` ([N, 3] BGR colours) writes a palette image whose ``img``
    holds [H, W] indices, with ``trns`` (alpha per entry) as its tRNS
    chunk; ``bit_depth`` 1, 2 or 4 packs gray samples or palette indices,
    which must fit; ``interlace`` writes the Adam7 passes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples are uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"PNG images are [H, W, 1|3|4], not {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    H, W, C = img.shape
    if C in (3, 4):  # BGR(A) -> RGB(A)
        img = img[..., [2, 1, 0, 3][:C]]
    depth = bit_depth or 8 * img.dtype.itemsize
    if palette is not None:
        if C != 1 or img.dtype != np.uint8 or depth > 8:
            raise ValueError("a palette image holds [H, W] uint8 indices")
        ctype = 3
    else:
        ctype = {1: 0, 3: 2, 4: 6}[C]
    if depth not in DEPTHS[ctype] or (depth < 8 and img.dtype != np.uint8):
        raise ValueError(f"bit depth {depth} of colour type {ctype}")
    if depth < 8 and int(img.max(initial=0)) >> depth:
        raise ValueError(f"samples above {depth} bits")
    bits = C * depth
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(
        _filtered(_packed(img[y0::dy, x0::dx], depth), max(1, bits // 8),
                  filter_type).tobytes()
        for x0, y0, dx, dy in passes
        if x0 < W and y0 < H)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    extra = b""
    if palette is not None:
        rgb = np.asarray(palette, np.uint8).reshape(-1, 3)[:, ::-1]
        extra = chunk(b"PLTE", rgb.tobytes())
        if trns is not None:
            extra += chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes())
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                         0, int(interlace)))
            + extra
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray, filter_type: int = 4) -> None:
    """Write ``img`` as a PNG file (:func:`encode_png`), as ``cv2.imwrite``
    writes a ``.png``, or as a JPEG file (:func:`encode_jpeg` at
    ``cv2.imwrite``'s defaults: quality 95, 4:2:0) for ``.jpg`` /
    ``.jpeg``."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".png":
        data = encode_png(img, filter_type)
    elif ext in (".jpg", ".jpeg"):
        data = encode_jpeg(img)
    else:
        raise NotImplementedError(f"{path}: only PNG and JPEG files are "
                                  "written")
    with open(path, "wb") as fh:
        fh.write(data)


# -- BMP ---------------------------------------------------------------------

BMP_RLE = {1: "RLE8", 2: "RLE4"}


def bgr_gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's gray of ``uint8`` BGR samples (``icvCvt_BGR2Gray_8u``):
    coefficients 1868 / 9617 / 4899 over 2^14, rounded."""
    b, g, r = (bgr[..., c].astype(np.int64) for c in range(3))
    return ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14).astype(np.uint8)


def bgra_bitfields_gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's gray of a 32-bit BMP with bit masks (BI_BITFIELDS):
    coefficients 7471 / 38470 / 19595 over 2^16, truncated."""
    b, g, r = (bgr[..., c].astype(np.int64) for c in range(3))
    return ((7471 * b + 38470 * g + 19595 * r) >> 16).astype(np.uint8)


# the masks of BGRA bytes (red, green, blue), the only ones read
BMP_MASKS = (0xFF0000, 0xFF00, 0xFF)


def decode_bmp(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """Uncompressed BMP bytes (8-bit palette, 24- and 32-bit, the latter
    also with the BGRA bit masks that ``cv2.imwrite`` writes; bottom-up or
    top-down; rows padded to 4 bytes) -> ``uint8 [H, W, 3]`` BGR as
    ``cv2.imread`` returns them (a 32-bit file's fourth byte dropped), or
    with ``gray`` ``[H, W]`` as ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``
    (:func:`bgr_gray` of the colours; :func:`bgra_bitfields_gray` for bit
    masks).  RLE compression, other depths and other masks raise
    ``NotImplementedError``."""
    if len(data) < 26 or not data.startswith(BMP_MAGIC):
        raise ValueError(f"{path}: not a BMP file")
    offset, size = struct.unpack_from("<II", data, 10)
    if size < 40 or len(data) < 54:
        raise NotImplementedError(f"{path}: BMP header of {size} bytes "
                                  "(the 40-byte header and its extensions "
                                  "are read)")
    W, height, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    colours, = struct.unpack_from("<I", data, 46)
    if compression in BMP_RLE:
        raise NotImplementedError(f"{path}: {BMP_RLE[compression]} "
                                  "compressed BMP")
    if bpp not in (8, 24, 32) or compression not in (0, 3) or (
            compression == 3 and bpp != 32):
        raise NotImplementedError(f"{path}: {bpp}-bit BMP (compression "
                                  f"{compression}); 8-bit palette, 24- and "
                                  "32-bit files are read")
    if compression == 3 and (len(data) < 66 or struct.unpack_from(
            "<III", data, 54) != BMP_MASKS):
        raise NotImplementedError(f"{path}: BMP bit masks other than BGRA "
                                  "bytes")
    H = abs(height)
    if W <= 0 or H == 0:
        raise ValueError(f"{path}: BMP of {W} x {height} pixels")
    pitch = ((W * bpp + 7) // 8 + 3) & ~3
    if offset + H * pitch > len(data):
        raise ValueError(f"{path}: BMP pixel data ends early")
    rows = np.frombuffer(data, np.uint8, H * pitch, offset).reshape(H, pitch)
    if height > 0:  # bottom-up
        rows = rows[::-1]
    if bpp == 8:
        n = colours or 256
        if not 0 <= n <= 256 or 14 + size + 4 * n > len(data):
            raise ValueError(f"{path}: BMP palette of {n} colours")
        table = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(data, np.uint8, 4 * n, 14 + size)
        table[:n] = pal.reshape(n, 4)[:, :3]
        bgr = table[rows[:, :W]]
    else:
        c = bpp // 8
        bgr = rows[:, :W * c].reshape(H, W, c)[..., :3]
    if gray:
        return bgra_bitfields_gray(bgr) if compression == 3 else \
            bgr_gray(bgr)
    return np.ascontiguousarray(bgr)


def encode_bmp(img: np.ndarray, top_down: bool = False,
               palette=None) -> bytes:
    """``uint8`` ``[H, W, 3]`` BGR (24-bit), ``[H, W, 4]`` BGRA (32-bit) or
    ``[H, W]`` (8-bit, through ``palette`` [N, 3] BGR, else a gray ramp)
    -> uncompressed BMP bytes with a 40-byte header, bottom-up unless
    ``top_down``, rows padded to 4 bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[-1] not in (3, 4)):
        raise ValueError(f"BMP images are uint8 [H, W(, 3|4)], not "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    bpp = 8 if img.ndim == 2 else 8 * img.shape[-1]
    table = b""
    if bpp == 8:
        pal = (np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
               if palette is None else np.asarray(palette, np.uint8))
        quad = np.zeros((len(pal), 4), np.uint8)
        quad[:, :3] = pal
        table = quad.tobytes()
    pitch = ((W * bpp // 8) + 3) & ~3
    rows = np.zeros((H, pitch), np.uint8)
    rows[:, :W * bpp // 8] = img.reshape(H, -1)
    if not top_down:
        rows = rows[::-1]
    offset = 54 + len(table)
    header = struct.pack("<2sIHHI", BMP_MAGIC, offset + rows.size, 0, 0,
                         offset)
    info = struct.pack("<IiiHHIIiiII", 40, W, -H if top_down else H, 1, bpp,
                       0, rows.size, 2835, 2835, len(table) // 4, 0)
    return header + info + table + rows.tobytes()


# -- JPEG --------------------------------------------------------------------

JPEG_STATUS = {1: ValueError, 2: NotImplementedError, 3: MemoryError}
# OpenCV's CV_IO_MAX_IMAGE_PIXELS: imread returns None for larger images
MAX_PIXELS = 1 << 30
# EXIF orientation -> the flips and transpose cv2.imread applies
# (imgcodecs' ExifTransform)
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
           6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
           7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1],
           8: lambda a: a.transpose(1, 0, 2)[::-1]}


def _jpeg_call(fn, path, *args):
    err = ctypes.create_string_buffer(256)
    status = fn(*args, err, len(err))
    if status:
        raise JPEG_STATUS.get(status, RuntimeError)(
            f"{path}: JPEG: {err.value.decode(errors='replace')}")


def decode_jpeg(data: bytes, path="<bytes>", gray: bool = False
                ) -> np.ndarray:
    """JPEG bytes -> ``uint8 [H, W, 3]`` BGR with the EXIF orientation
    applied: what ``cv2.imread`` returns for a file of these bytes (module
    docstring), or with ``gray`` ``[H, W]`` as ``cv2.imread(path,
    cv2.IMREAD_ANYDEPTH)`` returns it (libjpeg's ``JCS_GRAYSCALE`` output:
    the Y plane, or the luma of an RGB file); decoded in C
    (``csrc/host/jpeg_decode.c``)."""
    lib = _build.load("jpeg_decode")
    c_char, i64, ptr, cint = (ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int)
    lib.jpeg_info.argtypes = [c_char, i64, ptr, c_char, cint]
    lib.jpeg_decode_as.argtypes = [c_char, i64, ptr, i64, i64, cint, c_char,
                                   cint]
    lib.jpeg_info.restype = lib.jpeg_decode_as.restype = cint
    info = np.zeros(3, np.int32)
    _jpeg_call(lib.jpeg_info, path, data, len(data), info.ctypes.data)
    H, W, orientation = (int(v) for v in info)
    if H * W > MAX_PIXELS:
        raise ValueError(f"{path}: JPEG: {H}x{W} is more than cv2.imread "
                         f"reads ({MAX_PIXELS} pixels)")
    out = np.empty((H, W) if gray else (H, W, 3), np.uint8)
    _jpeg_call(lib.jpeg_decode_as, path, data, len(data), out.ctypes.data, H,
               W, int(gray))
    if gray:
        out = out[..., None]
    if orientation in _ORIENT:
        out = np.ascontiguousarray(_ORIENT[orientation](out))
    return out[..., 0] if gray else out


# Annex K.1 quantisation tables (natural order) and K.3 Huffman tables
# (code counts per length 1..16, then the values)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32)])
_DC_BITS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
_AC_BITS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
            (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# luma sampling factors (h, v) of each subsampling; chroma is 1 x 1
SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2),
               "411": (4, 1)}
# orthonormal 8-point DCT-II matrix
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _huff_codes(bits, vals):
    """Code and length of every symbol of a table (Annex C)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n, cnt in enumerate(bits, start=1):
        for _ in range(cnt):
            code[vals[k]], length[vals[k]] = c, n
            c, k = c + 1, k + 1
        c <<= 1
    return code, length


def _quant_table(base, quality: int) -> np.ndarray:
    """libjpeg's quality scaling (jcparam.c), clamped to baseline's 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _sizes(v):
    """JPEG magnitude category of each value: the bit length of |v|."""
    return np.frexp(np.abs(v))[1].astype(np.int64)


def _planes(img: np.ndarray, h: int, v: int) -> list:
    """The component planes of ``img`` padded to whole MCUs of ``h`` x
    ``v`` luma blocks by edge replication: gray, or Y and the chroma
    averaged over ``h`` x ``v`` (JFIF's YCbCr, from BGR), level-shifted."""
    H, W = img.shape[:2]
    pad = [(0, -H % (8 * v)), (0, -W % (8 * h))] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img, pad, mode="edge").astype(np.float64)
    if img.ndim == 2:
        return [x - 128]
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b
    PH, PW = y.shape
    return [y - 128] + [c.reshape(PH // v, v, PW // h, h).mean(axis=(1, 3))
                        for c in (cb, cr)]


def _mcu_blocks(planes: list, h: int, v: int):
    """8 x 8 blocks in scan order (per MCU the luma blocks row by row, then
    Cb, Cr), their component, and the blocks per MCU."""
    def blocks(plane, bh, bw):
        rows, cols = plane.shape[0] // (8 * bh), plane.shape[1] // (8 * bw)
        b = plane.reshape(rows, bh, 8, cols, bw, 8).transpose(0, 3, 1, 4, 2,
                                                              5)
        return b.reshape(rows * cols, bh * bw, 8, 8)
    per_mcu = [blocks(planes[0], v, h)] + [blocks(p, 1, 1)
                                           for p in planes[1:]]
    comp = np.concatenate([np.full(p.shape[1], c)
                           for c, p in enumerate(per_mcu)])
    n_mcu = per_mcu[0].shape[0]
    return (np.concatenate(per_mcu, axis=1).reshape(-1, 8, 8),
            np.tile(comp, n_mcu), len(comp))


def _events(q: np.ndarray, dc: np.ndarray, luma: np.ndarray):
    """The Huffman-coded symbols of the blocks' zigzag coefficients ``q``
    (DC as the differences ``dc``), in stream order: (block, code and
    appended bits as one value, its length in bits)."""
    tabs = {"dc": [_huff_codes(_DC_BITS[t], bytes(range(12)))
                   for t in (0, 1)],
            "ac": [_huff_codes(_AC_BITS[t], _AC_VALS[t]) for t in (0, 1)]}

    def coded(kind, sym, is_luma, val=None, size=0):
        (c0, l0), (c1, l1) = tabs[kind]
        code = np.where(is_luma, c0[sym], c1[sym])
        length = np.where(is_luma, l0[sym], l1[sym])
        if val is None:
            return code, length
        extra = np.where(val < 0, val + (1 << size) - 1, val)
        return (code << size) | extra, length + size

    nb = len(q)
    blocks, slots, vals, lens = [], [], [], []

    def add(block, slot, val_len):
        blocks.append(block)
        slots.append(slot)
        vals.append(val_len[0])
        lens.append(val_len[1])

    # DC at slot 0; a nonzero AC coefficient at zigzag k at slot 2k + 1,
    # after its runs of 16 zeros (ZRL) at slot 2k; EOB at slot 128
    size = _sizes(dc)
    add(np.arange(nb), np.zeros(nb, np.int64),
        coded("dc", size, luma, dc, size))
    bi, ki = np.nonzero(q[:, 1:])
    k = ki + 1
    prev_k = np.r_[0, k[:-1]]
    prev_k[np.r_[True, bi[1:] != bi[:-1]]] = 0
    run = k - prev_k - 1
    val = q[bi, k]
    size = _sizes(val)
    add(bi, 2 * k + 1, coded("ac", (run % 16) << 4 | size, luma[bi], val,
                             size))
    zrl = np.repeat(np.arange(len(bi)), run // 16)
    add(bi[zrl], 2 * k[zrl], coded("ac", np.full(len(zrl), 0xF0),
                                   luma[bi[zrl]]))
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    add(eob, np.full(len(eob), 128), coded("ac", np.zeros(len(eob),
                                                          np.int64),
                                           luma[eob]))
    blocks = np.concatenate(blocks)
    order = np.argsort(blocks * 256 + np.concatenate(slots), kind="stable")
    return (blocks[order], np.concatenate(vals)[order],
            np.concatenate(lens)[order])


def _pack(vals, lens, interval, n_int: int) -> np.ndarray:
    """The events' bits as bytes, each restart interval padded with 1 bits
    to a byte, 0xFF bytes stuffed with a zero and RSTn markers between the
    intervals."""
    bits_per = np.bincount(interval, weights=lens, minlength=n_int
                           ).astype(np.int64)
    pad = -bits_per % 8
    at = np.searchsorted(interval, np.arange(n_int), side="right")
    vals = np.insert(vals, at, (1 << pad) - 1)
    lens = np.insert(lens, at, pad)
    idx = np.repeat(np.arange(len(lens)), lens)
    off = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    data = np.packbits(((vals[idx] >> (lens[idx] - 1 - off)) & 1)
                       .astype(np.uint8))
    ends = np.cumsum((bits_per + pad) // 8)
    ff = np.nonzero(data == 0xFF)[0]
    data = np.insert(data, ff + 1, 0)
    ends = ends + np.searchsorted(ff, ends)
    marks = np.stack([np.full(n_int - 1, 0xFF),
                      0xD0 + np.arange(n_int - 1) % 8], 1).reshape(-1)
    return np.insert(data, np.repeat(ends[:-1], 2), marks).astype(np.uint8)


def encode_jpeg(img: np.ndarray, quality: int = 95, subsampling: str = "420",
                restart_interval: int = 0) -> bytes:
    """``[H, W, 3]`` BGR or ``[H, W]`` gray ``uint8`` -> baseline JFIF bytes
    with the Annex K tables scaled to ``quality`` (1-100, libjpeg's
    scaling), the luma ``subsampling`` of :data:`SUBSAMPLING` and a restart
    marker every ``restart_interval`` MCUs (0: none).  A float DCT and
    rounding: for writing fixtures, as ``cv2.imwrite`` writes them for the
    JAX package's tests."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"JPEG samples are uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(f"JPEG images are [H, W] or [H, W, 3], not "
                         f"{img.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality} is not 1-100")
    H, W = img.shape[:2]
    h, v = (1, 1) if img.ndim == 2 else SUBSAMPLING[subsampling]
    planes = _planes(img, h, v)
    blk, comp, bpm = _mcu_blocks(planes, h, v)
    qtabs = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    table = np.where((comp > 0)[:, None], qtabs[1][None], qtabs[0][None])
    coef = (_DCT @ blk @ _DCT.T).reshape(-1, 64)
    q = np.rint(coef / table).astype(np.int64)[:, _ZIGZAG]

    # DC differences within each restart interval, per component
    mcu = np.arange(len(comp)) // bpm
    interval = mcu // restart_interval if restart_interval else 0 * mcu
    dc = q[:, 0].copy()
    for c in range(len(planes)):
        sel = np.nonzero(comp == c)[0]
        first = np.r_[True, interval[sel][1:] != interval[sel][:-1]]
        dc[sel] -= np.where(first, 0, np.r_[0, q[sel[:-1], 0]])
    block, vals, lens = _events(q, dc, comp == 0)
    data = _pack(vals, lens, interval[block], int(interval[-1]) + 1)

    ncomp = len(planes)
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(min(ncomp, 2)):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            qtabs[t][_ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, H, W, ncomp)
    for c in range(ncomp):
        sof += bytes([c + 1, (h << 4 | v) if c == 0 else 0x11, min(c, 1)])
    out.append(_segment(0xC0, sof))
    for t in range(min(ncomp, 2)):
        out.append(_segment(0xC4, bytes([t]) + bytes(_DC_BITS[t])
                            + bytes(range(12))))
        out.append(_segment(0xC4, bytes([0x10 | t]) + bytes(_AC_BITS[t])
                            + _AC_VALS[t]))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([ncomp])
    for c in range(ncomp):
        sos += bytes([c + 1, 0x11 * min(c, 1)])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out += [data.tobytes(), b"\xff\xd9"]
    return b"".join(out)
