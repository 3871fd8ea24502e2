"""Image files for the port's data layer: decoders and encoders of its own
in place of the ``cv2.imread`` / ``cv2.imwrite`` calls of the JAX
package's data layer (the port runs where OpenCV is not installed).

:func:`imread` picks the decoder by the file's signature, as ``cv2.imread``
does (:func:`sniff`), whatever the file's name, and returns what
``cv2.imread`` (OpenCV 5.0) returns:

- ``imread(path)``: ``uint8 [H, W, 3]``, BGR for every format but P7 RGB
  (kept in the file's order, as OpenCV keeps it); gray comes back as three
  equal channels, alpha is dropped (WebP and GIF: not composited), and
  16-bit samples become 8-bit by each reader's own rule (PNG, PNM, PAM and
  16-bit gray TIFF keep the high byte; 16-bit colour TIFF rounds
  ``x / 257``; JPEG 2000 shifts by its precision less 8); Radiance HDR's
  floats become ``saturate(round(255 f))``;
- ``imread(path, anydepth=True)`` (``cv2.IMREAD_ANYDEPTH``): one channel,
  ``uint16`` for 16-bit PNG, TIFF, PNM and PAM, 9- to 16-bit JPEG 2000
  and 10- and 12-bit AVIF,
  ``float32`` for float TIFF,
  PFM and Radiance HDR, TIFF's own dtype for its other samples (``int8``,
  ``int16``, ``uint32``, ``int32``, ``uint64``, ``int64``, ``float64``),
  ``uint8`` otherwise; colour converts to gray as each reader converts it
  (libpng's ``rgb_to_gray`` for PNG, libjpeg's ``JCS_GRAYSCALE`` output
  for JPEG, OpenCV's own ``(4899 R + 9617 G + 1868 B + 8192) >> 14`` for
  BMP, TIFF, PNM, PAM and Sun raster, ``cvtColor``'s ``(9798 R + 19235 G +
  3735 B + 16384) >> 15`` for WebP, GIF, JPEG 2000 and AVIF, ``cvtColor``'s
  float gray for HDR).

The formats, their decoders and what each reads:

- PNG (:func:`decode_png`): every colour type and bit depth of the
  standard, palette with ``tRNS``, all five row filters (the row unfilter
  in C, ``csrc/host/png_unfilter.c``, built by the host compiler at first
  use; :func:`unfilter_plain` is its numpy version) and Adam7;
- JPEG (:func:`decode_jpeg`, in C, ``csrc/host/jpeg_decode.c``): baseline,
  extended and progressive files, Huffman or arithmetic coded, of 1, 3 or
  4 components (CMYK and YCCK by the Adobe marker, converted as OpenCV
  converts them), every sampling factor, restart intervals and the EXIF
  orientation, lossless files of 2 to 8 bits in the read mode OpenCV takes
  them in, damaged streams as libjpeg-turbo 3.1 reads them;
- BMP (:func:`decode_bmp`): 1-, 4-, 8-bit palettes, RLE8 and RLE4 (in C,
  ``csrc/host/bmp_rle.c``), 16-bit 5-5-5 and 5-6-5, 24- and 32-bit,
  bottom-up and top-down, 40-byte (and longer) and OS/2 headers;
- TIFF (``data/tiff.py``): classic and BigTIFF, strips and tiles, both
  byte orders and fill orders, planar 1 and 2, none / LZW (both codings)
  / Deflate / PackBits with their predictors, JPEG, CCITT RLE / RLEW /
  Group 3 / Group 4 (in C, ``csrc/host/ccitt_decode.c``) and SGI LogL,
  orientations 1-4, 1-, 8- and 16-bit gray with or without alpha, RGB and
  RGBA, 1- and 8-bit palettes, CMYK, YCbCr, CIE L*a*b*, signed and
  32/64-bit integer and float samples;
- PBM / PGM / PPM, PAM and PFM (``data/pnm.py``);
- WebP (``data/webp.py``; VP8L, VP8 and ALPH in C,
  ``csrc/host/webp_decode.c``): lossless and lossy, simple and extended
  (VP8X, ALPH, ICCP / EXIF / XMP) files and animations (frame 0 on its
  canvas), bare VP8 / VP8L bitstreams;
- GIF (``data/gif.py``; LZW in C, ``csrc/host/gif_lzw.c``): GIF87a and
  GIF89a, global and local tables, interlacing, transparency, frame 0 on
  the background colour;
- Radiance HDR (``data/hdr.py``; scanlines in C,
  ``csrc/host/hdr_rgbe.c``): RGBE, new-style run-length and flat
  scanlines;
- Sun raster (``data/sunras.py``): depths 1, 8, 24 and 32, old and
  standard types, colour maps;
- JPEG 2000 (``data/jp2.py``; the codestream in C,
  ``csrc/host/j2k_decode.c``): JP2 files and raw codestreams, the 5/3 and
  9/7 wavelets, every progression order and its changes (POC), tiles and
  tile-parts, precincts, layers, code blocks cut short by rate allocation
  and all six code-block styles, SOP / EPH, packed packet headers (PPM /
  PPT), ROI shifts, palettes and channel
  definitions, 8- to 16-bit components (and wider, shifted to 8 bits in
  colour), the sRGB, gray and sYCC colour spaces;
- AVIF (``data/avif.py``; the AV1 stream in C, ``csrc/host/
  av1_decode.c``): still images, lossless and lossy, 8 to 12 bits, 4:4:4
  colour under the identity matrix, 4:4:4 and 4:2:0 under BT.601 full
  range and 4:0:0 gray, every intra tool and transform of libaom's key
  frames, deblocking and CDEF, tiles, alpha items (decoded, dropped).

PNG (``eXIf``) and WebP (``EXIF``) files are flipped and transposed by
their EXIF orientation after the gray or depth conversion, in both read
modes, as cv2.imread does (``data/exif.py``), as JPEG files are.

A file ``cv2.imread`` returns None for raises ``ValueError``, decided
where each decoder decides it (the C decoders, ``tiff.py``, ``webp.py``,
...), so a file reached by any path gets the same class.  A format this
OpenCV build reads and the port does not yet read raises
``NotImplementedError`` naming it: within the formats above what each
decoder lists (AVIF: superres, segmentation, film grain, frames
libavif scales to their item's size, grids, sequences; TIFF's separate colour planes of 12 or 16 bits read to
gray and an 8-bit AV1 frame under a deeper AVIF av1C read with
anydepth, which OpenCV reads partly from memory it never wrote).
The encoders
(:func:`encode_png`, :func:`encode_jpeg`, :func:`encode_bmp`,
``tiff.encode_tiff``, ``pnm.encode_pnm`` / ``encode_pam`` /
``encode_pfm``, ``webp.encode_webp_lossless``, ``gif.encode_gif``,
``hdr.encode_hdr``, ``sunras.encode_sunras``, ``avif.encode_avif``) write
fixtures of the modes the decoders read.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from lgu_slam_tpu_torch.data import (avif, exif, gif, hdr, jp2, pnm, sunras,
                                     tiff, webp)
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
        if len(body) != length:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        if zlib.crc32(kind + body) == crc:
            yield kind, body
        elif not kind[0] & 0x20:  # libpng drops an ancillary chunk
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
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


def decode_png(data: bytes, path="<bytes>", meta=None) -> np.ndarray:
    """PNG bytes -> ``[H, W, C]`` samples as libpng hands them to OpenCV
    (RGB(A) or gray(+alpha) order; ``uint8``, or ``uint16`` at bit depth
    16): gray at bit depths 1, 2 and 4 expanded to 8 bits
    (``png_set_expand_gray_1_2_4_to_8``: x 255, 85, 17), a palette image
    expanded through ``PLTE`` to RGB, or RGBA where ``tRNS`` gives its
    entries alpha (``png_set_palette_to_rgb``; an index past the palette
    reads black, as libpng's zeroed 256-entry palette gives it), Adam7
    passes put back in place.  With a dict ``meta``, sets
    ``meta["orientation"]`` to the EXIF orientation of the first ``eXIf``
    chunk libpng keeps (a good CRC and a TIFF header ``II*\\0`` or
    ``MM\\0*``, before or after the image data, not past ``IEND``), or 0.
    The first chunk must be ``IHDR``; an ancillary chunk whose CRC fails
    is dropped, as libpng drops it."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, plte, trns = None, [], None, None
    exif_block = None
    for kind, body in _chunks(data, path):
        if header is None and kind != b"IHDR":
            raise ValueError(f"{path}: PNG chunk {kind!r} before IHDR")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"eXIf" and exif_block is None and body[:4] in (
                b"II*\0", b"MM\0*"):
            exif_block = body
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
    if meta is not None:
        meta["orientation"] = exif.orientation(exif_block) if exif_block \
            else 0
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


def sniff(data: bytes) -> str:
    """The decoder ``cv2.imread`` picks for ``data``, by its signature
    (OpenCV 5.0's registration order: BMP, HDR, JPEG, WebP, Sun raster,
    PNM / PFM, TIFF, PNG, GIF, JPEG 2000, PAM): ``bmp``, ``hdr``
    (``#?RGBE`` / ``#?RADIANCE``), ``jpeg``, ``webp`` (libwebp's header
    check of the first 32 bytes, which also takes a bare VP8 or VP8L
    bitstream), ``sunras``, ``pnm``, ``pfm``, ``tiff``, ``png``, ``gif``
    (``GIF8``: the decoder then takes only GIF87a and GIF89a), ``avif``
    (an ``ftyp`` box naming ``avif`` or ``avis``), ``jp2`` (the JP2
    signature box or a codestream's SOC and SIZ markers) or ``pam``;
    anything else ``ValueError`` (cv2.imread returns None)."""
    head = data[:32]
    if head.startswith(BMP_MAGIC):
        return "bmp"
    if head.startswith(hdr.SIGNATURES):
        return "hdr"
    if head.startswith(JPEG_SOI):
        return "jpeg"
    if webp.is_webp(data):
        return "webp"
    if head.startswith(sunras.MAGIC):
        return "sunras"
    if len(head) >= 3 and head[0] == 0x50 and head[2] in pnm.SPACE:
        if 0x31 <= head[1] <= 0x36:
            return "pnm"
        if head[1] in b"fF":
            return "pfm"
        if head[1] == 0x37:
            return "pam"
    if head[:4] in (tiff.TIFF_II, tiff.TIFF_MM) + tiff.BIGTIFF:
        return "tiff"
    if head.startswith(SIGNATURE):
        return "png"
    if avif.is_avif(data):
        return "avif"
    if head[:4] == b"GIF8":
        return "gif"
    if head.startswith((jp2.SIGNATURE, jp2.CODESTREAM)):
        return "jp2"
    raise ValueError("no image format of cv2.imread's has this signature")


def imread(path, anydepth: bool = False) -> np.ndarray:
    """``cv2.imread(path)``, or with ``anydepth`` ``cv2.imread(path,
    cv2.IMREAD_ANYDEPTH)``, for the formats of the module docstring, picked
    by the file's signature as OpenCV picks them: ``uint8 [H, W, 3]`` BGR,
    or with ``anydepth`` ``[H, W]`` of ``uint8``, ``uint16``, ``float32``
    (float TIFF, PFM, HDR) or, for TIFF, the samples' own dtype (``int8``,
    ``int16``, ``uint32``, ``int32``, ``uint64``, ``int64``,
    ``float64``).  A missing file raises
    ``FileNotFoundError``; a file OpenCV returns None for, ``ValueError``;
    a format OpenCV reads and the port does not yet read,
    ``NotImplementedError`` naming it (never to be taken for None)."""
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        kind = sniff(data)
    except (NotImplementedError, ValueError) as e:
        raise type(e)(f"{path}: {e}") from None
    if kind != "png":
        return DECODERS[kind](data, path, gray=anydepth)
    meta = {}
    px = decode_png(data, path, meta)
    if px.shape[-1] in (2, 4):  # alpha is dropped (png_set_strip_alpha)
        px = px[..., :-1]
    if anydepth:
        px = px[..., 0] if px.shape[-1] == 1 else png_gray(px)
    else:
        if px.dtype == np.uint16:
            px = (px >> 8).astype(np.uint8)
        px = np.repeat(px, 3, axis=-1) if px.shape[-1] == 1 else \
            px[..., ::-1]
    # the EXIF orientation, after the conversion, as cv2.imread applies it
    return exif.orient(np.ascontiguousarray(px), meta["orientation"])


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
    coefficients 1868 / 9617 / 4899 over 2^14, rounded
    (:func:`pnm.gray14` of the samples in RGB order)."""
    return pnm.gray14(bgr[..., 2::-1])


def bitfields_gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's gray of a 32-bit BMP whose bit masks it applies: ``R *
    0.299f + G * 0.587f + B * 0.114f`` in float32, summed in that order,
    truncated."""
    b, g, r = (bgr[..., c].astype(np.float32) for c in range(3))
    f32 = np.float32
    return np.floor(r * f32(0.299) + g * f32(0.587) + b * f32(0.114)
                    ).astype(np.uint8)


def bitfields_channel(px: np.ndarray, mask: int) -> np.ndarray:
    """The field ``mask`` of ``uint32`` pixels scaled to 8 bits as OpenCV
    scales it: ``(float)field * (255.f / (float)(mask >> shift))``,
    truncated."""
    shift = (mask & -mask).bit_length() - 1
    scale = np.float32(255) / np.float32(mask >> shift)
    field = (px & np.uint32(mask)) >> np.uint32(shift)
    return np.floor(field.astype(np.float32) * scale).astype(np.uint8)


# 16-bit masks (red, green, blue) OpenCV reads, and its depth for them
BMP_MASKS16 = {(0x7C00, 0x3E0, 0x1F): 15, (0xF800, 0x7E0, 0x1F): 16}


def _bmp_header(data: bytes, path) -> tuple:
    """(width, height, bits, compression, palette [256, 3] BGR or None,
    pixel data offset, 32-bit masks) of a BMP as OpenCV's reader takes
    them (grfmt_bmp.cpp readHeader): a 12-byte OS/2 header with 3-byte
    palette entries, or a header of 36 bytes or more (40, or the V2 to V5
    extensions) with 4-byte entries and, for 16-bit bit masks, the masks
    after the header; 16-bit samples are 5-5-5 (bits 15) or 5-6-5.  The
    32-bit masks (red, green, blue) are those OpenCV applies: read from a
    header of 56 bytes or more and only if none is zero, else None (a
    40-byte header's masks are ignored, and the pixels read as BGRA
    bytes)."""
    def u32(at):
        if at + 4 > len(data):
            raise ValueError(f"{path}: BMP header cut short")
        return struct.unpack_from("<I", data, at)[0]

    offset, size = u32(10), u32(14)
    palette = masks32 = None
    if size >= 36:
        W, H = struct.unpack("<ii", struct.pack("<II", u32(18), u32(22)))
        bpp, compression, colours = u32(26) >> 16, u32(30), u32(46)
        if compression > 3:
            raise ValueError(f"{path}: BMP compression {compression}")
        ok = (bpp in (1, 4, 8, 24, 32) and compression == 0) or (
            bpp in (16, 32) and compression in (0, 3)) or (
            (bpp, compression) in ((4, 2), (8, 1)))
        if W <= 0 or H == 0 or not ok:
            raise ValueError(f"{path}: {bpp}-bit BMP of {W} x {H} pixels, "
                             f"compression {compression}")
        at = 14 + size
        if bpp <= 8:
            if colours > 256:
                raise ValueError(f"{path}: BMP palette of {colours} colours")
            n = colours or 1 << bpp
            if at + 4 * n > len(data):
                raise ValueError(f"{path}: BMP palette cut short")
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(data, np.uint8, 4 * n, at
                                        ).reshape(n, 4)[:, :3]
        elif bpp == 16 and compression == 3:
            masks = (u32(at), u32(at + 4), u32(at + 8))
            if masks not in BMP_MASKS16:
                raise ValueError(f"{path}: 16-bit BMP masks "
                                 f"{[hex(m) for m in masks]}")
            bpp = BMP_MASKS16[masks]
        elif bpp == 16:
            bpp = 15
        elif bpp == 32 and compression == 3 and size >= 56:
            masks = (u32(54), u32(58), u32(62))
            masks32 = masks if all(masks) else None
    elif size == 12:
        if len(data) < 26:
            raise ValueError(f"{path}: BMP header cut short")
        W, H = struct.unpack_from("<HH", data, 18)
        bpp, compression = u32(22) >> 16, 0
        if W == 0 or H == 0 or bpp not in (1, 4, 8, 24, 32):
            raise ValueError(f"{path}: {bpp}-bit OS/2 BMP of {W} x {H} "
                             "pixels")
        if bpp <= 8:
            n = 1 << bpp
            if 26 + 3 * n > len(data):
                raise ValueError(f"{path}: BMP palette cut short")
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 26
                                        ).reshape(n, 3)
    else:
        raise ValueError(f"{path}: BMP header of {size} bytes")
    return W, H, bpp, compression, palette, offset, masks32


def bmp_rle(data: bytes, width: int, height: int, rle4: bool) -> np.ndarray:
    """RLE8 / RLE4 pixel data -> ``uint8 [height, width]`` palette indices
    in the order the data fills the rows, decoded in C as OpenCV's reader
    decodes it (``csrc/host/bmp_rle.c``); data it refuses raises
    ``ValueError``."""
    lib = _build.load("bmp_rle")
    fn = lib.bmp_rle_decode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = np.zeros((height, width), np.uint8)
    if fn(data, len(data), int(rle4), width, height, out.ctypes.data):
        raise ValueError(f"BMP {'RLE4' if rle4 else 'RLE8'} data runs past "
                         "a row or ends early")
    return out


def decode_bmp(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """BMP bytes -> ``uint8 [H, W, 3]`` BGR as ``cv2.imread`` returns them,
    or with ``gray`` ``[H, W]`` as ``cv2.imread(path,
    cv2.IMREAD_ANYDEPTH)``: 1-, 4- and 8-bit palettes, RLE8 and RLE4
    (:func:`bmp_rle`), 16-bit 5-5-5 and 5-6-5 (each 5 or 6 bits shifted
    left, not scaled), 24-bit, 32-bit (with bit masks of any width and
    place, applied as :func:`_bmp_header` says OpenCV applies them:
    :func:`bitfields_channel`); bottom-up or top-down; OS/2 headers.  Gray
    is :func:`bgr_gray` of the colours, :func:`bitfields_gray` where 32-bit
    masks are applied.  Files OpenCV refuses raise ``ValueError``."""
    if len(data) < 18 or not data.startswith(BMP_MAGIC):
        raise ValueError(f"{path}: not a BMP file")
    W, height, bpp, compression, palette, offset, masks = _bmp_header(
        data, path)
    H = abs(height)
    if H * W * 3 >= 1 << 30:
        raise ValueError(f"{path}: BMP of {W} x {H} pixels is more than "
                         "cv2.imread reads")
    if compression in BMP_RLE:
        rows = bmp_rle(data[offset:], W, H, compression == 2)
    else:
        pitch = ((W * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        if offset + H * pitch > len(data):
            raise ValueError(f"{path}: BMP pixel data ends early")
        rows = np.frombuffer(data, np.uint8, H * pitch, offset
                             ).reshape(H, pitch)
        if bpp < 8:  # indices packed most significant first
            bits = np.unpackbits(rows, axis=1).reshape(H, -1, bpp)
            rows = bits @ (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
    if height > 0:  # bottom-up
        rows = rows[::-1]
    if bpp <= 8:
        bgr = palette[rows[:, :W]]
    elif bpp in (15, 16):
        t = rows[:, :2 * W].copy().view("<u2").astype(np.int64)
        bgr = np.stack([t << 3, (t >> 2) & 0xF8 if bpp == 15 else
                        (t >> 3) & 0xFC, (t >> 7 if bpp == 15 else t >> 8)
                        & 0xF8], axis=-1).astype(np.uint8)
    elif masks is not None:
        px = rows[:, :4 * W].copy().view("<u4")
        bgr = np.stack([bitfields_channel(px, m) for m in masks[::-1]], -1)
        return bitfields_gray(bgr) if gray else bgr
    else:
        c = bpp // 8
        bgr = rows[:, :W * c].reshape(H, W, c)[..., :3]
    if gray:
        return bgr_gray(bgr)
    return np.ascontiguousarray(bgr)


def _rle_rows(idx: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4 of rows of indices (bottom row first): runs of 3 or
    more equal values encoded, the rest in absolute runs (3 or more values)
    or encoded runs of 1 or 2; an end-of-line after each row but the last,
    which ends with the end-of-bitmap."""
    out = bytearray()
    for k, row in enumerate(idx):
        row, i, W = [int(v) for v in row], 0, len(row)
        while i < W:
            j = i
            while j + 1 < W and row[j + 1] == row[i] and j - i < 254:
                j += 1
            if j - i >= 2 or W - i < 3:
                n = j - i + 1
                out += bytes([n, row[i] * 17 if rle4 else row[i]])
                i = j + 1
                continue
            j = i
            while j < W and j - i < 255 and not (
                    j + 2 < W and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            n = j - i
            if n < 3:
                out += bytes([1, row[i] * 17 if rle4 else row[i]])
                i += 1
                continue
            vals = row[i:j]
            if rle4:
                vals += [0] * (n & 1)
                body = bytes(a << 4 | b for a, b in zip(vals[::2],
                                                          vals[1::2]))
            else:
                body = bytes(vals)
            out += bytes([0, n]) + body + b"\0" * (len(body) & 1)
            i = j
        out += b"\0\1" if k == len(idx) - 1 else b"\0\0"
    return bytes(out)


def encode_bmp(img: np.ndarray, top_down: bool = False, palette=None,
               bpp=None, rle: bool = False, masks16=None, os2: bool = False,
               rle_data=None, masks32=None, header: int = 40) -> bytes:
    """``uint8`` ``[H, W, 3]`` BGR (24-bit, or 16-bit with ``bpp`` 16:
    5-5-5, or with ``masks16`` "555" / "565" bit masks), ``[H, W, 4]``
    BGRA (32-bit) or ``[H, W]`` indices (8-bit, or ``bpp`` 1 or 4, through
    ``palette`` [N, 3] BGR, else a gray ramp) -> BMP bytes with a 40-byte
    header (``os2``: the 12-byte OS/2 one), bottom-up unless ``top_down``,
    rows padded to 4 bytes; ``rle`` compresses indices as RLE8 or RLE4
    (:func:`_rle_rows`), or ``rle_data`` is written as the RLE data.
    ``masks32`` (red, green, blue[, alpha]) writes a 32-bit image as
    BI_BITFIELDS with these masks over its bytes as they are; ``header``
    of 56, 108 or 124 bytes holds the masks (the V3 to V5 headers; the
    fields after the masks zero), a 40-byte one is followed by the
    three."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[-1] not in (3, 4)):
        raise ValueError(f"BMP images are uint8 [H, W(, 3|4)], not "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    if os2 and top_down:
        raise ValueError("an OS/2 BMP header has no top-down rows")
    bpp = bpp or (8 if img.ndim == 2 else 8 * img.shape[-1])
    if masks16 is not None:
        bpp = 16
    table, compression, extra = b"", 0, b""
    if bpp <= 8:
        pal = (np.repeat(np.linspace(0, 255, 1 << bpp).astype(np.uint8)
                         [:, None], 3, 1)
               if palette is None else np.asarray(palette, np.uint8))
        quad = np.zeros((len(pal), 3 if os2 else 4), np.uint8)
        quad[:, :3] = pal
        table = quad.tobytes()
    if bpp == 16:
        b, g, r = (img[..., c].astype(np.uint16) for c in range(3))
        if masks16 == "565":
            px = (r >> 3) << 11 | (g >> 2) << 5 | b >> 3
        else:
            px = (r >> 3) << 10 | (g >> 3) << 5 | b >> 3
        img = px.astype("<u2").view(np.uint8).reshape(H, 2 * W)
        if masks16 is not None:
            compression = 3
            extra = struct.pack("<III", *{
                "555": (0x7C00, 0x3E0, 0x1F),
                "565": (0xF800, 0x7E0, 0x1F)}[masks16])
    if masks32 is not None:
        if bpp != 32 or os2:
            raise ValueError("32-bit masks belong to a 32-bit image")
        compression = 3
        masks32 = tuple(masks32) + (0,) * (4 - len(masks32))
        if header == 40:
            extra = struct.pack("<III", *masks32[:3])
    elif header != 40:
        raise ValueError("a longer header is written for 32-bit masks only")
    if rle or rle_data is not None:
        compression = {8: 1, 4: 2}[bpp]
        rows = img[::-1] if not top_down else img
        body = rle_data if rle_data is not None else \
            _rle_rows(rows, bpp == 4)
    else:
        pitch = ((W * bpp + 7) // 8 + 3) & ~3
        rows = np.zeros((H, pitch), np.uint8)
        if bpp < 8:
            bits = np.unpackbits(img[..., None], axis=-1)[..., 8 - bpp:]
            packed = np.packbits(bits.reshape(H, -1), axis=1)
            rows[:, :packed.shape[1]] = packed
        else:
            rows[:, :W * bpp // 8] = img.reshape(H, -1)
        if not top_down:
            rows = rows[::-1]
        body = rows.tobytes()
    hsize = 12 if os2 else header
    offset = 14 + hsize + len(extra) + len(table)
    head = struct.pack("<2sIHHI", BMP_MAGIC, offset + len(body), 0, 0,
                       offset)
    if os2:
        info = struct.pack("<IHHHH", 12, W, H, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", hsize, W, -H if top_down else H,
                           1, bpp, compression, len(body), 2835, 2835,
                           len(table) // 4, 0)
        if hsize > 40:
            info += struct.pack("<IIII", *masks32) + bytes(hsize - 56)
    return head + info + extra + table + body


# -- JPEG --------------------------------------------------------------------

JPEG_STATUS = {1: ValueError, 3: MemoryError}
# output colour spaces of the C decoder (jpeg_decode.c JPEG_OUT_*)
JPEG_OUT_BGR, JPEG_OUT_GRAY, JPEG_OUT_YCC_RGB, JPEG_OUT_RAW = range(4)
# OpenCV's CV_IO_MAX_IMAGE_PIXELS: imread returns None for larger images
MAX_PIXELS = 1 << 30
def _jpeg_call(fn, path, *args):
    err = ctypes.create_string_buffer(256)
    status = fn(*args, err, len(err))
    if status:
        raise JPEG_STATUS.get(status, RuntimeError)(
            f"{path}: JPEG: {err.value.decode(errors='replace')}")


def _jpeg_lib():
    lib = _build.load("jpeg_decode")
    c_char, i64, ptr, cint = (ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int)
    lib.jpeg_info.argtypes = [c_char, i64, ptr, c_char, cint]
    lib.jpeg_decode_as.argtypes = [c_char, i64, ptr, i64, i64, cint, c_char,
                                   cint]
    lib.jpeg_info.restype = lib.jpeg_decode_as.restype = cint
    return lib


def jpeg_info(data: bytes, path="<bytes>") -> tuple:
    """The frame header of a JPEG stream: (height, width, EXIF orientation
    or 0, components, component 0's horizontal and vertical sampling
    factors, whether every other component is sampled 1 x 1)."""
    info = np.zeros(7, np.int32)
    _jpeg_call(_jpeg_lib().jpeg_info, path, data, len(data),
               info.ctypes.data)
    return tuple(int(v) for v in info)


def jpeg_samples(data: bytes, mode: int, channels: int, path="<bytes>"
                 ) -> np.ndarray:
    """The samples of a JPEG stream in output colour space ``mode``
    (``JPEG_OUT_*``: BGR, gray, YCbCr taken to RGB, or the components as
    stored), ``uint8 [H, W, channels]``, the orientation not applied."""
    H, W = jpeg_info(data, path)[:2]
    if H * W > MAX_PIXELS:
        raise ValueError(f"{path}: JPEG: {H}x{W} is more than cv2.imread "
                         f"reads ({MAX_PIXELS} pixels)")
    out = np.empty((H, W, channels), np.uint8)
    _jpeg_call(_jpeg_lib().jpeg_decode_as, path, data, len(data),
               out.ctypes.data, H, W, mode)
    return out


def decode_jpeg(data: bytes, path="<bytes>", gray: bool = False
                ) -> np.ndarray:
    """JPEG bytes -> ``uint8 [H, W, 3]`` BGR with the EXIF orientation
    applied: what ``cv2.imread`` returns for a file of these bytes (module
    docstring), or with ``gray`` ``[H, W]`` as ``cv2.imread(path,
    cv2.IMREAD_ANYDEPTH)`` returns it (libjpeg's ``JCS_GRAYSCALE`` output:
    the Y plane, or the luma of an RGB file); decoded in C
    (``csrc/host/jpeg_decode.c``)."""
    orientation = jpeg_info(data, path)[2]
    out = jpeg_samples(data, JPEG_OUT_GRAY if gray else JPEG_OUT_BGR,
                       1 if gray else 3, path)
    out = exif.orient(out, orientation)
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


def _planes(img: np.ndarray, fac: list, transform) -> list:
    """The component planes of ``img`` padded to whole MCUs by edge
    replication, each averaged down to its sampling factors ``fac`` ((h, v)
    per component), level-shifted: gray; Y, Cb, Cr of BGR (JFIF's YCbCr),
    or with the Adobe ``transform`` 0 its R, G, B as they are; the four
    samples of CMYK; or with ``transform`` 2 Y, Cb, Cr of R, G, B = 255 -
    C, M, Y and K (Adobe's YCCK)."""
    H, W = img.shape[:2]
    hm, vm = max(f[0] for f in fac), max(f[1] for f in fac)
    pad = [(0, -H % (8 * vm)), (0, -W % (8 * hm))] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img, pad, mode="edge").astype(np.float64)
    ycck = transform == 2
    if img.ndim == 2:
        comps = [x - 128]
    elif img.shape[-1] == 3 and transform == 0:
        comps = [x[..., c] - 128 for c in (2, 1, 0)]
    elif img.shape[-1] == 4 and not ycck:
        comps = [x[..., c] - 128 for c in range(4)]
    else:
        if img.shape[-1] == 4:
            r, g, b = 255 - x[..., 0], 255 - x[..., 1], 255 - x[..., 2]
        else:
            b, g, r = x[..., 0], x[..., 1], x[..., 2]
        comps = [0.299 * r + 0.587 * g + 0.114 * b - 128,
                 -0.168735892 * r - 0.331264108 * g + 0.5 * b,
                 0.5 * r - 0.418687589 * g - 0.081312411 * b]
        if img.shape[-1] == 4:
            comps.append(x[..., 3] - 128)
    PH, PW = comps[0].shape
    out = []
    for c, (h, v) in zip(comps, fac):
        dy, dx = vm // v, hm // h
        out.append(c.reshape(PH // dy, dy, PW // dx, dx).mean(axis=(1, 3)))
    return out


def _mcu_blocks(planes: list, fac: list):
    """8 x 8 blocks in scan order (per MCU each component's v x h blocks row
    by row, component after component), their component, and the blocks per
    MCU."""
    def blocks(plane, bh, bw):
        rows, cols = plane.shape[0] // (8 * bh), plane.shape[1] // (8 * bw)
        b = plane.reshape(rows, bh, 8, cols, bw, 8).transpose(0, 3, 1, 4, 2,
                                                              5)
        return b.reshape(rows * cols, bh * bw, 8, 8)
    per_mcu = [blocks(p, v, h) for p, (h, v) in zip(planes, fac)]
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


# T.81 Table D.2 as libjpeg packs it (jaricom.c): Qe << 16 |
# Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
# fixed estimate of probability 0.5
_ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
)
# libjpeg's progressions (jcparam.c jpeg_simple_progression): (components,
# Ss, Se, Ah, Al); "Y" is component 0 alone, "C" each other one alone
_PROGRESSION = ((None, 0, 0, 0, 1), ("Y", 1, 5, 0, 2), ("C", 1, 63, 0, 1),
                ("Y", 6, 63, 0, 2), ("Y", 1, 63, 2, 1), (None, 0, 0, 1, 0),
                ("C", 1, 63, 1, 0), ("Y", 1, 63, 1, 0))
# the lossless files' DC table: categories 0-16 by code lengths 2 to 14
_LOSSLESS_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0)


def _qm_encoder():
    """T.81 Annex D's QM encoder as jcarith.c writes it: ``(encode(bins,
    i, bit), finish())``; ``encode`` codes one decision in statistics bin
    ``bins[i]`` (a bytearray, updated), ``finish`` ends the segment
    (Section D.1.8) and returns its bytes, 0xFF stuffed."""
    out = bytearray()
    c, a, sc, zc, ct, buf = 0, 0x10000, 0, 0, 11, -1

    def flush_zeros():
        nonlocal zc
        if zc:
            out.extend(bytes(zc))
            zc = 0

    def emit(byte):
        out.append(byte)
        if byte == 0xFF:
            out.append(0)

    def carry():  # an overflow into the stacked bytes
        nonlocal zc, sc
        if buf >= 0:
            flush_zeros()
            emit(buf + 1)
        zc += sc
        sc = 0

    def settle():  # the stacked bytes will not overflow any more
        nonlocal zc, sc
        if buf == 0:
            zc += 1
        elif buf >= 0:
            flush_zeros()
            out.append(buf)
        if sc:
            flush_zeros()
            out.extend(b"\xff\x00" * sc)
            sc = 0

    def encode(bins, i, val):
        nonlocal c, a, sc, ct, buf
        sv = bins[i]
        e = _ARITAB[sv & 0x7F]
        qe = e >> 16
        a -= qe
        if val != sv >> 7:  # the less probable symbol
            if a >= qe:
                c += a
                a = qe
            bins[i] = (sv & 0x80) ^ (e & 0xFF)
        else:
            if a >= 0x8000:
                return
            if a < qe:
                c += a
                a = qe
            bins[i] = (sv & 0x80) ^ (e >> 8 & 0xFF)
        while True:  # renormalisation and output (D.1.6)
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    carry()
                    buf = temp & 0xFF
                elif temp == 0xFF:
                    sc += 1
                else:
                    settle()
                    buf = temp
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                return

    def finish():
        nonlocal c
        temp = (a - 1 + c) & 0xFFFF0000
        c = temp + 0x8000 if temp < c else temp
        c <<= ct
        if c & 0xF8000000:
            carry()
        else:
            settle()
        if c & 0x7FFF800:
            flush_zeros()
            emit(c >> 19 & 0xFF)
            if c & 0x7F800:
                emit(c >> 11 & 0xFF)
        return bytes(out)

    return encode, finish


def _arith_dc(enc, bins, ctx: int, v: int, L: int, U: int) -> int:
    """A DC difference ``v`` in context ``ctx`` (Figures F.4 and F.6-F.9);
    returns the next context (F.1.4.4.1.2, L and U from DAC)."""
    if v == 0:
        enc(bins, ctx, 0)
        return 0
    enc(bins, ctx, 1)
    if v > 0:
        enc(bins, ctx + 1, 0)
        st, ctx = ctx + 2, 4
    else:
        v = -v
        enc(bins, ctx + 1, 1)
        st, ctx = ctx + 3, 8
    m = 0
    v -= 1
    if v:
        enc(bins, st, 1)
        m, st, v2 = 1, 20, v >> 1
        while v2:
            enc(bins, st, 1)
            m, st, v2 = m << 1, st + 1, v2 >> 1
    enc(bins, st, 0)
    if m < (1 << L) >> 1:
        ctx = 0
    elif m > (1 << U) >> 1:
        ctx += 8
    st += 14
    m >>= 1
    while m:
        enc(bins, st, 1 if m & v else 0)
        m >>= 1
    return ctx


def _arith_ac(enc, bins, fixed, zz, ss: int, se: int, al: int, K: int
              ) -> None:
    """Zigzag coefficients ``zz[ss..se]`` of a block, ``al`` bits dropped
    from their magnitudes (Figure F.5 and F.6-F.9; G.1.3.2)."""
    vals = [0] * 64
    ke = 0
    for k in range(se, 0, -1):
        v = int(zz[k])
        v = (v >> al) if v >= 0 else -((-v) >> al)
        vals[k] = v
        if v and not ke:
            ke = k
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        enc(bins, st, 0)  # not the end of block
        while vals[k] == 0:
            enc(bins, st + 1, 0)
            st += 3
            k += 1
        enc(bins, st + 1, 1)
        v = vals[k]
        if v > 0:
            enc(fixed, 0, 0)
        else:
            v = -v
            enc(fixed, 0, 1)
        st += 2
        m = 0
        v -= 1
        if v:
            enc(bins, st, 1)
            m, v2 = 1, v >> 1
            if v2:
                enc(bins, st, 1)
                m, st, v2 = 2, 189 if k <= K else 217, v2 >> 1
                while v2:
                    enc(bins, st, 1)
                    m, st, v2 = m << 1, st + 1, v2 >> 1
        enc(bins, st, 0)
        st += 14
        m >>= 1
        while m:
            enc(bins, st, 1 if m & v else 0)
            m >>= 1
        k += 1
    if k <= se:
        enc(bins, 3 * (k - 1), 1)  # end of block


def _arith_ac_refine(enc, bins, fixed, zz, ss: int, se: int, ah: int,
                     al: int) -> None:
    """The bit ``al`` of AC coefficients ``zz[ss..se]`` after a scan that
    sent bits from ``ah`` up (Figure G.10)."""
    def mag(v, b):
        return (v >> b) if v >= 0 else (-v) >> b

    ke = next((k for k in range(se, 0, -1) if mag(int(zz[k]), al)), 0)
    kex = next((k for k in range(ke, 0, -1) if mag(int(zz[k]), ah)), 0)
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            enc(bins, st, 0)
        while True:
            v = int(zz[k])
            m = mag(v, al)
            if m:
                if m >> 1:  # already nonzero: its next bit
                    enc(bins, st + 2, m & 1)
                else:  # newly nonzero, and its sign
                    enc(bins, st + 1, 1)
                    enc(fixed, 0, int(v < 0))
                break
            enc(bins, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc(bins, 3 * (k - 1), 1)


def _arith_scan(q, units, tabs, ss, se, ah, al, restart, conditioning,
                progressive: bool) -> bytes:
    """One arithmetic-coded scan: ``units`` lists, per MCU, its blocks as
    (index into the zigzag coefficients ``q``, component); ``tabs[c]`` the
    component's table; restart markers every ``restart`` MCUs."""
    L, U, K = conditioning
    out, enc, finish = b"", None, None
    fixed = bytearray([113])
    for n, mcu in enumerate(units):
        if n % (restart or len(units)) == 0:
            if enc is not None:
                out += finish() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            enc, finish = _qm_encoder()
            dc_bins = [bytearray(64) for _ in range(2)]
            ac_bins = [bytearray(256) for _ in range(2)]
            ctx, pred = {}, {}
        for b, c in mcu:
            t, zz = tabs[c], q[b]
            if not progressive:
                dc = int(zz[0])
                ctx[c] = _arith_dc(enc, dc_bins[t], ctx.get(c, 0),
                                   dc - pred.get(c, 0), L, U)
                pred[c] = dc
                _arith_ac(enc, ac_bins[t], fixed, zz, 1, 63, 0, K)
            elif ss == 0 and ah == 0:
                dc = int(zz[0]) >> al
                ctx[c] = _arith_dc(enc, dc_bins[t], ctx.get(c, 0),
                                   dc - pred.get(c, 0), L, U)
                pred[c] = dc
            elif ss == 0:
                enc(fixed, 0, int(zz[0]) >> al & 1)
            elif ah == 0:
                _arith_ac(enc, ac_bins[t], fixed, zz, ss, se, al, K)
            else:
                _arith_ac_refine(enc, ac_bins[t], fixed, zz, ss, se, ah, al)
    return out + finish()


def _block_index(fac: list, bpm: int, mcux: int):
    """index(c, by, bx): the place of component c's block (by, bx) among
    the MCU-ordered blocks of :func:`_mcu_blocks`."""
    first = np.cumsum([0] + [h * v for h, v in fac])

    def index(c, by, bx):
        h, v = fac[c]
        mcu = (by // v) * mcux + bx // h
        return mcu * bpm + first[c] + (by % v) * h + bx % h
    return index


def _lossless_events(planes: list, predictor: int, pt: int, precision: int,
                     rows_per_interval: int):
    """The Huffman-coded differences of interleaved components ``planes``
    (each ``[H, W]``, sampled 1 x 1), in stream order: (code and extra bits
    as one value, length, restart interval); predictions as jdlossls.c
    undoes them (the first row of each interval from the left only)."""
    codes, lengths = _huff_codes(_LOSSLESS_BITS, bytes(range(17)))
    H, W = planes[0].shape
    diffs = []
    for x in planes:
        x = x.astype(np.int64) >> pt
        pred = np.empty_like(x)
        ra = np.zeros_like(x)
        ra[:, 1:] = x[:, :-1]
        rb = np.zeros_like(x)
        rb[1:] = x[:-1]
        rc = np.zeros_like(x)
        rc[1:, 1:] = x[:-1, :-1]
        pred[:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                   5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                   7: (ra + rb) >> 1}[predictor]
        pred[:, 0] = rb[:, 0]
        first = np.arange(H) % rows_per_interval == 0
        pred[first, 1:] = x[first, :-1]
        pred[first, 0] = 1 << (precision - pt - 1)
        d = (x - pred) & 0xFFFF
        diffs.append(np.where(d >= 32768, d - 65536, d))
    d = np.stack(diffs, -1).reshape(-1)  # per pixel, component after
    size = np.where(d == -32768, 16, _sizes(d))
    extra = np.where(d < 0, d + (1 << np.minimum(size, 15)) - 1, d)
    extra = np.where(size == 16, 0, extra)
    ebits = np.where(size == 16, 0, size)
    vals = (codes[size] << ebits) | extra
    interval = np.repeat(np.arange(H) // rows_per_interval, W * len(planes))
    return vals, lengths[size] + ebits, interval


def _lossless_jpeg(img: np.ndarray, predictor: int, pt: int,
                   precision: int, restart_rows: int) -> bytes:
    """A lossless (SOF3) file of ``[H, W]`` gray or ``[H, W, 3]`` BGR
    samples (stored as R, G, B with component ids 1, 2, 3 and no JFIF
    marker, which libjpeg-turbo then takes for RGB), every component
    sampled 1 x 1, a restart marker every ``restart_rows`` rows."""
    if predictor not in range(1, 8) or not 0 <= pt < precision:
        raise ValueError(f"lossless predictor {predictor}, point transform "
                         f"{pt}")
    if int(img.max(initial=0)) >> precision:
        raise ValueError(f"samples above {precision} bits")
    H, W = img.shape[:2]
    planes = [img] if img.ndim == 2 else [img[..., 2], img[..., 1],
                                          img[..., 0]]
    rows = restart_rows or H
    vals, lens, interval = _lossless_events(planes, predictor, pt, precision,
                                            rows)
    data = _pack(vals, lens, interval, int(interval[-1]) + 1)
    n = len(planes)
    sof = struct.pack(">BHHB", precision, H, W, n) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(n))
    out = [b"\xff\xd8", _segment(0xC3, sof),
           _segment(0xC4, bytes([0]) + bytes(_LOSSLESS_BITS)
                    + bytes(range(17)))]
    if restart_rows:
        out.append(_segment(0xDD, struct.pack(">H", restart_rows * W)))
    sos = bytes([n]) + b"".join(bytes([c + 1, 0]) for c in range(n))
    out.append(_segment(0xDA, sos + bytes([predictor, 0, pt])))
    return b"".join(out + [data.tobytes(), b"\xff\xd9"])


def encode_jpeg(img: np.ndarray, quality: int = 95, subsampling: str = "420",
                restart_interval: int = 0, adobe_transform=None,
                arithmetic: bool = False, progressive: bool = False,
                conditioning=None, lossless: bool = False,
                predictor: int = 1, point_transform: int = 0,
                precision: int = 8) -> bytes:
    """``[H, W, 3]`` BGR or ``[H, W]`` gray ``uint8`` -> baseline JFIF bytes
    with the Annex K tables scaled to ``quality`` (1-100, libjpeg's
    scaling), the luma ``subsampling`` of :data:`SUBSAMPLING` and a restart
    marker every ``restart_interval`` MCUs (0: none).  ``[H, W, 4]`` CMYK
    samples as Adobe stores them (inverted: 0 is full ink) -> a 4-component
    file with an Adobe APP14 marker of ``adobe_transform`` 0 (CMYK, every
    component at full resolution; the default) or 2 (YCCK: Y and K at the
    luma sampling, Cb and Cr at 1 x 1); ``adobe_transform`` 0 of BGR
    stores R, G and B as they are (Adobe's RGB, each at 1 x 1).  A float DCT and rounding: for
    writing fixtures, as ``cv2.imwrite`` (or, for CMYK, an image editor)
    writes them for the JAX package's tests.  The same quantised
    coefficients go to each coding:

    - ``arithmetic``: arithmetic coding (SOF9, T.81 Annex D's QM coder as
      libjpeg's jcarith.c codes) with the DAC ``conditioning`` (L, U, Kx)
      of every table (default libjpeg's 0, 1, 5, and no DAC segment);
      ``progressive`` (SOF10): libjpeg's simple progression, spectral
      selection and successive approximation;
    - ``lossless`` (SOF3, Huffman): the samples themselves, ``predictor``
      1-7, ``point_transform`` bits dropped, ``precision`` bits per sample
      (``uint16`` samples above 8), ``[H, W]`` or ``[H, W, 3]`` sampled
      1 x 1; ``restart_interval`` counts rows."""
    img = np.asarray(img)
    if lossless:
        if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3) \
                or (img.ndim == 3 and img.shape[-1] != 3):
            raise ValueError(f"lossless JPEG of {img.dtype} {img.shape}")
        return _lossless_jpeg(img, predictor, point_transform, precision,
                              restart_interval)
    if progressive and not arithmetic:
        raise NotImplementedError("progressive Huffman files are written "
                                  "by cv2.imwrite, not here")
    if img.dtype != np.uint8:
        raise TypeError(f"JPEG samples are uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1]
                                  not in (3, 4)):
        raise ValueError(f"JPEG images are [H, W], [H, W, 3] or [H, W, 4], "
                         f"not {img.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality} is not 1-100")
    H, W = img.shape[:2]
    ncomp = 1 if img.ndim == 2 else img.shape[-1]
    transform = (adobe_transform or 0) if ncomp == 4 else (
        adobe_transform if ncomp == 3 else None)
    h, v = (1, 1) if ncomp == 1 or transform == 0 else \
        SUBSAMPLING[subsampling]
    fac = [(h, v)] + [(1, 1)] * min(ncomp - 1, 2) + [(h, v)] * (ncomp == 4)
    tsel = [0, 1, 1, 0][:ncomp]  # quantisation and Huffman table per comp
    planes = _planes(img, fac, transform)
    blk, comp, bpm = _mcu_blocks(planes, fac)
    qtabs = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    luma = np.asarray(tsel)[comp] == 0
    table = np.where(luma[:, None], qtabs[0][None], qtabs[1][None])
    coef = (_DCT @ blk @ _DCT.T).reshape(-1, 64)
    q = np.rint(coef / table).astype(np.int64)[:, _ZIGZAG]

    scans = []  # (SOS segment body, entropy-coded data)
    if arithmetic:
        cond = conditioning or (0, 1, 5)
        mcux = -(-W // (8 * h))
        index = _block_index(fac, bpm, mcux)
        mcus = [[(b, int(comp[b])) for b in range(m * bpm, (m + 1) * bpm)]
                for m in range(len(comp) // bpm)]
        script = _PROGRESSION if progressive else ((None, 0, 63, 0, 0),)
        for which, ss, se, ah, al in script:
            groups = [list(range(ncomp))] if which is None else [[0]] \
                if which == "Y" else [[c] for c in range(1, ncomp)]
            for cs in groups:
                if len(cs) > 1 or ncomp == 1:
                    units = mcus
                else:  # one component: its blocks in raster order
                    c = cs[0]
                    hc, vc = fac[c]
                    hm, vm = max(f[0] for f in fac), max(f[1] for f in fac)
                    wib = -(-W * hc // (8 * hm))
                    hib = -(-H * vc // (8 * vm))
                    units = [[(index(c, by, bx), c)] for by in range(hib)
                             for bx in range(wib)]
                data = _arith_scan(q, units, tsel, ss, se, ah, al,
                                   restart_interval, cond, progressive)
                sos = bytes([len(cs)]) + b"".join(
                    bytes([c + 1, 0x11 * tsel[c]]) for c in cs) + \
                    bytes([ss, se, ah << 4 | al])
                scans.append((sos, data))
    else:
        # DC differences within each restart interval, per component
        mcu = np.arange(len(comp)) // bpm
        interval = mcu // restart_interval if restart_interval else 0 * mcu
        dc = q[:, 0].copy()
        for c in range(len(planes)):
            sel = np.nonzero(comp == c)[0]
            first = np.r_[True, interval[sel][1:] != interval[sel][:-1]]
            dc[sel] -= np.where(first, 0, np.r_[0, q[sel[:-1], 0]])
        block, vals, lens = _events(q, dc, luma)
        data = _pack(vals, lens, interval[block], int(interval[-1]) + 1)
        sos = bytes([ncomp]) + b"".join(
            bytes([c + 1, 0x11 * tsel[c]]) for c in range(ncomp))
        scans.append((sos + bytes([0, 63, 0]), data.tobytes()))

    out = [b"\xff\xd8"]
    if transform is not None:  # "Adobe", version 100, flags, transform
        out.append(_segment(0xEE, b"Adobe\x00\x64\0\0\0\0"
                            + bytes([transform])))
    else:
        out.append(_segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01"
                            b"\x00\x00"))
    for t in range(min(ncomp, 2)):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            qtabs[t][_ZIGZAG].astype(np.uint8))))
    marker = 0xC0 if not arithmetic else (0xCA if progressive else 0xC9)
    sof = struct.pack(">BHHB", 8, H, W, ncomp)
    for c in range(ncomp):
        sof += bytes([c + 1, fac[c][0] << 4 | fac[c][1], tsel[c]])
    out.append(_segment(marker, sof))
    if arithmetic and conditioning is not None:
        L, U, K = conditioning
        out.append(_segment(0xCC, b"".join(
            bytes([t, U << 4 | L, 16 + t, K]) for t in range(min(ncomp, 2)))))
    for t in range(min(ncomp, 2) if not arithmetic else 0):
        out.append(_segment(0xC4, bytes([t]) + bytes(_DC_BITS[t])
                            + bytes(range(12))))
        out.append(_segment(0xC4, bytes([0x10 | t]) + bytes(_AC_BITS[t])
                            + _AC_VALS[t]))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    for sos, data in scans:
        out += [_segment(0xDA, sos), data]
    out.append(b"\xff\xd9")
    return b"".join(out)


# imread's decoder of each sniff kind but PNG, whose result imread adjusts
DECODERS = {"jpeg": decode_jpeg, "bmp": decode_bmp, "pnm": pnm.decode_pnm,
            "pfm": pnm.decode_pfm, "pam": pnm.decode_pam,
            "tiff": tiff.decode_tiff, "webp": webp.decode_webp,
            "gif": gif.decode_gif, "hdr": hdr.decode_hdr,
            "sunras": sunras.decode_sunras, "jp2": jp2.decode_jp2,
            "avif": avif.decode_avif}
