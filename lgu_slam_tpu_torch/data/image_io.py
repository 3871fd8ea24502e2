"""Image files for the port's data layer: a PNG decoder and encoder of its
own, in place of the ``cv2.imread`` / ``cv2.imwrite`` calls of the JAX
package's data layer (the port runs where OpenCV is not installed).

:func:`imread` returns what ``cv2.imread`` returns for the PNGs the data
layer reads:

- ``imread(path)``: ``uint8 [H, W, 3]`` in BGR order; a gray PNG comes back
  as three equal channels, alpha is dropped, and 16-bit samples keep their
  high byte (libpng's ``png_set_strip_16``, which OpenCV's decoder calls);
- ``imread(path, anydepth=True)`` (``cv2.IMREAD_ANYDEPTH``): a gray PNG as
  one channel, ``uint16`` for 16-bit files, ``uint8`` for 8-bit ones.

Decoding covers bit depth 8 and 16 of gray, gray + alpha, RGB and RGBA with
all five row filters.  Interlaced, palette and sub-byte images raise
``ValueError``; JPEG and every other format raise ``NotImplementedError``.
The row unfilter, sequential along a row for the Average and Paeth filters,
runs in C (``csrc/host/png_unfilter.c``, built by the host compiler at
first use); :func:`unfilter_plain` is its numpy version, for the tests.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from lgu_slam_tpu_torch.ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel (palette, type 3, is not read)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
JPEG_TODO = ("JPEG decoding is not ported yet (ROADMAP A.R item 8: a host C "
             "decoder held to cv2.imread)")


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


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """PNG bytes -> ``[H, W, C]`` samples as stored (RGB(A) or gray(+alpha)
    order; ``uint8``, or ``uint16`` at bit depth 16)."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, method, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not "
                         "read")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not read")
    if interlace != 0 or method != 0:
        raise ValueError(f"{path}: interlaced PNG is not read")
    bpp = CHANNELS[ctype] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    pixels = unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    return pixels.reshape(height, width, CHANNELS[ctype])


def imread(path, anydepth: bool = False) -> np.ndarray:
    """``cv2.imread(path)``, or with ``anydepth`` ``cv2.imread(path,
    cv2.IMREAD_ANYDEPTH)``, for PNG files (module docstring).  A missing
    file raises ``FileNotFoundError`` (OpenCV returns None)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(b"\xff\xd8\xff"):
        raise NotImplementedError(f"{path}: {JPEG_TODO}")
    if not data.startswith(SIGNATURE):
        raise NotImplementedError(f"{path}: only PNG files are read")
    px = decode_png(data, path)
    if px.shape[-1] in (2, 4):  # alpha is dropped
        px = px[..., :-1]
    if anydepth:
        if px.shape[-1] != 1:
            raise ValueError(f"{path}: anydepth reads gray PNGs only")
        return px[..., 0]
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


def encode_png(img: np.ndarray, filter_type: int = 4) -> bytes:
    """``[H, W]`` or ``[H, W, C]`` (C = 1 gray, 3 BGR, 4 BGRA) ``uint8`` or
    ``uint16`` -> PNG bytes, every row filtered with ``filter_type``
    (0-4)."""
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
    depth = 8 * img.dtype.itemsize
    bpp = C * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(f">u{img.dtype.itemsize}")) \
        .view(np.uint8).reshape(H, W * bpp)
    raw = np.empty((H, W * bpp + 1), np.uint8)
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
    ctype = {1: 0, 3: 2, 4: 6}[C]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray, filter_type: int = 4) -> None:
    """Write ``img`` as a PNG file (:func:`encode_png`), as ``cv2.imwrite``
    writes a ``.png``."""
    if os.path.splitext(str(path))[1].lower() != ".png":
        raise NotImplementedError(f"{path}: only PNG files are written")
    with open(path, "wb") as fh:
        fh.write(encode_png(img, filter_type))
