"""GIF files as ``cv2.imread`` reads them (OpenCV 5.0's own decoder,
``grfmt_gif.cpp``), for the port's data layer, and an encoder for fixtures.

What OpenCV's reader does, which :func:`decode_gif` repeats:

- the signature is ``GIF87a`` or ``GIF89a``; the logical screen must have
  a non-zero size, and a background index past the global colour table
  fails the read;
- the whole file is walked first (to count its frames): every block at the
  top level must be an extension (``0x21``), an image (``0x2C``) or the
  trailer (``0x3B``), which must come; anything else, or data that ends
  early, fails the read;
- frame 0 is read: a Graphic Control Extension before it gives its
  transparent index (disposal methods above 3 fail the read), its
  rectangle must lie inside the screen, its indices come from LZW
  (``csrc/host/gif_lzw.c``; rows put back in place when interlaced);
- colours: a local table's entries, then the global table's past them; an
  index past both fails the read; with no table at all, gray (index 1
  white);
- the frame is drawn onto a canvas of the global table's background
  colour (black without a global table), its transparent pixels left as
  the canvas; later frames are not read;
- the result drops alpha (``COLOR_BGRA2BGR``); a gray read is
  ``COLOR_BGR2GRAY`` of it (:func:`pnm.cvt_gray`).

:func:`encode_gif` writes GIF87a / GIF89a files of palette indices: global
or local tables, interlacing, a transparent index, several frames, any
minimum code size from 2 to 8.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from lgu_slam_tpu_torch.data import pnm
from lgu_slam_tpu_torch.ops import _build

SIGNATURES = (b"GIF87a", b"GIF89a")
# the order of an interlaced frame's rows: every 8th from 0, every 8th from
# 4, every 4th from 2, every 2nd from 1
INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


class _Reader:
    """Bytes read in order; reading past the end fails the read."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("GIF: the file ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def blocks(self) -> bytes:
        """The data sub-blocks up to their terminator, joined."""
        parts = []
        while True:
            n = self.byte()
            if n == 0:
                return b"".join(parts)
            parts.append(self.take(n))


def _table(r: _Reader, flags: int) -> np.ndarray:
    size = 1 << ((flags & 7) + 1)
    return np.frombuffer(r.take(3 * size), np.uint8).reshape(size, 3)


def _walk(r: _Reader) -> None:
    """The frame count pass: blocks up to the trailer."""
    while True:
        kind = r.byte()
        if kind == 0x3B:
            return
        if kind == 0x21:
            r.byte()
            r.blocks()
        elif kind == 0x2C:
            flags = r.take(9)[8]
            if flags & 0x80:
                _table(r, flags)
            r.byte()
            r.blocks()
        else:
            raise ValueError(f"GIF: block type {kind:#x}")


def lzw_indices(data: bytes, min_code_size: int, npix: int) -> np.ndarray:
    """A frame's joined LZW data -> ``npix`` indices, decoded in C
    (``csrc/host/gif_lzw.c``); what OpenCV refuses raises ValueError."""
    lib = _build.load("gif_lzw")
    fn = lib.gif_lzw_decode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = np.empty(npix, np.uint8)
    status = fn(data, len(data), min_code_size, npix, out.ctypes.data)
    if status == 3:
        raise MemoryError("GIF: out of memory")
    if status:
        raise ValueError("GIF: the LZW data does not decode to the frame")
    return out


def decode_gif(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """GIF bytes -> what ``cv2.imread`` returns for a file of them (module
    docstring): ``uint8 [H, W, 3]`` BGR, or with ``gray`` ``[H, W]``.
    Files OpenCV does not read raise ``ValueError``."""
    try:
        bgr = _frame0(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return pnm.cvt_gray(bgr) if gray else bgr


def _frame0(data: bytes) -> np.ndarray:
    r = _Reader(data)
    if r.take(6) not in SIGNATURES:
        raise ValueError("GIF: not GIF87a or GIF89a")
    W, H, flags, bg, _ = struct.unpack("<HHBBB", r.take(7))
    if W == 0 or H == 0:
        raise ValueError("GIF: an empty logical screen")
    glob = _table(r, flags) if flags & 0x80 else None
    if glob is not None and bg >= len(glob):
        raise ValueError("GIF: the background index is past the table")
    start = r.pos
    _walk(r)
    if W * H * 3 >= 1 << 30 or W > 1 << 20 or H > 1 << 20:
        raise ValueError("GIF: larger than cv2.imread reads")
    r.pos = start
    transparent = None
    while True:
        kind = r.byte()
        if kind == 0x2C:
            break
        if kind == 0x3B:
            raise ValueError("GIF: no image")
        label = r.byte()
        body = r.blocks()
        if label == 0xF9 and len(body) >= 4:
            if (body[0] >> 2) & 7 > 3:
                raise ValueError("GIF: disposal method above 3")
            transparent = body[3] if body[0] & 1 else None
    x0, y0, w, h, flags = struct.unpack("<HHHHB", r.take(9))
    if w == 0 or h == 0 or x0 + w > W or y0 + h > H:
        raise ValueError("GIF: the frame lies outside the screen")
    local = _table(r, flags) if flags & 0x80 else None
    min_code = r.byte()
    idx = lzw_indices(r.blocks(), min_code, w * h).reshape(h, w)
    if flags & 0x40:
        order = np.concatenate([np.arange(s, h, d) for s, d in INTERLACE])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if glob is None and local is None:
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        palette[1] = 255
    else:
        size = max(len(t) for t in (glob, local) if t is not None)
        palette = np.zeros((size, 3), np.uint8)
        if glob is not None:
            palette[:len(glob)] = glob
        if local is not None:
            palette[:len(local)] = local
    if int(idx.max()) >= len(palette):
        raise ValueError("GIF: an index past the colour tables")
    canvas = np.zeros((H, W, 3), np.uint8)
    if glob is not None:
        canvas[:] = glob[bg][::-1]
    drawn = palette[idx][..., ::-1]
    region = canvas[y0:y0 + h, x0:x0 + w]
    keep = idx != transparent if transparent is not None else \
        np.ones(idx.shape, bool)
    region[keep] = drawn[keep]
    return canvas


def _lzw(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF LZW of a flat index array (a clear code first and whenever the
    table fills, the end code last)."""
    clear = 1 << min_code_size
    table = {(i,): i for i in range(clear)}
    nxt, size = clear + 2, min_code_size + 1
    codes, widths = [clear], [size]
    cur = ()
    for v in indices.tolist():
        cand = cur + (v,)
        if cand in table:
            cur = cand
            continue
        codes.append(table[cur])
        widths.append(size)
        if nxt < 4096:
            table[cand] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            codes.append(clear)
            widths.append(size)
            table = {(i,): i for i in range(clear)}
            nxt, size = clear + 2, min_code_size + 1
        cur = (v,)
    if cur:
        codes.append(table[cur])
        widths.append(size)
    codes.append(clear + 1)
    widths.append(size)
    acc, nbits, out = 0, 0, bytearray()
    for c, n in zip(codes, widths):
        acc |= c << nbits
        nbits += n
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _table_bytes(table: np.ndarray) -> tuple:
    """(size bits k, padded RGB bytes) of a table of up to 256 entries."""
    k = max(0, int(np.ceil(np.log2(max(len(table), 2)))) - 1)
    pad = np.zeros(((2 << k) - len(table), 3), np.uint8)
    return k, np.concatenate([np.asarray(table, np.uint8), pad]).tobytes()


def encode_gif(frames, palette=None, version: bytes = b"GIF89a",
               background: int = 0, min_code_size: int = 8) -> bytes:
    """A GIF of ``frames``: ``uint8 [h, w]`` index arrays, or dicts with
    ``indices`` and optional ``pos`` (x, y), ``palette`` (a local table,
    RGB rows), ``interlace``, ``transparent`` (an index), ``disposal``,
    ``min_code_size``.  ``palette`` is the global table (RGB rows; None:
    none); the screen is frame 0's size unless a frame reaches further."""
    frames = [f if isinstance(f, dict) else {"indices": f} for f in frames]
    W = max(f.get("pos", (0, 0))[0] + f["indices"].shape[1] for f in frames)
    H = max(f.get("pos", (0, 0))[1] + f["indices"].shape[0] for f in frames)
    out = bytearray(version + struct.pack("<HH", W, H))
    if palette is not None:
        k, table = _table_bytes(palette)
        out += bytes([0x80 | 0x70 | k, background, 0]) + table
    else:
        out += bytes([0x70, background, 0])
    if len(frames) > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        h, w = idx.shape
        if "transparent" in f or "disposal" in f:
            t = f.get("transparent")
            out += b"\x21\xf9\x04" + bytes([
                (f.get("disposal", 0) << 2) | (t is not None), 10, 0,
                t or 0, 0])
        x, y = f.get("pos", (0, 0))
        flags = 0x40 if f.get("interlace") else 0
        local = b""
        if f.get("palette") is not None:
            k, local = _table_bytes(f["palette"])
            flags |= 0x80 | k
        out += b"\x2c" + struct.pack("<HHHHB", x, y, w, h, flags) + local
        if f.get("interlace"):
            idx = idx[np.concatenate([np.arange(s, h, d)
                                      for s, d in INTERLACE])]
        mcs = f.get("min_code_size", min_code_size)
        out += bytes([mcs]) + _blocks(_lzw(idx.ravel(), mcs))
    return bytes(out) + b"\x3b"
