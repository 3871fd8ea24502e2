"""Sun raster files as ``cv2.imread`` reads them (OpenCV 5.0's
``grfmt_sunras.cpp``), for the port's data layer, and an encoder for
fixtures.

What OpenCV's reader takes, measured against it:

- the eight big-endian header words; a positive width and height, depth
  1, 8, 24 or 32, type 0 (old) or 1 (standard): the reader's header check
  compares the decoder's pixel type where it means the file's type, so
  byte-encoded (type 2) and RGB-order (type 3) files are not read; no
  colour map (its length 0), or an ``RMT_EQUAL_RGB`` map of at most
  3 * 2^depth bytes, only at depths 1 and 8 (its entries the map's thirds,
  unlisted ones black);
- rows padded to 16 bits; 24-bit pixels B, G, R; 32-bit pixels a pad byte
  then B, G, R; 1-bit pixels most significant bit first; a file shorter
  than its rows is not read (longer is);
- colour: a map's colours, else gray (0 / 255 at depth 1); gray
  (``anydepth``): 24/32-bit pixels and a map's entries through OpenCV's
  ``(4899 R + 9617 G + 1868 B + 8192) >> 14``; a depth-1 or depth-8 file
  without a map reads as zeros (the reader looks its pixels up in a gray
  table it fills only from a map).
"""

from __future__ import annotations

import struct

import numpy as np

from lgu_slam_tpu_torch.data.pnm import gray14

MAGIC = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB = 0, 1, 2, 3
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def decode_sunras(data: bytes, path="<bytes>", gray: bool = False
                  ) -> np.ndarray:
    """Sun raster bytes -> what ``cv2.imread`` returns for a file of them
    (module docstring); ``ValueError`` where it returns None."""
    if len(data) < 32 or not data.startswith(MAGIC):
        raise ValueError(f"{path}: not a Sun raster file")
    W, H, depth, _, kind, maptype, maplen = struct.unpack(">7i", data[4:32])
    pal_size = 3 << depth if 0 < depth <= 8 else 0
    if not (W > 0 and H > 0 and depth in (1, 8, 24, 32)
            and kind in (RT_OLD, RT_STANDARD)
            and ((maptype == RMT_NONE and maplen == 0)
                 or (maptype == RMT_EQUAL_RGB and 0 < maplen <= pal_size
                     and depth <= 8))):
        raise ValueError(f"{path}: a Sun raster header OpenCV refuses")
    if W > 1 << 20 or H > 1 << 20 or W * H > 1 << 30:
        raise ValueError(f"{path}: larger than cv2.imread reads")
    pitch, pos = _pitch(W, depth), 32 + maplen
    if len(data) < pos + H * pitch:
        raise ValueError(f"{path}: the Sun raster data ends early")
    rows = np.frombuffer(data, np.uint8, H * pitch, pos).reshape(H, pitch)
    if depth > 8:
        c = depth // 8
        bgr = rows[:, :W * c].reshape(H, W, c)[..., c - 3:]
        return gray14(bgr[..., ::-1]) if gray else bgr.copy()
    idx = np.unpackbits(rows, axis=1)[:, :W] if depth == 1 else rows[:, :W]
    palette = np.zeros((256, 3), np.uint8)  # RGB
    if maplen:
        n = maplen // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette[:n] = cmap.T
        if gray:
            return gray14(palette)[idx]
    elif gray:
        return np.zeros((H, W), np.uint8)
    else:
        palette[:] = (np.arange(256) * (255 if depth == 1 else 1)
                      ).clip(0, 255)[:, None]
    return np.ascontiguousarray(palette[idx][..., ::-1])


def _pitch(width: int, depth: int) -> int:
    """Bytes of a row: its bits rounded up to a 16-bit word."""
    return ((width * depth + 7) // 8 + 1) & ~1


def _rle(data: bytes) -> bytes:
    """Sun's byte encoding: a run of n > 2 (or any 0x80) as 0x80, n - 1,
    value; a single 0x80 as 0x80, 0."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 256 and data[j] == data[i]:
            j += 1
        run = j - i
        if run > 2 or data[i] == 0x80:
            if data[i] == 0x80 and run == 1:
                out += b"\x80\x00"
            else:
                out += bytes([0x80, run - 1, data[i]])
            i = j
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def encode_sunras(img: np.ndarray, depth=None, kind: int = RT_STANDARD,
                  colormap=None, maptype=None) -> bytes:
    """A Sun raster file: ``img`` is ``uint8 [H, W]`` (indices or gray;
    depth 1 packs 0/1 indices MSB first, depth 8 one byte each) or ``[H,
    W, 3]`` BGR (depth 24, or 32 with a pad byte first in each pixel);
    ``kind`` 0 (old), 1 (standard), 2 (byte-encoded RLE) or 3 (RGB order);
    ``colormap`` RGB rows for depths 1 and 8 (``RMT_EQUAL_RGB``)."""
    H, W = img.shape[:2]
    if depth is None:
        depth = 24 if img.ndim == 3 else 8
    pitch = _pitch(W, depth)
    rows = np.zeros((H, pitch), np.uint8)
    if depth == 1:
        rows[:, :(W + 7) // 8] = np.packbits(img.astype(bool), axis=1)
    elif depth == 8:
        rows[:, :W] = img
    else:
        px = img if kind != RT_FORMAT_RGB else img[..., ::-1]
        if depth == 32:
            px = np.concatenate([np.zeros((H, W, 1), np.uint8), px], -1)
        rows[:, :W * depth // 8] = px.reshape(H, -1)
    body = rows.tobytes()
    if kind == RT_BYTE_ENCODED:
        body = _rle(body)
    cmap = b""
    if colormap is not None:
        cm = np.asarray(colormap, np.uint8)
        cmap = cm[:, 0].tobytes() + cm[:, 1].tobytes() + cm[:, 2].tobytes()
    if maptype is None:
        maptype = RMT_EQUAL_RGB if cmap else RMT_NONE
    return MAGIC + struct.pack(">7I", W, H, depth, len(body), kind, maptype,
                               len(cmap)) + cmap + body
