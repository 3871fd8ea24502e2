"""Radiance HDR (RGBE) files as ``cv2.imread`` reads them (OpenCV 5.0's
``grfmt_hdr.cpp`` over its ``rgbe.cpp``), for the port's data layer, and
an encoder for fixtures.

- The header is read line by line as ``fgets`` into 128 bytes reads it:
  the first line stays in play (OpenCV passes no header info), lines run
  until a blank one after ``FORMAT=32-bit_rle_rgbe`` (exactly, with its
  newline; ``32-bit_rle_xyze`` is not taken: no format, no image), then
  the size line must parse as ``-Y %d +X %d`` (the only orientation; other
  text after it is ignored), with both sizes positive.
- The pixels (``csrc/host/hdr_rgbe.c``): new-style run-length scanlines,
  flat scanlines, and a file whose scanline does not start with the
  run-length marker read flat from there on (old-style run-length pixels
  are not expanded); data that ends early or a bad run is no image.
- ``imread(path)``: ``uint8`` BGR ``saturate(round(255 f))`` computed in
  float32 (no gamma; a value whose 255 f reaches 2^31 reads 0, as
  OpenCV's float-to-int conversion gives INT_MIN for it);
  ``imread(path, anydepth=True)``: ``float32 [H, W]``, ``cvtColor``'s
  gray of the float BGR (its fused multiply-adds, in the order OpenCV's
  x86-64 build takes them: :func:`float_gray`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from lgu_slam_tpu_torch.ops import _build

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
FORMAT = b"FORMAT=32-bit_rle_rgbe\n"


def _lines(data: bytes, pos: int):
    """``fgets(buf, 128, fp)`` from ``pos`` on: (the line as C string
    functions see it, the position after it); None at the end of the
    data."""
    while True:
        if pos >= len(data):
            yield None, pos
            return
        end = data.find(b"\n", pos, pos + 127)
        end = pos + 127 if end < 0 else end + 1
        end = min(end, len(data))
        line = data[pos:end]
        pos = end
        yield line.split(b"\0", 1)[0], pos


def _scan_int(s: bytes, i: int):
    """``%d`` of sscanf at ``s[i:]``: (value, next index) or None."""
    while i < len(s) and s[i:i + 1].isspace():
        i += 1
    j = i
    if j < len(s) and s[j:j + 1] in (b"+", b"-"):
        j += 1
    k = j
    while k < len(s) and 48 <= s[k] <= 57:
        k += 1
    if k == j:
        return None
    return int(s[i:k]), k


def _size(line: bytes):
    """``sscanf(line, "-Y %d +X %d")``: (height, width) or None."""
    values, i = [], 0
    for literal in (b"-Y", b"+X"):
        while i and i < len(line) and line[i:i + 1].isspace():
            i += 1
        if line[i:i + 2] != literal:
            return None
        got = _scan_int(line, i + 2)
        if got is None:
            return None
        value, i = got
        values.append(value)
    return tuple(values)


def header(data: bytes) -> tuple:
    """(height, width, offset of the pixels) of an HDR file, read as
    ``RGBE_ReadHeader`` reads it; raises ``ValueError`` where it fails or
    gives no positive size."""
    lines = _lines(data, 0)
    line, pos = next(lines)
    if line is None:
        raise ValueError("HDR: empty header")
    found = False
    while True:
        if line == b"" or line[:1] == b"\n":
            if found:
                break
            raise ValueError("HDR: no FORMAT=32-bit_rle_rgbe line")
        if line == FORMAT:
            found = True
        line, pos = next(lines)
        if line is None:
            raise ValueError("HDR: the header ends early")
    if line != b"\n":
        raise ValueError("HDR: a NUL byte ends the header")
    line, pos = next(lines)
    if line is None:
        raise ValueError("HDR: no size line")
    size = _size(line)
    if size is None:
        raise ValueError("HDR: the size line is not -Y H +X W")
    H, W = size
    if H <= 0 or W <= 0:
        raise ValueError("HDR: no positive size")
    if W > 1 << 20 or H > 1 << 20 or W * H > 1 << 30:
        raise ValueError("HDR: larger than cv2.imread reads")
    return H, W, pos


def _lib():
    lib = _build.load("hdr_rgbe")
    lib.hdr_read_pixels.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_void_p]
    lib.hdr_read_pixels.restype = ctypes.c_int
    lib.hdr_gray.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_void_p]
    lib.hdr_gray.restype = None
    return lib


def read_float(data: bytes) -> np.ndarray:
    """An HDR file's pixels: ``float32 [H, W, 3]`` BGR."""
    H, W, pos = header(data)
    out = np.empty((H, W, 3), np.float32)
    status = _lib().hdr_read_pixels(data[pos:], len(data) - pos, W, H,
                                    out.ctypes.data)
    if status == 3:
        raise MemoryError("HDR: out of memory")
    if status:
        raise ValueError("HDR: the pixel data ends early or holds a bad run")
    return out


def float_gray(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)`` of ``float32 [H, W, 3]``
    BGR (row by row, as ``csrc/host/hdr_rgbe.c`` describes)."""
    bgr = np.ascontiguousarray(bgr, np.float32)
    out = np.empty(bgr.shape[:-1], np.float32)
    _lib().hdr_gray(bgr.ctypes.data, bgr.shape[0], bgr.shape[1],
                    out.ctypes.data)
    return out


def to_uint8(f: np.ndarray) -> np.ndarray:
    """``convertTo(CV_8U, 255)`` of float32: ``round(255 f)`` in float32,
    half to even, saturated; 2^31 and above (as INT_MIN) give 0."""
    with np.errstate(over="ignore"):
        v = f.astype(np.float32) * np.float32(255)
    r = np.rint(v)
    return np.where(np.abs(v) < 2.0 ** 31, np.clip(r, 0, 255), 0
                    ).astype(np.uint8)


def decode_hdr(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """Radiance HDR bytes -> what ``cv2.imread`` returns for a file of them
    (module docstring); ``ValueError`` where it returns None."""
    try:
        bgr = read_float(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return float_gray(bgr) if gray else to_uint8(bgr)


def float_to_rgbe(bgr: np.ndarray) -> np.ndarray:
    """``float32 [..., 3]`` BGR -> ``uint8 [..., 4]`` RGBE as ``rgbe.cpp``'s
    ``float2rgbe`` makes them (the largest channel's frexp)."""
    rgb = np.asarray(bgr, np.float32)[..., ::-1].astype(np.float64)
    v = rgb.max(-1)
    mant, exp = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, mant * 256.0 / np.where(v > 0, v, 1))
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, exp + 128).astype(np.uint8)
    return out


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """``uint8 [..., 4]`` RGBE -> ``float32 [..., 3]`` BGR as ``rgbe2float``
    computes it (the C reader's arithmetic, in numpy)."""
    e = rgbe[..., 3].astype(np.int64)
    f = np.ldexp(np.ones(e.shape), e - 136).astype(np.float32)
    out = rgbe[..., 2::-1].astype(np.float32) * f[..., None]
    return np.where(e[..., None] > 0, out, np.float32(0)).astype(np.float32)


def depth_values(depth: np.ndarray) -> np.ndarray:
    """What ``imread(path, anydepth=True)`` returns for
    ``encode_hdr`` of a depth map written as gray (each value in R, G and
    B): ``float32``, the values RGBE holds of it."""
    gray3 = np.repeat(np.asarray(depth, np.float32)[..., None], 3, -1)
    return float_gray(rgbe_to_float(float_to_rgbe(gray3)))


def _rle_rows(channel: np.ndarray) -> np.ndarray:
    """``uint8 [H, W]`` channel planes -> each row in new-style run-length
    form of copies only (a count byte of up to 128, then the bytes):
    ``[H, W + ceil(W / 128)]``."""
    H, W = channel.shape
    n = -(-W // 128)
    counts = np.full(n, 128)
    counts[-1] = W - 128 * (n - 1)
    starts = np.arange(n) * 129
    out = np.zeros((H, W + n), np.uint8)
    out[:, starts] = counts
    keep = np.ones(W + n, bool)
    keep[starts] = False
    out[:, keep] = channel
    return out


def encode_hdr(bgr: np.ndarray, rle: str = "new") -> bytes:
    """A Radiance HDR file of ``float32 [H, W, 3]`` BGR: ``rle="new"``
    (new-style run-length scanlines, the form ``cv2.imwrite`` writes, for
    widths 8 to 32767, here of copy packets only; flat otherwise),
    ``"flat"`` or ``"old"`` (old-style runs: a repeated pixel written as
    (1, 1, 1, 1), which OpenCV reads as a pixel)."""
    H, W = bgr.shape[:2]
    rgbe = float_to_rgbe(bgr)
    head = b"#?RADIANCE\n" + FORMAT + b"\n" + b"-Y %d +X %d\n" % (H, W)
    if rle == "flat" or (rle == "new" and not 8 <= W <= 0x7FFF):
        return head + rgbe.tobytes()
    if rle == "old":
        body = bytearray()
        for px in rgbe.reshape(-1, 4):
            if body[-4:] == bytes(px) and len(body) >= 4:
                body += bytes([1, 1, 1, 1])
            else:
                body += bytes(px)
        return head + bytes(body)
    marker = np.broadcast_to(np.array([2, 2, W >> 8, W & 0xFF], np.uint8),
                             (H, 4))
    rows = [marker] + [_rle_rows(rgbe[..., ch]) for ch in range(4)]
    return head + np.concatenate(rows, 1).tobytes()
