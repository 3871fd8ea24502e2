"""Netpbm files for the port's data layer: PBM, PGM and PPM (P1-P6), PAM
(P7) and PFM (Pf / PF) decoders that return what ``cv2.imread`` (OpenCV
5.0's ``grfmt_pxm.cpp``, ``grfmt_pam.cpp`` and ``grfmt_pfm.cpp``) returns,
and encoders of the files they read, for fixtures.

The rules, as measured against ``cv2.imread``:

- P1-P6: numbers in the header are separated by whitespace and ``#``
  comments, and the data starts one byte after the last number.  ASCII
  8-bit samples are clamped to ``maxval`` and scaled by ``v * 255 //
  maxval``; binary 8-bit samples are kept as stored, whatever ``maxval``
  is; 16-bit samples (``maxval`` above 255, big-endian when binary) are
  kept as stored by ``IMREAD_ANYDEPTH`` and shifted right by 8 otherwise.
  PBM's 1 is black.  Colour to gray: ``(4899 R + 9617 G + 1868 B + 8192)
  >> 14`` at 8 and 16 bits.  A data stream that ends early (an ASCII one
  must end in a byte after its last number) is refused;
- P7: ``WIDTH``, ``HEIGHT``, ``DEPTH`` (1-4), ``MAXVAL`` and ``ENDHDR``,
  each once, an optional ``TUPLTYPE`` of ``BLACKANDWHITE``, ``GRAYSCALE``,
  ``GRAYSCALE_ALPHA``, ``RGB`` or ``RGB_ALPHA`` (case counts; without one,
  only 1 or 3 channels of at most 8 bits are read).  Samples are kept as
  stored (16-bit ones shifted right by 8 for an 8-bit result); three
  channels stay in the file's order (OpenCV copies them, it does not swap
  R and B); ``MAXVAL 1`` reads each row's bytes as packed bits, 1 white.
  With an alpha channel OpenCV's result holds memory it never wrote, so
  those files raise ``NotImplementedError``;
- PFM: ``Pf`` (gray) or ``PF`` (RGB) and a line feed, then width, height
  and scale, each ended by one whitespace byte; rows bottom-up, little-
  endian where the scale is negative; every sample multiplied by
  ``float32(1 / |scale|)`` (and a sign of zero lost) unless that is 1.  Gray is read only with ``IMREAD_ANYDEPTH``
  (``float32 [H, W]``) and colour only without it (BGR rounded half to
  even and saturated to ``uint8``; NaN and values past the int range give
  0): cv2 returns None for the other two, and the decoder raises
  ``ValueError``, as it does for every file cv2 returns None for.
"""

from __future__ import annotations

import re

import numpy as np

MAX_PIXELS = 1 << 30
MAX_SIDE = 1 << 20
SPACE = b" \t\n\v\f\r"
PAM_TUPLTYPES = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB",
                 "RGB_ALPHA")
PAM_FIELDS = ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE", "ENDHDR")


def _check_size(W: int, H: int, path) -> None:
    if W <= 0 or H <= 0 or W > MAX_SIDE or H > MAX_SIDE or \
            W * H > MAX_PIXELS:
        raise ValueError(f"{path}: an image of {W} x {H} pixels is not "
                         "read by cv2.imread")


def gray14(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's imgcodecs gray of R, G, B samples (last axis; the
    ``icvCvt_BGR*2Gray`` functions of its BMP, TIFF, PNM and PAM readers):
    ``(4899 R + 9617 G + 1868 B + 8192) >> 14``, in the samples' dtype."""
    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(rgb.dtype)


def cvt_gray(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)`` of ``uint8`` or ``uint16``
    B, G, R(, A) samples (last axis), the gray the WebP, GIF and JPEG 2000
    readers return: ``(3735 B + 19235 G + 9798 R + 16384) >> 15``, in the
    samples' dtype."""
    b, g, r = (bgr[..., c].astype(np.int64) for c in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + 16384) >> 15).astype(
        bgr.dtype)


class _Stream:
    """OpenCV's byte stream: reading past the end is an error."""

    def __init__(self, data: bytes, path, pos: int = 0):
        self.data, self.path, self.pos = data, path, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError(f"{self.path}: the file ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.path}: the image data ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def number(self, maxdigits: int = 0) -> int:
        """grfmt_pxm.cpp ReadNumber: skip whitespace and comments, read
        digits; the byte after them is consumed."""
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:  # '#': to the end of the line
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in SPACE:
                while c in SPACE:
                    c = self.byte()
            else:
                raise ValueError(f"{self.path}: unexpected byte {c:#x} in "
                                 "a PNM file")
        val, digits = 0, 0
        while True:
            val = val * 10 + c - 48
            if val > 0x7FFFFFFF:
                raise ValueError(f"{self.path}: a number too large")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val


def decode_pnm(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """P1-P6 bytes -> ``cv2.imread``'s ``uint8 [H, W, 3]`` BGR, or with
    ``gray`` ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``'s ``[H, W]``
    (``uint16`` where ``maxval`` exceeds 255)."""
    if len(data) < 3 or data[0] != 80 or not 49 <= data[1] <= 54 or \
            data[2] not in SPACE:
        raise ValueError(f"{path}: not a PNM file")
    kind = data[1] - 48
    s = _Stream(data, path, 2)
    W, H = s.number(), s.number()
    maxval = 1 if kind in (1, 4) else s.number()
    if maxval > 65535 or maxval == 0:
        raise ValueError(f"{path}: PNM maxval {maxval}")
    _check_size(W, H, path)
    ch = 3 if kind in (3, 6) else 1
    wide = maxval > 255
    if kind in (1, 4):
        if kind == 1:
            bits = np.array([s.number(1) != 0 for _ in range(W * H)],
                            np.uint8).reshape(H, W)
        else:
            rows = np.frombuffer(s.take(H * ((W + 7) // 8)), np.uint8)
            bits = np.unpackbits(rows.reshape(H, -1), axis=1)[:, :W]
        px = ((1 - bits) * 255).astype(np.uint8)[..., None]
    elif kind in (2, 3):
        vals = np.minimum([s.number() for _ in range(W * H * ch)], maxval)
        px = np.asarray(vals, np.int64).reshape(H, W, ch)
        px = px.astype(np.uint16) if wide else \
            (px * 255 // maxval).astype(np.uint8)
    else:
        raw = s.take(W * H * ch * (2 if wide else 1))
        px = np.frombuffer(raw, ">u2" if wide else np.uint8
                           ).astype(np.uint16 if wide else np.uint8
                                    ).reshape(H, W, ch)
    if not gray and wide:
        px = (px >> 8).astype(np.uint8)
    if ch == 1:
        return px[..., 0] if gray else np.repeat(px, 3, axis=-1)
    return gray14(px) if gray else np.ascontiguousarray(px[..., ::-1])


def _pam_header(data: bytes, path) -> tuple:
    """(fields, offset of the data) of a P7 header (grfmt_pam.cpp
    ReadPAMHeaderLine): a field name, whitespace, its value to the end of
    the line, trailing whitespace removed."""
    if len(data) < 3 or data[:2] != b"P7" or data[2] not in (10, 13):
        raise ValueError(f"{path}: not a PAM file")
    s = _Stream(data, path, 3)
    fields = {}
    while True:
        c = s.byte()
        while c in SPACE:
            c = s.byte()
        if c == 35:  # a comment
            while c not in (10, 13):
                c = s.byte()
            continue
        ident = bytearray()
        while c not in SPACE and len(ident) < 8:
            ident.append(c)
            c = s.byte()
        name = ident.decode("latin-1")
        if c not in SPACE or name not in PAM_FIELDS or name in fields:
            raise ValueError(f"{path}: PAM header field {name!r}")
        if name == "ENDHDR":
            if c in (10, 13):
                return fields, s.pos
            fields[name] = None
            raise ValueError(f"{path}: PAM ENDHDR with a value")
        value = bytearray()
        if c not in (10, 13):
            c = s.byte()
            while c in SPACE:
                c = s.byte()
            while c not in (10, 13) and len(value) < 255:
                value.append(c)
                c = s.byte()
            if c not in (10, 13):
                raise ValueError(f"{path}: PAM header line too long")
        fields[name] = value.decode("latin-1").rstrip(" \t\n\v\f\r")


def decode_pam(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """P7 bytes -> ``cv2.imread``'s ``uint8 [H, W, 3]``, or with ``gray``
    ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``'s ``[H, W]`` (module
    docstring)."""
    fields, offset = _pam_header(data, path)
    need = ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL")
    if any(k not in fields for k in need):
        raise ValueError(f"{path}: PAM header without "
                         f"{[k for k in need if k not in fields]}")
    nums = {}
    for k in need:
        if not re.fullmatch(r"-?\d+", fields[k]):
            raise ValueError(f"{path}: PAM {k} {fields[k]!r}")
        nums[k] = int(fields[k])
    W, H, D, maxval = (nums[k] for k in need)
    if maxval > 65535:
        raise ValueError(f"{path}: PAM MAXVAL {maxval}")
    tupltype = fields.get("TUPLTYPE")
    if tupltype is not None and tupltype not in PAM_TUPLTYPES:
        raise ValueError(f"{path}: PAM TUPLTYPE {tupltype!r}")
    if tupltype is None and not (D == 1 or (D == 3 and maxval < 256)):
        raise ValueError(f"{path}: PAM of depth {D}, maxval {maxval} "
                         "without a TUPLTYPE")
    if not 1 <= D <= 4:
        raise ValueError(f"{path}: PAM DEPTH {D}")
    if tupltype is None and maxval > 255:
        raise ValueError(f"{path}: 16-bit PAM without a TUPLTYPE")
    _check_size(W, H, path)
    fmt = tupltype or ("GRAYSCALE" if D == 1 else "RGB")
    channels = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "RGB": 3}.get(fmt)
    if maxval != 1 and channels != D:
        raise NotImplementedError(
            f"{path}: PAM {tupltype or 'without TUPLTYPE'} of depth {D} "
            "(cv2.imread returns memory it never wrote for it)")
    wide = maxval > 255
    s = _Stream(data, path, offset)
    rowbytes = W * D * (2 if wide else 1)
    raw = np.frombuffer(s.take(H * rowbytes), np.uint8).reshape(H, rowbytes)
    if maxval == 1:  # each row's bytes as packed bits, 1 white
        bits = np.unpackbits(raw, axis=1)[:, :W]
        px = (bits * 255).astype(np.uint8)
        return px if gray else np.repeat(px[..., None], 3, axis=-1)
    px = raw.view(">u2").astype(np.uint16) if wide else raw
    px = px.reshape(H, W, D)
    if not gray and wide:
        px = (px >> 8).astype(np.uint8)
    if D == 1:
        return px[..., 0] if gray else np.repeat(px, 3, axis=-1)
    return gray14(px) if gray else px


def _atoi(token: bytes) -> int:
    m = re.match(rb"[+-]?\d+", token)
    return int(m.group()) if m else 0


def _atof(token: bytes) -> float:
    m = re.match(rb"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", token)
    return float(m.group()) if m else 0.0


def decode_pfm(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """PFM bytes -> ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``'s ``float32
    [H, W]`` of a ``Pf`` file (``gray``), or ``cv2.imread(path)``'s ``uint8
    [H, W, 3]`` of a ``PF`` file (module docstring)."""
    if len(data) < 3 or data[0] != 80 or data[1] not in b"fF" or \
            data[2] not in SPACE:
        raise ValueError(f"{path}: not a PFM file")
    if data[2] != 10:
        raise ValueError(f"{path}: PFM header without its line feed")
    s = _Stream(data, path, 3)
    tokens = []
    for _ in range(3):
        tok = bytearray()
        c = s.byte()
        while c not in SPACE and len(tok) < 2048:
            tok.append(c)
            c = s.byte()
        tokens.append(bytes(tok))
    W, H, scale = _atoi(tokens[0]), _atoi(tokens[1]), _atof(tokens[2])
    _check_size(W, H, path)
    ch = 3 if data[1] == ord("F") else 1
    if (ch == 1) != gray:
        raise ValueError(f"{path}: a {'gray' if ch == 1 else 'colour'} PFM "
                         f"read {'without' if ch == 1 else 'with'} "
                         "IMREAD_ANYDEPTH (cv2.imread returns None)")
    raw = s.take(W * H * ch * 4)
    if scale == 0:
        raise ValueError(f"{path}: PFM scale 0")
    px = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").astype(
        np.float32).reshape(H, W, ch)[::-1]
    alpha = np.float32(1.0 / abs(scale))
    if alpha != 1:  # OpenCV's convertTo: a copy at scale 1, else x * a + 0
        px = px * alpha + np.float32(0)
    if ch == 1:
        return np.ascontiguousarray(px[..., 0])
    px = np.rint(px[..., ::-1].astype(np.float64))
    out = np.where(np.isnan(px) | (px >= 2 ** 31), 0, np.clip(px, 0, 255))
    return out.astype(np.uint8)


# -- encoders ----------------------------------------------------------------

def encode_pnm(img, maxval=None, binary: bool = True, bilevel: bool = False,
               comment=None) -> bytes:
    """``[H, W]`` gray or ``[H, W, 3]`` BGR ``uint8`` / ``uint16`` -> PGM or
    PPM bytes (P5 / P6, or P2 / P3 without ``binary``) with ``maxval``
    (default 255 or 65535; samples above it are written as they are), and
    a ``comment`` line; ``bilevel``: PBM (P4 / P1) of ``img`` != 0, 1
    black."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    note = b"" if comment is None else b"# " + comment.encode() + b"\n"
    if bilevel:
        bits = (img != 0).astype(np.uint8)
        if binary:
            body = np.packbits(bits, axis=1).tobytes()
        else:
            body = b"\n".join(b" ".join(b"%d" % v for v in row)
                              for row in bits) + b"\n"
        return b"P%d\n%s%d %d\n" % (4 if binary else 1, note, W, H) + body
    ch = 3 if img.ndim == 3 else 1
    if maxval is None:
        maxval = 65535 if img.dtype == np.uint16 else 255
    px = img[..., ::-1] if ch == 3 else img  # BGR -> RGB
    kind = (6 if ch == 3 else 5) if binary else (3 if ch == 3 else 2)
    head = b"P%d\n%s%d %d\n%d\n" % (kind, note, W, H, maxval)
    if binary:
        return head + np.ascontiguousarray(px).astype(
            ">u2" if maxval > 255 else np.uint8).tobytes()
    rows = px.reshape(H, -1)
    return head + b"\n".join(b" ".join(b"%d" % v for v in row)
                             for row in rows) + b"\n"


def encode_pam(img, tupltype=None, maxval=None) -> bytes:
    """``[H, W]`` or ``[H, W, C]`` ``uint8`` / ``uint16`` -> P7 bytes,
    samples in the given order (as ``cv2.imwrite`` writes them), with an
    optional ``TUPLTYPE``."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, D = img.shape
    if maxval is None:
        maxval = 65535 if img.dtype == np.uint16 else 255
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (W, H, D,
                                                                maxval)
    if tupltype is not None:
        head += b"TUPLTYPE " + tupltype.encode() + b"\n"
    return head + b"ENDHDR\n" + img.astype(
        ">u2" if maxval > 255 else np.uint8).tobytes()


def encode_pfm(img, scale: float = -1.0) -> bytes:
    """``float32 [H, W]`` (``Pf``) or ``[H, W, 3]`` BGR (``PF``, stored
    RGB) -> PFM bytes, rows bottom-up, little-endian for a negative
    ``scale``."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    px = img[::-1, :, ::-1] if img.ndim == 3 else img[::-1]
    kind = b"F" if img.ndim == 3 else b"f"
    return b"P" + kind + b"\n%d %d\n%s\n" % (W, H, repr(float(scale)).encode()
                                           ) + px.astype(
        "<f4" if scale < 0 else ">f4").tobytes()
