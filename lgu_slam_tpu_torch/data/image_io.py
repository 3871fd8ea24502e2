"""Image files for the port's data layer: PNG and JPEG decoders and
encoders of its own, in place of the ``cv2.imread`` / ``cv2.imwrite`` calls
of the JAX package's data layer (the port runs where OpenCV is not
installed).

:func:`imread` returns what ``cv2.imread`` returns for the PNGs and JPEGs
the data layer reads:

- ``imread(path)``: ``uint8 [H, W, 3]`` in BGR order; a gray PNG comes back
  as three equal channels, alpha is dropped, and 16-bit samples keep their
  high byte (libpng's ``png_set_strip_16``, which OpenCV's decoder calls);
- ``imread(path, anydepth=True)`` (``cv2.IMREAD_ANYDEPTH``): a gray PNG as
  one channel, ``uint16`` for 16-bit files, ``uint8`` for 8-bit ones.

PNG decoding covers bit depth 8 and 16 of gray, gray + alpha, RGB and RGBA
with all five row filters.  Interlaced, palette and sub-byte images raise
``ValueError``.  The row unfilter, sequential along a row for the Average
and Paeth filters, runs in C (``csrc/host/png_unfilter.c``, built by the
host compiler at first use); :func:`unfilter_plain` is its numpy version,
for the tests.

JPEG decoding (:func:`decode_jpeg`) runs in C (``csrc/host/jpeg_decode.c``,
built the same way): baseline and progressive Huffman JPEG of 8-bit gray or
3-component files, every sampling factor OpenCV writes, restart intervals
and the EXIF orientation, bit for bit as ``cv2.imread`` (libjpeg-turbo)
decodes them.  Arithmetic coding, 12-bit, lossless, CMYK and progressive
files that leave coefficients incomplete raise ``NotImplementedError``; a
truncated or corrupt stream raises ``ValueError``.  :func:`encode_jpeg` is
a baseline encoder in numpy for writing fixtures.  Every other format
raises ``NotImplementedError``.
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
    cv2.IMREAD_ANYDEPTH)``, for PNG and JPEG files (module docstring).  A
    missing file raises ``FileNotFoundError`` (OpenCV returns None)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(JPEG_SOI):
        if anydepth:
            raise ValueError(f"{path}: anydepth reads gray PNGs only")
        return decode_jpeg(data, path)
    if not data.startswith(SIGNATURE):
        raise NotImplementedError(f"{path}: only PNG and JPEG files are "
                                  "read")
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


# -- JPEG --------------------------------------------------------------------

JPEG_STATUS = {1: ValueError, 2: NotImplementedError, 3: MemoryError}
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


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """JPEG bytes -> ``uint8 [H, W, 3]`` BGR with the EXIF orientation
    applied: what ``cv2.imdecode`` / ``cv2.imread`` return (module
    docstring); decoded in C (``csrc/host/jpeg_decode.c``)."""
    lib = _build.load("jpeg_decode")
    c_char, i64, ptr, cint = (ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int)
    lib.jpeg_info.argtypes = [c_char, i64, ptr, c_char, cint]
    lib.jpeg_decode.argtypes = [c_char, i64, ptr, i64, i64, c_char, cint]
    lib.jpeg_info.restype = lib.jpeg_decode.restype = cint
    info = np.zeros(3, np.int32)
    _jpeg_call(lib.jpeg_info, path, data, len(data), info.ctypes.data)
    H, W, orientation = (int(v) for v in info)
    out = np.empty((H, W, 3), np.uint8)
    _jpeg_call(lib.jpeg_decode, path, data, len(data), out.ctypes.data, H, W)
    if orientation in _ORIENT:
        out = np.ascontiguousarray(_ORIENT[orientation](out))
    return out


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
