"""WebP files as ``cv2.imread`` (OpenCV 5.0 over libwebp 1.6) reads them,
for the port's data layer, and a lossless encoder for fixtures.

The container is parsed here, in libwebp's own steps (``webp_dec.c``
``ParseHeadersInternal``; ``demux.c`` for animations); the bitstreams are
decoded in C (``csrc/host/webp_decode.c``: VP8L, VP8, ALPH).  What OpenCV's
reader does around them:

- the first 32 bytes decide (``WebPGetFeatures`` on them alone): a shorter
  file, or a header libwebp refuses, is not read (``ValueError``); a RIFF
  container is not required (a bare VP8 or VP8L bitstream reads too);
- a still image is decoded whole (``WebPDecodeBGRInto`` /
  ``BGRAInto``): the RIFF size, the chunk sizes and the VP8X canvas must
  agree with the data, and any bitstream error, a VP8 partition that ends
  early or a VP8L stream that reads past its end fails the read; an
  ``ALPH`` chunk beside a VP8 frame is decoded (and must decode) although
  the result drops alpha;
- an animation (the VP8X animation flag) goes through ``WebPAnimDecoder``:
  the whole container is validated as the demuxer validates it, and frame
  0 is decoded into its rectangle of a canvas of zeros;
- alpha is dropped (``COLOR_BGRA2BGR``, not composited); a gray read is
  ``COLOR_BGR2GRAY`` of the colour one.

:func:`encode_webp_lossless` writes VP8L files (subtract-green and
predictor transforms, the colour cache, prefix codes built from the
image's histograms) for the tests and for the card machine, which has no
WebP encoder.
"""

from __future__ import annotations

import ctypes
import heapq
import struct

import numpy as np

from lgu_slam_tpu_torch.data import exif, pnm
from lgu_slam_tpu_torch.ops import _build

HEADER = 32  # OpenCV's WEBP_HEADER_SIZE: the bytes its header read sees
MAX_CHUNK = (1 << 32) - 1 - 10  # libwebp's MAX_CHUNK_PAYLOAD
ANIMATION_FLAG = 0x02
STATUS = {1: ValueError, 3: MemoryError}


class _Short(Exception):
    """VP8_STATUS_NOT_ENOUGH_DATA: the data ends inside a header."""


def _le(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "little")


def _vp8_info(data: bytes, pos: int, chunk_size: int):
    """VP8GetInfo: (width, height) of a VP8 key frame at ``pos``."""
    if len(data) - pos < 10:
        raise _Short
    if data[pos + 3:pos + 6] != b"\x9d\x01\x2a":
        raise ValueError("bad VP8 start code")
    bits = _le(data, pos, 3)
    w, h = _le(data, pos + 6, 2) & 0x3FFF, _le(data, pos + 8, 2) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or \
            (bits >> 5) >= chunk_size or w == 0 or h == 0:
        raise ValueError("VP8 frame header refused")
    return w, h


def _vp8l_info(data: bytes, pos: int):
    """VP8LGetInfo: (width, height) of a VP8L header."""
    if len(data) - pos < 5:
        raise _Short
    if data[pos] != 0x2F or data[pos + 4] >> 5:
        raise ValueError("bad VP8L signature")
    v = _le(data, pos + 1, 4)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1


def parse_headers(data: bytes, have_all: bool, headers: bool) -> dict:
    """``ParseHeadersInternal`` of libwebp: the features of ``data`` (its
    first bytes, or all of it with ``have_all``), and with ``headers`` the
    position of the bitstream and of an ``ALPH`` payload.  Raises
    ``ValueError`` where libwebp returns an error status."""
    n = len(data)
    if n < 12:
        raise ValueError("WebP: fewer than 12 bytes")
    out = dict(alpha=None, animation=False)
    pos, riff_size = 0, 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise ValueError("WebP: RIFF without WEBP")
        riff_size = _le(data, 4, 4)
        if riff_size < 12 or riff_size > MAX_CHUNK:
            raise ValueError("WebP: RIFF size")
        if have_all and riff_size > n - 8:
            raise ValueError("WebP: the file is shorter than its RIFF size")
        pos = 12
    found_vp8x = False
    canvas = None
    try:
        if n - pos < 8:
            raise _Short
        if data[pos:pos + 4] == b"VP8X":
            if _le(data, pos + 4, 4) != 10:
                raise ValueError("WebP: VP8X chunk size")
            if n - pos < 18:
                raise _Short
            flags = _le(data, pos + 8, 4)
            w, h = _le(data, pos + 12, 3) + 1, _le(data, pos + 15, 3) + 1
            if w * h >= 1 << 32:
                raise ValueError("WebP: canvas too large")
            pos += 18
            found_vp8x, canvas = True, (w, h)
            out["animation"] = bool(flags & ANIMATION_FLAG)
            out["width"], out["height"] = w, h
        if not riff_size and found_vp8x:
            raise ValueError("WebP: VP8X outside a RIFF container")
        if found_vp8x and out["animation"] and not headers:
            return out
        if n - pos < 4:
            raise _Short
        if (riff_size and found_vp8x) or (not riff_size and not found_vp8x
                                          and data[pos:pos + 4] == b"ALPH"):
            total = 4 + 8 + 10
            while True:  # ParseOptionalChunks
                if n - pos < 8:
                    raise _Short
                size = _le(data, pos + 4, 4)
                if size > MAX_CHUNK:
                    raise ValueError("WebP: chunk size")
                disk = (8 + size + 1) & ~1
                total += disk
                if riff_size > 0 and total > riff_size:
                    raise ValueError("WebP: chunks past the RIFF size")
                if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if n - pos < disk:
                    raise _Short
                if data[pos:pos + 4] == b"ALPH":
                    out["alpha"] = (pos + 8, size)
                pos += disk
        if n - pos < 8:
            raise _Short
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            size = _le(data, pos + 4, 4)
            if riff_size >= 12 and size > riff_size - 12:
                raise ValueError("WebP: VP8 chunk size")
            if have_all and size > n - pos - 8:
                raise ValueError("WebP: the bitstream is cut short")
            pos += 8
            lossless = tag == b"VP8L"
        else:  # a bare bitstream
            size = n - pos
            lossless = n - pos >= 5 and data[pos] == 0x2F and \
                not data[pos + 4] >> 5
        if size > MAX_CHUNK:
            raise ValueError("WebP: chunk size")
        if lossless:
            w, h = _vp8l_info(data, pos)
        else:
            w, h = _vp8_info(data, pos, size)
        if found_vp8x and canvas != (w, h):
            raise ValueError("WebP: the VP8X canvas is not the image's size")
        out.update(width=w, height=h, lossless=lossless, offset=pos)
    except _Short:
        if not (found_vp8x and not headers):
            raise ValueError("WebP: the data ends inside a header") from None
    return out


def _lib():
    lib = _build.load("webp_decode")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for name in ("webp_vp8l_decode", "webp_vp8_decode", "webp_alpha_decode"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


def _call(fn, what: str, data: bytes, W: int, H: int, out: np.ndarray):
    status = fn(data, len(data), W, H, out.ctypes.data)
    if status:
        raise STATUS.get(status, RuntimeError)(f"WebP: {what} does not "
                                               "decode")


def vp8l_argb(data: bytes, W: int, H: int) -> np.ndarray:
    """A VP8L bitstream (from its signature byte) -> ``uint32 [H, W]``
    ARGB."""
    out = np.empty((H, W), np.uint32)
    _call(_lib().webp_vp8l_decode, "the VP8L bitstream", data, W, H, out)
    return out


def vp8_bgr(data: bytes, W: int, H: int) -> np.ndarray:
    """A VP8 key frame (from its frame tag to the end of the data) ->
    ``uint8 [H, W, 3]`` BGR."""
    out = np.empty((H, W, 3), np.uint8)
    _call(_lib().webp_vp8_decode, "the VP8 frame", data, W, H, out)
    return out


def alpha_plane(data: bytes, W: int, H: int) -> np.ndarray:
    """An ``ALPH`` chunk's payload -> ``uint8 [H, W]`` alpha."""
    out = np.empty((H, W), np.uint8)
    _call(_lib().webp_alpha_decode, "the ALPH chunk", data, W, H, out)
    return out


def _decode_still(data: bytes) -> tuple:
    """``DecodeInto`` of libwebp on the whole of ``data``: (BGR, alpha or
    None)."""
    f = parse_headers(data, True, True)
    if f["animation"]:
        raise ValueError("WebP: an animation is not a still image")
    W, H, pos = f["width"], f["height"], f["offset"]
    if f["lossless"]:
        argb = vp8l_argb(data[pos:], W, H)
        bgra = argb.view(np.uint8).reshape(H, W, 4)
        return np.ascontiguousarray(bgra[..., :3]), bgra[..., 3].copy()
    bgr = vp8_bgr(data[pos:], W, H)
    alpha = None
    if f["alpha"] is not None:
        start, size = f["alpha"]
        alpha = alpha_plane(data[start:start + size], W, H)
    return bgr, alpha


def _chunks(data: bytes, pos: int, end: int):
    """(tag, payload start, payload size) of the chunks in [pos, end)."""
    while pos < end:
        if end - pos < 8:
            raise ValueError("WebP: a chunk header is cut short")
        size = _le(data, pos + 4, 4)
        if size > MAX_CHUNK or pos + 8 + size + (size & 1) > end:
            raise ValueError("WebP: a chunk runs past its container")
        yield data[pos:pos + 4], pos + 8, size
        pos += 8 + size + (size & 1)


def _decode_animation(data: bytes) -> np.ndarray:
    """``WebPAnimDecoder``'s first frame: the container validated as
    ``WebPDemux`` validates it, frame 0 decoded into its rectangle of a
    canvas of zeros (a key frame: nothing is blended).  BGR."""
    if len(data) < 30 or data[:4] != b"RIFF" or data[12:16] != b"VP8X":
        raise ValueError("WebP: an animation without a VP8X container")
    riff_end = _le(data, 4, 4) + 8
    if riff_end > len(data):
        raise ValueError("WebP: the file is shorter than its RIFF size")
    flags = _le(data, 20, 4)
    W, H = _le(data, 24, 3) + 1, _le(data, 27, 3) + 1
    if flags & ~0x3E or W * H >= 1 << 32:
        raise ValueError("WebP: VP8X flags or canvas")
    frames, anim = [], False
    for tag, start, size in _chunks(data, 30, riff_end):
        if tag == b"VP8X":
            raise ValueError("WebP: a second VP8X chunk")
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            raise ValueError("WebP: an image outside a frame of an "
                             "animation")
        if tag == b"ANIM":
            if size + (size & 1) < 6:
                raise ValueError("WebP: ANIM chunk size")
            anim = True
        elif tag == b"ANMF":
            if not anim:
                raise ValueError("WebP: a frame before the ANIM chunk")
            if size < 16:
                raise ValueError("WebP: ANMF chunk size")
            x0, y0 = 2 * _le(data, start, 3), 2 * _le(data, start + 3, 3)
            payload, image, alph = start + 16, None, None
            for sub, s_start, s_size in _chunks(data, payload,
                                                start + size):
                if sub == b"ALPH" and image is None and alph is None:
                    alph = s_start - 8
                elif sub in (b"VP8 ", b"VP8L"):
                    if image is not None:
                        raise ValueError("WebP: two images in a frame")
                    image = (alph if alph is not None else s_start - 8,
                             s_start + s_size)
            if image is None:
                raise ValueError("WebP: a frame without an image")
            f = parse_headers(data[image[0]:image[1]], True, True)
            if x0 + f["width"] > W or y0 + f["height"] > H:
                raise ValueError("WebP: a frame outside the canvas")
            frames.append((x0, y0, image))
    if not frames:
        raise ValueError("WebP: an animation without frames")
    x0, y0, (a, b) = frames[0]
    bgr, _ = _decode_still(data[a:b])
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[y0:y0 + bgr.shape[0], x0:x0 + bgr.shape[1]] = bgr
    return canvas


def is_webp(data: bytes) -> bool:
    """OpenCV's WebP signature check: libwebp takes the first 32 bytes as
    the start of a WebP file (RIFF or a bare VP8 / VP8L bitstream)."""
    try:
        return len(data) >= HEADER and bool(parse_headers(data[:HEADER],
                                                          False, False))
    except ValueError:
        return False


def decode_webp(data: bytes, path="<bytes>", gray: bool = False
                ) -> np.ndarray:
    """WebP bytes -> what ``cv2.imread`` returns for a file of them
    (module docstring): ``uint8 [H, W, 3]`` BGR, or with ``gray`` ``[H,
    W]`` (``COLOR_BGR2GRAY``).  Files OpenCV does not read raise
    ``ValueError``."""
    try:
        if len(data) < HEADER:
            raise ValueError("WebP: fewer than 32 bytes")
        first = parse_headers(data[:HEADER], False, False)
        W, H = first["width"], first["height"]
        if W > 1 << 20 or H > 1 << 20 or W * H > 1 << 30:
            raise ValueError("WebP: larger than cv2.imread reads")
        if first["animation"]:
            bgr = _decode_animation(data)
        else:
            bgr = exif.orient(_decode_still(data)[0],
                              exif.orientation(exif_chunk(data) or b""))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return pnm.cvt_gray(bgr) if gray else bgr


def exif_chunk(data: bytes):
    """The payload of the first ``EXIF`` chunk of an extended (VP8X) file
    whose EXIF flag is set, as OpenCV's reader gets it from ``WebPDemux``;
    None where there is none or where the demuxer refuses the chunk list (a
    chunk that runs past the RIFF size).  cv2.imread applies its
    orientation to a still image only."""
    if len(data) < 30 or data[:4] != b"RIFF" or data[12:16] != b"VP8X" \
            or not _le(data, 20, 4) & 0x08:
        return None
    try:
        chunks = list(_chunks(data, 30, min(_le(data, 4, 4) + 8,
                                            len(data))))
    except ValueError:
        return None
    for tag, start, size in chunks:
        if tag == b"EXIF":
            return data[start:start + size]
    return None


def decode_webp_bgra(data: bytes) -> np.ndarray:
    """A still WebP -> ``uint8 [H, W, 4]`` BGRA (alpha 255 where the file
    holds none), as libwebp's ``WebPDecodeBGRA`` returns it."""
    bgr, alpha = _decode_still(data)
    if alpha is None:
        alpha = np.full(bgr.shape[:2], 255, np.uint8)
    return np.concatenate([bgr, alpha[..., None]], -1)


# -- the lossless encoder --------------------------------------------------

class _Bits:
    """LSB-first bit writer of (value, width) pairs, packed with numpy."""

    def __init__(self):
        self.vals, self.lens = [], []

    def put(self, value: int, n: int):
        self.put_many(np.array([value]), np.array([n]))

    def put_many(self, values: np.ndarray, lens: np.ndarray):
        keep = lens > 0
        self.vals.append(values[keep].astype(np.uint64))
        self.lens.append(lens[keep].astype(np.int64))

    def bytes(self) -> bytes:
        vals, lens = np.concatenate(self.vals), np.concatenate(self.lens)
        pos = np.cumsum(lens) - lens
        total = int(lens.sum())
        words = np.zeros(total // 64 + 2, np.uint64)
        w, off = pos >> 6, (pos & 63).astype(np.uint64)
        np.bitwise_or.at(words, w, vals << off)
        spill = off.astype(np.int64) + lens > 64
        np.bitwise_or.at(words, w[spill] + 1,
                         vals[spill] >> (np.uint64(64) - off[spill]))
        return words.astype("<u8").view(np.uint8)[:(total + 7) // 8
                                                   ].tobytes()


def _limited_lengths(freq: np.ndarray, limit: int) -> np.ndarray:
    """Huffman code lengths of ``freq`` no longer than ``limit`` (small
    counts raised until the tree is shallow enough); unused symbols get
    0, a lone symbol 1."""
    used = np.nonzero(freq)[0]
    lengths = np.zeros(len(freq), np.int64)
    if len(used) <= 1:
        lengths[used] = 1
        return lengths
    floor = 1
    while True:
        w = np.maximum(freq[used].astype(np.int64), floor)
        heap = [(int(w[i]), i) for i in range(len(used))]
        heapq.heapify(heap)
        parent = list(range(len(used)))
        while len(heap) > 1:
            (wa, a), (wb, b) = heapq.heappop(heap), heapq.heappop(heap)
            parent.append(len(parent))
            parent[a] = parent[b] = len(parent) - 1
            heapq.heappush(heap, (wa + wb, len(parent) - 1))
        depth = np.zeros(len(parent), np.int64)
        for node in range(len(parent) - 2, -1, -1):
            depth[node] = depth[parent[node]] + 1
        if depth[:len(used)].max() <= limit:
            lengths[used] = depth[:len(used)]
            return lengths
        floor *= 2


def _canonical(lengths: np.ndarray) -> np.ndarray:
    """Each symbol's code, bit-reversed for LSB-first writing."""
    codes = np.zeros(len(lengths), np.uint64)
    code = 0
    for n in range(1, 16):
        for s in np.nonzero(lengths == n)[0]:
            codes[s] = int(f"{code:0{n}b}"[::-1], 2)
            code += 1
        code <<= 1
    return codes


_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _write_code(bw: _Bits, freq: np.ndarray) -> tuple:
    """A prefix code for ``freq`` into the stream; (codes, lengths)."""
    used = np.nonzero(freq)[0]
    if len(used) <= 1 and (len(used) == 0 or used[0] < 256):
        symbol = int(used[0]) if len(used) else 0
        bw.put(1, 1)  # simple code, one symbol
        bw.put(0, 1)
        bw.put(1, 1)  # 8-bit symbol
        bw.put(symbol, 8)
        return (np.zeros(len(freq), np.uint64),
                np.zeros(len(freq), np.int64))
    lengths = _limited_lengths(freq, 15)
    cl_lengths = _limited_lengths(np.bincount(lengths, minlength=19), 7)
    n_cl = max(4, max(i + 1 for i, s in enumerate(_ORDER)
                      if cl_lengths[s] or i < 4))
    bw.put(0, 1)
    bw.put(n_cl - 4, 4)
    for s in _ORDER[:n_cl]:
        bw.put(int(cl_lengths[s]), 3)
    bw.put(0, 1)  # every symbol's length follows
    if np.count_nonzero(cl_lengths) > 1:  # else each length reads 0 bits
        bw.put_many(_canonical(cl_lengths)[lengths], cl_lengths[lengths])
    if len(used) == 1:  # a lone symbol reads with 0 bits
        return np.zeros(len(freq), np.uint64), np.zeros(len(freq), np.int64)
    return _canonical(lengths), lengths


def _predictions(px: np.ndarray, mode: int) -> np.ndarray:
    """VP8L predictor ``mode`` of every pixel from its original neighbours
    (``uint8 [H, W, 4]`` ARGB bytes as B, G, R, A); row 0 and column 0
    take the format's fixed predictors later."""
    p = px.astype(np.int64)
    H, W, _ = p.shape
    pad = np.zeros((H + 1, W + 2, 4), np.int64)
    pad[1:, 1:W + 1] = p
    pad[1:, W + 1] = np.concatenate([p[1:, 0], np.zeros((1, 4), np.int64)])
    L, T = pad[1:, :W], pad[:H, 1:W + 1]
    TL, TR = pad[:H, :W], pad[:H, 2:W + 2]

    def avg(a, b):
        return (a + b) >> 1
    if mode == 0:
        return np.broadcast_to(np.array([0, 0, 0, 255]), p.shape)
    if mode in (1, 2, 3, 4):
        return (L, T, TR, TL)[mode - 1]
    if mode == 5:
        return avg(avg(L, TR), T)
    if mode in (6, 7, 8, 9):
        return avg(*((L, TL), (L, T), (TL, T), (T, TR))[mode - 6])
    if mode == 10:
        return avg(avg(L, TL), avg(T, TR))
    if mode == 11:
        s = (np.abs(L - TL) - np.abs(T - TL)).sum(-1, keepdims=True)
        return np.where(s <= 0, T, L)
    if mode == 12:
        return np.clip(L + T - TL, 0, 255)
    a = avg(L, T)
    return np.clip(a + np.trunc((a - TL) / 2).astype(np.int64), 0, 255)


PREDICTOR_BITS = 3  # the predictor transform's tiles: 8 x 8 pixels


def encode_webp_lossless(img: np.ndarray, cache_bits: int = 6) -> bytes:
    """A lossless WebP (RIFF + VP8L) of ``uint8 [H, W, 3]`` BGR or ``[H,
    W, 4]`` BGRA: the subtract-green transform, then the predictor
    transform (its 14 modes over the 8 x 8 tiles, in turn), then the
    residuals through the colour cache of ``cache_bits`` (0: none) with
    prefix codes of their histograms."""
    H, W = img.shape[:2]
    alpha = img.shape[-1] == 4
    px = np.concatenate([img[..., :3], img[..., 3:] if alpha else
                         np.full((H, W, 1), 255, np.uint8)], -1)
    px = px.astype(np.int64)  # B, G, R, A
    sg = px.copy()
    sg[..., 0] = (px[..., 0] - px[..., 1]) & 0xFF
    sg[..., 2] = (px[..., 2] - px[..., 1]) & 0xFF
    tiles_y, tiles_x = -(-H // (1 << PREDICTOR_BITS)), \
        -(-W // (1 << PREDICTOR_BITS))
    modes = (np.arange(tiles_y)[:, None] + np.arange(tiles_x)) % 14
    mode_px = np.repeat(np.repeat(modes, 1 << PREDICTOR_BITS, 0),
                        1 << PREDICTOR_BITS, 1)[:H, :W]
    pred = np.zeros_like(sg)
    for m in range(14):
        sel = mode_px == m
        if sel.any():
            pred[sel] = _predictions(sg, m)[sel]
    pred[0, 1:] = sg[0, :-1]
    pred[1:, 0] = sg[:-1, 0]
    pred[0, 0] = (0, 0, 0, 255)
    res = ((sg - pred) & 0xFF).reshape(-1, 4)
    argb = (res[:, 3] << 24) | (res[:, 2] << 16) | (res[:, 1] << 8) | \
        res[:, 0]
    bw = _Bits()
    bw.put(0x2F, 8)
    bw.put(W - 1, 14)
    bw.put(H - 1, 14)
    bw.put(int(alpha), 1)
    bw.put(0, 3)
    bw.put(1, 1)
    bw.put(2, 2)  # subtract green
    bw.put(1, 1)
    bw.put(0, 2)  # predictor
    bw.put(PREDICTOR_BITS - 2, 3)
    # its sub-image: one pixel per tile, the mode in green, each code one
    # symbol but green's, which is written per tile
    bw.put(0, 1)  # no colour cache
    gfreq = np.bincount(modes.ravel(), minlength=280)
    gcodes, glens = _write_code(bw, gfreq)
    for _ in range(4):
        _write_code(bw, np.zeros(256 if _ < 3 else 40, np.int64))
    m = modes.ravel()
    bw.put_many(gcodes[m], glens[m])
    bw.put(0, 1)  # no more transforms
    n = len(argb)
    if cache_bits:
        keys = ((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits)
        order = np.lexsort((np.arange(n), keys))
        prev = np.full(n, -1, np.int64)
        same = keys[order][1:] == keys[order][:-1]
        prev[order[1:][same]] = order[:-1][same]
        hit = (prev >= 0) & (argb[np.maximum(prev, 0)] == argb)
        bw.put(1, 1)
        bw.put(cache_bits, 4)
    else:
        hit = np.zeros(n, bool)
        keys = np.zeros(n, np.int64)
        bw.put(0, 1)
    bw.put(0, 1)  # no meta prefix codes
    green = np.where(hit, 280 + keys, res[:, 1])
    lit = ~hit
    alphabet = 280 + ((1 << cache_bits) if cache_bits else 0)
    codes = []
    for sym, size in ((green, alphabet), (res[lit, 2], 256),
                      (res[lit, 0], 256), (res[lit, 3], 256),
                      (np.zeros(0, np.int64), 40)):
        codes.append(_write_code(bw, np.bincount(sym, minlength=size)))
    vals = np.zeros((n, 4), np.uint64)
    lens = np.zeros((n, 4), np.int64)
    vals[:, 0], lens[:, 0] = codes[0][0][green], codes[0][1][green]
    for k, ch in ((1, 2), (2, 0), (3, 3)):
        vals[lit, k] = codes[k][0][res[lit, ch]]
        lens[lit, k] = codes[k][1][res[lit, ch]]
    bw.put_many(vals.ravel(), lens.ravel())
    body = bw.bytes()
    chunk = b"VP8L" + struct.pack("<I", len(body)) + body + \
        b"\0" * (len(body) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
