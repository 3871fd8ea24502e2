"""The port's WebP reader (lgu_slam_tpu_torch/data/webp.py, bitstreams in
csrc/host/webp_decode.c) against cv2.imread (OpenCV 5.0 over libwebp),
bit for bit in both read modes: lossy files of cv2.imwrite at several
qualities (segments and the normal loop filter, libwebp's defaults), with
their first partition rewritten to the simple filter or to sharpness 1-7,
and with their tokens re-encoded into 2, 4 and 8 partitions; lossless
files of cv2, PIL (every method, palettes that take the colour-indexing
transform with pixel bundling, alpha) and the port's own encoder; VP8X
files with alpha (lossy and lossless ALPH) and ICC / EXIF / XMP chunks;
animations (frame 0 on its canvas); a bare VP8L bitstream; odd sizes;
every prefix and 200 mutations of a small lossless and a small lossy
file; and the committed fixtures of tests/data/webp against the hashes of
cv2's arrays."""

import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port import damaged_same_as_cv2, same_as_cv2

from lgu_slam_tpu_torch.data import webp

SIZES = ((1, 1), (17, 33), (40, 57))
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "webp")


def _images(rng, H, W, channels=3):
    noise = rng.integers(0, 256, (H, W, channels), np.uint8)
    smooth = (np.cumsum(rng.integers(-3, 4, (H, W, channels)), axis=1)
              + 128).clip(0, 255).astype(np.uint8)
    return noise, smooth


def _pil(img, **kw) -> bytes:
    b = io.BytesIO()
    mode = "RGBA" if img.shape[-1] == 4 else "RGB"
    order = [2, 1, 0, 3][:img.shape[-1]]
    Image.fromarray(np.ascontiguousarray(img[..., order]), mode).save(
        b, "WEBP", **kw)
    return b.getvalue()


def _check(data: bytes, tmp_path, name="a.webp"):
    """cv2.imread reads the file, and the port returns its arrays."""
    path = tmp_path / name
    path.write_bytes(data)
    assert cv2.imread(str(path)) is not None
    same_as_cv2(path)


@pytest.mark.parametrize("quality", [5, 40, 75, 95, 100])
def test_lossy_matches_cv2(quality, tmp_path):
    """cv2.imwrite's lossy WebP (VP8: 4 segments with their quantisers,
    the normal filter) at a quality, random and smooth frames at odd and
    even sizes: cv2.imread's arrays exactly, in both modes."""
    rng = np.random.default_rng(quality)
    for H, W in SIZES + ((64, 96),):
        for im in _images(rng, H, W):
            ok, buf = cv2.imencode(".webp", im,
                                   [cv2.IMWRITE_WEBP_QUALITY, quality])
            _check(buf.tobytes(), tmp_path)


# -- rewriting a VP8 frame's first partition (boolean coder, RFC 6386) ---

class _BoolReader:
    """RFC 6386 section 7.3's boolean decoder."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.count = 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            bit, self.range, self.value = 1, self.range - split, \
                self.value - big
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return bit


class _BoolWriter:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def bit(self, prob: int, bit: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                i = len(self.out) - 1
                while i >= 0 and self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def bytes(self) -> bytes:
        for _ in range(32):
            self.bit(128, 0)
        return bytes(self.out)


def _first_partition(data: bytes, mb_w: int, mb_h: int):
    """The boolean decisions of a key frame's first partition, in order,
    as (probability, bit); where the filter header's bits and the token
    partition count start; whether segments are on; the coefficient
    probabilities; each macroblock's (skip flag or None, 4x4 modes)."""
    r, bits = _BoolReader(data), []

    def get(prob=128):
        b = r.bit(prob)
        bits.append([prob, b])
        return b

    def value(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | get()
        return v

    def signed(n):
        v = value(n)
        return -v if get() else v

    value(2)  # colour space, clamping
    use_segment = get()
    update_map = 0
    if use_segment:
        update_map = get()
        if get():
            get()
            for _ in range(4):
                if get():
                    signed(7)
            for _ in range(4):
                if get():
                    signed(6)
        seg_probs = [value(8) if get() else 255 for _ in range(3)] \
            if update_map else [255] * 3
    filter_at = len(bits)
    value(1 + 6 + 3)
    if get() and get():
        for _ in range(8):
            if get():
                signed(6)
    parts_at = len(bits)
    value(2)  # token partitions
    value(7)
    for _ in range(5):
        if get():
            signed(4)
    get()
    proba = [value(8) if get(int(p)) else int(d)
             for p, d in zip(_C_TABLES["update"], _C_TABLES["proba0"])]
    skip = get()
    skip_p = value(8) if skip else None
    kf = _C_TABLES["bmodes"]
    top = np.zeros(4 * mb_w, int)
    blocks = []
    for _ in range(mb_h):
        left = [0] * 4
        for x in range(mb_w):
            if update_map:
                if not get(seg_probs[0]):
                    get(seg_probs[1])
                else:
                    get(seg_probs[2])
            skipped = get(skip_p) if skip_p is not None else None
            is_16 = get(145)
            blocks.append((skipped, not is_16))
            if is_16:  # 16x16
                m = (1 if get(128) else 3) if get(156) else \
                    (2 if get(163) else 0)
                top[4 * x:4 * x + 4] = m
                left = [m] * 4
            else:
                for y in range(4):
                    mode = left[y]
                    for i in range(4):
                        prob = kf[top[4 * x + i], mode]
                        node = 0
                        tree = (-0, 2, -1, 4, -2, 6, 8, 12, -3, 10, -4, -5,
                                -6, 14, -7, 16, -8, -9)
                        while True:
                            nxt = tree[node + get(int(prob[node >> 1]))]
                            if nxt <= 0:
                                mode = -nxt
                                break
                            node = nxt
                        top[4 * x + i] = mode
                    left[y] = mode
            if get(142):
                if get(114):
                    get(183)
    return dict(bits=bits, filter_at=filter_at, parts_at=parts_at,
                use_segment=use_segment,
                proba=np.array(proba).reshape(4, 8, 3, 11), blocks=blocks)


def _read_c_tables():
    """kCoeffsUpdateProba and kBModesProba from the decoder's source."""
    src = open(os.path.join(os.path.dirname(webp.__file__), "..", "csrc",
                            "host", "webp_decode.c")).read()

    def table(name, shape):
        body = src[src.index(name):]
        body = body[body.index("=") + 1:body.index(";")]
        vals = [int(v) for v in body.replace("{", " ").replace(
            "}", " ").replace(",", " ").split()]
        return np.array(vals).reshape(shape)
    return {"update": table("kCoeffsUpdateProba", (-1,)),
            "proba0": table("kCoeffsProba0", (-1,)),
            "bmodes": table("kBModesProba[10][10][9]", (10, 10, 9))}


_C_TABLES = _read_c_tables()


def _refilter(data: bytes, simple: int, level: int, sharpness: int) -> bytes:
    """A lossy WebP (RIFF, VP8) with its filter header rewritten: the first
    partition decoded, its filter fields replaced, re-encoded."""
    assert data[12:16] == b"VP8 "
    vp8 = data[20:20 + struct.unpack("<I", data[16:20])[0]]
    tag = int.from_bytes(vp8[:3], "little")
    p0_len = tag >> 5
    w, h = (int.from_bytes(vp8[6:8], "little") & 0x3FFF,
            int.from_bytes(vp8[8:10], "little") & 0x3FFF)
    first = _first_partition(vp8[10:10 + p0_len], (w + 15) // 16,
                             (h + 15) // 16)
    bits, at, use_segment = first["bits"], first["filter_at"], \
        first["use_segment"]
    fields = [simple] + [(level >> (5 - i)) & 1 for i in range(6)] + \
        [(sharpness >> (2 - i)) & 1 for i in range(3)]
    for k, b in enumerate(fields):
        bits[at + k][1] = b
    writer = _BoolWriter()
    for prob, b in bits:
        writer.bit(prob, b)
    p0 = writer.bytes()
    tag = (tag & 0x1F) | (len(p0) << 5)
    body = tag.to_bytes(3, "little") + vp8[3:10] + p0 + vp8[10 + p0_len:]
    chunk = b"VP8 " + struct.pack("<I", len(body)) + body + \
        b"\0" * (len(body) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk, \
        use_segment


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _token_rows(data: bytes, first: dict, mb_w: int, mb_h: int) -> list:
    """The boolean decisions of a one-partition frame's tokens, per
    macroblock row (RFC 6386 section 13, libwebp's contexts)."""
    r, rows = _BoolReader(data), []
    proba = first["proba"]

    def get(prob):
        b = r.bit(int(prob))
        rows[-1].append((int(prob), b))
        return b

    def coeffs(prob, ctx, n):
        p = prob[_BANDS[n]][ctx]
        while n < 16:
            if not get(p[0]):
                return n
            while not get(p[1]):
                n += 1
                p = prob[_BANDS[n]][0]
                if n == 16:
                    return 16
            p_ctx = prob[_BANDS[n + 1]]
            if not get(p[2]):
                p = p_ctx[1]
            else:
                if not get(p[3]):
                    if get(p[4]):
                        get(p[5])
                elif not get(p[6]):
                    if not get(p[7]):
                        get(159)
                    else:
                        get(165)
                        get(145)
                else:
                    b1 = get(p[8])
                    for t in _CATS[2 * b1 + get(p[9 + b1])]:
                        get(t)
                p = p_ctx[2]
            get(128)  # the sign
            n += 1
        return 16

    top = np.zeros((mb_w, 9), int)  # 4 Y, 2 U, 2 V columns, the Y2 DC
    blocks = iter(first["blocks"])
    for _ in range(mb_h):
        rows.append([])
        left = np.zeros(9, int)
        for x in range(mb_w):
            skipped, i4x4 = next(blocks)
            t = top[x]
            if skipped:
                t[:8] = left[:8] = 0
                if not i4x4:
                    t[8] = left[8] = 0
                continue
            first_n = 0
            if not i4x4:
                t[8] = left[8] = coeffs(proba[1], t[8] + left[8], 0) > 0
                first_n = 1
            ac = proba[0] if not i4x4 else proba[3]
            for y in range(4):
                for i in range(4):
                    nz = coeffs(ac, left[y] + t[i], first_n) > first_n
                    left[y] = t[i] = nz
            for c in (4, 6):
                for y in range(2):
                    for i in range(2):
                        nz = coeffs(proba[2], left[c + y] + t[c + i], 0) > 0
                        left[c + y] = t[c + i] = nz
    return rows


def _repartition(data: bytes, k: int) -> bytes:
    """A lossy WebP of one token partition rewritten to ``k`` (2, 4 or 8):
    the tokens decoded, each macroblock row re-encoded into partition
    row % k, the count written into the first partition."""
    vp8 = data[20:20 + struct.unpack("<I", data[16:20])[0]]
    tag = int.from_bytes(vp8[:3], "little")
    p0_len = tag >> 5
    w, h = (int.from_bytes(vp8[6:8], "little") & 0x3FFF,
            int.from_bytes(vp8[8:10], "little") & 0x3FFF)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    first = _first_partition(vp8[10:10 + p0_len], mb_w, mb_h)
    bits = first["bits"]
    assert [b for _, b in bits[first["parts_at"]:first["parts_at"] + 2]] \
        == [0, 0]  # one partition
    rows = _token_rows(vp8[10 + p0_len:], first, mb_w, mb_h)
    n = k.bit_length() - 1
    bits[first["parts_at"]][1], bits[first["parts_at"] + 1][1] = \
        n >> 1, n & 1
    parts = []
    for p in range(k):
        writer = _BoolWriter()
        for row in rows[p::k]:
            for prob, b in row:
                writer.bit(prob, b)
        parts.append(writer.bytes())
    writer = _BoolWriter()
    for prob, b in bits:
        writer.bit(prob, b)
    p0 = writer.bytes()
    tag = (tag & 0x1F) | (len(p0) << 5)
    sizes = b"".join(len(q).to_bytes(3, "little") for q in parts[:-1])
    body = tag.to_bytes(3, "little") + vp8[3:10] + p0 + sizes + \
        b"".join(parts)
    chunk = b"VP8 " + struct.pack("<I", len(body)) + body + \
        b"\0" * (len(body) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_lossy_token_partitions_match_cv2(parts, tmp_path):
    """cv2.imwrite's lossy files (one token partition, skip flags on) with
    their tokens re-encoded into 2, 4 or 8 partitions (rows taken in
    turn): cv2.imread's arrays exactly, and the same as the original's."""
    rng = np.random.default_rng(20 + parts)
    for H, W in ((17, 33), (72, 40)):
        for im in _images(rng, H, W):
            data = cv2.imencode(".webp", im, [cv2.IMWRITE_WEBP_QUALITY, 60]
                                )[1].tobytes()
            out = _repartition(data, parts)
            _check(out, tmp_path)
            assert np.array_equal(webp.decode_webp(out),
                                  webp.decode_webp(data))


@pytest.mark.parametrize("simple, sharpness", [(1, 0), (1, 5), (0, 1),
                                               (0, 3), (0, 7)])
def test_lossy_filters_match_cv2(simple, sharpness, tmp_path):
    """cv2.imwrite's lossy files (which use segments) with the first
    partition rewritten to the simple loop filter or to a sharpness, at
    filter levels 10 and 40: cv2.imread's arrays exactly."""
    rng = np.random.default_rng(10 + sharpness)
    for H, W in ((17, 33), (48, 80)):
        im = _images(rng, H, W)[1]
        data = cv2.imencode(".webp", im, [cv2.IMWRITE_WEBP_QUALITY, 50]
                            )[1].tobytes()
        for level in (10, 40):
            out, use_segment = _refilter(data, simple, level, sharpness)
            assert use_segment
            _check(out, tmp_path)


@pytest.mark.parametrize("method", range(7))
def test_lossless_matches_cv2(method, tmp_path):
    """Lossless files of PIL at each method (the transforms libwebp picks:
    predictor, cross-colour, subtract-green, colour indexing with pixel
    bundling for 2-, 4- and 16-colour palettes), of cv2.imwrite (quality
    above 100) and of the port's encoder, with and without alpha."""
    rng = np.random.default_rng(100 + method)
    for H, W in SIZES:
        noise, smooth = _images(rng, H, W, 4)
        palettes = [rng.integers(0, 256, (n, 4), np.uint8)[
            rng.integers(0, n, (H, W))] for n in (2, 3, 11, 200)]
        for im in [noise, smooth] + palettes:
            _check(_pil(im[..., :3], lossless=True, method=method), tmp_path)
            _check(_pil(im, lossless=True, method=method, exact=True),
                   tmp_path)
        if method == 0:
            _check(cv2.imencode(".webp", smooth[..., :3],
                                [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes(),
                   tmp_path)
            for cache_bits in (0, 4, 10):
                for im in (smooth[..., :3], smooth):
                    data = webp.encode_webp_lossless(im, cache_bits)
                    _check(data, tmp_path)
                    assert np.array_equal(
                        webp.decode_webp_bgra(data)[..., :im.shape[-1]], im)


@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
def test_alpha_matches_cv2_and_pil(alpha_quality, tmp_path):
    """VP8X files with an ALPH chunk (PIL: lossy colour with alpha
    compressed at alpha_quality, its filters picked by libwebp) and
    lossless files with alpha: cv2's arrays exactly (alpha dropped, not
    composited), and the decoded alpha plane equals PIL's."""
    rng = np.random.default_rng(200 + alpha_quality)
    for H, W in SIZES:
        for im in _images(rng, H, W, 4):
            for kw in (dict(quality=70, alpha_quality=alpha_quality),
                       dict(lossless=True)):
                data = _pil(im, **kw)
                _check(data, tmp_path)
                ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
                got = webp.decode_webp_bgra(data)
                assert np.array_equal(got[..., 3], ref[..., 3])
                assert np.array_equal(got[..., :3], ref[..., 2::-1])


def test_metadata_chunks_and_bare_bitstreams(tmp_path):
    """VP8X files with ICCP, EXIF and XMP chunks (lossy and lossless), a
    bare VP8L bitstream and a bare VP8 frame (no RIFF: libwebp takes them
    too), trailing bytes after the RIFF: as cv2 reads them."""
    rng = np.random.default_rng(300)
    im = _images(rng, 17, 33)[1]
    for kw in (dict(quality=80), dict(lossless=True)):
        _check(_pil(im, icc_profile=b"\0" * 40 + b"icc" * 20,
                    exif=b"Exif\0\0" + b"e" * 31, xmp=b"<x:xmpmeta/>", **kw),
               tmp_path)
    lossless = webp.encode_webp_lossless(im)
    _check(lossless[20:], tmp_path)
    lossy = cv2.imencode(".webp", im)[1].tobytes()
    _check(lossy[20:], tmp_path)
    _check(lossy + b"trailing bytes", tmp_path)


def _anmf(x, y, frame: bytes) -> bytes:
    w, h = webp.parse_headers(frame, True, True)["width"], \
        webp.parse_headers(frame, True, True)["height"]
    head = b"".join(int(v).to_bytes(3, "little")
                    for v in (x // 2, y // 2, w - 1, h - 1, 100)) + b"\0"
    body = head + frame[12:]
    return b"ANMF" + struct.pack("<I", len(body)) + body + \
        b"\0" * (len(body) & 1)


def test_animations_match_cv2(tmp_path):
    """Animated WebP (PIL, lossy and lossless, with alpha) and hand-built
    ones whose frame 0 is smaller than the canvas at an offset: cv2.imread
    returns frame 0 on a canvas of zeros, and so does the port."""
    rng = np.random.default_rng(400)
    for channels in (3, 4):
        frames = [Image.fromarray(rng.integers(0, 256, (20, 30, channels),
                                               np.uint8))
                  for _ in range(3)]
        for kw in (dict(lossless=True), dict(quality=60)):
            b = io.BytesIO()
            frames[0].save(b, "WEBP", save_all=True,
                           append_images=frames[1:], duration=100, **kw)
            _check(b.getvalue(), tmp_path)
    small = _images(rng, 6, 8)[0]
    for x, y in ((0, 0), (2, 4), (10, 6)):
        vp8x = bytes([0x12, 0, 0, 0]) + (19).to_bytes(3, "little") + \
            (11).to_bytes(3, "little")
        body = b"WEBP" + b"VP8X" + struct.pack("<I", 10) + vp8x + b"ANIM" + \
            struct.pack("<IIH", 6, 0xFF102030, 0) + \
            _anmf(x, y, webp.encode_webp_lossless(small)) + \
            _anmf(0, 0, webp.encode_webp_lossless(small[::-1]))
        _check(b"RIFF" + struct.pack("<I", len(body)) + body, tmp_path)


@pytest.mark.parametrize("kind", ["lossless", "lossy"])
def test_damaged_files_follow_cv2(kind, tmp_path):
    """Every prefix and 200 seeded mutations of a small file (cv2.imwrite,
    lossless or lossy): an array exactly where cv2.imread returns one,
    ValueError exactly where it returns None."""
    im = np.random.default_rng(500).integers(0, 256, (9, 13, 3), np.uint8)
    q = 101 if kind == "lossless" else 80
    data = cv2.imencode(".webp", im, [cv2.IMWRITE_WEBP_QUALITY, q]
                        )[1].tobytes()
    damaged_same_as_cv2(data, tmp_path, 200, seed=len(kind))


def test_committed_fixtures_decode_to_cv2_hashes():
    """tests/data/webp (scripts/make_webp_fixtures_torch.py: a lossy 480 x
    640 frame, lossy and lossless alpha, a 3-frame animation): the port's
    arrays hash as cv2.imread's do (the hashes written beside them), and
    cv2 still agrees; each file at most 64 KB, the set at most 512 KB."""
    from lgu_slam_tpu_torch.data import image_io

    hashes = json.load(open(os.path.join(FIXTURES, "hashes.json")))
    assert len(hashes) == 4
    total = 0
    for name, want in hashes.items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        assert os.path.getsize(path) <= 64 * 1024
        for mode, flag in (("color", cv2.IMREAD_COLOR),
                           ("anydepth", cv2.IMREAD_ANYDEPTH)):
            got = image_io.imread(path, anydepth=mode == "anydepth")
            ref = cv2.imread(path, flag)
            for a in (got, ref):
                assert hashlib.sha256(a.tobytes()).hexdigest() == \
                    want[mode]["sha256"]
                assert list(a.shape) == want[mode]["shape"]
    assert total <= 512 * 1024
