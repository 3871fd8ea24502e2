"""The port's GIF reader (lgu_slam_tpu_torch/data/gif.py, LZW in
csrc/host/gif_lzw.c) against cv2.imread (OpenCV 5.0's own GIF decoder),
bit for bit in both read modes: files of the port's encoder (GIF87a and
GIF89a, global and local tables, interlacing, transparency with the
background colour, frames smaller than the screen, animations, minimum
code sizes 2-8, a table that fills without a clear code), of PIL and of
cv2.imwrite; hand-made LZW streams (codes past the table, end codes before
the image is full, data that ends early, codes after the last pixel);
odd sizes; every prefix and 200 mutations of small files."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port import damaged_same_as_cv2, same_as_cv2

from lgu_slam_tpu_torch.data import gif


def _check(data: bytes, tmp_path, readable=True):
    path = tmp_path / "a.gif"
    path.write_bytes(data)
    if readable:
        assert cv2.imread(str(path)) is not None
    same_as_cv2(path)


@pytest.mark.parametrize("min_code_size", range(2, 9))
def test_code_sizes_match_cv2(min_code_size, tmp_path):
    """Every minimum code size, random and smooth indices at odd sizes
    (1 x 1 included), global or local table, GIF87a or GIF89a, interlaced
    or not: cv2.imread's arrays exactly."""
    rng = np.random.default_rng(min_code_size)
    n = 1 << min_code_size
    for H, W in ((1, 1), (17, 33), (40, 57)):
        pal = rng.integers(0, 256, (n, 3), np.uint8)
        noise = rng.integers(0, n, (H, W), np.uint8)
        smooth = (np.cumsum(rng.integers(0, 2, (H, W)), axis=1) % n
                  ).astype(np.uint8)
        for idx in (noise, smooth):
            for version in (b"GIF87a", b"GIF89a"):
                _check(gif.encode_gif([idx], palette=pal, version=version,
                                      min_code_size=min_code_size), tmp_path)
            _check(gif.encode_gif([dict(indices=idx, palette=pal,
                                        interlace=True)],
                                  min_code_size=min_code_size), tmp_path)


def test_tables_transparency_and_canvas_match_cv2(tmp_path):
    """A local table over a larger global one (its entries first, the
    global table's past them), no table at all (gray), transparent
    indices (the background colour shows), disposal methods 0-3, frames
    smaller than the screen at an offset (the background around them),
    a second frame (ignored), extensions before the image."""
    rng = np.random.default_rng(20)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    small = rng.integers(0, 256, (4, 3), np.uint8)
    idx = rng.integers(0, 8, (9, 13), np.uint8)
    cases = [
        gif.encode_gif([dict(indices=idx, palette=small)], palette=pal),
        gif.encode_gif([dict(indices=idx % 4, palette=small)]),
        gif.encode_gif([idx]),
        gif.encode_gif([dict(indices=idx, pos=(3, 2))], palette=pal,
                       background=5),
    ]
    for disposal in range(4):
        cases.append(gif.encode_gif(
            [dict(indices=idx, transparent=3, disposal=disposal)],
            palette=pal, background=7))
    cases.append(gif.encode_gif([idx, dict(indices=idx[::-1], pos=(1, 1))],
                                palette=pal))
    for data in cases:
        _check(data, tmp_path)


def test_pil_and_cv2_files_match_cv2(tmp_path):
    """GIFs of PIL (palette and RGB images, interlaced with a transparent
    index, a 3-frame animation) and of cv2.imwrite: cv2's arrays."""
    rng = np.random.default_rng(30)
    for size in ((1, 1), (21, 34)):
        rgb = rng.integers(0, 256, size + (3,), np.uint8)
        for im in (Image.fromarray(rgb), Image.fromarray(rgb).convert("P")):
            for kw in ({}, dict(interlace=True, transparency=5)):
                b = io.BytesIO()
                im.save(b, "GIF", **kw)
                _check(b.getvalue(), tmp_path)
    frames = [Image.fromarray(rng.integers(0, 256, (20, 30, 3), np.uint8))
              for _ in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "GIF", save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    _check(b.getvalue(), tmp_path)
    path = str(tmp_path / "cv.gif")
    assert cv2.imwrite(path, rng.integers(0, 256, (17, 33, 3), np.uint8))
    same_as_cv2(path)


def _pack(codes):
    """(code, width) pairs -> LSB-first bytes."""
    acc = nbits = 0
    out = bytearray()
    for c, n in codes:
        acc |= c << nbits
        nbits += n
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    return bytes(out + (bytes([acc]) if nbits else b""))


def _widths(codes, mcs):
    """The widths a decoder reads ``codes`` at (growing as entries are
    added; reset by clear and end codes)."""
    clear, out, nxt, w, first = 1 << mcs, [], (1 << mcs) + 2, mcs + 1, True
    for c in codes:
        out.append((c, w))
        if c in (clear, clear + 1):
            nxt, w, first = clear + 2, mcs + 1, True
        elif first:
            first = False
        else:
            nxt = min(nxt + 1, 4096)
            if nxt == 1 << w and w < 12:
                w += 1
    return out


def _raw(W, H, mcs, data, pal):
    return b"GIF89a" + struct.pack("<HH", W, H) + bytes([0xF7, 0, 0]) + \
        pal.tobytes() + b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0) + \
        bytes([mcs]) + gif._blocks(data) + b"\x3b"


def test_lzw_streams_match_cv2(tmp_path):
    """300 seeded LZW code streams around a frame's pixel count: literals,
    table codes (valid, one past the table, further), clear and end codes
    anywhere, trailing zero bytes: cv2's array or its refusal each time."""
    rng = np.random.default_rng(40)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    read = 0
    for _ in range(300):
        mcs = int(rng.integers(2, 9))
        clear = 1 << mcs
        H, W = int(rng.integers(1, 5)), int(rng.integers(1, 6))
        codes = [clear] if rng.random() < 0.9 else []
        nxt, first = clear + 2, True
        for _ in range(int(rng.integers(max(1, H * W - 3), H * W + 4))):
            r = rng.random()
            if r < 0.6 or first:
                c = int(rng.integers(0, min(clear, 16)))
            elif r < 0.9:
                c = int(rng.integers(clear + 2, nxt + 1))
            elif r < 0.95:
                c = clear
            else:
                c = int(rng.integers(clear + 2, nxt + 3))
            codes.append(c)
            if c == clear:
                nxt, first = clear + 2, True
            elif first:
                first = False
            else:
                nxt += 1
        if rng.random() < 0.7:
            codes.append(clear + 1)
        data = _pack(_widths(codes, mcs))
        if rng.random() < 0.3:
            data += bytes(int(rng.integers(1, 3)))
        path = tmp_path / "s.gif"
        path.write_bytes(_raw(W, H, mcs, data, pal))
        read += cv2.imread(str(path)) is not None
        same_as_cv2(path)
    assert 30 < read < 270  # both outcomes are exercised


def test_full_table_without_clear_matches_cv2(tmp_path):
    """An encoder that never sends a clear code once the table holds 4096
    entries (a deferred clear: 12-bit codes, no new entries)."""
    rng = np.random.default_rng(50)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    idx = rng.integers(0, 64, (100, 120), np.uint8)
    table = {(i,): i for i in range(256)}
    nxt, size, codes, cur = 258, 9, [(256, 9)], ()
    for v in idx.ravel().tolist():
        if cur + (v,) in table:
            cur += (v,)
            continue
        codes.append((table[cur], size))
        if nxt < 4096:
            table[cur + (v,)] = nxt
            nxt += 1
            if nxt > 1 << size and size < 12:
                size += 1
        cur = (v,)
    codes += [(table[cur], size), (257, size)]
    _check(_raw(120, 100, 8, _pack(codes), pal), tmp_path)


@pytest.mark.parametrize("interlace", [False, True])
def test_damaged_files_follow_cv2(interlace, tmp_path):
    """Every prefix and 200 seeded mutations of a small GIF (a 16-entry
    table, minimum code size 4; interlaced with a transparent index):
    cv2.imread's array or ValueError exactly where it returns None."""
    rng = np.random.default_rng(60 + interlace)
    idx = rng.integers(0, 16, (9, 13), np.uint8)
    frame = dict(indices=idx, interlace=interlace)
    if interlace:
        frame["transparent"] = 2
    data = gif.encode_gif([frame], palette=rng.integers(0, 256, (16, 3),
                                                        np.uint8),
                          min_code_size=4)
    damaged_same_as_cv2(data, tmp_path, 200, seed=interlace)


def test_refusals(tmp_path):
    """Files cv2.imread returns None for: another GIF version, an empty
    screen, a background index past the global table, an index past the
    tables, disposal method 4, a frame outside the screen, a missing
    trailer, a stray byte between blocks, a minimum code size of 1."""
    rng = np.random.default_rng(70)
    pal = rng.integers(0, 256, (4, 3), np.uint8)
    idx = rng.integers(0, 4, (5, 7), np.uint8)
    good = gif.encode_gif([idx], palette=pal)
    cases = [b"GIF88a" + good[6:], good[:6] + bytes(4) + good[10:],
             gif.encode_gif([idx], palette=pal, background=9),
             gif.encode_gif([np.full((5, 7), 5, np.uint8)], palette=pal),
             gif.encode_gif([dict(indices=idx, disposal=4)], palette=pal),
             good[:-1], good[:-1] + b"\x99\x3b",
             gif.encode_gif([idx % 2], palette=pal, min_code_size=1)]
    shifted = bytearray(good)
    pos = shifted.index(b"\x2c")
    shifted[pos + 1] = 3  # left = 3: the frame passes the screen's edge
    cases.append(bytes(shifted))
    for data in cases:
        path = tmp_path / "r.gif"
        path.write_bytes(data)
        assert cv2.imread(str(path)) is None
        same_as_cv2(path)
