"""AV1 inter frames in the port's AVIF reader (slice 24): the layered
(progressive) items libavif writes (``extraLayerCount``, avifenc's
``--progressive``), read as OpenCV reads them (libavif 1.4.2 over libaom
3.14.1) in both read modes; each layer held against libaom's own decode of
the item's data up to it; inter prediction of one block held against the
specification's formulas over libaom's filter tables (the 8- and 4-tap
sub-sample filters at 8, 10 and 12 bits, vectors scaled to a reference of
another size, the block warp of local warp) and the wedge masks against
libaom's; damaged layered files raise ValueError where cv2.imread returns
None."""

import ctypes
import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
from test_torch_avif import DATA, QUEUED
from test_torch_avif_grain import _libaom, aom_planes
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif, image_io

SCRIPTS = os.path.join(os.path.dirname(DATA), "..", "..", "scripts")
sys.path.insert(0, SCRIPTS)
import extract_av1_tables_torch as tables  # noqa: E402
from make_avif_fixtures_torch import (  # noqa: E402
    encode_layered,
    frame_ends,
    frame_headers,
    with_props,
)

HASHES = json.load(open(os.path.join(DATA, "hashes.json")))
LAYERED = sorted(n for n in HASHES if n.startswith("layered_"))
# the multi-layer items whose every layer libaom decodes on its own (the
# 480 x 640 frames are phase 24's; a selected layer is libavif's choice)
LAYERS = [n for n in LAYERED if "480x640" not in n and HASHES[n]["color"]
          and "lsel" not in n]


@pytest.mark.parametrize("name", LAYERED)
def test_layered_fixture_reads_as_cv2(name):
    """Each committed layered item (2-4 layers, same-size quality layers
    and scaled base layers, 8 / 10 / 12 bits, 4:2:0 / 4:4:4 / gray, speeds
    0, 2, 6 and 9, alpha, lsel and a1op, the 480 x 640 sequence of
    chip_smoke.py phase 24) reads in both modes to cv2.imread's hash, or
    raises ValueError where cv2 returned None."""
    path = os.path.join(DATA, name)
    for mode in ("color", "anydepth"):
        want = HASHES[name][mode]
        if want is None:
            with pytest.raises(ValueError):
                image_io.imread(path, anydepth=mode == "anydepth")
            continue
        got = image_io.imread(path, anydepth=mode == "anydepth")
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
        assert list(got.shape) == want["shape"]
        assert str(got.dtype) == want["dtype"]


def _payload(data: bytes, alpha: bool = False) -> bytes:
    box = avif.parse(data)
    return avif._payload(data, box, box["alpha" if alpha else "color"])


@pytest.mark.parametrize("name", LAYERS)
def test_every_layer_equals_libaom(name):
    """Each layer of each committed item (and of its alpha item) decodes
    to libaom's planes of the item's data up to that layer: the inter
    frames' prediction, reconstruction and filters, layer by layer."""
    data = open(os.path.join(DATA, name), "rb").read()
    items = [_payload(data)] + ([_payload(data, True)] if "alpha" in name
                                else [])
    for obus in items:
        ends = frame_ends(obus)
        assert len(ends) >= 2
        for end in ends:
            got = avif.av1_planes(obus[:end])[0]
            want = aom_planes(obus[:end])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_fixtures_use_the_inter_tools():
    """The committed items reach each tool the inter decoder reads from
    libaom's layers: NEWMV, OBMC, local warp, inter-intra (smooth and
    wedge), prediction from scaled references, chroma blocks over several
    luma blocks, the projected motion field and its temporal candidates;
    none reaches a tool refused at the end of a decode (a global warp, two
    interpolation filters); the frame headers of a scaled item's layers
    carry its sizes."""
    total = dict.fromkeys(avif.INTER_TOOLS, 0)
    for name in LAYERS:
        counts = avif.inter_stats(_payload(open(os.path.join(DATA, name),
                                                "rb").read()))[0]
        for k, v in counts.items():
            total[k] += v
    for tool in ("inter", "newmv", "obmc", "local_warp", "interintra",
                 "wedge", "scaled", "sub8x8", "projected", "temporal"):
        assert total[tool] > 0, tool
    assert total["global_warp"] == total["dual_filter"] == 0
    obus = _payload(open(os.path.join(DATA, "layered_l3_s0_quarter.avif"),
                         "rb").read())
    assert [(h["width"], h["height"]) for h in frame_headers(obus)] == [
        (32, 24), (64, 48), (128, 96)]


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "4:0:0"])
def test_layered_item_written_now(sub, tmp_path):
    """A layered item written here through cv2's libavif (2 layers, the
    base at half scale, speed 4; 3 quality layers at speed 7) of an odd
    size reads equal to cv2.imread in both modes."""
    rng = np.random.default_rng(24)
    y, x = np.mgrid[0:70, 0:102]
    img = np.stack([np.sin(x / 7.0 + c) * 70 + np.cos(y / 5.0) * 40 + 120
                    for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    moved = np.roll(img, (2, 3), (0, 1))
    for k, kw in enumerate((dict(speed=4, qualities=[30, 70],
                                 scales=[(1, 2), (1, 1)]),
                            dict(speed=7, qualities=[20, 50, 80]))):
        layers = [img, moved, img][:len(kw["qualities"])]
        path = tmp_path / f"{k}.avif"
        path.write_bytes(encode_layered(layers, sub=sub, **kw))
        same_as_cv2(path)


def test_layer_selection(tmp_path):
    """lsel: libavif has libaom output every layer and takes the selected
    one (scaled to ispe where it is smaller); a1op: the operating point
    (libaom takes 0 where the sequence has not as many); each read equal to
    cv2.imread; an absent layer is None to cv2 and ValueError here."""
    data = open(os.path.join(DATA, "layered_l3_s0_quarter.avif"), "rb").read()
    lsel = [avif._box(b"lsel", struct.pack(">H", k)) for k in range(4)]
    a1op = [avif._box(b"a1op", bytes([k])) for k in range(3)]
    cases = [[(lsel[k], True)] for k in range(4)] + \
        [[(a1op[k], True)] for k in (1, 2)] + [[(a1op[2], True),
                                                 (lsel[2], True)]]
    for k, extra in enumerate(cases):
        path = tmp_path / f"{k}.avif"
        path.write_bytes(with_props(data, extra))
        same_as_cv2(path)
    assert cv2.imread(str(tmp_path / "3.avif")) is None


# -- one block's prediction against the specification ----------------------

def _lib():
    lib = avif._lib()
    lib.av1_predict.argtypes = [ctypes.c_void_p, ctypes.c_int64] + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_char_p, ctypes.c_int]
    lib.av1_predict.restype = ctypes.c_int
    lib.av1_wedge_masks.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.av1_wedge_masks.restype = ctypes.c_int
    return lib


def _port_predict(ref, rw, rh, fw, fh, depth, ssx, ssy, p):
    ref = np.ascontiguousarray(ref, np.uint16)
    params = np.zeros(16, np.int32)
    params[:len(p)] = p
    out = np.zeros((p[4], p[3]), np.uint16)
    err = ctypes.create_string_buffer(128)
    assert _lib().av1_predict(ref.ctypes.data, ref.shape[1], rw, rh, fw, fh,
                              depth, ssx, ssy, params.ctypes.data,
                              out.ctypes.data, err, 128) == 0, err.value
    return out


def _libaom_tables():
    with open(tables.library_path(), "rb") as f:
        syms = tables.symbols(f.read())
    sub = np.stack([np.frombuffer(tables.table(syms, s, 256), "<i2")
                    .reshape(16, 8) for s in tables.SUBPEL]).astype(np.int64)
    warp = np.frombuffer(tables.table(syms, "av1_warped_filter", 3088),
                         "<i2").reshape(193, 8).astype(np.int64)
    div = np.frombuffer(tables.table(syms, "div_lut", 514), "<i2")
    return sub, warp, div.astype(np.int64)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def _round2signed(x, n):
    return _round2(x, n) if x >= 0 else -_round2(-x, n)


def _spec_predict(ref, rw, rh, fw, fh, depth, ssx, ssy, p, sub):
    """7.11.3.3-4: the motion vector scaling process and the block inter
    prediction process, with InterRound0 / InterRound1 of 8-12 bits."""
    plane, x, y, w, h, mvr, mvc, fy, fx = p[:9]
    sx_, sy_ = (ssx, ssy) if plane else (0, 0)
    r0, r1 = (5, 9) if depth == 12 else (3, 11)
    xscale = ((rw << 14) + fw // 2) // fw
    yscale = ((rh << 14) + fh // 2) // fh
    ox = (x << 4) + ((2 * mvc) >> sx_) + 8
    oy = (y << 4) + ((2 * mvr) >> sy_) + 8
    startx = _round2signed(ox * xscale - (8 << 14), 8) + 32
    starty = _round2signed(oy * yscale - (8 << 14), 8) + 32
    xstep, ystep = _round2signed(xscale, 4), _round2signed(yscale, 4)
    lastx, lasty = ((rw + sx_) >> sx_) - 1, ((rh + sy_) >> sy_) - 1

    def four(f, n):  # the 4-tap filters of blocks 4 samples or fewer
        return f if n > 4 else {1: 5, 3: 3}.get(f, 4)

    fx, fy = four(fx, w), four(fy, h)
    ih = (((h - 1) * ystep + (1 << 10) - 1) >> 10) + 8
    inter = np.zeros((ih, w), np.int64)
    for r in range(ih):
        yy = min(max((starty >> 10) + r - 3, 0), lasty)
        for c in range(w):
            pos = startx + xstep * c
            taps = sub[fx][(pos >> 6) & 15]
            s = sum(int(taps[t]) * int(ref[yy, min(max((pos >> 10) + t - 3,
                                                        0), lastx)])
                    for t in range(8))
            inter[r, c] = _round2(s, r0)
    out = np.zeros((h, w), np.int64)
    for r in range(h):
        pos = (starty & 1023) + ystep * r
        taps = sub[fy][(pos >> 6) & 15]
        for c in range(w):
            s = sum(int(taps[t]) * int(inter[(pos >> 10) + t, c])
                    for t in range(8))
            out[r, c] = min(max(_round2(s, r1), 0), (1 << depth) - 1)
    return out


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_subpel_prediction_matches_spec(depth):
    """Blocks of 2-16 samples (4-tap filters at 4 or fewer) with random
    vectors (sub-sample in both directions, reaching past the frame's
    edges) and every filter pair, luma and 4:2:0 chroma, at 8, 10 and 12
    bits: the port's block_inter equals the specification's two passes
    over libaom's filter tables."""
    sub = _libaom_tables()[0]
    rng = np.random.default_rng(depth)
    rw, rh = 44, 36
    for _ in range(24):
        plane = int(rng.integers(0, 2))
        ssx = ssy = 1
        pw, ph = ((rw + 1) >> 1, (rh + 1) >> 1) if plane else (rw, rh)
        ref = rng.integers(0, 1 << depth, (ph, pw + 3)).astype(np.uint16)
        w, h = (int(v) for v in rng.choice([2, 4, 8, 16], 2))
        p = [plane, int(rng.integers(0, pw - w + 1)),
             int(rng.integers(0, ph - h + 1)), w, h,
             int(rng.integers(-120, 120)), int(rng.integers(-120, 120)),
             int(rng.integers(0, 4)), int(rng.integers(0, 4))]
        got = _port_predict(ref, rw, rh, rw, rh, depth, ssx, ssy, p)
        want = _spec_predict(ref, rw, rh, rw, rh, depth, ssx, ssy, p, sub)
        np.testing.assert_array_equal(got, want, err_msg=str(p))


@pytest.mark.parametrize("scale", [(2, 1), (1, 2), (3, 2)])
def test_scaled_prediction_matches_spec(scale):
    """A reference of another size than the frame (twice, half and 1.5
    times as large; 7.11.3.3's xScale / yScale and the 1/1024 steps): the
    port's prediction equals the specification's."""
    sub = _libaom_tables()[0]
    rng = np.random.default_rng(sum(scale))
    fw, fh = 48, 32
    rw, rh = fw * scale[0] // scale[1], fh * scale[0] // scale[1]
    for _ in range(12):
        plane = int(rng.integers(0, 2))
        pw, ph = ((rw + 1) >> 1, (rh + 1) >> 1) if plane else (rw, rh)
        ref = rng.integers(0, 256, (ph, pw)).astype(np.uint16)
        w, h = (int(v) for v in rng.choice([4, 8, 16], 2))
        fpw = fw >> plane
        p = [plane, int(rng.integers(0, fpw - w + 1)),
             int(rng.integers(0, (fh >> plane) - h + 1)), w, h,
             int(rng.integers(-60, 60)), int(rng.integers(-60, 60)),
             int(rng.integers(0, 4)), int(rng.integers(0, 4))]
        got = _port_predict(ref, rw, rh, fw, fh, 8, 1, 1, p)
        want = _spec_predict(ref, rw, rh, fw, fh, 8, 1, 1, p, sub)
        np.testing.assert_array_equal(got, want, err_msg=str(p))


def _shear(w, div):
    """libaom's av1_get_shear_params: (alpha, beta, gamma, delta), reduced
    to multiples of 64, or None where the warp is not valid."""
    def divisor(d):
        n = d.bit_length() - 1
        e = d - (1 << n)
        f = _round2(e, n - 8) if n > 8 else e << (8 - n)
        return int(div[f]), n + 14

    if w[2] <= 0:
        return None
    clamp = lambda v: max(-32768, min(32767, v))  # noqa: E731
    alpha, beta = clamp(w[2] - 65536), clamp(w[3])
    y, shift = divisor(w[2])
    gamma = clamp(_round2signed(w[4] * 65536 * y, shift))
    delta = clamp(w[5] - _round2signed(w[3] * w[4] * y, shift) - 65536)
    sh = [_round2signed(v, 6) * 64 for v in (alpha, beta, gamma, delta)]
    if 4 * abs(sh[0]) + 7 * abs(sh[1]) >= 65536 or \
            4 * abs(sh[2]) + 4 * abs(sh[3]) >= 65536:
        return None
    return sh


def _spec_warp(ref, w, x, y, bw, bh, depth, ss, warp, div):
    """libaom's av1_warp_affine_c (the block warp of 7.11.3.5 with the
    filter positions reduced to multiples of 64) of a bw x bh block."""
    alpha, beta, gamma, delta = _shear(w, div)
    r0 = 5 if depth == 12 else 3
    lasty, lastx = ref.shape[0] - 1, ref.shape[1] - 1
    out = np.zeros((bh, bw), np.int64)
    for i in range(y, y + bh, 8):
        for j in range(x, x + bw, 8):
            sx, sy = (j + 4) << ss, (i + 4) << ss
            dx = w[2] * sx + w[3] * sy + w[0]
            dy = w[4] * sx + w[5] * sy + w[1]
            x4, y4 = dx >> ss, dy >> ss
            ix4, iy4 = x4 >> 16, y4 >> 16
            sx4 = ((x4 & 65535) - 4 * alpha - 4 * beta) & ~63
            sy4 = ((y4 & 65535) - 4 * gamma - 4 * delta) & ~63
            tmp = np.zeros((15, 8), np.int64)
            for k in range(-7, 8):
                yy = min(max(iy4 + k, 0), lasty)
                for m in range(-4, 4):
                    s_ = sx4 + beta * (k + 4) + alpha * (m + 4)
                    taps = warp[_round2(s_, 10) + 64]
                    s = sum(int(taps[t]) * int(ref[yy, min(max(
                        ix4 + m - 3 + t, 0), lastx)]) for t in range(8))
                    tmp[k + 7, m + 4] = _round2(s, r0)
            for k in range(-4, min(4, y + bh - i - 4)):
                for m in range(-4, min(4, x + bw - j - 4)):
                    s_ = sy4 + delta * (k + 4) + gamma * (m + 4)
                    taps = warp[_round2(s_, 10) + 64]
                    s = sum(int(taps[t]) * int(tmp[k + t + 4, m + 4])
                            for t in range(8))
                    out[i - y + k + 4, j - x + m + 4] = min(max(
                        _round2(s, 14 - r0), 0), (1 << depth) - 1)
    return out


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_warp_matches_libaom(depth):
    """Random valid affine warps (near identity, shears within libaom's
    limits) of 8 x 8 to 16 x 16 luma and 4:2:0 chroma blocks at 8, 10 and
    12 bits: the port's block_warp equals libaom's warp filter formulas
    over its av1_warped_filter and div_lut."""
    _, warp, div = _libaom_tables()
    rng = np.random.default_rng(100 + depth)
    rw, rh = 48, 40
    done = 0
    while done < 10:
        plane = int(rng.integers(0, 2))
        ss = plane
        wm = [int(rng.integers(-40000, 40000)), int(rng.integers(-40000,
                                                                 40000)),
              65536 + int(rng.integers(-2500, 2500)),
              int(rng.integers(-2500, 2500)), int(rng.integers(-2500, 2500)),
              65536 + int(rng.integers(-2500, 2500))]
        if _shear(wm, div) is None:
            continue
        pw, ph = ((rw + 1) >> 1, (rh + 1) >> 1) if plane else (rw, rh)
        ref = rng.integers(0, 1 << depth, (ph, pw)).astype(np.uint16)
        bw, bh = (int(v) for v in rng.choice([8, 16], 2))
        x, y = int(rng.integers(0, pw - bw + 1)), int(rng.integers(0, ph - bh
                                                                   + 1))
        p = [plane, x, y, bw, bh, 0, 0, 0, 0, 1] + wm
        got = _port_predict(ref, rw, rh, rw, rh, depth, 1, 1, p)
        want = _spec_warp(ref, wm, x, y, bw, bh, depth, ss, warp, div)
        np.testing.assert_array_equal(got, want, err_msg=str(p))
        done += 1


def test_wedge_masks_match_libaom():
    """The wedge masks of inter-intra (every size that has them, the 16
    wedges, sign 0) equal the masks libaom builds at start-up, read out of
    its av1_wedge_params_lookup after its decoder has decoded a frame
    (libaom builds them once, when a decoder first decodes)."""
    lib = _libaom()
    aom_planes(_payload(open(os.path.join(DATA, LAYERS[0]), "rb").read()))
    with open(tables.library_path(), "rb") as f:
        raw = f.read()
    shoff, = struct.unpack_from("<Q", raw, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", raw, 0x3A)
    secs = [struct.unpack_from("<IIQQQQIIQQ", raw, shoff + k * shentsize)
            for k in range(shnum)]
    _, _, _, _, off, size, link, _, _, ent = [s for s in secs
                                              if s[1] == 2][0]
    addr = {}
    for k in range(size // ent):
        no, _, _, _, value, _ = struct.unpack_from("<IBBHQQ", raw,
                                                   off + k * ent)
        s = secs[link][4] + no
        addr[raw[s:raw.index(b"\0", s)]] = value
    base = ctypes.cast(lib.aom_codec_av1_dx, ctypes.c_void_p).value - \
        addr[b"aom_codec_av1_dx"]
    lookup = base + addr[b"av1_wedge_params_lookup"]
    wl = [0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4]
    hl = [0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2]
    sizes = 0
    for b in range(22):
        if not ctypes.c_int.from_address(lookup + 32 * b).value:
            continue
        w, h = 4 << wl[b], 4 << hl[b]
        masks = ctypes.c_void_p.from_address(lookup + 32 * b + 24).value
        mine = np.zeros(16 * w * h, np.uint8)
        assert _lib().av1_wedge_masks(b, mine.ctypes.data) == 0
        for k in range(16):
            ptr = ctypes.c_void_p.from_address(masks + 8 * k).value
            want = np.frombuffer(ctypes.string_at(ptr, w * h), np.uint8)
            np.testing.assert_array_equal(mine[k * w * h:(k + 1) * w * h],
                                          want)
        sizes += 1
    assert sizes == 9


# -- damaged layered items ---------------------------------------------------

# kind: (rng seed, {(feature, cv2 reads): reads}) as measured with OpenCV
# 5.0.0 (libavif 1.4.2, libaom 3.14.1)
LAYERED_DAMAGE = {
    "headers": (61, {("AV1 frame_refs_short_signaling", False): 6,
                     ("an AV1 switch frame", False): 2,
                     ("an AV1 compound prediction", False): 2}),
    "tiles": (62, {("AV1 frame_refs_short_signaling", False): 2})}


@pytest.mark.parametrize("kind", sorted(LAYERED_DAMAGE))
def test_layered_damage(kind, tmp_path):
    """300 copies of a layered item (three layers, the base at a quarter of
    the size, speed 0: OBMC, wedge inter-intra, scaled prediction) with one
    or two bytes changed in the first 24 of a frame OBU (the sequence
    header, the key frame's and the inter frames' headers) or anywhere in
    the AV1 data, each read in both modes: cv2's array where cv2.imread
    reads, ValueError where it returns None; NotImplementedError only for
    a feature of test_torch_avif.QUEUED, counted against
    ``LAYERED_DAMAGE``."""
    seed, want = LAYERED_DAMAGE[kind]
    rng = np.random.default_rng(seed)
    data = open(os.path.join(DATA, "layered_l3_s0_quarter.avif"), "rb").read()
    obus = _payload(data)
    start = data.index(obus)
    heads = []
    for end in [0] + frame_ends(obus)[:-1]:
        heads += range(start + end, start + end + 24)
    path = tmp_path / "d.avif"
    queued = {}
    for _ in range(300):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            i = int(rng.choice(heads)) if kind == "headers" else int(
                rng.integers(start, len(d)))
            if rng.integers(0, 2):
                d[i] = int(rng.integers(0, 256))
            else:
                d[i] ^= 1 << int(rng.integers(0, 8))
        path.write_bytes(bytes(d))
        for anydepth in (False, True):
            try:
                ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                                 else cv2.IMREAD_COLOR)
            except cv2.error:
                ref = None
            try:
                got = image_io.imread(str(path), anydepth=anydepth)
            except NotImplementedError as e:
                feature = next((q for q in QUEUED if q in str(e)), None)
                assert feature, str(e)
                key = (feature, ref is not None)
                queued[key] = queued.get(key, 0) + 1
                continue
            except ValueError as e:
                assert ref is None, str(e)
                continue
            assert ref is not None
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert got.tobytes() == ref.tobytes()
    assert queued == want
