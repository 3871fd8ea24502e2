"""The port's reader of lossy AVIF (lgu_slam_tpu_torch/data/avif.py over
csrc/host/av1_decode.c: AV1 transforms of every size and type, quantiser
matrices, delta q, 4:2:0 chroma, deblocking, CDEF, libavif's BT.601 YUV to
RGB) against OpenCV's (libavif 1.4.2 over libaom 3.14): cv2.imwrite's
files at every quality and at speeds 5-10 (and 0-4 where the frame uses no
loop restoration), 8 to 12 bits, gray, colour and alpha, odd sizes, a
natural scene, Pillow's 4:2:0 lossless, 4:4:4 and tiled files, and the
port's lossy writer's, read bit for bit in both read modes; every sample
value through each of libavif's YUV to RGB paths; damaged lossy files
refused exactly where cv2.imread returns None."""

import cv2
import numpy as np
import pytest
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif, image_io


def _cv2_avif(path, img, quality, speed=None, depth=None):
    params = [cv2.IMWRITE_AVIF_QUALITY, quality]
    if speed is not None:
        params += [cv2.IMWRITE_AVIF_SPEED, speed]
    if depth:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    assert cv2.imwrite(str(path), img, params)
    return path


def _scene(rng, H, W):
    """Sines, a checker and noise."""
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([np.sin(x / (5.0 + c)) * 60 + np.cos(y / (4.0 + c)) * 50
                     + 120 + ((x // 9 + y // 7) % 2) * 30 for c in range(3)],
                    -1)
    return np.clip(base + rng.normal(0, 4, base.shape), 0,
                   255).astype(np.uint8)


def _natural(rng, H, W):
    """Overlapping discs of flat colour over a slanted wave and noise: the
    edges and flat areas of a photograph, which make libaom pick its
    transform sizes per block and several CDEF strengths."""
    img = np.zeros((H, W, 3))
    y, x = np.mgrid[0:H, 0:W]
    for _ in range(12):
        cy, cx, r = rng.uniform(0, H), rng.uniform(0, W), rng.uniform(10, 80)
        m = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[m] = img[m] * 0.3 + rng.uniform(0, 255, 3) * 0.7
    img += 20 * np.sin(x / 3.0 + y / 7.0)[..., None]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _header(path):
    data = open(str(path), "rb").read()
    box = avif.parse(data)
    return avif.av1_info(avif._payload(data, box, box["color"]))


@pytest.mark.parametrize("quality", [0, 10, 30, 50, 80, 90, 95, 99])
def test_cv2_lossy_files_at_every_quality(quality, tmp_path):
    """cv2.imwrite at a quality and speeds 5-10, 8-bit colour (4:2:0 under
    BT.601, quantiser matrices, delta q, deblocking and CDEF as libaom
    picks them), and at speed 6 8-bit gray, 10-bit colour, 12-bit gray and
    colour: equal to cv2.imread in both read modes."""
    rng = np.random.default_rng(quality)
    img = _scene(rng, 48, 64)
    for speed in range(5, 11):
        same_as_cv2(_cv2_avif(tmp_path / f"s{speed}.avif", img, quality,
                              speed))
    cases = {"g8": (img[..., 1].copy(), None),
             "c10": (img.astype(np.uint16) * 4 + 1, 10),
             "g12": (img[..., 0].astype(np.uint16) * 16 + 5, 12),
             "c12": (img.astype(np.uint16) * 16 + 9, 12)}
    for name, (a, depth) in cases.items():
        path = _cv2_avif(tmp_path / f"{name}.avif", a, quality, 6, depth)
        same_as_cv2(path)
        assert _header(path)["base_q"] > 0 or quality > 95


@pytest.mark.parametrize("speed", range(5))
def test_cv2_slow_speeds_read_with_loop_restoration(speed, tmp_path):
    """cv2.imwrite at speeds 0-4, where libaom restores the loop: every
    frame reads equal to cv2.imread in both modes, those that restore
    too (a self-guided unit at quality 80 at speeds 0-3; none of these
    frames restores at speed 4, tests/test_torch_avif_lr.py's do)."""
    restored = 0
    for k, quality in enumerate((20, 50, 80)):
        img = _natural(np.random.default_rng(10 * speed + k), 64, 96)
        path = _cv2_avif(tmp_path / f"q{quality}.avif", img, quality, speed)
        same_as_cv2(path)
        data = path.read_bytes()
        box = avif.parse(data)
        counts = avif.lr_stats(avif._payload(data, box, box["color"]))[0]
        restored += int(counts[:, 1:].sum())
    assert restored == (speed < 4)


def test_cv2_lossy_alpha_odd_sizes_and_deep_gray(tmp_path):
    """Lossy BGRA at 8, 10 and 12 bits (a lossy 4:0:0 alpha item, decoded
    and dropped), odd sizes (37 x 53, 45 x 61, 1 x 1, 3 x 17: half chroma
    blocks at the right and bottom edges), gray of odd size at 10 bits:
    equal to cv2.imread in both modes."""
    rng = np.random.default_rng(7)
    img = _natural(rng, 64, 96)
    for depth in (8, 10, 12):
        bgra = np.concatenate([img, img[..., :1] // 2 + 60], -1)
        if depth > 8:
            bgra = bgra.astype(np.uint16) << (depth - 8)
        same_as_cv2(_cv2_avif(tmp_path / f"a{depth}.avif", bgra, 60, 6,
                              depth if depth > 8 else None))
    for H, W in ((37, 53), (45, 61), (1, 1), (3, 17)):
        for quality in (20, 70):
            same_as_cv2(_cv2_avif(tmp_path / f"{H}x{W}.avif", img[:H, :W],
                                  quality, 7))
    same_as_cv2(_cv2_avif(tmp_path / "g10.avif", img[:37, :53, 2].astype(
        np.uint16) * 4, 40, 6, 10))


def test_natural_scene_transform_sizes_and_cdef_sets(tmp_path):
    """A 240 x 320 natural scene at speeds 5-8 and three qualities: libaom
    selects transform sizes per block (tx_mode_select) and two or more
    CDEF strengths; each file reads equal to cv2.imread in both modes."""
    img = _natural(np.random.default_rng(3), 240, 320)
    tools = set()
    for speed in (5, 8):
        for quality in (30, 60, 85):
            path = _cv2_avif(tmp_path / f"n{speed}_{quality}.avif", img,
                             quality, speed)
            info = _header(path)
            tools.add((info["tx_mode_select"], info["cdef_bits"] > 0))
            same_as_cv2(path)
    assert (1, True) in tools


def test_pillow_420_lossless_444_and_tiles(tmp_path):
    """Pillow's (its own libavif and libaom): lossless 4:2:0 (its default
    subsampling), lossless and lossy 4:4:4 under BT.601, lossy 4:2:0 in 2
    x 2 tiles: equal to cv2.imread in both modes."""
    from PIL import Image

    img = _natural(np.random.default_rng(11), 160, 256)
    rgb = Image.fromarray(img[..., ::-1].copy())
    for name, kw in {"420": dict(quality=100),
                     "444": dict(quality=100, subsampling="4:4:4"),
                     "444q": dict(quality=60, subsampling="4:4:4"),
                     "tiles": dict(quality=50, tile_rows=1, tile_cols=1)
                     }.items():
        rgb.save(tmp_path / f"{name}.avif", **kw)
        same_as_cv2(tmp_path / f"{name}.avif")


def _colr_bt601(data: bytes) -> bytes:
    """The writer's identity 4:4:4 file relabelled BT.601 (libavif takes
    the colr box's matrix over the sequence header's)."""
    old = b"nclx" + bytes([0, 2, 0, 2, 0, 0, 0x80])
    assert old in data
    return data.replace(old, b"nclx" + bytes([0, 1, 0, 13, 0, 6, 0x80]))


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("chroma", ["444", "420"])
def test_yuv_to_rgb_every_sample_value(depth, chroma, alpha, tmp_path):
    """Lossless files of the writer whose Y, U and V each take every sample
    value of their depth (Y down the rows, U and V across, V in another
    order), with and without an alpha item (OpenCV then asks libavif for
    BGRA, which takes other libyuv paths at 10 and 12 bits): libavif's
    paths through cv2.imread, colour read (libyuv at 8 bits, of samples
    shifted to 8 bits, or at 10 / 12 bits; bilinear or repeated 4:2:0
    chroma) and IMREAD_ANYDEPTH (libavif's float32 conversion at the
    samples' depth, then cvtColor's gray), equal bit for bit.  Odd sizes
    put the upsampling's edge rules to work."""
    n = 1 << depth
    side = 64 if depth == 8 else 128
    H, W = side + 1, side + 3
    k = np.arange(H * W).reshape(H, W)
    Y = (k % n).astype(np.uint16)
    dtype = np.uint8 if depth == 8 else np.uint16
    a = ((k * 3) % n).astype(dtype) if alpha else None
    if chroma == "444":
        U = ((k // 3) % n).astype(np.uint16)
        V = ((k * 7 + 3) % n).astype(np.uint16)
        img = np.stack([U, Y, V], -1).astype(dtype)
        data = _colr_bt601(avif.encode_avif(img, depth, alpha=a))
    else:
        c = np.arange(((H + 1) // 2) * ((W + 1) // 2)).reshape(
            (H + 1) // 2, (W + 1) // 2)
        U = (c % n).astype(np.uint16)
        V = ((c * 5 + 1) % n).astype(np.uint16)
        data = _with_planes(H, W, depth, [Y, U, V], a)
    path = tmp_path / "p.avif"
    path.write_bytes(data)
    same_as_cv2(path)


def _with_planes(H, W, depth, planes, alpha=None) -> bytes:
    """A lossless 4:2:0 AVIF file holding ``planes`` exactly (and
    ``alpha``): the writer's container around its OBUs of these planes."""
    import struct

    zero = np.zeros((H, W, 3), np.uint8 if depth == 8 else np.uint16)
    data = avif.encode_avif(zero, depth, subsampling="4:2:0", alpha=alpha)
    old = avif.encode_av1(avif.yuv420(zero, depth), depth, 0, True)
    new = avif.encode_av1(planes, depth, 0, True)
    at = data.index(old)
    data = data[:at] + new + data[at + len(old):]
    k = data.index(struct.pack(">I", len(old)), data.index(b"iloc"))
    data = data[:k] + struct.pack(">I", len(new)) + data[k + 4:]
    m = data.index(b"mdat") - 4
    return data[:m] + struct.pack(">I", len(data) - m) + data[m + 4:]


# restoration units for the writer: the Wiener taps at their least, most
# and middle values (the outer tap first; the vertical pass, then the
# horizontal), self-guided sets with xqd at the ends of their ranges
LR_WIENER_MIN = ("wiener", (-5, -23, -17), (-5, -23, -17))
LR_WIENER_MAX = ("wiener", (10, 8, 46), (10, 8, 46))
LR_WIENER_MID = ("wiener", (3, -7, 15), (-5, 8, 46))
LR_SGR = [("sgrproj", k, ((-96, 95), (31, -32), (0, 0), (-32, 31))[k % 4])
          for k in range(16)]

WRITER = {
    "q60 16": dict(depth=8, lossy=dict(base_q=60, qm=8, block=16,
                                       lf=(8, 8, 4, 4), cdef_damping=4,
                                       cdef=[(2, 1, 1, 0), (4, 2, 2, 1)])),
    "q200 32 sharp": dict(depth=8, lossy=dict(
        base_q=200, qm=15, block=32, lf=(40, 30, 63, 12), sharpness=7,
        cdef_damping=6, cdef=[(15, 4, 15, 4), (0, 0, 0, 0), (7, 2, 3, 1),
                              (1, 4, 9, 0)])),
    "q1 8": dict(depth=8, lossy=dict(base_q=1, qm=0, block=8,
                                     lf=(2, 0, 0, 1), sharpness=3)),
    "q120 8 cdef8": dict(depth=8, lossy=dict(
        base_q=120, qm=4, block=8, lf=(20, 20, 10, 10), sharpness=1,
        cdef_damping=3, cdef=[(k, k % 3, 15 - k, 4) for k in range(8)])),
    "10-bit": dict(depth=10, lossy=dict(base_q=90, qm=11, block=16,
                                        lf=(16, 12, 6, 6), sharpness=5,
                                        cdef_damping=5,
                                        cdef=[(6, 2, 3, 1)])),
    "12-bit": dict(depth=12, lossy=dict(base_q=30, qm=14, block=32,
                                        lf=(63, 63, 63, 63),
                                        cdef_damping=4,
                                        cdef=[(9, 4, 9, 4), (3, 1, 0, 2)])),
    "gray": dict(depth=8, gray=True, lossy=dict(
        base_q=150, qm=6, block=16, lf=(30, 10), sharpness=2,
        cdef_damping=5, cdef=[(5, 1, 0, 0), (10, 4, 0, 0)])),
    "lossless 4:2:0": dict(depth=10, subsampling="4:2:0"),
    "4:2:2 BT.709 limited": dict(depth=8, subsampling="4:2:2",
                                 colour=(1, 1, 1, 0), lossy=dict(
                                     base_q=80, qm=6, block=16,
                                     lf=(12, 12, 6, 6), cdef_damping=4,
                                     cdef=[(3, 1, 2, 1)])),
    "lossless 4:2:2 BT.2020": dict(depth=12, subsampling="4:2:2",
                                   colour=(9, 16, 9, 1)),
    "lr 64 switchable": dict(depth=8, size=(140, 200), lossy=dict(
        base_q=120, block=16, lf=(10, 10, 5, 5), cdef_damping=4,
        cdef=[(4, 1, 2, 1)], lr=dict(
            types=("switchable", "wiener", "sgrproj"), unit_shift=0,
            uv_shift=1, units=[[LR_WIENER_MIN, LR_SGR[0], ("none",),
                                LR_SGR[10], LR_WIENER_MAX, LR_SGR[14]],
                               [LR_WIENER_MAX, LR_WIENER_MIN],
                               [LR_SGR[5], ("none",), LR_SGR[15]]]))),
    "lr 10-bit 4:2:2 sb128": dict(depth=10, subsampling="4:2:2", sb128=True,
                                  size=(256, 1024), lossy=dict(
        base_q=90, block=32, lf=(20, 16, 8, 8), cdef_damping=5,
        cdef=[(6, 2, 3, 1), (0, 0, 0, 0)], lr=dict(
            types=("sgrproj", "switchable", "wiener"), unit_shift=1,
            units=[[LR_SGR[k] for k in range(16)],
                   [("none",), LR_SGR[11], LR_WIENER_MIN],
                   [LR_WIENER_MAX, LR_WIENER_MIN]]))),
    "lr 12-bit": dict(depth=12, size=(260, 260), lossy=dict(
        base_q=60, block=8, lf=(30, 30, 15, 15), cdef_damping=3,
        cdef=[(9, 4, 9, 4)], lr=dict(
            types=("wiener", "sgrproj", "switchable"), unit_shift=0,
            units=[[LR_WIENER_MIN, LR_WIENER_MAX, LR_WIENER_MID],
                   [LR_SGR[k] for k in (13, 2, 14, 7)],
                   [LR_WIENER_MAX, LR_SGR[12], ("none",)]]))),
    "lr 12-bit sb128 uv": dict(depth=12, sb128=True, size=(260, 390),
                               lossy=dict(
        base_q=200, block=16, lf=(40, 40, 20, 20), cdef_damping=6,
        cdef=[(15, 4, 15, 4)], lr=dict(
            types=("switchable", "switchable", "switchable"), unit_shift=1,
            uv_shift=1, units=[[LR_SGR[3], LR_WIENER_MAX, ("none",)],
                               [LR_SGR[8], LR_WIENER_MIN],
                               [LR_WIENER_MID, LR_SGR[15]]]))),
    "lr gray": dict(depth=10, gray=True, size=(256, 600), lossy=dict(
        base_q=150, block=16, lf=(30, 10), cdef_damping=5,
        cdef=[(5, 1, 0, 0)], lr=dict(
            types=("wiener", "none", "none"), unit_shift=2,
            units=[[LR_WIENER_MAX, LR_WIENER_MIN]]))),
}


@pytest.mark.parametrize("name", list(WRITER))
def test_writer_lossy_files_read_back_through_cv2(name, tmp_path):
    """The port's writer (avif.encode_avif): lossy 4:2:0, 4:2:2 and gray at
    8 to 12 bits with quantiser matrices, every block size, deblocking
    levels up to 63 and sharpness up to 7, CDEF damping 3-6 and one to
    eight strengths, loop restoration of each type on each plane with
    units of 64 to 256 samples, lr_uv_shift, 128 x 128 superblocks, the
    Wiener taps and self-guided projections at the ends of their ranges
    (settings libaom's encoder never picks; restoration at 12 bits, which
    it never enables), lossless 4:2:0 and 4:2:2, BT.709 limited range and
    BT.2020: the port reads each equal to cv2.imread in both modes, its
    AV1 planes equal the writer's own reconstruction, and each unit type
    given is used."""
    case = WRITER[name]
    depth = case["depth"]
    img = _natural(np.random.default_rng(len(name)),
                   *case.get("size", (70, 98)))
    if case.get("gray"):
        img = img[..., 1].copy()
    if depth > 8:
        img = img.astype(np.uint16) << (depth - 8)
    data, rec = avif.encode_avif(img, depth, 3, lossy=case.get("lossy"),
                                 subsampling=case.get("subsampling"),
                                 recon=True, colour=case.get("colour"),
                                 sb128=case.get("sb128", False))
    path = tmp_path / "w.avif"
    path.write_bytes(data)
    same_as_cv2(path)
    box = avif.parse(data)
    obus = avif._payload(data, box, box["color"])
    planes = avif.av1_planes(obus)[0]
    assert len(planes) == len(rec)
    for a, b in zip(planes, rec):
        np.testing.assert_array_equal(a, b)
    if not case.get("lossy") and not case.get("gray") and \
            case.get("subsampling") == "4:2:0":
        np.testing.assert_array_equal(rec[0], avif.yuv420(img, depth)[0])
    lr = (case.get("lossy") or {}).get("lr")
    if lr:
        counts = avif.lr_stats(obus)[0]
        for p, units in enumerate(lr["units"]):
            for t in {avif.LR_TYPES[u[0]] for u in units}:
                assert counts[p, t], (p, t)


def _damaged(data: bytes, rng, start: int) -> bytes:
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 3))):
        i = int(rng.integers(start, len(d)))
        if rng.integers(0, 2):
            d[i] = int(rng.integers(0, 256))
        else:
            d[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(d)


# kind: (rng seed, {(feature, cv2 reads): reads}) as measured with OpenCV
# 5.0.0 (libavif 1.4.2, libaom 3.14.1)
DAMAGE = {"whole": (21, {}), "obus": (22, {}), "alpha": (23, {})}


@pytest.mark.parametrize("kind", sorted(DAMAGE))
def test_lossy_damage(kind, tmp_path):
    """300 copies of a lossy file with one or two bytes changed (``whole``:
    anywhere in cv2.imwrite's 4:2:0 file; ``obus``: in its AV1 data, where
    libaom checks each tile's trailing bits; ``alpha``: anywhere in a lossy
    BGRA file), each read in both modes: where cv2.imread reads, the port
    returns its bytes; where cv2 returns None, the port raises ValueError.
    The one other outcome is NotImplementedError naming a feature of
    test_torch_avif.QUEUED, counted against the counts measured
    (``DAMAGE``)."""
    from test_torch_avif import QUEUED

    seed, want = DAMAGE[kind]
    rng = np.random.default_rng(seed)
    img = _natural(np.random.default_rng(5), 48, 64)
    if kind == "alpha":
        img = np.concatenate([img, img[..., :1]], -1)
    data = _cv2_avif(tmp_path / "src.avif", img, 50, 6).read_bytes()
    start = data.index(b"mdat") + 4 if kind == "obus" else 0
    path = tmp_path / "d.avif"
    queued = {}
    for _ in range(300):
        path.write_bytes(_damaged(data, rng, start))
        for anydepth in (False, True):
            ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                             else cv2.IMREAD_COLOR)
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


# kind: (rng seed, {(feature, cv2 reads): reads}) as measured with OpenCV
# 5.0.0 (libavif 1.4.2, libaom 3.14.1)
LR_DAMAGE = {"whole": (31, {}), "obus": (32, {})}


@pytest.mark.parametrize("kind", sorted(LR_DAMAGE))
def test_restoration_damage(kind, tmp_path):
    """300 copies of a cv2 file whose frame restores every plane with
    Wiener units, with one or two bytes changed (``whole``: anywhere;
    ``obus``: in its AV1 data, the restoration coefficients among them),
    each read in both modes: cv2's array where cv2.imread reads, ValueError
    where it returns None; NotImplementedError only for a feature of
    test_torch_avif.QUEUED, counted against ``LR_DAMAGE``."""
    from test_torch_avif import QUEUED
    from test_torch_avif_lr import _cv2_avif as cv2_avif, _tum, _used

    seed, want = LR_DAMAGE[kind]
    rng = np.random.default_rng(seed)
    src = cv2_avif(tmp_path / "src.avif", _tum(120, 160), 50, 4)
    assert _used(src) == {("luma", "wiener"), ("chroma", "wiener")}
    data = src.read_bytes()
    start = data.index(b"mdat") + 4 if kind == "obus" else 0
    path = tmp_path / "d.avif"
    queued = {}
    for _ in range(300):
        path.write_bytes(_damaged(data, rng, start))
        for anydepth in (False, True):
            ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                             else cv2.IMREAD_COLOR)
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


def test_cut_lossy_files(tmp_path):
    """Every cut of a lossy 4:2:0 file of cv2 (every 5th byte) and of the
    writer's: ValueError exactly where cv2.imread returns None."""
    img = _natural(np.random.default_rng(8), 40, 56)
    sources = [_cv2_avif(tmp_path / "c.avif", img, 40, 8).read_bytes(),
               avif.encode_avif(img, lossy=WRITER["q60 16"]["lossy"])]
    path = tmp_path / "cut.avif"
    for data in sources:
        for k in range(0, len(data), 5):
            path.write_bytes(data[:k])
            same_as_cv2(path)
