"""The port's AVIF reader (lgu_slam_tpu_torch/data/avif.py over the AV1
intra decoder csrc/host/av1_decode.c) against OpenCV's (libavif 1.4.2 over
libaom): lossless files of libaom at every speed, 8 to 12 bits, colour and
gray, odd sizes, screen content (palettes, intra block copy), tiles,
alpha, Pillow's and the port's writer's files read bit for bit in both read
modes; cut and damaged files raise ValueError where cv2 returns None; what
OpenCV reads and the port does not yet read raises NotImplementedError
naming it.  Lossy files: tests/test_torch_avif_lossy.py."""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif, image_io

DATA = os.path.join(os.path.dirname(__file__), "data", "avif")
sys.path.insert(0, os.path.join(os.path.dirname(DATA), "..", "..",
                                "scripts"))
from make_avif_fixtures_torch import encode_grid, two_frames  # noqa: E402


def _cv2_avif(path, img, quality=100, speed=6, depth=None):
    params = [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_SPEED,
              speed]
    if depth:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    assert cv2.imwrite(str(path), img, params)
    return path


def _scene(rng, H, W):
    """A smooth image with edges and noise: every intra predictor has
    work."""
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([np.sin(x / (5.0 + c)) * 60 + np.cos(y / (4.0 + c)) * 50
                     + 120 + ((x // 9 + y // 7) % 2) * 30 for c in range(3)],
                    -1)
    return np.clip(base + rng.normal(0, 4, base.shape), 0,
                   255).astype(np.uint8)


def test_committed_fixtures_decode_to_cv2_hashes():
    """tests/data/avif (scripts/make_avif_fixtures_torch.py): cv2.imwrite's
    lossless files at speeds 0-9, 8 / 10 / 12-bit colour and gray, odd
    sizes, screen content (palettes, intra block copy), alpha, Pillow's
    4:0:0 gray with and without tiles, the port's writer's files, a damaged
    and a cut file, cv2's lossy files (48 x 64 at quality 90, 480 x 640
    frames at 95, 50 and 10-bit 80, frames using loop restoration: 480 x
    640 at speed 2, qualities 30 and 60, 48 x 64 at speed 0), Pillow's
    4:4:4 under BT.601, 4:2:2 and limited-range 4:2:0, the writer's 4:2:0
    under BT.709, film grain (Pillow's and the writer's), grids, Pillow's
    avis sequence, frames scaled to their ispe, slice 23's (Pillow's
    lossless and lossy screen content with intra block copy, cv2's lossy
    text pages, the writer's segmentation, superres and items of several
    frames, two AV1 frames in one item), slice 24's layered items
    (libavif's progressive layers: AV1 inter frames): the port's arrays
    hash as cv2.imread's do in both read modes (the hashes written beside
    them, which chip_smoke.py phases 19 to 24 check on machines without
    OpenCV),
    or both refuse (null: ValueError); a queued file (none now) is read by
    cv2 and raises NotImplementedError naming its feature."""
    hashes = json.load(open(os.path.join(DATA, "hashes.json")))
    assert len(hashes) == 83
    for name, want in hashes.items():
        path = os.path.join(DATA, name)
        for mode, flag in (("color", cv2.IMREAD_COLOR),
                           ("anydepth", cv2.IMREAD_ANYDEPTH)):
            ref = cv2.imread(path, flag)
            if want.get("queued"):
                assert ref is not None
                with pytest.raises(NotImplementedError,
                                   match=want["queued"]):
                    image_io.imread(path, anydepth=mode == "anydepth")
                continue
            if want[mode] is None:
                assert ref is None
                with pytest.raises(ValueError):
                    image_io.imread(path, anydepth=mode == "anydepth")
                continue
            got = image_io.imread(path, anydepth=mode == "anydepth")
            for a in (got, ref):
                assert hashlib.sha256(a.tobytes()).hexdigest() == \
                    want[mode]["sha256"], (name, mode)
                assert list(a.shape) == want[mode]["shape"]
                assert str(a.dtype) == want[mode]["dtype"]


@pytest.mark.parametrize("speed", range(11))
def test_cv2_lossless_files_at_every_speed(speed, tmp_path):
    """cv2.imwrite at IMWRITE_AVIF_QUALITY 100 and each speed (libaom picks
    other partitions, modes and tools: filter intra, CfL, palettes,
    directional modes with angle deltas and the edge filter's upsampling,
    128 x 128 superblocks at speed 0): 8-bit colour and gray, 10- and
    12-bit colour and gray, odd and even sizes, equal to cv2.imread in
    both read modes."""
    rng = np.random.default_rng(speed)
    img = _scene(rng, 37 + speed, 45 + 2 * speed)
    cases = {"c8": img, "g8": img[..., 1].copy(),
             "c10": img.astype(np.uint16) * 4 + 3,
             "g12": img[..., 0].astype(np.uint16) * 16 + 9}
    for name, a in cases.items():
        depth = int(name[1:])
        path = _cv2_avif(tmp_path / f"{name}.avif", a, speed=speed,
                         depth=depth if depth > 8 else None)
        same_as_cv2(path)


def test_depth_conversions_follow_libavif(tmp_path):
    """Every 10- and 12-bit sample value, gray and colour: the colour read
    of a 4:0:0 file is rint(v / 2^(depth - 8)) (round half to even), of a
    4:4:4 identity file rint(float32(v) * float32(255 / max)); IMREAD_ANYDEPTH
    keeps gray as stored and takes cvtColor's 15-bit gray of colour."""
    for depth in (10, 12):
        n = 1 << depth
        v = np.arange(n, dtype=np.uint16).reshape(-1, 64)
        path = _cv2_avif(tmp_path / f"g{depth}.avif", v, depth=depth)
        same_as_cv2(path)
        got = image_io.imread(str(path))[..., 0]
        np.testing.assert_array_equal(got, np.clip(np.rint(
            v / float(1 << (depth - 8))), 0, 255))
        c = np.stack([v, v[::-1], (v * 7) % n], -1).astype(np.uint16)
        path = _cv2_avif(tmp_path / f"c{depth}.avif", c, depth=depth)
        same_as_cv2(path)
        scale = np.float32(255 / (n - 1))
        np.testing.assert_array_equal(
            image_io.imread(str(path)),
            np.clip(np.rint(c.astype(np.float32) * scale), 0, 255))


def test_screen_content_and_tiles(tmp_path):
    """Flat text-like frames push libaom into palettes (colour cache,
    wavefront index map) and intra block copy; Pillow writes 2 x 2 tiles
    of 4:0:0 gray: each equal to cv2.imread."""
    from PIL import Image

    rng = np.random.default_rng(8)
    img = np.full((128, 192, 3), 235, np.uint8)
    for y in range(14, 128, 20):
        for x in range(0, 150, 48):
            cv2.putText(img, "LGU", (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        tuple(int(c) for c in rng.integers(0, 120, 3)), 1)
    for speed in (1, 2, 4):
        same_as_cv2(_cv2_avif(tmp_path / f"t{speed}.avif", img, speed=speed))
        same_as_cv2(_cv2_avif(tmp_path / f"tg{speed}.avif",
                              img[..., 0].copy(), speed=speed))
    gray = _scene(rng, 150, 260)[..., 1]
    Image.fromarray(gray).save(tmp_path / "tiles.avif", quality=100,
                               subsampling="4:0:0", tile_rows=1, tile_cols=1)
    same_as_cv2(tmp_path / "tiles.avif")


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_writer_files_read_back_through_cv2(depth, tmp_path):
    """The port's writer (avif.encode_avif: lossless colour at 4:4:4 under
    the identity matrix, gray at 4:0:0, an alpha item): cv2.imread gives
    back the input exactly (IMREAD_UNCHANGED), and the port reads each
    file as cv2 does in both modes."""
    rng = np.random.default_rng(depth)
    img = _scene(rng, 29, 43)
    if depth > 8:
        img = img.astype(np.uint16) * (1 << (depth - 8)) + 1
    for seed, (name, a, alpha) in enumerate((
            ("c", img, None), ("g", img[..., 2].copy(), None),
            ("ca", img, img[..., 0].copy()))):
        path = tmp_path / f"{name}.avif"
        path.write_bytes(avif.encode_avif(a, depth, seed, alpha=alpha))
        back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back[..., :3] if alpha is not None
                                      else back, a)
        same_as_cv2(path)


def test_cut_and_damaged_files(tmp_path):
    """Every cut of a writer file and of a cv2 file, and 150 copies each
    with one or two bits of their AV1 data flipped (the decoder's trailing
    bit check after each tile, as libaom's): ValueError exactly where
    cv2.imread returns None, else cv2's array."""
    rng = np.random.default_rng(4)
    img = _scene(rng, 20, 28)
    sources = [avif.encode_avif(img, 8, 5),
               _cv2_avif(tmp_path / "c.avif", img).read_bytes()]
    path = tmp_path / "d.avif"
    for data in sources:
        for k in range(0, len(data), 7):
            path.write_bytes(data[:k])
            same_as_cv2(path)
        start = data.index(b"mdat") + 4
        for _ in range(150):
            d = bytearray(data)
            for _ in range(int(rng.integers(1, 3))):
                i = int(rng.integers(start + 16, len(d)))
                d[i] ^= 1 << int(rng.integers(0, 8))
            path.write_bytes(bytes(d))
            same_as_cv2(path)


# what the port refuses with NotImplementedError where cv2.imread reads
# (or fails on what the port does not decode): the AV1 tools of inter
# frames no layered item here uses, each queued in ROADMAP.md A item 1
# (compound prediction, skip mode, switch frames, short reference
# signalling, a reference replaced by its order hint, a frame size taken
# from a reference, segmentation of an inter frame, film grain of a
# reference frame, a reference frame other than LAST, a block predicted
# from a reference with global motion, dual interpolation filters, a
# vector candidate of the extra search, a wedge inter-intra block with
# 4:2:2 chroma: these raised once a decode libaom's checks pass has
# ended), and two guards: a frame of more samples than its image and than
# avif.SCALED_PIXELS (against a damaged header) and the 8-bit frame under
# a deeper av1C, where OpenCV reads uninitialised memory
QUEUED = ("an AV1 compound prediction", "an AV1 skip mode",
          "an AV1 switch frame", "AV1 frame_refs_short_signaling",
          "an AV1 reference frame replaced", "an AV1 frame size taken from",
          "an AV1 segmentation of an inter", "an AV1 film grain of a ref",
          "an AV1 reference frame other", "with global motion",
          "an AV1 dual interpolation filter", "of the extra search",
          "an AV1 wedge inter-intra block with 4:2:2",
          "a frame larger than its",
          "an 8-bit frame under a deeper")


def _damage_base(kind):
    img = _scene(np.random.default_rng(9), 24, 36)
    if kind == "alpha":
        return avif.encode_avif(img, 8, 0, alpha=img[..., 1].copy())
    if kind == "gray12":
        return avif.encode_avif(img[..., 1].astype(np.uint16) * 16, 12, 0)
    return open(os.path.join(DATA, "cv2_c10_37x53.avif"), "rb").read()


# kind: (rng seed, {(feature, cv2 reads): reads}) as measured with OpenCV
# 5.0.0 (libavif 1.4.2, libaom 3.14.1)
DAMAGE = {"alpha": (9, {}), "gray12": (10, {}), "cv2": (11, {})}


@pytest.mark.parametrize("kind", sorted(DAMAGE))
def test_container_damage(kind, tmp_path):
    """300 copies of a file (the writer's colour with alpha, its 12-bit
    gray, cv2.imwrite's 10-bit colour) with one or two of its box bytes
    (ftyp, meta and the AV1 sequence header) set at random, each read in
    both modes: where cv2.imread reads, the port returns its bytes; where
    cv2 returns None, the port raises ValueError.  The one other outcome
    is NotImplementedError naming a feature of ``QUEUED``; those reads are
    counted, and the counts are the ones measured (``DAMAGE``)."""
    seed, want = DAMAGE[kind]
    rng = np.random.default_rng(seed)
    data = _damage_base(kind)
    end = data.index(b"mdat") + 24
    path = tmp_path / "d.avif"
    queued = {}
    for _ in range(300):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            d[int(rng.integers(0, end))] = int(rng.integers(0, 256))
        path.write_bytes(bytes(d))
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


def test_frame_larger_than_its_image_is_not_decoded(tmp_path, monkeypatch):
    """A frame of more samples than its ispe (and than ``SCALED_PIXELS``,
    lowered here) is refused from its header alone, NotImplementedError
    (cv2 reads it, scaled by libavif), and never decoded; a sequence
    header patched to claim a 65536 x 65536 frame is refused as libaom
    refuses it (its frame header no longer parses: ValueError), from the
    headers alone."""
    img = _scene(np.random.default_rng(4), 64, 96)
    ispe = b"ispe" + bytes(4) + struct.pack(">II", 96, 64)
    data = avif.encode_avif(img, 8, 0).replace(
        ispe, b"ispe" + bytes(4) + struct.pack(">II", 36, 24))
    path = tmp_path / "scaled.avif"
    path.write_bytes(data)
    assert cv2.imread(str(path)).shape == (24, 36, 3)

    def no_decode(*args):
        raise AssertionError("decoded")

    monkeypatch.setattr(avif, "SCALED_PIXELS", 1000)
    monkeypatch.setattr(avif, "av1_planes", no_decode)
    for anydepth in (False, True):
        with pytest.raises(NotImplementedError, match="larger than its"):
            image_io.imread(str(path), anydepth=anydepth)
    # the writer's reduced header: 16-bit size fields, then both maxima
    huge = bytearray(avif.encode_avif(img[:24, :36], 8, 0))
    start = huge.index(b"mdat") + 4
    assert huge[start:start + 3] == b"\x0a\x0b\x3f"
    bits = "".join(f"{x:08b}" for x in huge[start + 2:start + 13])
    bits = bits[:16] + "1" * 32 + bits[48:]
    huge[start + 2:start + 13] = int(bits, 2).to_bytes(11, "big")
    with pytest.raises(ValueError, match="byte_alignment"):
        avif.decode_avif(bytes(huge))


def test_refusals_cv2_gives_none(tmp_path):
    """Files libavif and libaom read and cv2.imread still returns None
    for, ValueError in both modes: a gray (4:0:0) image with alpha
    (OpenCV's reader takes no two-channel image), a sequence header whose
    trailing bits are wrong, a frame OBU followed by a cut one."""
    img = _scene(np.random.default_rng(6), 24, 36)
    gray = img[..., 1].copy()
    data = avif.encode_avif(img, 8, 0)
    at = data.index(b"mdat") + 4
    assert data[at:at + 2] == b"\x0a\x0b"  # the writer's sequence header
    files = {"gray alpha": avif.encode_avif(gray, 8, 0, alpha=gray)}
    bad = bytearray(data)
    bad[at + 12] |= 1
    files["trailing bits"] = bytes(bad)
    # the colour item's extent taken 6 bytes into the alpha's OBUs
    two = avif.encode_avif(img, 8, 0, alpha=gray)
    n = len(avif.encode_av1(np.stack([img[..., 1], img[..., 0],
                                      img[..., 2]]), 8, 0))
    k = two.index(struct.pack(">I", n), two.index(b"iloc"))
    files["cut second OBU"] = two[:k] + struct.pack(">I", n + 6) + \
        two[k + 4:]
    for name, d in files.items():
        path = tmp_path / f"{name}.avif"
        path.write_bytes(d)
        assert cv2.imread(str(path)) is None, name
        same_as_cv2(path)


def _with_props(img, boxes, essential):
    return avif.encode_avif(img, 8, 0, extra_props=boxes,
                            essential=essential)


def test_transforms_are_not_applied(tmp_path):
    """irot, imir and clap marked essential: cv2.imread applies none of
    them (nor a clap libavif would find invalid); not marked essential,
    libavif refuses the file (ValueError)."""
    img = _scene(np.random.default_rng(1), 24, 36)
    boxes = [avif._box(b"irot", bytes([1])), avif._box(b"imir", bytes([1])),
             avif._box(b"clap", struct.pack(">8I", 20, 1, 16, 1, 0, 1, 0,
                                            1)),
             avif._box(b"clap", struct.pack(">8I", 100, 0, 16, 1, 0, 1, 0,
                                            1))]
    for k, box in enumerate(boxes):
        for essential in (True, False):
            path = tmp_path / f"{k}{essential}.avif"
            path.write_bytes(_with_props(img, [box], essential))
            same_as_cv2(path)
            if essential:
                np.testing.assert_array_equal(image_io.imread(str(path)),
                                              img)
            else:
                assert cv2.imread(str(path)) is None


def test_queued_files_raise_not_implemented(tmp_path):
    """Files of features this reader once refused, one for each feature
    an encoder here can write, read equal to cv2.imread in both modes:
    film grain (Pillow, libaom's grain test vectors), an avis sequence
    (Pillow, two frames: the first), a 1 x 2 grid of the writer's 64 x 64
    images (MIAF's least tile size, no colr), equal to the image it was
    cut from, and an item of two AV1 frames (cv2 shows the second).
    Files of
    features read before: a cv2.imwrite frame at speed 0 that uses loop
    restoration, 4:2:2 (Pillow), colour under BT.709 (the writer's file,
    its colr changed), limited-range colour and gray (Pillow; OpenCV
    copies a 4:0:0 image's Y as stored, whatever its
    range)."""
    from PIL import Image

    img = _scene(np.random.default_rng(2), 40, 56)
    rgb = Image.fromarray(img[..., ::-1].copy())
    _cv2_avif(tmp_path / "r.avif", _scene(np.random.default_rng(50), 48, 64),
              50, 0)
    rgb.save(tmp_path / "422.avif", quality=60, subsampling="4:2:2")
    bt709 = avif.encode_avif(img, subsampling="4:2:0").replace(
        b"nclx" + bytes([0, 1, 0, 13, 0, 6]), b"nclx" + bytes([0, 1, 0, 1,
                                                                0, 1]))
    (tmp_path / "709.avif").write_bytes(bt709)
    rgb.save(tmp_path / "lc.avif", quality=60, range="limited")
    Image.fromarray(img[..., 1].copy()).save(
        tmp_path / "lim.avif", quality=100, subsampling="4:0:0",
        range="limited")
    rgb.save(tmp_path / "g.avif", quality=50,
             advanced=[("film-grain-test", "1")])
    rgb.save(tmp_path / "s.avif", save_all=True, quality=100,
             append_images=[Image.fromarray(255 - img)])
    for name in ("r", "422", "709", "lc", "lim", "g", "s"):
        assert cv2.imread(str(tmp_path / f"{name}.avif")) is not None
        same_as_cv2(tmp_path / f"{name}.avif")
    big = _scene(np.random.default_rng(2), 64, 128)
    (tmp_path / "grid.avif").write_bytes(encode_grid(
        [big[:, :64], big[:, 64:]], 2, nclx=False))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "grid.avif")),
                                  big)
    same_as_cv2(tmp_path / "grid.avif")
    (tmp_path / "two.avif").write_bytes(two_frames(img))
    assert cv2.imread(str(tmp_path / "two.avif")) is not None
    same_as_cv2(tmp_path / "two.avif")


def test_alpha_items(tmp_path):
    """An alpha item (cv2.imwrite of BGRA, the writer's) is decoded and
    dropped; one whose AV1 data is damaged fails the read as it fails
    cv2's (ValueError / None)."""
    img = _scene(np.random.default_rng(3), 24, 36)
    bgra = np.concatenate([img, img[..., :1]], -1)
    same_as_cv2(_cv2_avif(tmp_path / "a.avif", bgra))
    data = bytearray(avif.encode_avif(img, 8, 0, alpha=img[..., 2].copy()))
    (tmp_path / "w.avif").write_bytes(bytes(data))
    same_as_cv2(tmp_path / "w.avif")
    data[-20] ^= 0xFF
    data[-5] ^= 0x55
    (tmp_path / "b.avif").write_bytes(bytes(data))
    assert cv2.imread(str(tmp_path / "b.avif")) is None
    same_as_cv2(tmp_path / "b.avif")
