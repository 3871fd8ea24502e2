"""The AV1 tools of slice 23 in the port's AVIF reader, against OpenCV's
(libavif 1.4.2 over libaom 3.14.1) in both read modes: intra block copy in
lossless 4:2:0 / 4:2:2 frames (its half-sample chroma and 4 x 4 chroma
blocks) and in lossy frames (the variable transform partition and the
inter transform sets), segmentation, superres and items of several intra
frames; damaged files of each kind raise ValueError where cv2.imread
returns None."""

import os
import sys

import cv2
import numpy as np
import pytest
from test_torch_avif import DATA, QUEUED, _scene
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif, image_io

sys.path.insert(0, os.path.join(os.path.dirname(DATA), "..", "..",
                                "scripts"))
from make_avif_fixtures_torch import (  # noqa: E402
    av1_frame,
    av1_item,
    cv2_file,
    gbr,
    pillow_file,
    repeated_text,
    text_page,
    two_colour,
)


def _file(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("sub", ["420", "422"])
def test_lossless_subsampled_intra_block_copy(sub):
    """C7: Pillow's lossless screen content at 4:2:0 and 4:2:2 (speed 2):
    its intra block copy vectors of odd luma samples predict chroma at
    half samples (libaom's bilinear filter) and 4 x 4 luma blocks take a 4
    x 4 chroma block; the port reads both equal to cv2.imread."""
    same_as_cv2(os.path.join(DATA, f"pillow_screen_c{sub}_s2.avif"))


@pytest.mark.parametrize("quality", [50, 80, 95])
@pytest.mark.parametrize("speed", [0, 2, 4])
def test_cv2_lossy_intra_block_copy(quality, speed, tmp_path):
    """cv2.imwrite of rows of a repeated word (gray, and as two-colour
    BGR) at three qualities and speeds: libaom codes its glyphs with lossy
    intra block copy; the port reads each equal to cv2.imread."""
    text = repeated_text(128, 192, 20)
    for kind, img in (("g", text), ("c", two_colour(text))):
        same_as_cv2(_file(tmp_path, f"{kind}.avif",
                          cv2_file(img, quality=quality, speed=speed)))


def test_lossy_intra_block_copy_of_other_encoders(tmp_path):
    """Text pages (intra block copy blocks with residuals, split
    transforms, the inter transform types) from Pillow's screen content
    tuning at 4:2:0, 4:2:2 and 4:4:4, qualities 90 and 60, and from
    cv2.imwrite at 10-bit colour and 12-bit gray: equal to cv2.imread."""
    page = text_page(192, 256, 2)
    rgb = two_colour(page)[..., ::-1].copy()
    for sub in ("4:2:0", "4:2:2", "4:4:4"):
        for q in (90, 60):
            same_as_cv2(_file(tmp_path, f"p{sub[-1]}{q}.avif", pillow_file(
                rgb, quality=q, subsampling=sub,
                advanced=[("tune-content", "screen")])))
    same_as_cv2(_file(tmp_path, "c10.avif", cv2_file(
        two_colour(page).astype(np.uint16) * 4 + 1, quality=95, speed=2,
        depth=10)))
    same_as_cv2(_file(tmp_path, "g12.avif", cv2_file(
        page.astype(np.uint16) * 16 + 3, quality=80, speed=2, depth=12)))


# the writer's intra block copy frames: (depth, subsampling, lossy)
INTRABC = {
    "lossless_444": (8, None, None),
    "lossless_420": (8, "4:2:0", None),
    "lossless_422_12": (12, "4:2:2", None),
    "lossy_420": (8, None, dict(base_q=80)),
    "lossy_422_12": (12, "4:2:2", dict(base_q=90, block=16)),
    "lossy_gray_12": (12, "gray", dict(base_q=60, block=8)),
    "lossy_444_10": (10, "4:4:4", dict(base_q=70, qm=4)),
    "lossy_segmented": (8, None, dict(base_q=80, segments=[
        dict(), dict(alt_q=-80)])),
}


@pytest.mark.parametrize("name", sorted(INTRABC))
def test_writer_intra_block_copy(name, tmp_path):
    """The writer's text pages with intra block copy (vectors up and left,
    odd ones among them: half chroma samples), lossless and lossy (the
    variable transform partition read, the inter transform sets), 8 to
    12 bits, 4:4:4, 4:2:2, 4:2:0 and gray, with a lossless segment: equal
    to cv2.imread, and the port's planes equal to the writer's
    reconstruction."""
    depth, sub, lossy = INTRABC[name]
    page = text_page(192, 384, 3)
    img = page if sub == "gray" else two_colour(page)
    if depth > 8:
        img = img.astype(np.uint16) << (depth - 8)
    data, rec = avif.encode_avif(img, depth, 5, lossy=lossy, recon=True,
                                 subsampling=None if sub == "gray" else sub,
                                 intrabc=True)
    same_as_cv2(_file(tmp_path, "w.avif", data))
    box = avif.parse(data)
    planes = avif.av1_planes(avif._payload(data, box, box["color"]))[0]
    for a, b in zip(planes, rec):
        np.testing.assert_array_equal(a, b)


LR = dict(types=("switchable", "sgrproj", "switchable"), unit_shift=0,
          units=[[("wiener", (1, -3, 8), (2, -5, 10)),
                  ("sgrproj", 5, (-10, 30))], [("sgrproj", 3, (-20, 40))],
                 [("none",), ("sgrproj", 10, (0, 50)),
                  ("wiener", (0, -2, 5), (0, 3, -7))]])
# the writer's segmented frames: (depth, subsampling or "gray", lossy)
SEGMENTS = {
    "alt_q": (8, None, dict(base_q=80, lf=(10, 12, 6, 5), segments=[
        dict(alt_q=-40), dict(alt_q=60), dict(alt_q=-80)])),
    "lossless_segment": (8, None, dict(base_q=60, lf=(8, 8, 4, 4), segments=[
        dict(), dict(alt_q=-60)])),
    "alt_lf": (8, None, dict(base_q=100, lf=(20, 20, 10, 10), segments=[
        dict(lf_y_v=-10, lf_u=5), dict(lf_y_h=30, lf_v=-63),
        dict(alt_q=10, lf_y_v=40)])),
    "skip_cdef_10": (10, None, dict(
        base_q=90, lf=(10, 10, 5, 5), cdef=[(4, 1, 2, 1), (8, 2, 0, 4)],
        cdef_damping=4, segments=[dict(alt_q=-30), dict(skip=True)])),
    "gray_12": (12, "gray", dict(base_q=70, lf=(10, 10, 0, 0), segments=[
        dict(alt_q=-70), dict(alt_q=40, lf_y_v=5), dict(lf_y_h=-5)])),
    "422_10": (10, "4:2:2", dict(base_q=50, lf=(6, 6, 3, 3), segments=[
        dict(alt_q=30), dict(alt_q=-50)])),
    "qm": (8, None, dict(base_q=100, qm=5, lf=(6, 6, 3, 3), segments=[
        dict(alt_q=-100), dict()])),
    "base_q_0": (8, None, dict(base_q=0, lf=(6, 6, 3, 3), segments=[
        dict(), dict(alt_q=90)])),
    "restoration": (8, None, dict(base_q=120, lf=(6, 6, 3, 3), segments=[
        dict(alt_q=-50), dict(alt_q=50)], lr=LR)),
    "444": (8, "4:4:4", dict(base_q=70, lf=(8, 8, 4, 4), segments=[
        dict(alt_q=-70), dict(alt_q=40), dict(lf_u=9)])),
    "444_lossless": (8, "4:4:4", dict(base_q=0, segments=[
        dict(lf_y_v=3), dict(), dict(lf_v=2)])),
}


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_segmentation(name, tmp_path):
    """The writer's segmented frames (alt q, a lossless segment in a lossy
    frame, alt loop filter levels, skip (SegIdPreSkip 1) and the others
    (0), 8 to 12 bits, 4:2:0, 4:2:2, 4:4:4 and gray, quantiser matrices,
    restoration): equal to cv2.imread, and the port's planes equal to the
    writer's reconstruction."""
    depth, sub, lossy = SEGMENTS[name]
    img = _scene(np.random.default_rng(5), 72, 100)
    img = img[..., 1].copy() if sub == "gray" else img
    if depth > 8:
        img = img.astype(np.uint16) << (depth - 8)
    data, rec = avif.encode_avif(img, depth, 3, lossy=lossy, recon=True,
                                 subsampling=None if sub == "gray" else sub)
    same_as_cv2(_file(tmp_path, "s.avif", data))
    box = avif.parse(data)
    planes = avif.av1_planes(avif._payload(data, box, box["color"]))[0]
    for a, b in zip(planes, rec):
        np.testing.assert_array_equal(a, b)


# the writer's superres frames: (width, depth, subsampling or "gray",
# SuperresDenom, tile_cols_log2, lossy); 16 or fewer samples wide, a frame
# is coded at its width (libaom's clamp)
SUPERRES = {
    "d9": (200, 8, None, 9, 0, dict(base_q=80, lf=(10, 10, 5, 5))),
    "d16": (200, 8, None, 16, 0, dict(base_q=80, lf=(10, 10, 5, 5))),
    "d12_restoration_tiles": (200, 8, None, 12, 1, dict(
        base_q=90, lf=(8, 8, 4, 4), cdef=[(4, 1, 2, 1), (8, 2, 0, 4)],
        lr=LR)),
    "d13_gray_12": (200, 12, "gray", 13, 0, dict(
        base_q=70, lf=(6, 6, 0, 0), lr=dict(
            types=("sgrproj", "none", "none"), unit_shift=1,
            units=[[("sgrproj", 2, (-30, 60))]]))),
    "d10_422_10": (200, 10, "4:2:2", 10, 0, dict(base_q=60,
                                                 lf=(6, 6, 3, 3))),
    "d11_lossless_restoration": (200, 8, None, 11, 0, dict(base_q=0,
                                                            lr=LR)),
    "d15_sb128_tiles": (400, 8, None, 15, 1, dict(
        base_q=100, lf=(8, 8, 4, 4), lr=dict(LR, unit_shift=1))),
    "narrow_12": (12, 8, None, 9, 0, dict(base_q=70)),
    "narrow_16": (16, 8, None, 14, 0, dict(base_q=70, lf=(6, 6, 3, 3),
                                           lr=LR)),
    "narrow_20": (20, 8, None, 16, 0, dict(base_q=70, lr=LR)),
    "tiles_too_narrow": (200, 10, None, 16, 1, dict(base_q=90, lr=LR)),
    # screen content tools on (full headers): allow_intrabc is read where
    # the clamp leaves the frame at its width, and only there
    "narrow_16_screen_content": (16, 8, None, 14, 0, dict(base_q=70)),
    "d12_screen_content": (200, 8, None, 12, 0, dict(base_q=70)),
}


@pytest.mark.parametrize("name", sorted(SUPERRES))
def test_superres(name, tmp_path):
    """The writer's superres frames (denominators 9-16, 8 to 12 bits,
    4:2:0, 4:2:2 and gray, restoration over two tile columns, lossless,
    frames 16 or fewer samples wide, 128 x 128 superblocks, screen content
    tools on): equal to
    cv2.imread, or refused as cv2 refuses them (tile columns narrower than
    128 coded samples); the upscale is timed where the frame is
    scaled."""
    W, depth, sub, denom, tiles, lossy = SUPERRES[name]
    img = _scene(np.random.default_rng(7), 96, 200)
    img = np.concatenate([img, img], 1)[:, :W].copy()
    img = img[..., 1].copy() if sub == "gray" else img
    if depth > 8:
        img = img.astype(np.uint16) << (depth - 8)
    frame = dict(type="key", sct=True) if "screen" in name else None
    data = avif.encode_avif(img, depth, 3, lossy=lossy, sb128="sb128" in name,
                            subsampling=None if sub == "gray" else sub,
                            superres=denom, tile_cols_log2=tiles, frame=frame)
    path = _file(tmp_path, "s.avif", data)
    same_as_cv2(path)
    if name == "tiles_too_narrow":
        assert cv2.imread(str(path)) is None
        return
    box = avif.parse(data)
    ms = avif.superres_ms(avif._payload(data, box, box["color"]))
    coded = max((W * 8 + denom // 2) // denom, min(W, 16))
    assert (ms[1] > 0) == (coded != W) and ms[0] >= ms[1]


def _frames(kind):
    """(AV1 data, W, H, depth, mono, subsampling) of an item of several
    frames of ``kind``."""
    img = _scene(np.random.default_rng(8), 48, 64)
    img2 = _scene(np.random.default_rng(9), 48, 64)
    hidden = dict(type="key", show=False, showable=True, refresh=1)
    intra = dict(type="intra", refresh=2)
    se = avif.show_existing_obu
    key = av1_frame(gbr(img), sequence=True, frame=hidden)
    b = av1_frame(gbr(img2), 8, 1, frame=intra)
    c = av1_frame(gbr(img2), 8, 2, frame=dict(
        type="intra", show=False, showable=True, refresh=4))
    if kind.startswith("sizes"):
        big = _scene(np.random.default_rng(10), 96, 128)
        a = av1_frame(gbr(big), sequence=True, frame=dict(
            type="key", max_size=(128, 96)))
        d = av1_frame(gbr(img2), 8, 1, frame=dict(intra,
                                                   max_size=(128, 96)))
        return {"sizes_small_last": (a + d, 128, 96),
                "sizes_small_last_small_ispe": (a + d, 64, 48),
                "sizes_existing_shown_key": (a + d + se(0), 128, 96)}[
            kind] + (8, False, 0)
    if kind.startswith("grain"):
        yuv = avif.yuv_planes(img, 8, "4:2:0")
        g = av1_frame(yuv, subsampled=True, sequence=True, grain=3,
                      lossy=dict(base_q=60, lf=(6, 6, 3, 3)), frame=hidden)
        gi = av1_frame(avif.yuv_planes(img2, 8, "4:2:0"), 8, 1,
                       subsampled=True, lossy=dict(base_q=60), grain=7,
                       frame=intra)
        return {"grain_hidden_existing": g + se(0),
                "grain_two_shown": g + gi,
                "grain_two_existing": g + gi + se(0)}[kind], 64, 48, 8, \
            False, 1
    if kind.startswith("sequence"):
        y8 = [img[..., 1].astype(np.uint16)]
        y10 = [img2[..., 1].astype(np.uint16) << 2]
        a8 = av1_frame(y8, sequence=True, frame=dict(type="key"))
        a10 = av1_frame(y10, 10, sequence=True, frame=dict(type="key"))
        i10 = av1_frame(y10, 10, 1, sequence=True, frame=dict(intra,
                                                               refresh=1))
        data = {"sequence_changes": (a8 + a10, 8),
                "sequence_changes_10": (a8 + a10, 10),
                "sequence_same_twice": (a8 + av1_frame(
                    y8, 8, 1, sequence=True, frame=dict(type="key")), 8),
                "sequence_changes_intra": (a8 + i10, 10)}[kind]
        return data[0], 64, 48, data[1], True, 0
    data = {"two_keys": av1_frame(gbr(img), sequence=True,
                                  frame=dict(type="key")) +
            av1_frame(gbr(img2), 8, 1, frame=dict(type="key")),
            "hidden_key_intra": key + b,
            "hidden_key_intra_existing": key + b + se(0),
            "hidden_key_existing": key + se(0),
            "hidden_key_existing_twice": key + se(0) + se(0),
            "hidden_only": key,
            "existing_empty_slot": key + se(3),
            "intra_hidden_existing": key + b + c + se(2),
            "intra_shown_existing": key + b + se(1),
            "last_hidden": key + b + c,
            "intra_first": av1_frame(gbr(img2), 8, 1, sequence=True,
                                     frame=intra)}[kind]
    return data, 64, 48, 8, False, 0


FRAMES = ["two_keys", "hidden_key_intra", "hidden_key_intra_existing",
          "hidden_key_existing", "hidden_key_existing_twice", "hidden_only",
          "existing_empty_slot", "intra_hidden_existing",
          "intra_shown_existing", "last_hidden", "intra_first",
          "sizes_small_last", "sizes_small_last_small_ispe",
          "sizes_existing_shown_key", "grain_hidden_existing",
          "grain_two_shown", "grain_two_existing", "sequence_changes",
          "sequence_changes_10", "sequence_same_twice",
          "sequence_changes_intra"]
# the layouts cv2.imread returns None for (measured): no frame shown,
# show_existing_frame of an empty slot or of a frame not showable (a key
# frame shown once), a new sequence header before a frame that is not a
# key frame
REFUSED = {"hidden_only", "existing_empty_slot", "hidden_key_existing_twice",
           "sizes_existing_shown_key", "sequence_changes_intra"}


@pytest.mark.parametrize("kind", FRAMES)
def test_items_of_several_frames(kind, tmp_path):
    """Items of several intra frames (the writer's full headers): key and
    intra-only frames, shown or hidden, show_existing_frame of a slot
    (with its film grain), frames of another size than the first
    (frame_size_override; libavif scales the last to the ispe), second
    sequence headers that change or not: the port outputs the last frame
    shown, as libaom does, and equals cv2.imread; the layouts cv2 returns
    None for raise ValueError."""
    data, W, H, depth, mono, sub = _frames(kind)
    path = _file(tmp_path, "f.avif", av1_item(data, W, H, depth, mono, sub))
    assert (cv2.imread(str(path)) is None) == (kind in REFUSED)
    same_as_cv2(path)


def test_two_frame_fixture_reads_the_second():
    """tests/data/avif/port_two_frames.avif (two reduced still picture
    headers, each with its key frame) reads as cv2's second frame."""
    same_as_cv2(os.path.join(DATA, "port_two_frames.avif"))


def _damage_base(kind):
    if kind == "intrabc":
        return open(os.path.join(DATA, "cv2_page_c_q80_s2.avif"),
                    "rb").read()
    if kind == "segmented":
        return open(os.path.join(DATA, "port_seg_lossless.avif"), "rb").read()
    if kind == "superres":
        return open(os.path.join(DATA, "port_superres_lr_tiles.avif"),
                    "rb").read()
    return open(os.path.join(DATA, "port_frames_existing.avif"), "rb").read()


# kind: (rng seed, {(feature, cv2 reads): reads}) as measured with OpenCV
# 5.0.0 (libavif 1.4.2, libaom 3.14.1)
TOOLS_DAMAGE = {"intrabc": (41, {}), "segmented": (42, {}),
                "superres": (43, {("a frame larger than its", False): 2}),
                "frames": (44, {})}


@pytest.mark.parametrize("kind", sorted(TOOLS_DAMAGE))
def test_tools_damage(kind, tmp_path):
    """200 copies of a file of each tool (cv2's lossy intra block copy
    page, the writer's segmented frame, its superres frame with
    restoration in two tile columns, its item of three frames) with one or
    two bytes of the AV1 data changed, each read in both modes: cv2's
    array where cv2.imread reads, ValueError where it returns None;
    NotImplementedError only for a feature of test_torch_avif.QUEUED,
    counted against ``TOOLS_DAMAGE``."""
    seed, want = TOOLS_DAMAGE[kind]
    rng = np.random.default_rng(seed)
    data = _damage_base(kind)
    start = data.index(b"mdat") + 4
    path = tmp_path / "d.avif"
    queued = {}
    for _ in range(200):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            i = int(rng.integers(start, len(d)))
            if rng.integers(0, 2):
                d[i] = int(rng.integers(0, 256))
            else:
                d[i] ^= 1 << int(rng.integers(0, 8))
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
