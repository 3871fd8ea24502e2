"""AV1 film grain in the port's AVIF reader (csrc/host/av1_grain.h, the
parameters read by av1_decode.c) against OpenCV's (libavif 1.4.2 over
libaom 3.14.1, which adds the grain to the frame it outputs) and against
libaom's own decode through ctypes: Pillow's files with each of libaom's 16
film grain test vectors at 4:2:0, 4:4:4, 4:2:2 and 4:0:0, the port's
writer's grain at 8, 10 and 12 bits (lags 0-3, chroma scaling from luma,
overlap, the clip to the restricted range under BT.601 and the identity
matrix), an alpha item with grain, the refusals, and seeded damage to the
grain's bytes with every class exact."""

import ctypes
import glob
import os
import sys

import cv2
import numpy as np
import pytest
from test_torch_avif import _scene
from test_torch_avif_container import _damage
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif, image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "avif")


def _libaom():
    """cv2's own libaom, loaded with ctypes (its decoder adds the grain)."""
    site = os.path.dirname(os.path.dirname(os.path.abspath(cv2.__file__)))
    lib = ctypes.CDLL(glob.glob(os.path.join(site, "opencv_python.libs",
                                             "libaom-*.so*"))[0])
    vp = ctypes.c_void_p
    lib.aom_codec_av1_dx.restype = vp
    lib.aom_codec_dec_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.aom_codec_decode.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t,
                                     vp]
    lib.aom_codec_get_frame.argtypes = [vp, vp]
    lib.aom_codec_get_frame.restype = vp
    lib.aom_codec_destroy.argtypes = [vp]
    return lib


def aom_planes(obus: bytes) -> list:
    """libaom's output planes (uint16) of an AV1 frame: ``aom_image_t``'s
    fmt at 0 (0x800: 16-bit samples), monochrome at 16, d_w / d_h at 40 /
    44, chroma shifts at 56 / 60, planes at 64, strides at 88."""
    lib = _libaom()
    ctx = ctypes.create_string_buffer(512)
    assert lib.aom_codec_dec_init_ver(ctx, lib.aom_codec_av1_dx(), None, 0,
                                      22) == 0
    try:
        assert lib.aom_codec_decode(ctx, obus, len(obus), None) == 0
        it = ctypes.c_void_p(0)
        img = lib.aom_codec_get_frame(ctx, ctypes.byref(it))
        assert img
        raw = ctypes.string_at(img, 100)
        fmt, mono = (int.from_bytes(raw[k:k + 4], "little") for k in (0, 16))
        dw, dh, xs, ys = (int.from_bytes(raw[k:k + 4], "little")
                          for k in (40, 44, 56, 60))
        out = []
        for p in range(1 if mono else 3):
            w = dw if p == 0 else (dw + xs) >> xs
            h = dh if p == 0 else (dh + ys) >> ys
            ptr = int.from_bytes(raw[64 + 8 * p:72 + 8 * p], "little")
            stride = int.from_bytes(raw[88 + 4 * p:92 + 4 * p], "little")
            a = np.frombuffer(ctypes.string_at(ptr, stride * h),
                              np.uint16 if fmt & 0x800 else np.uint8)
            out.append(a.reshape(h, -1)[:, :w].astype(np.uint16))
        return out
    finally:
        lib.aom_codec_destroy(ctx)


def _obus(data: bytes) -> bytes:
    box = avif.parse(data)
    return avif._payload(data, box, box["color"])


def _pillow(img, path, vector: int, subsampling: str, quality=60):
    from PIL import Image

    src = img[..., 1].copy() if subsampling == "4:0:0" else \
        img[..., ::-1].copy()
    Image.fromarray(src).save(path, quality=quality, subsampling=subsampling,
                              advanced=[("film-grain-test", str(vector))])
    return path


def test_grain_tables_are_libaoms(tmp_path):
    """av1_tables.h's gaussian_sequence and film_grain_test_vectors are
    what scripts/extract_av1_tables_torch.py reads out of cv2's libaom
    (``--check``), and each vector, read in aom_film_grain_t's layout,
    is the grain libaom's encoder writes for Pillow's
    ``film-grain-test`` option: the parameters the port reads from
    Pillow's file equal those it reads from the writer's file of the same
    vector, field for field, but the clip to the restricted range, which
    libaom's encoder clears in a full-range stream (Pillow's, and the
    writer's here)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import extract_av1_tables_torch as extract

    assert extract.main(["--check"]) == 0
    img = _scene(np.random.default_rng(0), 32, 48)
    for vector in range(1, 17):
        pillow = avif.grain_params(_obus(_pillow(
            img, tmp_path / "p.avif", vector, "4:2:0").read_bytes()))
        mine = avif.grain_params(_obus(avif.encode_avif(
            img, lossy=dict(base_q=60), grain=dict(
                vector=vector, clip_to_restricted_range=0))))
        np.testing.assert_array_equal(pillow, mine, err_msg=str(vector))
        assert pillow[0] == 1 and pillow[-1] == avif.grain_vector(vector)[-1]
    assert not avif.grain_params(_obus(avif.encode_avif(img))).any()


@pytest.mark.parametrize("vector", range(1, 17))
def test_pillow_grain_vectors(vector, tmp_path):
    """Pillow's lossy files with libaom's test vector at 4:2:0, 4:4:4,
    4:2:2 and 4:0:0, on a 128 x 192 gradient (four stripes of six blocks)
    and an odd 37 x 53 scene: equal to cv2.imread in both modes, the
    planes equal to libaom's own decode."""
    y, x = np.mgrid[0:128, 0:192]
    grad = np.stack([x * 255 // 191, y * 255 // 127, (x + y) * 255 // 318],
                    -1).astype(np.uint8)
    odd = _scene(np.random.default_rng(vector), 37, 53)
    for img in (grad, odd):
        for sub in ("4:2:0", "4:4:4", "4:2:2", "4:0:0"):
            path = _pillow(img, tmp_path / "g.avif", vector, sub)
            same_as_cv2(path)
            obus = _obus(path.read_bytes())
            assert avif.grain_params(obus)[0] == 1
            got = avif.av1_planes(obus)[0]
            for a, b in zip(got, aom_planes(obus)):
                np.testing.assert_array_equal(a, b)


# the writer's files: (image kind, encode_avif keywords)
WRITER = [("colour", {}), ("colour", dict(subsampling="4:2:0")),
          ("colour", dict(subsampling="4:2:2")), ("gray", {}),
          ("colour", dict(lossy=dict(base_q=60, lf=(8, 8, 4, 4),
                                     cdef=[(2, 1, 1, 0)]))),
          ("gray", dict(lossy=dict(base_q=60, lf=(8, 8, 4, 4))))]
# grains beyond Pillow's: every lag, chroma scaling from luma, no overlap,
# the clip (under BT.601, and under the identity matrix of lossless 4:4:4)
GRAINS = [1, 6, 15, 16, dict(vector=2, ar_coeff_lag=0),
          dict(vector=4, ar_coeff_lag=1, random_seed=7),
          dict(vector=3, chroma_scaling_from_luma=1),
          dict(vector=9, clip_to_restricted_range=1, overlap_flag=0),
          dict(vector=12, grain_scale_shift=3, scaling_shift=8)]


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_writer_grain(depth, tmp_path):
    """The writer's grain (encode_avif's ``grain``) at 8, 10 and 12 bits,
    lossless colour at 4:4:4 (identity), 4:2:0 and 4:2:2, gray, lossy
    4:2:0 and gray, 37 x 53 and 64 x 96: the planes equal libaom's own
    decode, the file reads equal to cv2.imread in both modes."""
    path = tmp_path / "w.avif"
    for k, (H, W) in enumerate(((37, 53), (64, 96))):
        img = _scene(np.random.default_rng(depth + k), H, W)
        if depth > 8:
            img = img.astype(np.uint16) * (1 << (depth - 8)) + 3
        for n, (kind, kw) in enumerate(WRITER):
            a = img[..., 1].copy() if kind == "gray" else img
            grain = GRAINS[(n + 3 * k + depth) % len(GRAINS)]
            data = avif.encode_avif(a, depth, n, grain=grain, **kw)
            obus = _obus(data)
            for got, want in zip(avif.av1_planes(obus)[0],
                                 aom_planes(obus)):
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{kind} {kw} {grain}")
            path.write_bytes(data)
            same_as_cv2(path)


def test_grain_options(tmp_path):
    """Each of GRAINS at 10-bit 4:2:0 and 12-bit 4:4:4 (lossless, the
    identity matrix): libaom's planes and cv2.imread's arrays; the grain's
    own time is reported (avif.grain_ms)."""
    img = _scene(np.random.default_rng(7), 40, 72).astype(np.uint16)
    path = tmp_path / "o.avif"
    for grain in GRAINS:
        for depth, kw in ((10, dict(subsampling="4:2:0")), (12, {})):
            data = avif.encode_avif(img << (depth - 8), depth, 1, grain=grain,
                                    **kw)
            obus = _obus(data)
            for got, want in zip(avif.av1_planes(obus)[0],
                                 aom_planes(obus)):
                np.testing.assert_array_equal(got, want, err_msg=str(grain))
            path.write_bytes(data)
            same_as_cv2(path)
    total, grain_ms = avif.grain_ms(obus)
    assert 0 < grain_ms <= total


def test_grain_on_alpha_and_its_refusals(tmp_path):
    """An alpha item with grain is decoded with it and dropped (cv2 reads
    the image); grains libaom refuses, ValueError where cv2 returns None:
    scaling points that do not increase, in the image or in its alpha,
    more than 14 luma or 10 chroma points, grain on one chroma plane of
    4:2:0."""
    img = _scene(np.random.default_rng(8), 24, 36)
    path = tmp_path / "a.avif"
    ok = avif.encode_avif(img, 8, 0, alpha=img[..., 0].copy(),
                          alpha_grain=dict(vector=6, ar_coeff_lag=0))
    path.write_bytes(ok)
    assert cv2.imread(str(path)) is not None
    same_as_cv2(path)
    flat = avif.grain_vector(1)
    flat[4] = flat[2]  # the second luma point's x: the first's
    cases = [dict(grain=flat), dict(alpha=img[..., 0].copy(),
                                    alpha_grain=flat),
             dict(grain=dict(vector=1, num_y_points=15)),
             dict(grain=dict(vector=1, num_cb_points=11),
                  subsampling="4:2:0"),
             dict(grain=dict(vector=2, num_cr_points=0),
                  subsampling="4:2:0")]
    for kw in cases:
        path.write_bytes(avif.encode_avif(img, 8, 0, **kw))
        assert cv2.imread(str(path)) is None, kw
        with pytest.raises(ValueError, match="film grain"):
            image_io.imread(str(path))
        same_as_cv2(path)


def _frame_header(data: bytes) -> tuple:
    """(start, end) in ``data`` of the colour item's frame OBU's first 60
    bytes (its header, where the grain is)."""
    box = avif.parse(data)
    off, n = box["color"]["extents"][0]
    k = 0
    while (data[off + k] >> 3) & 15 not in (3, 6):
        k += 2 + data[off + k + 1]
    return off + k, min(off + k + 60, off + n)


# file: (rng seed, {(feature, cv2 reads): reads}) as measured with OpenCV
# 5.0.0 (libavif 1.4.2, libaom 3.14.1)
GRAIN_DAMAGE = {"port_grain_c10.avif": (1, {}),
                "port_grain_g12.avif": (1, {}),
                "pillow_grain_v1_420.avif": (1, {}),
                "pillow_grain_v10_444.avif": (1, {}),
                "pillow_grain_v16_400.avif": (1, {})}


@pytest.mark.parametrize("name", sorted(GRAIN_DAMAGE))
def test_grain_damage(name, tmp_path):
    """300 copies of a committed grain file with one or two bytes of its
    frame header (the grain's fields among them) replaced or bit-flipped,
    each read in both modes: cv2's bytes where it reads, ValueError where
    it returns None, else NotImplementedError naming a feature of
    test_torch_avif.QUEUED, counted against the counts measured."""
    seed, want = GRAIN_DAMAGE[name]
    data = open(os.path.join(DATA, name), "rb").read()
    assert _damage(data, *_frame_header(data), np.random.default_rng(seed),
                   tmp_path / "d.avif", 300) == want
