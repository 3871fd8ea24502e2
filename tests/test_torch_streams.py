"""The port's streams (lgu_slam_tpu_torch/data/streams.py) against the JAX
package's on the same on-disk fixtures: timestamps equal, intrinsics
within 1e-6, images within 0 levels (the port's decoder, resize, remap and
undistort equal OpenCV's here: tests/test_torch_image_io.py,
tests/test_torch_imgproc.py), depth exact."""

import os
import struct

import numpy as np
import pytest
from torch_port import C2_KINDS, c2_tiff, torch_single_thread  # noqa: F401

from lgu_slam_tpu.data import streams as jstreams
from lgu_slam_tpu_torch.data import fixtures, tiff
from lgu_slam_tpu_torch.data import streams as tstreams
from lgu_slam_tpu_torch.data.image_io import imwrite

IMAGE_TOL = 0  # levels


def _held(port, ref):
    """Two streams' items, element by element."""
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert len(p) == len(r)
        assert p[0] == r[0]  # timestamp
        for a, b in zip(p[1:], r[1:]):
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.uint8:  # images
                assert np.abs(a.astype(int) - b.astype(int)).max() \
                    <= IMAGE_TOL
            elif a.ndim == 1:  # intrinsics
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            else:  # depth
                np.testing.assert_array_equal(a, b)
    return port


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Colour frames and 16-bit depth of a synthetic clip at 60 x 80."""
    root = tmp_path_factory.mktemp("folder")
    images, depths, _, _ = fixtures.render_sequence(
        5, 5, 60, 80, (70.0, 70.0, 40.0, 30.0), t_step=0.05, r_step=0.01)
    for sub in ("rgb", "depth"):
        os.makedirs(root / sub)
    for k in range(len(images)):
        imwrite(str(root / "rgb" / f"{k:03d}.png"), images[k])
        imwrite(str(root / "depth" / f"{k:03d}.png"),
                (depths[k] * 1000).astype(np.uint16))
    (root / "calib.txt").write_text("70.0 70.0 40.0 30.0\n")
    (root / "calib_dist.txt").write_text(
        "70.0 70.0 40.0 30.0 0.2624 -0.9531 -0.0054 0.0026 1.1633\n")
    return root


@pytest.mark.parametrize("calib", ["calib.txt", "calib_dist.txt"])
def test_image_stream_matches_jax(folder, calib):
    """Resized to ~3000 pixels (40 x 56), with and without distortion."""
    args = (str(folder / "rgb"), str(folder / calib))
    kw = dict(stride=2, t0=1, target_pixels=3000)
    items = _held(tstreams.image_stream(*args, **kw),
                  jstreams.image_stream(*args, **kw))
    assert items[0][1].shape == (40, 56, 3)


@pytest.mark.parametrize("source", ["cv2", "port"])
def test_jpeg_image_stream_matches_jax(tmp_path, source):
    """A directory of JPEG frames, written by cv2.imwrite or by the port's
    encoder (fixtures.write_jpeg_imagedir), read as the JAX image_stream
    reads it (cv2.imread): the same frames, resized to ~3000 pixels."""
    imagedir, calib = fixtures.write_jpeg_imagedir(
        str(tmp_path), n_frames=4, H=60, W=80, seed=6)
    if source == "cv2":
        import cv2

        for name in os.listdir(imagedir):
            path = os.path.join(imagedir, name)
            cv2.imwrite(path, cv2.imread(path), [cv2.IMWRITE_JPEG_QUALITY,
                                                 90])
    kw = dict(stride=1, target_pixels=3000)
    items = _held(tstreams.image_stream(imagedir, calib, **kw),
                  jstreams.image_stream(imagedir, calib, **kw))
    assert len(items) == 4 and items[0][1].shape == (40, 56, 3)


def test_rgbd_stream_matches_jax(folder):
    args = (str(folder / "rgb"), str(folder / "depth"),
            str(folder / "calib_dist.txt"))
    kw = dict(stride=1, target_pixels=3000)
    items = _held(tstreams.rgbd_stream(*args, **kw),
                  jstreams.rgbd_stream(*args, **kw))
    assert len(items) == 5 and items[0][2].dtype == np.float32


def test_tum_rgbd_stream_matches_jax(tmp_path):
    """fr1 (undistorted) and fr3 (no distortion) at 480 x 640, cropped and
    halved to 240 x 320, depth associated 10 ms after colour."""
    for name in ("rgbd_dataset_freiburg1_desk", "rgbd_dataset_freiburg3_x"):
        root = fixtures.write_tum_sequence(str(tmp_path / name), n_frames=3)
        for stride in (1, 2):
            items = _held(tstreams.tum_rgbd_stream(root, stride=stride),
                          jstreams.tum_rgbd_stream(root, stride=stride))
            assert items[0][1].shape == (240, 320, 3)
            assert len(items) == (3 if stride == 1 else 2)


def test_euroc_stereo_stream_matches_jax(tmp_path):
    """Gray 752 x 480 pairs, rectified with the factory maps and resized to
    320 x 512; a left frame without its right one is skipped."""
    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=3)
    right = os.path.join(root, "mav0", "cam1", "data")
    os.remove(os.path.join(right, sorted(os.listdir(right))[1]))
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 2 and items[0][1].shape == (2, 320, 512, 3)


def test_euroc_stream_skips_unreadable_left_image(tmp_path):
    """A left file that cv2.imread cannot read (non-image bytes) drops its
    pair, as the JAX stream drops it: 3 of 4 frames, the same ones."""
    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=4)
    left = os.path.join(root, "mav0", "cam0", "data")
    bad = sorted(os.listdir(left))[2]
    with open(os.path.join(left, bad), "wb") as fh:
        fh.write(b"not an image\n" * 8)
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 3
    assert float(bad.split(".")[0]) / 1e9 not in [it[0] for it in items]


@pytest.mark.parametrize("kind", ["jpeg_12bit", "tiff_lzma"])
def test_euroc_stream_skips_what_cv2_returns_none_for(kind, tmp_path):
    """A left image stored as a 12-bit JPEG or an LZMA TIFF, each a file
    cv2.imread returns None for (OpenCV reads 8-bit JPEG only; this
    libtiff has no LZMA): the JAX stream skips the pair, and so does the
    port's (ValueError), so both yield the same 3 of 4 frames."""
    import cv2

    from lgu_slam_tpu_torch.data import image_io, tiff

    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=4)
    left = os.path.join(root, "mav0", "cam0", "data")
    bad = os.path.join(left, sorted(os.listdir(left))[1])
    gray = cv2.imread(bad, cv2.IMREAD_GRAYSCALE)
    if kind == "jpeg_12bit":
        raw = bytearray(image_io.encode_jpeg(gray))
        raw[raw.index(b"\xff\xc0") + 4] = 12
    else:
        raw = bytearray(tiff.encode_tiff(gray))
        tags = tiff._ifd(bytes(raw), "")[0]
        assert tags["compression"] == (1,)
        raw = raw.replace(struct.pack("<HHIH", 259, 3, 1, 1),
                          struct.pack("<HHIH", 259, 3, 1, 34925))
    with open(bad, "wb") as fh:
        fh.write(bytes(raw))
    assert cv2.imread(bad) is None
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 3
    assert float(os.path.basename(bad).split(".")[0]) / 1e9 not in [
        it[0] for it in items]


@pytest.mark.parametrize("kind", C2_KINDS)
def test_euroc_stream_skips_tiff_cv2_returns_none_for(kind, tmp_path):
    """A left image stored as a TIFF that cv2.imread returns None for and
    that the port's decoder once refused as NotImplementedError (a
    predictor other than 1-3, the floating-point predictor of 16-bit
    integers, mixed depths, a green YCbCr coefficient 0, a short strip
    the file cannot fill, JPEG of separate YCbCr planes:
    tests/torch_port.c2_tiff): the JAX stream, reading through cv2, skips
    the pair, and so does the port's (ValueError): the same 3 of 4 frames
    with the same timestamps."""
    import cv2

    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=4)
    left = os.path.join(root, "mav0", "cam0", "data")
    bad = os.path.join(left, sorted(os.listdir(left))[2])
    data = c2_tiff(kind, cv2.imread(bad))
    with open(bad, "wb") as fh:
        fh.write(data)
    assert cv2.imread(bad) is None
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 3
    assert float(os.path.basename(bad).split(".")[0]) / 1e9 not in [
        it[0] for it in items]


def test_euroc_stream_raises_on_a_format_it_cannot_read(tmp_path,
                                                        monkeypatch):
    """A left image stored as an AVIF item of two AV1 frames, which
    cv2.imread reads (the second): both streams yield all 4 frames, the
    same.  The same image stored as an AVIF frame larger than its ispe,
    which cv2.imread reads (scaled by libavif) and the port does not
    decode past ``avif.SCALED_PIXELS`` (lowered here): the JAX stream
    tracks all 4 frames; the port's stream raises NotImplementedError
    naming the format instead of dropping the frame."""
    import cv2
    from test_torch_avif import two_frames

    from lgu_slam_tpu_torch.data import avif

    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=4)
    left = os.path.join(root, "mav0", "cam0", "data")
    name = os.path.join(left, sorted(os.listdir(left))[1])
    img = cv2.imread(name)
    with open(name, "wb") as fh:
        fh.write(two_frames(img))
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 4
    H, W = img.shape[:2]
    ispe = b"ispe" + bytes(4) + struct.pack(">II", W, H)
    with open(name, "wb") as fh:
        fh.write(avif.encode_avif(img).replace(
            ispe, b"ispe" + bytes(4) + struct.pack(">II", W // 2, H // 2)))
    monkeypatch.setattr(avif, "SCALED_PIXELS", 1000)
    assert len(list(jstreams.euroc_stereo_stream(root))) == 4
    with pytest.raises(NotImplementedError, match="AVIF"):
        list(tstreams.euroc_stereo_stream(root))


@pytest.mark.parametrize("fmt", ["webp", "webp_lossy"])
def test_euroc_stream_reads_a_webp_left_image(fmt, tmp_path):
    """A left image stored as WebP (the port's lossless encoder, or lossy
    from cv2.imencode): the JAX stream and the port's yield the same 4
    frames."""
    import cv2

    from lgu_slam_tpu_torch.data import webp

    root = fixtures.write_euroc_sequence(str(tmp_path / "MH_01_easy"),
                                         n_frames=4)
    left = os.path.join(root, "mav0", "cam0", "data")
    name = os.path.join(left, sorted(os.listdir(left))[1])
    img = cv2.imread(name)
    if fmt == "webp":
        data = webp.encode_webp_lossless(img)
    else:
        data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 70]
                            )[1].tobytes()
    with open(name, "wb") as fh:
        fh.write(data)
    items = _held(tstreams.euroc_stereo_stream(root),
                  jstreams.euroc_stereo_stream(root))
    assert len(items) == 4


@pytest.mark.parametrize("fmt", ["webp", "gif", "ras"])
def test_image_stream_over_new_formats_matches_jax(fmt, tmp_path):
    """image_stream over a directory of lossless WebP, GIF (colour cube)
    or Sun raster frames: the JAX stream and the port's yield the same
    frames and intrinsics, with and without distortion."""
    images = fixtures.render_sequence(5, 4, 60, 80, (70.0, 70.0, 40.0, 30.0),
                                      t_step=0.05, r_step=0.01)[0]
    os.makedirs(tmp_path / "rgb")
    for k in range(len(images)):
        fixtures.write_frame(str(tmp_path / "rgb" / f"{k:03d}"), images[k],
                             fmt)
    (tmp_path / "calib.txt").write_text(
        "70.0 70.0 40.0 30.0 0.2624 -0.9531 -0.0054 0.0026 1.1633\n")
    args = (str(tmp_path / "rgb"), str(tmp_path / "calib.txt"))
    items = _held(tstreams.image_stream(*args, stride=1),
                  jstreams.image_stream(*args, stride=1))
    assert len(items) == 4


def test_jp2_streams_match_jax(tmp_path):
    """image_stream and rgbd_stream over a directory of lossless JPEG 2000
    colour frames (.jp2, the port's writer) and 16-bit JPEG 2000 depth
    (.j2k codestreams): the JAX streams (cv2.imread) and the port's yield
    the same frames, depths and intrinsics exactly."""
    from lgu_slam_tpu_torch.data import jp2

    images, depths, _, _ = fixtures.render_sequence(
        5, 4, 60, 80, (70.0, 70.0, 40.0, 30.0), t_step=0.05, r_step=0.01)
    for sub in ("rgb", "depth"):
        os.makedirs(tmp_path / sub)
    for k in range(len(images)):
        fixtures.write_frame(str(tmp_path / "rgb" / f"{k:03d}"), images[k],
                             "jp2")
        (tmp_path / "depth" / f"{k:03d}.j2k").write_bytes(jp2.encode_jp2(
            (depths[k] * 1000).astype(np.uint16), codestream=True))
    (tmp_path / "calib.txt").write_text(
        "70.0 70.0 40.0 30.0 0.2624 -0.9531 -0.0054 0.0026 1.1633\n")
    calib = str(tmp_path / "calib.txt")
    items = _held(tstreams.image_stream(str(tmp_path / "rgb"), calib),
                  jstreams.image_stream(str(tmp_path / "rgb"), calib))
    assert len(items) == 4
    args = (str(tmp_path / "rgb"), str(tmp_path / "depth"), calib)
    kw = dict(stride=1, target_pixels=3000)
    items = _held(tstreams.rgbd_stream(*args, **kw),
                  jstreams.rgbd_stream(*args, **kw))
    assert len(items) == 4 and items[0][2].max() > 0


@pytest.mark.parametrize("color", ["webp", "gif"])
def test_rgbd_stream_over_hdr_depth_matches_jax(color, tmp_path):
    """rgbd_stream over WebP or GIF colour with Radiance HDR depth (gray
    RGBE, read as float32 with IMREAD_ANYDEPTH): the JAX stream and the
    port's yield the same frames, depths and intrinsics exactly."""
    images, depths, _, _ = fixtures.render_sequence(
        5, 4, 60, 80, (70.0, 70.0, 40.0, 30.0), t_step=0.05, r_step=0.01)
    for sub in ("rgb", "depth"):
        os.makedirs(tmp_path / sub)
    for k in range(len(images)):
        fixtures.write_frame(str(tmp_path / "rgb" / f"{k:03d}"), images[k],
                             color)
        fixtures.write_frame(str(tmp_path / "depth" / f"{k:03d}"),
                             (depths[k] * 1000).astype(np.uint16), "hdr")
    (tmp_path / "calib.txt").write_text("70.0 70.0 40.0 30.0\n")
    args = (str(tmp_path / "rgb"), str(tmp_path / "depth"),
            str(tmp_path / "calib.txt"))
    kw = dict(stride=1, target_pixels=3000)
    items = _held(tstreams.rgbd_stream(*args, **kw),
                  jstreams.rgbd_stream(*args, **kw))
    assert len(items) == 4 and items[0][2].dtype == np.float32
    assert items[0][2].max() > 0


def test_tum_stream_webp_hdr_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of lossless WebP colour and HDR
    depth: the port's stream equals the JAX one exactly, and equals the
    port's own stream over PNG colour with the float32 TIFF of the values
    the HDR files hold (chip_smoke.py phase 14's pair)."""
    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "webp" / name),
                                       n_frames=3, color="webp",
                                       depth="hdr")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, depth="rgbe-tiff")
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    for a, b in zip(items, ref):
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


DEPTH_FORMATS = ["tiff", "pgm", "pfm"]


@pytest.mark.parametrize("depth", DEPTH_FORMATS)
def test_rgbd_stream_depth_formats_match_jax(depth, tmp_path):
    """rgbd_stream over PPM colour and depth stored as float32 TIFF
    (Deflate, floating-point predictor), 16-bit PGM (NYU Depth v2's raw
    form) or PFM (Middlebury, SceneFlow), the same depth values as the PNG
    fixture: the JAX stream (cv2.imread with IMREAD_ANYDEPTH, then
    .astype(float32)) and the port's yield the same arrays exactly."""
    images, depths, _, _ = fixtures.render_sequence(
        5, 4, 60, 80, (70.0, 70.0, 40.0, 30.0), t_step=0.05, r_step=0.01)
    for sub in ("rgb", "depth"):
        os.makedirs(tmp_path / sub)
    for k in range(len(images)):
        d = (depths[k] * 1000).astype(np.uint16)
        fixtures.write_frame(str(tmp_path / "rgb" / f"{k:03d}"), images[k],
                             "ppm")
        fixtures.write_frame(str(tmp_path / "depth" / f"{k:03d}"), d, depth)
    (tmp_path / "calib.txt").write_text("70.0 70.0 40.0 30.0\n")
    args = (str(tmp_path / "rgb"), str(tmp_path / "depth"),
            str(tmp_path / "calib.txt"))
    kw = dict(stride=1, target_pixels=3000)
    items = _held(tstreams.rgbd_stream(*args, **kw),
                  jstreams.rgbd_stream(*args, **kw))
    assert len(items) == 4 and items[0][2].dtype == np.float32
    assert items[0][2].max() > 0


@pytest.mark.parametrize("depth", DEPTH_FORMATS)
def test_tum_stream_depth_formats_match_jax(depth, tmp_path):
    """The TUM reader over an fr1 sequence stored with PPM colour and TIFF,
    PGM or PFM depth: the port's stream equals the JAX one exactly, and
    equals the port's own stream over the PNG sequence of the same frames
    (the depth values are the same)."""
    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / depth / name),
                                       n_frames=3, color="ppm", depth=depth)
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3)
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    for a, b in zip(items, ref):
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_tum_stream_ht_jp2_12bit_tiff_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of HTJ2K colour (.jp2, the
    port's HT writer) and 12-bit TIFF depth: the port's stream equals the
    JAX one (cv2.imread) in frames and timestamps, and equals the port's
    own stream over PNG colour with the 16-bit PNG depth of the 12-bit
    values shifted up by 4 (chip_smoke.py phase 18's pair)."""
    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "ht" / name),
                                       n_frames=3, H=60, W=80,
                                       color="ht-jp2", depth="12bit-tiff")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, H=60, W=80,
                                      depth="12bit-png")
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    assert len(items) == len(ref) == 3
    for a, b in zip(items, ref):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_tum_stream_ycbcr_tiff_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of uncompressed YCbCr TIFF
    colour (2 x 2 subsampled) and 16-bit LZW TIFF depth: the port's stream
    equals the JAX one exactly, and equals the port's own stream over the
    PNG of what those TIFFs read back as with the 16-bit PNG depth of the
    same values (chip_smoke.py phase 15's pair)."""
    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "tiff" / name),
                                       n_frames=3, color="ycbcr-tiff",
                                       depth="lzw16-tiff")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, color="ycbcr-png")
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    for a, b in zip(items, ref):
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


TIFF_KINDS = {
    "group4": lambda img: tiff.encode_tiff(
        (img[..., 1] > 100).astype(np.uint8), "group4", bilevel=True,
        photometric=0),
    "old_style_lzw": lambda img: tiff.encode_tiff(img, "lzw_old"),
    "cmyk": lambda img: tiff.encode_tiff(np.concatenate(
        [255 - img[..., ::-1], img[..., :1] // 4], -1), photometric=5),
    "cielab": lambda img: tiff.encode_tiff(img, photometric=8),
    "gray_alpha": lambda img: tiff.encode_tiff(
        np.stack([img[..., 1], img[..., 2]], -1), extra_samples=2)}


@pytest.mark.parametrize("kind", list(TIFF_KINDS))
def test_image_stream_over_new_tiff_kinds_matches_jax(kind, tmp_path):
    """image_stream over a directory of Group 4, old-style LZW, CMYK, CIE
    L*a*b* or gray-with-alpha TIFF frames: the JAX stream (cv2.imread) and
    the port's yield the same frames and intrinsics, with distortion."""
    images = fixtures.render_sequence(5, 4, 60, 80, (70.0, 70.0, 40.0, 30.0),
                                      t_step=0.05, r_step=0.01)[0]
    os.makedirs(tmp_path / "rgb")
    for k in range(len(images)):
        (tmp_path / "rgb" / f"{k:03d}.tif").write_bytes(
            TIFF_KINDS[kind](images[k]))
    (tmp_path / "calib.txt").write_text(
        "70.0 70.0 40.0 30.0 0.2624 -0.9531 -0.0054 0.0026 1.1633\n")
    args = (str(tmp_path / "rgb"), str(tmp_path / "calib.txt"))
    items = _held(tstreams.image_stream(*args, stride=1),
                  jstreams.image_stream(*args, stride=1))
    assert len(items) == 4


def test_tum_stream_exif_oriented_depth_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence whose 16-bit depth PNGs carry an
    eXIf chunk of Orientation 6 (cv2.imread turns them 90 degrees, also
    under IMREAD_ANYDEPTH): the port's stream equals the JAX one in frames,
    shapes and timestamps."""
    import zlib

    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / name), n_frames=3,
                                       H=60, W=80)
    exif = b"MM\0*" + struct.pack(">IHHHIHH", 8, 1, 0x112, 3, 1, 6, 0) \
        + bytes(4)
    chunk = struct.pack(">I", len(exif)) + b"eXIf" + exif + struct.pack(
        ">I", zlib.crc32(b"eXIf" + exif))
    for f in os.listdir(os.path.join(root, "depth")):
        path = os.path.join(root, "depth", f)
        data = open(path, "rb").read()
        with open(path, "wb") as fh:  # after IHDR (8 + 25 bytes)
            fh.write(data[:33] + chunk + data[33:])
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    assert len(items) == 3


def test_tum_stream_lossy_avif_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of the port writer's lossy 4:2:0
    AVIF colour (fixtures.LOSSY_AVIF: quantiser matrix, deblocking, CDEF)
    and 12-bit lossless AVIF depth: the port's stream equals the JAX one
    (cv2.imread over libavif and libaom) in frames and timestamps, and the
    port's own stream over the PNG of what those AVIF frames read back as
    with the 16-bit PNG depth (chip_smoke.py phase 20's pair)."""
    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "avif" / name),
                                       n_frames=3, H=60, W=80,
                                       color="lossy-avif",
                                       depth="12bit-avif")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, H=60, W=80,
                                      color="lossy-avif-png",
                                      depth="12bit-avif-png")
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    assert len(items) == len(ref) == 3
    for a, b in zip(items, ref):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_tum_stream_restored_avif_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of the port writer's lossy 4:2:0
    AVIF colour with loop restoration (fixtures.LR_AVIF: Wiener units on
    luma, self-guided units on chroma) and 12-bit lossless AVIF depth: the
    port's stream equals the JAX one (cv2.imread over libavif and libaom)
    in frames and timestamps, and the port's own stream over the PNG of
    what those AVIF frames read back as with the 16-bit PNG depth
    (chip_smoke.py phase 21's pair)."""
    from lgu_slam_tpu_torch.data import avif

    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "avif" / name),
                                       n_frames=3, H=60, W=80,
                                       color="lr-avif", depth="12bit-avif")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, H=60, W=80,
                                      color="lr-avif-png",
                                      depth="12bit-avif-png")
    rgb = os.path.join(root, "rgb")
    data = open(os.path.join(rgb, sorted(os.listdir(rgb))[0]), "rb").read()
    box = avif.parse(data)
    counts = avif.lr_stats(avif._payload(data, box, box["color"]))[0]
    assert counts[0, 1] and counts[1, 2] and counts[2, 2]
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    assert len(items) == len(ref) == 3
    for a, b in zip(items, ref):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_tum_stream_layered_avif_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence whose colour frames are three of
    the committed layered AVIF items (tests/data/avif/layered_tum*: two
    layers, the base at half size; AV1 inter frames, which no writer here
    makes) with 16-bit PNG depth: the port's stream equals the JAX one
    (cv2.imread over libavif and libaom) in frames, depth and timestamps,
    the ground truth both packages load is the same, and the port's own
    stream over the PNG of what those AVIF frames read back as equals it
    (chip_smoke.py phase 24's pair)."""
    from lgu_slam_tpu.eval.ate import load_tum_trajectory as jload
    from lgu_slam_tpu_torch.eval.ate import load_tum_trajectory as tload

    data = os.path.join(os.path.dirname(__file__), "data", "avif")
    colour = [("avif", open(os.path.join(
        data, f"layered_tum{k}_480x640.avif"), "rb").read())
        for k in range(3)]
    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_with_colour(str(tmp_path / "avif" / name),
                                          colour, 24, order=[0, 1, 2, 1])
    png = fixtures.write_tum_with_colour(str(tmp_path / "png" / name),
                                         colour, 24, order=[0, 1, 2, 1],
                                         png=True)
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    assert len(items) == len(ref) == 4
    for a, b in zip(items, ref):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.array(items[1][1]),
                                  np.array(items[3][1]))
    gt = os.path.join(root, "groundtruth.txt")
    for a, b in zip(tload(gt), jload(gt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tum_stream_avif_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of lossless AVIF colour and
    12-bit gray AVIF depth (the port's AV1 writer): the port's stream
    equals the JAX one (cv2.imread over libavif) in frames and timestamps,
    and equals the port's own stream over PNG colour with the 16-bit PNG
    depth of the same 12-bit values (chip_smoke.py phase 19's pair)."""
    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "avif" / name),
                                       n_frames=3, H=60, W=80, color="avif",
                                       depth="12bit-avif")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, H=60, W=80,
                                      depth="12bit-avif-png")
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    assert len(items) == len(ref) == 3
    for a, b in zip(items, ref):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_tum_stream_grain_avif_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of the port writer's lossy 4:2:0
    AVIF colour with film grain (fixtures.GRAIN_AVIF) and 12-bit lossless
    AVIF depth with grain (fixtures.GRAIN_DEPTH): the port's stream equals
    the JAX one (cv2.imread over libavif and libaom, which adds the grain)
    in frames, depth and timestamps, and the port's own stream over the
    PNG and 16-bit PNG of what those AVIF frames read back as
    (chip_smoke.py phase 22's pair)."""
    from lgu_slam_tpu_torch.data import avif

    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "avif" / name),
                                       n_frames=3, H=60, W=80,
                                       color="grain-avif",
                                       depth="12bit-grain-avif")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, H=60, W=80,
                                      color="grain-avif-png",
                                      depth="12bit-grain-avif-png")
    for folder in ("rgb", "depth"):
        path = os.path.join(root, folder)
        data = open(os.path.join(path, sorted(os.listdir(path))[0]),
                    "rb").read()
        box = avif.parse(data)
        assert avif.grain_params(avif._payload(data, box, box["color"]))[0]
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    assert len(items) == len(ref) == 3
    for a, b in zip(items, ref):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_tum_stream_tools_avif_matches_jax(tmp_path):
    """The TUM reader over an fr1 sequence of the port writer's lossy 4:2:0
    AVIF colour with segmentation (a lossless segment among them) and
    superres with loop restoration (fixtures.TOOLS_AVIF) and 12-bit AVIF
    depth stored as items of three frames (a hidden key frame shown again
    by show_existing_frame): the port's stream equals the JAX one
    (cv2.imread over libavif and libaom) in frames, depth and timestamps,
    and the port's own stream over the PNG and 16-bit PNG of the same
    values (chip_smoke.py phase 23's pair)."""
    from lgu_slam_tpu_torch.data import avif

    name = "rgbd_dataset_freiburg1_desk"
    root = fixtures.write_tum_sequence(str(tmp_path / "avif" / name),
                                       n_frames=3, H=60, W=80,
                                       color="tools-avif",
                                       depth="12bit-frames-avif")
    png = fixtures.write_tum_sequence(str(tmp_path / "png" / name),
                                      n_frames=3, H=60, W=80,
                                      color="tools-avif-png",
                                      depth="12bit-frames-avif-png")
    path = os.path.join(root, "rgb")
    data = open(os.path.join(path, sorted(os.listdir(path))[0]), "rb").read()
    box = avif.parse(data)
    assert avif.superres_ms(avif._payload(data, box, box["color"]))[1] > 0
    items = _held(tstreams.tum_rgbd_stream(root, stride=1),
                  jstreams.tum_rgbd_stream(root, stride=1))
    ref = list(tstreams.tum_rgbd_stream(png, stride=1))
    assert len(items) == len(ref) == 3
    for a, b in zip(items, ref):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
