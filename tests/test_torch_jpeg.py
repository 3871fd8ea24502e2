"""The port's JPEG codec (lgu_slam_tpu_torch/data/image_io.py and its C
decoder csrc/host/jpeg_decode.c) against OpenCV, whose ``cv2.imread``
decodes with libjpeg-turbo: files written by ``cv2.imwrite`` at every
quality, sampling factor and coding mode the cases name decode to the same
samples bit for bit (no mode needs a tolerance); the EXIF orientation turns
the image as ``cv2.imread`` does; what the decoder does not read raises
``NotImplementedError`` naming the feature; truncated and corrupt streams,
and random corruption, decode as ``cv2.imread`` reads them from a file
(libjpeg's warnings: the same samples bit for bit) or raise ``ValueError``
where it returns None, and never crash; the numpy encoder
writes files that decode as ``cv2.imread`` decodes them, within the PSNR
of the source that each subsampling states."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port import torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data import image_io

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
MODES = {"baseline": [],
         "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
         "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
         "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}
SIZES = ((1, 1), (7, 9), (67, 93))


def _image(H, W, kind, seed=0):
    """Smooth colour waves (a different phase per channel, so chroma has
    detail) or uniform noise, ``uint8 [H, W, 3]``."""
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (H, W, 3),
                                                    np.uint8)
    y, x = np.mgrid[0:H, 0:W]
    return np.stack([128 + 100 * np.sin(x / 7 + c) * np.cos(y / 9 - c)
                     for c in range(3)], -1).astype(np.uint8)


def _cv2_jpeg(im, params) -> bytes:
    ok, buf = cv2.imencode(".jpg", im, params)
    assert ok
    return buf.tobytes()


def _same_as_cv2(data: bytes):
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = image_io.decode_jpeg(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decodes_cv2_jpegs_bit_identically(sampling, mode):
    """Qualities 50, 75, 95 and 100 at 1 x 1, 7 x 9 and 67 x 93 (MCU
    padding cropped, the upsampler's edge rows and columns, planes of 1-2
    chroma columns that libjpeg replicates instead of filtering), smooth
    and noisy, and 480 x 640 at quality 95: the samples of cv2.imread."""
    for H, W in SIZES:
        for kind in ("smooth", "noise"):
            for quality in (50, 75, 95, 100):
                _same_as_cv2(_cv2_jpeg(_image(H, W, kind, seed=H), [
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                    *MODES[mode]]))
    _same_as_cv2(_cv2_jpeg(_image(480, 640, "smooth"), [
        cv2.IMWRITE_JPEG_QUALITY, 95,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling], *MODES[mode]]))


@pytest.mark.parametrize("mode", ["baseline", "progressive"])
def test_gray_files(mode, tmp_path):
    """One-component files come back as three equal channels, as
    cv2.imread returns them; imread reads them from disk."""
    for H, W in (*SIZES, (480, 640)):
        gray = _image(H, W, "smooth")[..., 1]
        data = _cv2_jpeg(gray, [cv2.IMWRITE_JPEG_QUALITY, 90, *MODES[mode]])
        got = _same_as_cv2(data)
        assert (got[..., 0] == got[..., 2]).all()
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, gray)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


@pytest.mark.parametrize("orientation", range(0, 9))
def test_exif_orientation(orientation, tmp_path):
    """A 30 x 40 image written by PIL with EXIF orientation 1-8 (0: no
    tag) comes back turned as cv2.imread turns it (5-8 as 40 x 30)."""
    im = _image(30, 40, "noise", seed=5)
    exif = Image.Exif()
    if orientation:
        exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(im[..., ::-1]).save(buf, format="JPEG", quality=90,
                                        exif=exif.tobytes())
    path = tmp_path / "o.jpg"
    path.write_bytes(buf.getvalue())
    got = image_io.imread(str(path))
    ref = cv2.imread(str(path))
    assert got.shape == ref.shape == ((40, 30, 3) if orientation >= 5
                                      else (30, 40, 3))
    np.testing.assert_array_equal(got, ref)


def _segments(data: bytes):
    """(marker, offset of its 0xFF, offset past the segment) of every
    marker segment before the first scan's entropy-coded data."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((marker, pos, pos + 2 + length))
        pos += 2 + length
        if marker == 0xDA:
            return out


def _find(data: bytes, marker: int):
    return next(s for s in _segments(data) if s[0] == marker)


def _rgb_named(data: bytes) -> bytes:
    """The file without its JFIF marker and with its components (in the
    frame header and the first scan) named 'R', 'G', 'B'."""
    _, app0, app0_end = _find(data, 0xE0)
    data = data[:app0] + data[app0_end:]
    raw = bytearray(data)
    _, sof, _ = _find(data, 0xC0)
    for c, name in enumerate(b"RGB"):
        raw[sof + 10 + 3 * c] = name
    _, sos, _ = _find(data, 0xDA)
    for c, name in enumerate(b"RGB"):
        raw[sos + 5 + 2 * c] = name
    return bytes(raw)


def test_rgb_colour_space():
    """Three components named 'R', 'G', 'B' and no JFIF marker: libjpeg
    takes the samples as RGB, with no colour conversion."""
    got = _same_as_cv2(_rgb_named(_cv2_jpeg(_image(67, 93, "smooth"), [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]])))
    assert not (got[..., 0] == got[..., 1]).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_anydepth_reads_gray(mode, tmp_path):
    """imread(path, anydepth=True) is cv2.imread(path, IMREAD_ANYDEPTH):
    libjpeg's JCS_GRAYSCALE output, the Y plane of a YCbCr file at every
    sampling, a gray file's samples, the luma of an RGB file; turned by
    the EXIF orientation as the colour read is."""
    path = tmp_path / "a.jpg"

    def same(data):
        path.write_bytes(data)
        ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH)
        got = image_io.imread(str(path), anydepth=True)
        assert got.dtype == ref.dtype == np.uint8
        assert got.shape == ref.shape and got.ndim == 2
        np.testing.assert_array_equal(got, ref)

    for H, W in SIZES:
        for sampling in SAMPLING.values():
            same(_cv2_jpeg(_image(H, W, "smooth"), [
                cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling, *MODES[mode]]))
        same(_cv2_jpeg(_image(H, W, "noise")[..., 0],
                       [cv2.IMWRITE_JPEG_QUALITY, 90, *MODES[mode]]))
    if mode != "progressive":  # _rgb_named renames the first scan's ids
        same(_rgb_named(_cv2_jpeg(_image(67, 93, "smooth"), [
            cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"],
            *MODES[mode]])))
    for orientation in (3, 6):
        exif = Image.Exif()
        exif[0x0112] = orientation
        buf = io.BytesIO()
        Image.fromarray(_image(30, 40, "noise", seed=5)).save(
            buf, format="JPEG", quality=90, exif=exif.tobytes())
        same(buf.getvalue())


def _baseline(**kw) -> bytes:
    return _cv2_jpeg(_image(24, 40, "noise", seed=7),
                     [cv2.IMWRITE_JPEG_QUALITY, 90, *kw.get("extra", [])])


def _cv2_file(data: bytes, tmp_path):
    """cv2.imread of the bytes as a file: libjpeg's stdio source, which
    reads past the end of the data as fake EOI markers (cv2.imdecode's
    source suspends there instead)."""
    path = tmp_path / "cut.jpg"
    path.write_bytes(data)
    return cv2.imread(str(path))


def _as_cv2_reads(data: bytes, tmp_path) -> str:
    """decode_jpeg against cv2.imread of the same bytes: the same samples
    where cv2 returns an image ("image"), ValueError where it returns None
    ("None")."""
    ref = _cv2_file(data, tmp_path)
    if ref is None:
        with pytest.raises(ValueError):
            image_io.decode_jpeg(data)
        return "None"
    got = image_io.decode_jpeg(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return "image"


@pytest.mark.parametrize("mode", ["baseline", "progressive", "restart"])
def test_truncated_streams_raise(mode, tmp_path):
    """Every prefix of a file decodes as cv2.imread reads it: a prefix cut
    in the markers before the first scan raises ValueError, one cut in the
    scan data is read with the data's end padded by zero bits and the MCUs
    after it left at zero coefficients, bit for bit; a progressive prefix
    so, its incomplete coefficients estimated by libjpeg's block smoothing
    (one cut in a later scan's header: ValueError, as cv2 returns None)."""
    data = _baseline(extra=MODES[mode])
    first_scan = _segments(data)[-1][2]
    outcomes = [_as_cv2_reads(data[:n], tmp_path)
                for n in range(len(data) + 1)]
    assert outcomes[-1] == "image"
    if mode == "progressive":
        assert outcomes[:first_scan] == ["None"] * first_scan
        assert outcomes[first_scan] == "image"
        assert outcomes.count("image") > len(data) // 2
        return
    # cut within the scan header's last three bytes (Ss, Se, Ah/Al, which
    # a sequential scan does not use): read too
    assert outcomes[:first_scan - 3] == ["None"] * (first_scan - 3)
    assert outcomes[first_scan - 3:] == ["image"] * (len(data) + 4
                                                     - first_scan)


def _corrupt(name: str) -> tuple[bytes, str]:
    """A file with one defect, and the words of the error it raises."""
    data = _baseline()
    raw = bytearray(data)
    _, sof, sof_end = _find(data, 0xC0)
    _, dht, _ = _find(data, 0xC4)
    _, sos, sos_end = _find(data, 0xDA)
    if name == "no_soi":
        raw[1] = 0xD9
        return bytes(raw), "no SOI"
    if name == "bad_huffman_table":
        counts = raw[dht + 5:dht + 21]  # two codes of length 1: 0 and 1
        k = next(i for i in range(1, 16) if counts[i] >= 2)
        raw[dht + 5], raw[dht + 5 + k] = counts[0] + 2, counts[k] - 2
        return bytes(raw), "bad Huffman table"
    if name == "undefined_quant_table":
        raw[sof + 12] = 3
        return bytes(raw), "quantisation table 3"
    if name == "bad_huffman_code":
        raw[sos_end:sos_end + 32] = b"\xff\x00" * 16
        return bytes(raw), "bad Huffman code"
    if name == "extraneous_bytes":
        return data[:-2] + b"\x12\x34\x56" + data[-2:], "extraneous"
    if name == "second_sof":
        return data[:sos] + data[sof:sof_end] + data[sos:], "second frame"
    if name == "zero_width":
        raw[sof + 7:sof + 9] = b"\x00\x00"
        return bytes(raw), "width 0"
    if name == "sos_before_sof":
        return data[:sof] + data[sof_end:], "before the frame header"
    if name == "segment_overrun":
        raw[sof + 2:sof + 4] = b"\xff\xff"
        return bytes(raw), "runs past the end"
    if name == "unknown_marker":
        return data[:2] + b"\xff\x02\x00\x02" + data[2:], "unknown marker"
    if name == "rst_out_of_order":
        data = _baseline(extra=MODES["restart"])
        at = next(i for i in range(len(data) - 1)
                  if data[i] == 0xFF and data[i + 1] == 0xD0)
        return data[:at + 1] + b"\xd1" + data[at + 2:], "RST0"
    raise KeyError(name)


# defects libjpeg only warns of: cv2.imread returns an image
READ_BY_CV2 = ("bad_huffman_code", "extraneous_bytes", "rst_out_of_order")


@pytest.mark.parametrize("name", [
    "no_soi", "bad_huffman_table", "undefined_quant_table",
    "bad_huffman_code", "extraneous_bytes", "second_sof", "zero_width",
    "sos_before_sof", "segment_overrun", "unknown_marker",
    "rst_out_of_order"])
def test_corrupt_streams_raise(name, tmp_path):
    """Where cv2.imread returns None the decoder raises ValueError with
    the defect's words; where libjpeg only warns (a bad Huffman code read
    as symbol 0, bytes skipped before a marker, a restart marker out of
    order resynchronised) it returns cv2.imread's samples bit for bit."""
    data, words = _corrupt(name)
    outcome = _as_cv2_reads(data, tmp_path)
    if name in READ_BY_CV2:
        assert outcome == "image"
    else:
        assert outcome == "None"
        with pytest.raises(ValueError, match=words):
            image_io.decode_jpeg(data)


def test_random_corruption_never_crashes(tmp_path):
    """Bytes overwritten at random in baseline, progressive and restart
    files: the decoder returns cv2.imread's image bit for bit, or raises
    ValueError where cv2 returns None; it never reads out of bounds (a
    crash would end the test process)."""
    rng = np.random.default_rng(11)
    outcomes = {"image": 0, "None": 0}
    for mode in ("baseline", "progressive", "restart"):
        base = _baseline(extra=MODES[mode])
        for _ in range(400):
            raw = bytearray(base)
            for i in rng.integers(2, len(raw), rng.integers(1, 5)):
                raw[i] = rng.integers(0, 256)
            outcomes[_as_cv2_reads(bytes(raw), tmp_path)] += 1
    assert outcomes["image"] > outcomes["None"] > 0


@pytest.mark.parametrize("feature", ["arithmetic", "12-bit", "lossless",
                                     "hierarchical", "CMYK", "YCCK"])
def test_unsupported_modes_raise(feature):
    """NotImplementedError naming the feature: the SOF marker or precision
    of a baseline file patched to arithmetic coding (SOF9), 12-bit samples,
    lossless (SOF3) or hierarchical (SOF5) coding; a CMYK file written by
    PIL, and the same with its Adobe marker's transform set to YCCK (2)."""
    data = _baseline()
    raw = bytearray(data)
    _, sof, _ = _find(data, 0xC0)
    if feature in ("CMYK", "YCCK"):
        buf = io.BytesIO()
        Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(buf, "JPEG")
        data, words = buf.getvalue(), "4 components"
        if feature == "YCCK":
            _, adobe, _ = _find(data, 0xEE)
            raw = bytearray(data)
            raw[adobe + 15] = 2  # the transform byte of "Adobe" + 7 bytes
            data = bytes(raw)
    else:
        patch, words = {"arithmetic": ((1, 0xC9), "arithmetic"),
                        "12-bit": ((4, 12), "12-bit"),
                        "lossless": ((1, 0xC3), "lossless"),
                        "hierarchical": ((1, 0xC5), "hierarchical")}[feature]
        raw[sof + patch[0]] = patch[1]
        data = bytes(raw)
    with pytest.raises(NotImplementedError, match=words):
        image_io.decode_jpeg(data)


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_block_smoothing(sampling, tmp_path):
    """Progressive files cut after each scan and inside scans, at 67 x 93
    and 120 x 160, smooth and noisy, quality 75 and 95, and gray: their
    incomplete coefficients estimated as libjpeg-turbo 3.1's block
    smoothing estimates them (the 5 x 5 DC neighbourhood while only DC
    came, the 9 first AC of blocks whose data ran out from the bits before
    the last scan), bit for bit with cv2.imread."""
    rng = np.random.default_rng(len(sampling))
    read = 0
    for H, W in ((67, 93), (120, 160)):
        for kind in ("smooth", "noise"):
            for quality in (75, 95):
                data = _cv2_jpeg(_image(H, W, kind, seed=H), [
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                    *MODES["progressive"]])
                scans = [i for i in range(len(data) - 1)
                         if data[i] == 0xFF and data[i + 1] == 0xDA]
                cuts = set(scans[1:]) | set(
                    rng.integers(scans[0], len(data), 8).tolist())
                for n in sorted(cuts):
                    read += _as_cv2_reads(data[:n], tmp_path) == "image"
    gray = _cv2_jpeg(_image(67, 93, "noise")[..., 0], [
        cv2.IMWRITE_JPEG_QUALITY, 90, *MODES["progressive"]])
    for n in rng.integers(_segments(gray)[-1][2], len(gray), 8):
        read += _as_cv2_reads(gray[:n], tmp_path) == "image"
    assert read > 60


# PSNR of decode_jpeg(encode_jpeg(x)) against x, 480 x 640 smooth colour
# waves at quality 95 (measured 47.0, 45.9, 44.4, 45.4 and 32.2 dB; 4:1:1
# keeps a quarter of the chroma columns of waves whose chroma has detail)
PSNR_DB = {"444": 46.0, "422": 45.0, "420": 43.5, "440": 44.5, "411": 31.5}


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64)
                                               - b) ** 2))


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_encoder_round_trip(sampling, tmp_path):
    """encode_jpeg's files, with and without restart markers and at odd
    sizes: decode_jpeg returns what cv2.imread returns for the same bytes,
    within the stated PSNR of the source; imwrite writes .jpg files so."""
    src = _image(480, 640, "smooth")
    for restart in (0, 5):
        data = image_io.encode_jpeg(src, 95, sampling, restart)
        assert _psnr(_same_as_cv2(data), src) >= PSNR_DB[sampling]
    for H, W in SIZES:
        _same_as_cv2(image_io.encode_jpeg(_image(H, W, "noise"), 75,
                                          sampling, 2))
    path = str(tmp_path / "x.jpg")
    image_io.imwrite(path, src)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


def test_encoder_gray():
    """Gray input makes a one-component file (within 50 dB here)."""
    src = _image(67, 93, "smooth")[..., 0]
    got = _same_as_cv2(image_io.encode_jpeg(src, 95, restart_interval=3))
    assert _psnr(got[..., 0], src) >= 50.0
