"""The port's JPEG codec (lgu_slam_tpu_torch/data/image_io.py and its C
decoder csrc/host/jpeg_decode.c) against OpenCV, whose ``cv2.imread``
decodes with libjpeg-turbo: files written by ``cv2.imwrite`` at every
quality, sampling factor and coding mode the cases name decode to the same
samples bit for bit (no mode needs a tolerance); the EXIF orientation turns
the image as ``cv2.imread`` does; 4-component (CMYK, YCCK) files decode
as ``cv2.imread`` decodes them; what the decoder does not read raises
``NotImplementedError`` naming the feature, what libjpeg refuses
``ValueError``; truncated and corrupt streams,
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
from torch_port import same_as_cv2, torch_single_thread  # noqa: F401

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
def test_unsupported_modes_raise(feature, tmp_path):
    """A baseline file's SOF patched to arithmetic coding (SOF9: its
    Huffman data read by the QM decoder) reads as cv2.imread reads it, in
    both modes; patched to 12-bit samples, to lossless coding (SOF3: a JFIF file's
    YCbCr, which libjpeg-turbo does not convert in a lossless file) or to
    hierarchical coding (SOF5): ValueError,
    where cv2 returns None.  A CMYK file written by PIL, and the same with
    its Adobe marker's transform set to YCCK (2): as cv2.imread reads
    them."""
    data = _baseline()
    raw = bytearray(data)
    _, sof, _ = _find(data, 0xC0)
    if feature in ("CMYK", "YCCK"):
        buf = io.BytesIO()
        Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(buf, "JPEG")
        data = buf.getvalue()
        if feature == "YCCK":
            _, adobe, _ = _find(data, 0xEE)
            raw = bytearray(data)
            raw[adobe + 15] = 2  # the transform byte of "Adobe" + 7 bytes
            data = bytes(raw)
        path = tmp_path / "c.jpg"
        path.write_bytes(data)
        same_as_cv2(path)
        return
    patch, words = {
        "arithmetic": ((1, 0xC9), None),
        "12-bit": ((4, 12), "12-bit"),
        "lossless": ((1, 0xC3), "lossless"),
        "hierarchical": ((1, 0xC5), "hierarchical")}[feature]
    raw[sof + patch[0]] = patch[1]
    data = bytes(raw)
    path = tmp_path / "h.jpg"
    path.write_bytes(data)
    same_as_cv2(path)
    if words is not None:
        assert cv2.imread(str(path)) is None
        with pytest.raises(ValueError, match=words):
            image_io.decode_jpeg(data)


@pytest.mark.parametrize("marker", [0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE,
                                    0xCF])
def test_refused_frame_types(marker, tmp_path):
    """SOF5-7 (hierarchical), JPG and SOF13-15 (hierarchical arithmetic):
    cv2.imread returns None (libjpeg: JERR_SOF_UNSUPPORTED), the decoder
    raises ValueError; so for a frame of 2 components."""
    raw = bytearray(_baseline())
    _, sof, _ = _find(bytes(raw), 0xC0)
    raw[sof + 1] = marker
    path = tmp_path / "r.jpg"
    path.write_bytes(bytes(raw))
    same_as_cv2(path)
    with pytest.raises(ValueError):
        image_io.imread(str(path))
    gray = image_io.encode_jpeg(_image(16, 16, "noise")[..., 0], 90)
    segs = dict((m, (at, n)) for m, at, n in _segments(gray))
    at, _ = segs[0xC0]
    two = bytearray(gray[:at + 4])  # SOF length, precision, size: 2 comps
    two[at + 2:at + 4] = struct.pack(">H", 8 + 3 * 2)
    frame = gray[at + 4:at + 9] + bytes([2]) + gray[at + 10:at + 13] + \
        bytes([2, 0x11, 0])
    path.write_bytes(bytes(two[:at + 4]) + frame + gray[at + 2 + 11:])
    same_as_cv2(path)


@pytest.mark.parametrize("source", ["pil", "port"])
def test_cmyk_and_ycck(source, tmp_path):
    """4-component files, bit for bit as cv2.imread reads them (libjpeg's
    CMYK output, YCCK converted by its ycck_cmyk_convert, then OpenCV's
    own CMYK to BGR and to gray): PIL's Adobe (inverted) CMYK at qualities
    75 and 95, 4:4:4 and 4:2:0, the same patched to YCCK and with the
    Adobe marker taken out (CMYK without it); the port's encoder's CMYK
    (transform 0) and YCCK (transform 2, 4:2:0 and 4:2:2, restart
    markers), progressive and sequential, noise and smooth; truncated
    files as cv2 reads them."""
    rng = np.random.default_rng(12)
    path = tmp_path / "k.jpg"
    for H, W in ((8, 16), (37, 53)):
        noise = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
        smooth = np.clip(np.cumsum(rng.normal(0, 8, (H, W, 4)), axis=1)
                         + 128, 0, 255).astype(np.uint8)
        files = []
        for im in (noise, smooth):
            if source == "pil":
                for q, sub in ((75, 2), (95, 0)):
                    buf = io.BytesIO()
                    Image.fromarray(im, "CMYK").save(buf, "JPEG", quality=q,
                                                     subsampling=sub)
                    data = buf.getvalue()
                    _, adobe, _ = _find(data, 0xEE)
                    ycck = bytearray(data)
                    ycck[adobe + 15] = 2
                    _, start, end = _find(data, 0xEE)
                    bare = data[:start] + data[end:]
                    files += [data, bytes(ycck), bare]
            else:
                files += [image_io.encode_jpeg(im, 90, "444", 0, 0),
                          image_io.encode_jpeg(im, 85, "420", 2, 2),
                          image_io.encode_jpeg(im, 95, "422", 0, 2)]
        for data in files:
            path.write_bytes(data)
            same_as_cv2(path)
        for cut in (len(files[-1]) // 2, len(files[-1]) - 9):
            path.write_bytes(files[-1][:cut])
            same_as_cv2(path)


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


# -- arithmetic coding, lossless files, fractional sampling ---------------

ARITH = {"sequential": {}, "progressive": dict(progressive=True),
         "restart": dict(restart_interval=3),
         "progressive_restart": dict(progressive=True, restart_interval=5),
         "conditioning": dict(conditioning=(2, 6, 12))}
# the port's encoder's samplings, and gray, CMYK and YCCK files
ARITH_SAMPLINGS = list(SAMPLING) + ["gray", "cmyk", "ycck"]


def _reads_as_cv2(data: bytes, tmp_path, anydepth: bool) -> str:
    """imread of the bytes as a file against cv2.imread in one mode: the
    same array ("image"), or ValueError where cv2 returns None ("None")."""
    path = tmp_path / "m.jpg"
    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                     else cv2.IMREAD_COLOR)
    if ref is None:
        with pytest.raises(ValueError):
            image_io.imread(str(path), anydepth=anydepth)
        return "None"
    got = image_io.imread(str(path), anydepth=anydepth)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return "image"


def _arith_source(H, W, sampling, kind, seed=0):
    """An image and encode_jpeg's keywords for one of ARITH_SAMPLINGS."""
    im = _image(H, W, kind, seed)
    if sampling == "gray":
        return im[..., 0], {}
    if sampling in ("cmyk", "ycck"):
        return np.concatenate([im, im[..., 1:2]], -1), dict(
            adobe_transform=0 if sampling == "cmyk" else 2)
    return im, dict(subsampling=sampling)


@pytest.mark.parametrize("sampling", ARITH_SAMPLINGS)
@pytest.mark.parametrize("coding", list(ARITH))
def test_arithmetic_matches_cv2(coding, sampling, tmp_path):
    """Arithmetic-coded files (SOF9 sequential, SOF10 progressive with
    libjpeg's simple progression: DC first and refine, AC first and
    refine), written by the port's QM encoder with restart intervals and
    DAC conditioning, at 1 x 1, 7 x 9 and 67 x 93, quality 30, 75 and 95,
    of every sampling, gray, CMYK and YCCK: read bit for bit as
    cv2.imread reads them, in both modes."""
    for (H, W), kind, q in zip(SIZES, ("noise", "smooth", "noise"),
                               (30, 75, 95)):
        im, kw = _arith_source(H, W, sampling, kind, seed=H)
        data = image_io.encode_jpeg(im, q, arithmetic=True, **ARITH[coding],
                                    **kw)
        marker = b"\xff\xca" if ARITH[coding].get("progressive") \
            else b"\xff\xc9"
        assert marker in data and b"\xff\xc4" not in data
        assert (b"\xff\xcc" in data) == (coding == "conditioning")
        for anydepth in (False, True):
            assert _reads_as_cv2(data, tmp_path, anydepth) == "image"


def test_arithmetic_equals_huffman_pixels():
    """The same quantised coefficients, Huffman-coded (baseline) and
    arithmetic-coded (sequential and progressive, with restarts): the same
    samples, in both output modes; the arithmetic files are smaller."""
    for sampling in ("420", "444"):
        im = _image(67, 93, "smooth")
        base = image_io.encode_jpeg(im, 90, sampling)
        for kw in ARITH.values():
            data = image_io.encode_jpeg(im, 90, sampling, arithmetic=True,
                                        **kw)
            assert len(data) < len(base)
            for gray in (False, True):
                np.testing.assert_array_equal(
                    image_io.decode_jpeg(data, gray=gray),
                    image_io.decode_jpeg(base, gray=gray))


@pytest.mark.parametrize("coding", ["sequential", "restart", "progressive",
                                    "progressive_restart"])
def test_arithmetic_truncated_and_damaged(coding, tmp_path):
    """Every prefix of an arithmetic-coded 4:2:0 file (zero data after the
    end, read as libjpeg's fake EOI marker gives it; a segment stopped by
    a bad code or a spectral overflow) and 150 files with bytes overwritten
    at random: the decoder returns cv2.imread's image bit for bit, or
    raises ValueError where it returns None."""
    data = image_io.encode_jpeg(_image(16, 24, "noise", seed=3), 85,
                                arithmetic=True, **ARITH[coding])
    outcomes = [_reads_as_cv2(data[:n], tmp_path, False)
                for n in range(len(data) + 1)]
    assert outcomes[-1] == "image" and "None" in outcomes
    assert outcomes.count("image") > len(data) // 2
    rng = np.random.default_rng(17)
    for _ in range(150):
        raw = bytearray(data)
        for i in rng.integers(2, len(raw), rng.integers(1, 5)):
            raw[i] = rng.integers(0, 256)
        _reads_as_cv2(bytes(raw), tmp_path, bool(rng.integers(0, 2)))


LOSSLESS = {"gray": (8, 0), "gray_pt": (8, 3), "gray_6bit": (6, 1),
            "rgb": (8, 0), "rgb_pt": (8, 2)}


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("kind", list(LOSSLESS))
def test_lossless_matches_cv2(kind, predictor, tmp_path):
    """Lossless files (SOF3) of predictors 1-7, point transforms, 6-bit
    samples and restart intervals (one every 3 rows), gray and RGB:
    cv2.imread reads gray only with IMREAD_ANYDEPTH and RGB only without
    (libjpeg-turbo converts no colour in a lossless file), each bit for bit
    as the decoder reads it, and returns None in the other mode, where the
    decoder raises ValueError; without a point transform they are the
    samples."""
    precision, pt = LOSSLESS[kind]
    im = _image(23, 37, "smooth")
    im[4:9, 5:30] = _image(5, 25, "noise", seed=predictor)
    im = (im.astype(np.int64) >> (8 - precision)).astype(np.uint8)
    gray = kind.startswith("gray")
    src = im[..., 0] if gray else im
    for restart in (0, 3):
        data = image_io.encode_jpeg(src, lossless=True, predictor=predictor,
                                    point_transform=pt, precision=precision,
                                    restart_interval=restart)
        assert _reads_as_cv2(data, tmp_path, gray) == "image"
        assert _reads_as_cv2(data, tmp_path, not gray) == "None"
        got = image_io.decode_jpeg(data, gray=gray)
        want = (src.astype(np.int64) >> pt << pt).astype(np.uint8)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["gray", "rgb_restart"])
def test_lossless_truncated_and_damaged(kind, tmp_path):
    """Every prefix of a lossless file (the MCU rows after the data ran
    out at 2^(P - Pt - 1)) and 150 randomly damaged copies: cv2.imread's
    image bit for bit, or ValueError where it returns None."""
    im = _image(12, 20, "noise", seed=4)
    gray = kind == "gray"
    data = image_io.encode_jpeg(im[..., 0] if gray else im, lossless=True,
                                predictor=6 if gray else 5,
                                restart_interval=0 if gray else 2)
    outcomes = [_reads_as_cv2(data[:n], tmp_path, gray)
                for n in range(len(data) + 1)]
    assert outcomes[-1] == "image" and "None" in outcomes
    rng = np.random.default_rng(19)
    for _ in range(150):
        raw = bytearray(data)
        for i in rng.integers(2, len(raw), rng.integers(1, 5)):
            raw[i] = rng.integers(0, 256)
        _reads_as_cv2(bytes(raw), tmp_path, gray)


def test_lossless_colour_spaces(tmp_path):
    """A lossless 3-component file is RGB unless a JFIF marker or an Adobe
    transform of 1 makes it YCbCr (component ids 'R', 'G', 'B' or 1, 2, 3
    alike): RGB reads without IMREAD_ANYDEPTH only, YCbCr in neither mode;
    a restart interval that is not whole MCU rows, a table missing (no
    standard tables in a lossless file), arithmetic lossless (SOF11) and
    12- or 16-bit samples: cv2 returns None, ValueError."""
    im = _image(9, 13, "noise", seed=6)
    data = image_io.encode_jpeg(im, lossless=True, predictor=1)
    jfif = _segment_bytes(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    cases = {"ids 1, 2, 3": (data, "image"),
             "JFIF": (data[:2] + jfif + data[2:], "None"),
             "Adobe 0": (data[:2] + _adobe(0) + data[2:], "image"),
             "Adobe 1": (data[:2] + _adobe(1) + data[2:], "None")}
    raw = bytearray(data)
    sof, sos = data.index(b"\xff\xc3"), data.index(b"\xff\xda")
    for k, c in enumerate(b"RGB"):
        raw[sof + 10 + 3 * k] = raw[sos + 5 + 2 * k] = c
    cases["ids R, G, B"] = (bytes(raw), "image")
    gray = image_io.encode_jpeg(im[..., 0], lossless=True, predictor=2,
                                restart_interval=2)
    at = gray.index(b"\xff\xdd")
    cases["restart not whole rows"] = (
        gray[:at + 4] + struct.pack(">H", 2 * 13 + 1) + gray[at + 6:], "None")
    at = gray.index(b"\xff\xc4")
    n, = struct.unpack(">H", gray[at + 2:at + 4])
    cases["no DHT"] = (gray[:at] + gray[at + 2 + n:], "None")
    cases["SOF11"] = (gray.replace(b"\xff\xc3", b"\xff\xcb"), "None")
    for p in (12, 16):
        wide = image_io.encode_jpeg(im[..., 0].astype(np.uint16) << (p - 8),
                                    lossless=True, precision=p)
        cases[f"{p}-bit"] = (wide, "None")
    for name, (body, colour) in cases.items():
        assert _reads_as_cv2(body, tmp_path, False) == colour, name
        assert _reads_as_cv2(body, tmp_path, True) == "None", name


def _segment_bytes(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _adobe(transform: int) -> bytes:
    return _segment_bytes(0xEE, b"Adobe\x00\x64\0\0\0\0" + bytes([transform]))


@pytest.mark.parametrize("factors", [(0x31, 0x21, 0x11), (0x21, 0x31, 0x11),
                                     (0x13, 0x12, 0x11), (0x32, 0x11, 0x11)])
def test_fractional_sampling(factors, tmp_path):
    """A 4:4:4 file's sampling factors set to ratios libjpeg upsamples by
    no integer (Y 3 x 1, Cb 2 x 1, Cr 1 x 1 and the like): read with
    IMREAD_ANYDEPTH, the Y plane alone, as cv2 reads it (none when Y
    itself is fractional); in colour, ValueError where cv2 returns None
    (every component is needed); integral ones read in both modes."""
    raw = bytearray(image_io.encode_jpeg(_image(37, 45, "smooth"), 90,
                                         "444"))
    sof = raw.index(b"\xff\xc0")
    raw[sof + 11], raw[sof + 14], raw[sof + 17] = factors
    y_whole = factors[0] >> 4 == max(f >> 4 for f in factors) and \
        factors[0] & 15 == max(f & 15 for f in factors)
    integral = factors == (0x32, 0x11, 0x11)
    assert _reads_as_cv2(bytes(raw), tmp_path, True) == (
        "image" if y_whole else "None")
    assert _reads_as_cv2(bytes(raw), tmp_path, False) == (
        "image" if integral else "None")
