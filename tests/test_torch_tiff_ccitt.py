"""The port's CCITT decoder (lgu_slam_tpu_torch/csrc/host/ccitt_decode.c,
through data/tiff.py) against ``cv2.imread``, which is what the JAX
package's data layer calls: 1-bit TIFFs coded as modified Huffman runs
(compression 2, RLE; 32771, RLEW), T.4 Group 3 (1-D, 2-D READ, EOLs with
fill bits) and T.6 Group 4, in both FillOrders and both photometric
interpretations, read bit for bit as cv2 reads them in both modes
(``same_as_cv2``: dtype, shape, bytes; tolerance 0), damaged streams
included.  Fixtures: the port's ``ccitt_encode`` and PIL, whose TIFF
writer is libtiff's own CCITT encoder."""

import io
import os

import numpy as np
import pytest
from test_torch_tiff import _patch
from torch_port import same_as_cv2, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data import image_io, tiff
from lgu_slam_tpu_torch.ops import _build

# encode_tiff's compression and T4Options of each scheme
SCHEMES = {"rle": ("ccitt_rle", 0), "rlew": ("ccitt_rlew", 0),
           "g3_1d": ("group3", 0), "g3_2d": ("group3", 1),
           "g3_fill": ("group3", 4), "g3_2d_fill": ("group3", 5),
           "g4": ("group4", 0)}
# odd widths (partial bytes), one pixel, and runs past the 2560 make-up code
SIZES = ((1, 1), (5, 7), (21, 35), (33, 64), (17, 2700))


def _bits(H, W, rng, kind):
    """Noise (short runs, every code) or blobs (long runs, pass modes)."""
    if kind == "noise":
        return (rng.random((H, W)) > 0.5).astype(np.uint8)
    yy, xx = np.mgrid[:H, :W]
    field = np.sin(xx / 4.0 + rng.random() * 6) * np.cos(yy / 3.0)
    return (field + 0.3 * rng.standard_normal((H, W)) > 0.2).astype(np.uint8)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_ccitt_matches_cv2(scheme, tmp_path):
    """Every scheme, FillOrder 1 and 2, min-is-white and min-is-black, one
    strip or strips of 4 rows, at odd sizes: as cv2.imread reads it, and
    the colour read is the pixels coded (black 1, shown as 0 where the
    photometric interpretation is min-is-white).  RLEW is the exception:
    libtiff's decoder drops the bytes of a row whose codes end in the
    first byte of a 16-bit word where it loaded the next byte already
    (Fax3DecodeRLE's word alignment), and cv2 reads those rows white."""
    rng = np.random.default_rng(list(SCHEMES).index(scheme))
    compression, options = SCHEMES[scheme]
    path = tmp_path / "c.tif"
    for H, W in SIZES:
        for kind in ("noise", "blobs"):
            bits = _bits(H, W, rng, kind)
            for fill_order in (1, 2):
                for photometric in (0, 1):
                    for layout in ({}, dict(rows_per_strip=4)):
                        path.write_bytes(tiff.encode_tiff(
                            bits, compression, bilevel=True,
                            photometric=photometric, t4_options=options,
                            fill_order=fill_order, **layout))
                        same_as_cv2(path)
            if scheme != "rlew":
                want = np.repeat((255 * (1 - bits))[..., None], 3, -1)
                np.testing.assert_array_equal(image_io.imread(str(path)),
                                              255 - want if photometric
                                              else want)


@pytest.mark.parametrize("compression",
                         ["group3", "group4", "tiff_ccitt", "tiff_raw_16"])
def test_libtiff_written(compression, tmp_path):
    """libtiff's own CCITT encoder (PIL's TIFF writer): RLE, RLEW, Group 3
    and Group 4 of min-is-black images read as cv2.imread reads them, and
    (but RLEW, test_ccitt_matches_cv2) as the pixels written."""
    from PIL import Image

    rng = np.random.default_rng(7)
    path = tmp_path / "p.tif"
    for H, W in SIZES[1:]:
        for kind in ("noise", "blobs"):
            bits = _bits(H, W, rng, kind).astype(bool)
            buf = io.BytesIO()
            Image.fromarray(bits).save(buf, "TIFF", compression=compression)
            path.write_bytes(buf.getvalue())
            same_as_cv2(path)
            if compression != "tiff_raw_16":
                np.testing.assert_array_equal(
                    image_io.imread(str(path), anydepth=True), 255 * bits)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_damaged_streams(scheme, tmp_path):
    """A file of five strips (of 5 rows: libtiff starts each strip's run
    arrays anew, but not their stale entries) with each strip's byte count
    cut, and 300 copies with 1-3 bytes of its strips replaced or
    bit-flipped: as cv2.imread reads them.  This holds libtiff's handling of damage: a code word in
    no table ends the row (its rest filled white, or black after a white
    run), a row the data does not finish ends the strip, a Group 3 strip
    whose data ends while an EOL's fill is skipped is decoded again from
    its first bit as if written without EOLs (and so is every later
    strip), rows the decoder never reached stay zero."""
    rng = np.random.default_rng(31 + list(SCHEMES).index(scheme))
    compression, options = SCHEMES[scheme]
    bits = _bits(23, 37, rng, "blobs")
    data = tiff.encode_tiff(bits, compression, bilevel=True, photometric=0,
                            t4_options=options, rows_per_strip=5)
    tags = tiff._ifd(data, "")[0]
    path = tmp_path / "d.tif"
    for k, count in enumerate(tags["strip_counts"]):
        for cut in range(1, count, 3):
            path.write_bytes(_patch(data, 279, cut, k))
            same_as_cv2(path)
    start = tags["strip_offsets"][0]
    end = tags["strip_offsets"][-1] + tags["strip_counts"][-1]
    for _ in range(300):
        raw = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start, end))
            raw[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else \
                raw[i] ^ 1 << int(rng.integers(0, 8))
        path.write_bytes(bytes(raw))
        same_as_cv2(path)


def test_encoder_round_trip():
    """``ccitt_encode`` of every scheme but RLEW (test_ccitt_matches_cv2)
    decodes (``decode_tiff``) to the pixels coded, over images of every run
    length up to 3000 and blobs whose rows pass modes, vertical and
    horizontal modes code."""
    rng = np.random.default_rng(5)
    for H, W in ((9, 3000), (40, 77)):
        bits = _bits(H, W, rng, "blobs")
        bits[0] = 0
        bits[1, 17:2900 if W > 2900 else W - 3] = 1  # long black run
        for name, (compression, options) in SCHEMES.items():
            if name == "rlew":
                continue
            data = tiff.encode_tiff(bits, compression, bilevel=True,
                                    photometric=1, t4_options=options)
            np.testing.assert_array_equal(tiff.decode_tiff(data, gray=True),
                                          255 * bits)


def test_ccitt_refusals(tmp_path):
    """What cv2.imread returns None for raises ValueError: Group 3 and 4 of
    8-bit samples, and a CCITT image of two samples per pixel."""
    rng = np.random.default_rng(3)
    path = tmp_path / "r.tif"
    gray = rng.integers(0, 256, (9, 12), np.uint8)
    two = tiff.encode_tiff(np.stack([gray & 1, gray >> 7], -1), "group4",
                           bilevel=True)
    for data in (_patch(tiff.encode_tiff(gray), 259, 3),
                 _patch(tiff.encode_tiff(gray), 259, 4), two):
        path.write_bytes(data)
        same_as_cv2(path)
        with pytest.raises(ValueError, match="cv2.imread returns None"):
            image_io.imread(str(path))


@pytest.mark.parametrize("library", ["ccitt_decode", "tiff_color"])
def test_failed_c_build_raises_new_libraries(library, tmp_path, monkeypatch):
    """The CCITT decoder's or the colour conversions' failed build raises
    and leaves no library: nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CC", "false")
    data = tiff.encode_tiff(np.ones((4, 9), np.uint8), "group4",
                            bilevel=True) if library == "ccitt_decode" else \
        tiff.encode_tiff(np.ones((4, 9, 4), np.uint8), photometric=5)
    with pytest.raises(RuntimeError, match=f"{library}.c"):
        tiff.decode_tiff(data)
    assert not os.path.exists(tmp_path / f"lib{library}.so")
