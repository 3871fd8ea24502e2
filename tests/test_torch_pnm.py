"""The port's Netpbm decoders (lgu_slam_tpu_torch/data/pnm.py: PBM, PGM,
PPM, PAM and PFM) against ``cv2.imread``, which is what the JAX package's
data layer calls: ``imread(path)`` and ``imread(path, anydepth=True)``
equal ``cv2.imread(path)`` and ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``
bit for bit (dtype, shape, bytes; tolerance 0), and files cv2 returns None
for raise ValueError.  Fixtures: ``cv2.imwrite`` (.pgm, .ppm, .pbm, .pam,
.pfm) and the port's encoders for ASCII files, odd maxvals, comments,
every PAM tuple type and PFM scales."""

import cv2
import numpy as np
import pytest
from torch_port import same_as_cv2, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data import image_io, pnm

H, W = 7, 11


def _image(ch, dtype, rng):
    top = np.iinfo(dtype).max + 1
    return rng.integers(0, top, (H, W) + ((3,) if ch == 3 else ())
                        ).astype(dtype)


@pytest.mark.parametrize("ext", ["pgm", "ppm", "pbm", "pam", "pfm"])
def test_decodes_cv2_files(ext, tmp_path):
    """cv2.imwrite's files, 8- and 16-bit (float for .pfm), gray and
    colour: 16-bit samples keep their high byte in the colour read, colour
    reads to gray as (4899 R + 9617 G + 1868 B + 8192) >> 14, PAM keeps
    the file's channel order, gray PFM reads only with anydepth and colour
    PFM only without it."""
    rng = np.random.default_rng(len(ext))
    path = tmp_path / f"a.{ext}"
    images = {
        "pgm": [_image(1, np.uint8, rng), _image(1, np.uint16, rng)],
        "ppm": [_image(3, np.uint8, rng), _image(3, np.uint16, rng)],
        "pbm": [_image(1, np.uint8, rng) // 128 * 255],
        "pam": [_image(1, np.uint8, rng), _image(3, np.uint8, rng)],
        "pfm": [rng.standard_normal((H, W)).astype(np.float32) * 50,
                (rng.standard_normal((H, W, 3)) * 120 + 100
                 ).astype(np.float32)],
    }[ext]
    for im in images:
        assert cv2.imwrite(str(path), im)
        same_as_cv2(path)


@pytest.mark.parametrize("maxval", [None, 1, 9, 100, 255, 256, 1000, 65535])
def test_maxvals(maxval, tmp_path):
    """P2, P3 (ASCII) and P5, P6 (binary) at a maxval, with a comment line
    and samples above maxval: ASCII 8-bit samples clamp and scale by
    v * 255 // maxval, binary 8-bit ones are kept, 16-bit ones kept or
    shifted right by 8; P1 and P4 (1 black)."""
    rng = np.random.default_rng(maxval or 0)
    path = tmp_path / "m.pnm"
    for ch in (1, 3):
        for dtype in (np.uint8, np.uint16):
            if maxval is not None and (maxval > 255) != (dtype == np.uint16):
                continue
            im = _image(ch, dtype, rng)
            if maxval is not None:
                im = np.minimum(im.astype(np.int64), maxval + 3).astype(dtype)
            for binary in (True, False):
                for comment in (None, "written by hand"):
                    path.write_bytes(pnm.encode_pnm(im, maxval, binary,
                                                    comment=comment))
                    same_as_cv2(path)
    bits = rng.integers(0, 2, (H, W)).astype(np.uint8)
    for binary in (True, False):
        path.write_bytes(pnm.encode_pnm(bits, binary=binary, bilevel=True))
        same_as_cv2(path)
        np.testing.assert_array_equal(image_io.imread(str(path),
                                                      anydepth=True),
                                      (1 - bits) * 255)


@pytest.mark.parametrize("tupltype", [None, "GRAYSCALE", "RGB",
                                      "BLACKANDWHITE", "GRAYSCALE_ALPHA",
                                      "RGB_ALPHA"])
def test_pam_tuple_types(tupltype, tmp_path):
    """Each TUPLTYPE at 8 and 16 bits and MAXVAL 1 (each row's bytes read
    as packed bits, 1 white): as cv2.imread reads them; with an alpha
    channel (not MAXVAL 1) NotImplementedError, because cv2's result then
    holds memory it never wrote; no TUPLTYPE with 16 bits or 2 and 4
    channels: ValueError, as cv2 returns None."""
    rng = np.random.default_rng(3)
    path = tmp_path / "p.pam"
    depth = {None: (1, 3, 2, 4), "GRAYSCALE": (1,), "RGB": (3,),
             "BLACKANDWHITE": (1,), "GRAYSCALE_ALPHA": (2,),
             "RGB_ALPHA": (4,)}[tupltype]
    for D in depth:
        for dtype, maxval in ((np.uint8, None), (np.uint8, 1),
                              (np.uint8, 100), (np.uint16, None)):
            im = rng.integers(0, np.iinfo(dtype).max + 1, (H, W, D)
                              ).astype(dtype)
            path.write_bytes(pnm.encode_pam(im, tupltype, maxval))
            alpha = D in (2, 4) and maxval != 1
            if alpha and tupltype is not None:
                assert cv2.imread(str(path)) is not None
                with pytest.raises(NotImplementedError, match="never"):
                    image_io.imread(str(path))
            else:
                same_as_cv2(path)


@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.5, 3.0, -1e-3])
def test_pfm_scales(scale, tmp_path):
    """Pf and PF at scales whose sign gives the byte order, samples times
    float32(1 / |scale|); colour rounded half to even and saturated, NaN
    and values past the int range giving 0; rows stored bottom-up."""
    rng = np.random.default_rng(5)
    path = tmp_path / "f.pfm"
    gray = rng.standard_normal((H, W)).astype(np.float32) * 100
    gray[0, :3] = (np.nan, -0.0, np.inf)
    colour = (rng.standard_normal((H, W, 3)) * 150 + 100).astype(np.float32)
    colour[0, 0] = (np.nan, np.inf, -np.inf)
    colour[0, 1] = (0.5, 1.5, 2.5)
    colour[0, 2] = (3e9, -3e9, 254.5)
    for im in (gray, colour):
        path.write_bytes(pnm.encode_pfm(im, scale))
        same_as_cv2(path)
    if scale == -1.0:  # the pixels written, rows 1.. (row 0 holds NaN)
        np.testing.assert_array_equal(
            image_io.imread(str(path))[1:],
            np.clip(np.rint(colour[1:]), 0, 255).astype(np.uint8))


HEADERS = {
    # PNM
    "p5_no_space_after_magic": b"P53 1 255\n\x01\x02\x03",
    "p5_comment_as_separator": b"P5 3 1 255#x\n\x01\x02\x03",
    "p5_blank_before_data": b"P5\n3 1\n255\n\n\x01\x02\x03",
    "p5_comments": b"P5\n# one\n3 # two\n1\n255\n\x01\x02\x03",
    "p5_extra_data": b"P5\n3 1\n255\n\x01\x02\x03\x04\x05",
    "p5_maxval_0": b"P5\n3 1\n0\n\x01\x02\x03",
    "p5_maxval_65536": b"P5\n3 1\n65536\n" + bytes(12),
    "p5_width_0": b"P5\n0 1\n255\n\x01",
    "p2_no_end": b"P2\n3 1\n255\n1 2 3",
    "p2_negative": b"P2\n3 1\n255\n1 -2 3\n",
    "p2_comment_in_data": b"P2\n3 1\n255\n1 #x\n2 3\n",
    "p1_digits_run": b"P1\n5 2\n1010101010",
    "p1_no_end": b"P1\n3 1\n1 0 1",
    # PAM
    "pam_crlf": b"P7\r\nWIDTH 4\r\nHEIGHT 1\r\nDEPTH 1\r\nMAXVAL 255\r\n"
                b"ENDHDR\r\n\x01\x02\x03\x04",
    "pam_spaces_tab": b"P7\n WIDTH\t 4  \nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                      b"ENDHDR\n\x01\x02\x03\x04",
    "pam_lowercase": b"P7\nwidth 4\nheight 1\ndepth 1\nmaxval 255\n"
                     b"endhdr\n\x01\x02\x03\x04",
    "pam_tupltype_lowercase": b"P7\nWIDTH 4\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                              b"TUPLTYPE grayscale\nENDHDR\n\x01\x02\x03\x04",
    "pam_twice": b"P7\nWIDTH 4\nWIDTH 4\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                 b"ENDHDR\n\x01\x02\x03\x04",
    "pam_no_maxval": b"P7\nWIDTH 4\nHEIGHT 1\nDEPTH 1\nENDHDR\n\x01\x02\x03"
                     b"\x04",
    "pam_leading_zero": b"P7\nWIDTH 04\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                        b"ENDHDR\n\x01\x02\x03\x04",
    "pam_hex": b"P7\nWIDTH 0x4\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n"
               b"\x01\x02\x03\x04",
    "pam_junk": b"P7\nWIDTH 4x\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n"
                b"\x01\x02\x03\x04",
    "pam_unknown_field": b"P7\nWIDTH 4\nFOO 1\nHEIGHT 1\nDEPTH 1\n"
                         b"MAXVAL 255\nENDHDR\n\x01\x02\x03\x04",
    "pam_space_after_magic": b"P7 WIDTH 4\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                             b"ENDHDR\n\x01\x02\x03\x04",
    "pam_depth_5": b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 5\nMAXVAL 255\nENDHDR\n"
                   + bytes(5),
    # PFM
    "pfm_cr": b"Pf\r4 1\n-1\n" + bytes(16),
    "pfm_space": b"Pf 4 1\n-1\n" + bytes(16),
    "pfm_junk_width": b"Pf\n4x 1\n-1\n" + bytes(16),
    "pfm_junk_scale": b"Pf\n4 1\n-1junk\n" + bytes(16),
    "pfm_scale_0": b"Pf\n4 1\n0\n" + bytes(16),
    "pfm_fraction_scale": b"Pf\n1 1\n.5\n" + np.float32(3).astype(
        ">f4").tobytes(),
    "pfm_extra_data": b"Pf\n1 1\n-1\n" + bytes(4) + b"junk",
}


@pytest.mark.parametrize("name", list(HEADERS))
def test_headers(name, tmp_path):
    """Headers cv2 reads and refuses, one case each: the port reads what
    cv2 reads, to the same array, and raises ValueError where it returns
    None (or raises)."""
    data = HEADERS[name]
    path = tmp_path / "h.bin"
    path.write_bytes(data)
    same_as_cv2(path)


@pytest.mark.parametrize("ext", ["pgm", "ppm", "pbm", "pam", "pfm"])
def test_truncated_and_damaged(ext, tmp_path):
    """Every cut of a cv2.imwrite file, and the ASCII files' data with a
    byte turned into a letter: ValueError wherever cv2 returns None, the
    same array where it reads one."""
    rng = np.random.default_rng(8)
    path = tmp_path / f"t.{ext}"
    im = {"pgm": _image(1, np.uint16, rng), "ppm": _image(3, np.uint8, rng),
          "pbm": _image(1, np.uint8, rng) // 128 * 255,
          "pam": _image(3, np.uint8, rng),
          "pfm": rng.standard_normal((H, W, 3)).astype(np.float32)}[ext]
    assert cv2.imwrite(str(path), im)
    full = path.read_bytes()
    for cut in sorted({0, 1, 2, 3, 5, 9, 14, 20, len(full) // 2,
                       len(full) - 1}):
        path.write_bytes(full[:cut])
        same_as_cv2(path)
    ascii_ = pnm.encode_pnm(_image(3, np.uint8, rng), binary=False)
    for at in (len(ascii_) - 2, len(ascii_) // 2, 12):
        damaged = bytearray(ascii_)
        damaged[at] = ord("x")
        path.write_bytes(bytes(damaged))
        same_as_cv2(path)
