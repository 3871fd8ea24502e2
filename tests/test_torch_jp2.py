"""JPEG 2000 (lgu_slam_tpu_torch/data/jp2.py, the codestream in C,
csrc/host/j2k_decode.c) against ``cv2.imread`` (OpenCV 5.0 over OpenJPEG
2.5): JP2 files and raw codestreams written by ``cv2.imwrite``, Pillow and
(for the coding options neither exposes) Pillow's OpenJPEG, read bit for
bit in both read modes, as are tile-parts, packed packet headers, damaged
and cut files; what cv2 returns None for raises ValueError."""

import hashlib
import importlib.util
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port import (  # noqa: F401
    damaged_same_as_cv2,
    same_as_cv2,
    torch_single_thread,
)

from lgu_slam_tpu_torch.data import image_io, jp2

DATA = os.path.join(os.path.dirname(__file__), "data", "jp2")
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                      "make_jp2_fixtures_torch.py")


def _script():
    spec = importlib.util.spec_from_file_location("make_jp2_fixtures", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _frame(H=48, W=64, C=3, seed=0):
    """Smooth rows with noise on them: every band gets coefficients."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-4, 5, (H, W, C)), axis=1) + 128
    return (walk + rng.integers(-6, 7, (H, W, C))).clip(0, 255).astype(
        np.uint8)


def _pillow(array, **kw) -> bytes:
    """Pillow's JPEG 2000 of ``array`` (its mode inferred: L, LA, RGB,
    RGBA or I;16)."""
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _codestream(data: bytes) -> bytes:
    return data[data.index(jp2.CODESTREAM):]


def _check(data: bytes, tmp_path, name="f.jp2"):
    path = tmp_path / name
    path.write_bytes(data)
    same_as_cv2(path)


@pytest.mark.parametrize("compression", [None, 1000, 500, 100])
@pytest.mark.parametrize("kind", ["bgr8", "gray8", "bgr16", "gray16"])
def test_cv2_imwrite(kind, compression, tmp_path):
    """cv2.imwrite's JP2 at its default (rate allocation cuts code blocks'
    passes short) and at IMWRITE_JPEG2000_COMPRESSION_X1000 1000, 500 and
    100, colour and gray, 8 and 16 bits, at odd and even sizes; and the raw
    codestream cut out of each file."""
    params = [] if compression is None else [
        cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, compression]
    for H, W in ((48, 64), (37, 51)):
        im = _frame(H, W, 3, seed=H)
        if kind.endswith("16"):
            im = im.astype(np.uint16) * 251 + 7
        if kind.startswith("gray"):
            im = im[..., 0]
        path = tmp_path / "c.jp2"
        assert cv2.imwrite(str(path), im, params)
        same_as_cv2(path)
        _check(_codestream(path.read_bytes()), tmp_path, "c.j2k")


PILLOW = {
    "lossless": dict(),
    "irreversible": dict(irreversible=True),
    "rct": dict(mct=1),
    "ict": dict(irreversible=True, mct=1),
    **{f"{p.lower()}_precincts": dict(progression=p, num_resolutions=3,
                                      precinct_size=(16, 16),
                                      codeblock_size=(8, 16))
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"{p.lower()}_tiles_layers": dict(
        progression=p, tile_size=(32, 40), irreversible=True,
        quality_layers=[40, 10, 2]) for p in ("LRCP", "RPCL", "CPRL")},
    **{f"resolutions_{n}": dict(num_resolutions=n, irreversible=n % 2 == 0)
       for n in range(1, 7)},
    "tiles_not_dividing": dict(tile_size=(33, 17), num_resolutions=4,
                               mct=1),
    "tiles_odd_97": dict(tile_size=(29, 21), num_resolutions=3,
                         irreversible=True),
    "layers_db": dict(quality_mode="dB", quality_layers=[30, 40, 50],
                      plt=True, comment="layers"),
    "codeblocks_4x1024": dict(codeblock_size=(4, 1024), num_resolutions=2),
    "precincts_rpcl_tiles": dict(codeblock_size=(64, 64),
                                 precinct_size=(32, 64), num_resolutions=5,
                                 progression="RPCL", tile_size=(64, 48)),
}


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "I;16"])
@pytest.mark.parametrize("case", list(PILLOW))
def test_pillow(case, mode, tmp_path):
    """Pillow's files (OpenJPEG 2.5's encoder) of each option: 5/3 and 9/7,
    the RCT and ICT, all five progression orders with precincts, tiles
    that do not divide the image, 1 to 6 resolutions, quality layers by
    rate and by distortion, PLT and COM markers, code blocks of 4 x 1024;
    RGB, gray, RGBA (its channel definitions) and 16-bit gray; as JP2 and
    as a raw codestream (no_jp2)."""
    im = _frame(75, 93, 4, seed=len(case))
    array = {"RGB": im[..., :3], "L": im[..., 0], "RGBA": im,
             "I;16": im[..., 0].astype(np.uint16) * 257 + im[..., 1]}[mode]
    for no_jp2 in (False, True):
        _check(_pillow(array, no_jp2=no_jp2, **PILLOW[case]), tmp_path,
               "p.j2k" if no_jp2 else "p.jp2")


def test_committed_fixtures_decode_to_cv2_hashes():
    """tests/data/jp2 (scripts/make_jp2_fixtures_torch.py: Pillow's,
    cv2.imwrite's and OpenJPEG's files of a rendered frame, the six
    code-block styles, SOP / EPH, POC, ROI, 12 bits, a palette, PPT and
    PPM, two 480 x 640 frames; the port's HT writer's HTJ2K files, a
    damaged one and a cut one): the port's arrays hash as cv2.imread's do
    (the hashes written beside them, which chip_smoke.py phases 16 and 18
    check on machines without OpenCV), or both refuse (null: ValueError),
    and cv2 still agrees; each file at most 256 KB, the set at most
    640 KB."""
    hashes = json.load(open(os.path.join(DATA, "hashes.json")))
    assert len(hashes) == 24
    total = 0
    for name, want in hashes.items():
        path = os.path.join(DATA, name)
        total += os.path.getsize(path)
        assert os.path.getsize(path) <= 256 * 1024
        for mode, flag in (("color", cv2.IMREAD_COLOR),
                           ("anydepth", cv2.IMREAD_ANYDEPTH)):
            ref = cv2.imread(path, flag)
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
    assert total <= 640 * 1024


def _tile_parts(cs: bytes):
    """(main header, [(tile, marker segments, data)], tail) of a
    codestream whose tiles each have one tile-part."""
    pos = cs.index(b"\xff\x90")
    main, parts = cs[:pos], []
    while cs[pos:pos + 2] == b"\xff\x90":
        tile, psot = struct.unpack_from(">HI", cs, pos + 4)
        part = cs[pos:pos + psot]
        sod = part.index(b"\xff\x93")
        parts.append((tile, part[12:sod], part[sod + 2:]))
        pos += psot
    return main, parts, cs[pos:]


def _sot(tile, body, part, nparts, psot=None):
    return struct.pack(">HHHIBB", 0xFF90, 10, tile,
                       12 + len(body) if psot is None else psot, part,
                       nparts) + body


@pytest.mark.parametrize("nparts", [1, 2, 3])
@pytest.mark.parametrize("declared", [True, False])
def test_tile_parts(nparts, declared, tmp_path):
    """Each tile's data split at arbitrary bytes into ``nparts``
    tile-parts (TNsot given, or 0), the last tile's last tile-part with
    Psot 0, tile-parts of different tiles interleaved, COM markers in the
    tile-part headers: as cv2 reads them; with TNsot 0 and the tiles in
    order the codestream may also lack its EOC, which OpenJPEG allows where
    each tile is one tile-part (and refuses otherwise)."""
    rng = np.random.default_rng(nparts)
    cs = _codestream(_pillow(_frame(60, 72), tile_size=(32, 32),
                             num_resolutions=3, quality_layers=[20, 5]))
    main, parts, tail = _tile_parts(cs)
    pieces = []
    for tile, markers, data in parts:
        cuts = sorted(rng.choice(np.arange(1, len(data)), nparts - 1,
                              replace=False)) if nparts > 1 else []
        chunks = np.split(np.frombuffer(data, np.uint8), cuts)
        for k, chunk in enumerate(chunks):
            extra = markers if k == 0 else b"\xff\x64\x00\x06\x00\x01hi"
            pieces.append((tile, k, extra + b"\xff\x93" + chunk.tobytes()))
    # interleave: the first parts of every tile, then the rest
    pieces.sort(key=lambda p: (p[1] > 0, p[0], p[1]))
    out = [_sot(t, body, k, nparts if declared else 0,
                psot=0 if i == len(pieces) - 1 else None)
           for i, (t, k, body) in enumerate(pieces)]
    _check(main + b"".join(out) + tail, tmp_path)
    if not declared:  # tiles in order, no Psot 0, no EOC
        pieces.sort(key=lambda p: (p[0], p[1]))
        _check(main + b"".join(_sot(t, body, k, 0) for t, k, body in pieces),
               tmp_path, "noeoc.j2k")
        # read where every tile is one tile-part (OpenJPEG's allowance)
        assert (cv2.imread(str(tmp_path / "noeoc.j2k")) is None) == (
            nparts > 1)


def test_markers_read_past(tmp_path):
    """COM, TLM, CRG and an unknown marker segment in the main header, and
    junk after EOC: as cv2 reads them (the unknown marker is skipped to the
    next known one)."""
    cs = _codestream(_pillow(_frame(), num_resolutions=3))
    cod = cs.index(b"\xff\x52")
    extra = {
        "com": b"\xff\x64\x00\x08\x00\x01abcd",
        "tlm": b"\xff\x55\x00\x0a\x00\x60\x00\x00\x00\x00\x04\x00"[:12],
        "crg": b"\xff\x63\x00\x0e" + bytes(12),
        "unknown": b"\xff\x6f\x00\x04\x12\x34",
    }
    for name, seg in extra.items():
        _check(cs[:cod] + seg + cs[cod:], tmp_path, f"{name}.j2k")
    _check(cs + b"\x00" * 9, tmp_path, "junk.j2k")


def _edit(data: bytes, marker: bytes, offset: int, value: bytes) -> bytes:
    at = data.index(marker) + offset
    return data[:at] + value + data[at + len(value):]


def test_damaged_and_cut_files(tmp_path):
    """Every proper prefix and 150 seeded byte mutations of a tiled RPCL
    file with layers and of a 9/7 codestream with SOP / EPH: as cv2 reads
    them (it returns None for a codestream cut inside its data or missing
    its EOC, and decodes the tiles before a cut that falls just after a
    marker).  Then Psot one byte long or short or 0, EPH announced and
    absent, SOP announced and absent, a stray marker where EOC belongs."""
    tiled = _pillow(_frame(40, 56), tile_size=(16, 24), progression="RPCL",
                    quality_layers=[20, 5], num_resolutions=3)
    damaged_same_as_cv2(tiled, tmp_path, mutations=150, seed=1,
                        name="d.jp2")
    opj = open(os.path.join(DATA, "opj_styles.j2k"), "rb").read()
    small = _codestream(_pillow(_frame(24, 32), irreversible=True,
                                num_resolutions=2))
    damaged_same_as_cv2(small, tmp_path, mutations=150, seed=2,
                        name="d.j2k")
    sot = opj.index(b"\xff\x90")
    psot, = struct.unpack_from(">I", opj, sot + 6)
    for value in (psot + 1, psot - 1, 0, 12, 13):
        _check(_edit(opj, b"\xff\x90", 6, struct.pack(">I", value)),
               tmp_path, f"psot{value}.j2k")
    cod = opj.index(b"\xff\x52")
    for scod in (0, 2, 4):  # SOP / EPH flags against the markers present
        _check(_edit(opj, b"\xff\x52", 4, bytes([scod])), tmp_path,
               f"scod{scod}.j2k")
    plain = _codestream(_pillow(_frame(), num_resolutions=2))
    for flag in (2, 4):
        _check(_edit(plain, b"\xff\x52", 4, bytes([flag])), tmp_path,
               f"flag{flag}.j2k")
    _check(plain[:-2] + b"\xff\xf9", tmp_path, "stray.j2k")
    _check(plain[:-2] + b"\xff\xf9\x00", tmp_path, "stray_more.j2k")
    assert cod > 0


def _refusal_cases():
    rgb = _pillow(_frame(), mct=1)
    siz = rgb.index(b"\xff\x51")
    colr = rgb.index(b"colr")
    cases = {
        "signed": _pillow(_frame(), signed=True),
        "image_origin": _edit(rgb, b"\xff\x51", 12, struct.pack(">I", 2)),
        "gray_codestream": _codestream(_pillow(_frame()[..., 0])),
        "gray_alpha": _pillow(_frame()[..., :2]),
        "gray_alpha_codestream": _codestream(_pillow(_frame()[..., :2])),
        "colr_missing": rgb[:colr] + b"xxxx" + rgb[colr + 4:],
        "colr_icc": rgb[:colr + 4] + b"\x02" + rgb[colr + 5:],
        "colr_method_3": rgb[:colr + 4] + b"\x03" + rgb[colr + 5:],
    }
    for comp in range(3):
        for field, value, name in ((1, 2, "dx2"), (2, 3, "dy3"),
                                   (0, 6, "bits7"), (0, 11, "bits12"),
                                   (0, 17, "bits18"), (0, 0x87, "signed8")):
            at = siz + 40 + 3 * comp + field
            cases[f"comp{comp}_{name}"] = rgb[:at] + bytes([value]) + \
                rgb[at + 1:]
    for enum in (0, 12, 14, 16, 17, 18, 24, 99):
        cases[f"colr_{enum}"] = rgb[:colr + 7] + struct.pack(">I", enum) + \
            rgb[colr + 11:]
    gray = _pillow(_frame()[..., 0])
    gcolr = gray.index(b"colr")
    for enum in (16, 18):
        cases[f"gray_colr_{enum}"] = gray[:gcolr + 7] + struct.pack(
            ">I", enum) + gray[gcolr + 11:]
    low = _codestream(_pillow(_frame()[..., 0]))
    at = low.index(b"\xff\x51") + 40
    cases["gray_bits5"] = low[:at] + b"\x04" + low[at + 1:]
    return cases


REFUSALS = _refusal_cases()


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_and_colour_spaces(name, tmp_path):
    """OpenCV's reader on layouts it refuses or converts: signed
    components, an image origin, subsampled components, components of 5,
    7, 12 and 18 bits (wider than 16: no IMREAD_ANYDEPTH read), 1 and 2
    components (gray and gray + alpha) in a codestream (sRGB assumed: no
    colour read) and in a JP2 (gray colr), every colr case (sRGB, gray on
    RGB, sYCC through COLOR_YUV2BGR, CMYK and e-sYCC refused, CIE L*a*b*,
    an unknown value, an ICC profile, an unknown method, none): as cv2
    reads them, ValueError where it returns None."""
    _check(REFUSALS[name], tmp_path, "r.jp2")


def _with_header_boxes(data: bytes, boxes) -> bytes:
    """``data`` with its jp2h box's contents replaced by ``boxes``."""
    def box(kind, body):
        return struct.pack(">I", 8 + len(body)) + kind + body
    at = data.index(b"jp2h") - 4
    length, = struct.unpack_from(">I", data, at)
    return data[:at] + box(b"jp2h", b"".join(box(k, b) for k, b in boxes)) \
        + data[at + length:]


def _ihdr(data: bytes):
    at = data.index(b"ihdr")
    return b"ihdr", data[at + 4:at + 18]


CDEF = {
    "standard": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)],
    "two_alphas": [(0, 0, 1), (1, 0, 2), (2, 1, 0), (3, 1, 0)],
    "premultiplied": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 0)],
    "unspecified": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 65535, 0)],
    "swapped": [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)],
    "rotated": [(0, 0, 2), (1, 0, 3), (2, 0, 1), (3, 1, 0)],
    "alpha_first": [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)],
    "incomplete": [(0, 0, 1), (1, 0, 2), (2, 0, 3)],
    "missing_channel": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (4, 1, 0)],
}


@pytest.mark.parametrize("name", list(CDEF))
def test_channel_definitions(name, tmp_path):
    """RGBA files whose cdef box moves colour channels, marks one or two
    channels as alpha (cv2 checks alpha before the box applies, so two
    alphas read) or misses a channel (None): as cv2 reads them."""
    rgba = _pillow(_frame(C=4))
    cdef = struct.pack(">H", len(CDEF[name])) + b"".join(
        struct.pack(">HHH", *e) for e in CDEF[name])
    colr = rgba.index(b"colr")
    boxes = [_ihdr(rgba), (b"colr", rgba[colr + 4:colr + 11]),
             (b"cdef", cdef)]
    _check(_with_header_boxes(rgba, boxes), tmp_path)


@pytest.mark.parametrize("palette", ["rgb8", "wide", "direct", "gray_colr",
                                     "no_cmap", "short_cmap"])
def test_palettes(palette, tmp_path):
    """A gray codestream under pclr / cmap boxes: 8-bit RGB entries, 12-
    and 16-bit entries (cast to 8 bits, as OpenCV casts them), a channel
    used directly, a gray colr box, a palette without cmap (not applied),
    a cmap cut short (None): as cv2 reads them."""
    rng = np.random.default_rng(len(palette))
    gray = _pillow(_frame()[..., 0])
    table = rng.integers(0, 256, (256, 3))
    bits, entries = bytes([7, 7, 7]), table.astype(np.uint8).tobytes()
    if palette == "wide":
        bits = bytes([11, 7, 15])
        entries = b"".join(struct.pack(">HBH", a * 16, b, c * 256)
                           for a, b, c in table.tolist())
    pclr = struct.pack(">HB", 256, 3) + bits + entries
    maps = [(0, 1, i) for i in range(3)]
    if palette == "direct":
        maps[0] = (0, 0, 0)
    cmap = b"".join(struct.pack(">HBB", *m) for m in maps)
    enum = 17 if palette == "gray_colr" else 16
    boxes = [_ihdr(gray), (b"colr", bytes([1, 0, 0]) + struct.pack(
        ">I", enum)), (b"pclr", pclr)]
    if palette != "no_cmap":
        boxes.append((b"cmap", cmap[:8] if palette == "short_cmap"
                      else cmap))
    _check(_with_header_boxes(gray, boxes), tmp_path)


def test_packed_packet_headers(tmp_path):
    """The packet headers of a codestream with SOP / EPH moved into PPT
    segments of the tile-parts or PPM segments of the main header, in
    segments of 100 bytes (each tile-part's Nppm straddling none): as cv2
    reads them."""
    make = _script()
    cs = open(os.path.join(DATA, "opj_styles.j2k"), "rb").read()
    for kind in ("ppt", "ppm"):
        packed = make.packed_headers(cs, kind, chunk=100)
        assert (b"\xff\x61" if kind == "ppt" else b"\xff\x60") in packed
        _check(packed, tmp_path, f"{kind}.j2k")


def _style_cases() -> dict:
    """The files test_htj2k_code_blocks holds to cv2: Pillow's EBCOT
    files with the code-block style byte set to HT (0x40) or mixed HT
    (0xC0)."""
    flat = _pillow(np.full((40, 56, 3), 128, np.uint8))
    busy = _pillow(_frame(40, 56))
    style = lambda d, v: _edit(d, b"\xff\x52", 12, bytes([v]))  # noqa: E731
    return {"flat": lambda: style(flat, 0x40),
            "busy": lambda: style(busy, 0x40),
            "mixed": lambda: style(busy, 0xC0)}


@pytest.mark.parametrize("name", list(_style_cases()))
def test_htj2k_code_blocks(name, tmp_path):
    """The HT code-block style bit over EBCOT code blocks: a file whose
    code blocks carry no coding pass reads as cv2 reads it; one whose code
    blocks carry EBCOT's passes is read as HT code blocks, as OpenJPEG
    reads it, and refused where it is (more than 3 passes in a block:
    cv2 returns None, ValueError); the mixed HT style: None."""
    _check(_style_cases()[name](), tmp_path, f"{name}.jp2")
    if name == "flat":
        assert cv2.imread(str(tmp_path / "flat.jp2")) is not None
    else:
        assert cv2.imread(str(tmp_path / f"{name}.jp2")) is None


# the port's HT writer (jp2.encode_jp2) -> each kind of file the tests
# hold to cv2: cleanup-only and refined blocks, 5/3 and 9/7, code-block
# sizes, tiles and the vertically causal SigProp
HT_KINDS = {
    "cleanup": dict(ht=True),
    "sigprop": dict(ht=True, refine=1),
    "sigprop_magref": dict(ht=True, refine=2),
    "cleanup_lossy": dict(ht=True, skip=2),
    "magref_lossy": dict(ht=True, refine=2, skip=1),
    "97": dict(ht=True, irreversible=True),
    "97_magref": dict(ht=True, irreversible=True, refine=2),
    "cblk_4x1024": dict(ht=True, cblk=(4, 1024)),
    "cblk_1024x4_magref": dict(ht=True, cblk=(1024, 4), refine=2),
    "cblk_8x8": dict(ht=True, cblk=(8, 8)),
    "cblk_32x16_sigprop": dict(ht=True, cblk=(32, 16), refine=1),
    "tiles": dict(ht=True, tile=(32, 48), levels=3),
    "tiles_97_magref": dict(ht=True, tile=(32, 64), levels=4,
                            irreversible=True, refine=2),
    "vcausal_magref": dict(ht=True, vcausal=True, refine=2,
                           cblk=(16, 16)),
}


@pytest.mark.parametrize("kind", ["bgr8", "gray8", "gray16"])
@pytest.mark.parametrize("name", list(HT_KINDS))
def test_ht_writer_reads_as_cv2_reads(name, kind, tmp_path):
    """HTJ2K code blocks (T.814) written by the port's HT coder
    (csrc/host/j2k_encode.c), read by cv2.imread first (OpenJPEG 2.5's
    ht_dec.c): every kind of HT_KINDS of colour, 8- and 16-bit gray, at an
    odd size, bit for bit in both read modes, JP2 and raw codestream;
    cleanup-only reversible files give back the image written (so the
    coder's cleanup pass is T.814's, as cv2 reads it), refined ones lose
    at most the last plane's bit of samples SigProp does not visit."""
    im = _frame(45, 70, 3, seed=len(name))
    im = {"bgr8": im, "gray8": im[..., 1],
          "gray16": im[..., 1].astype(np.uint16) * 257 + im[..., 2]}[kind]
    kw = HT_KINDS[name]
    data = jp2.encode_jp2(im, **kw)
    path = tmp_path / "h.jp2"
    path.write_bytes(data)
    back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert back is not None and back.shape == im.shape
    if not kw.get("irreversible") and not kw.get("skip") and \
            kw.get("refine", 0) != 1:
        err = np.abs(back.astype(np.int64) - im).max()
        assert err <= (1 if kw.get("refine") else 0)
    same_as_cv2(path)
    _check(jp2.encode_jp2(im, codestream=True, **kw), tmp_path, "h.j2k")


@pytest.mark.parametrize("name", ["cleanup", "sigprop_magref",
                                  "cblk_8x8", "tiles_97_magref"])
def test_ht_damaged_and_cut_files(name, tmp_path):
    """Every proper prefix and 120 seeded byte mutations of HT files: as
    cv2 reads them, OpenJPEG's refusals included (a U_q past the block's
    bit-planes, VLC codes of samples outside the block, a bad Scup or MEL
    start: None, ValueError) and its garbage where it reads on."""
    im = _frame(32, 48, 3, seed=3)
    damaged_same_as_cv2(jp2.encode_jp2(im, codestream=True, **HT_KINDS[name]),
                        tmp_path, mutations=120, seed=len(name))


def _rgn(cs: bytes, shift: int) -> bytes:
    """An RGN marker segment of component 0 (an ROI shift) before COD."""
    at = cs.index(b"\xff\x52")
    return cs[:at] + struct.pack(">HHBBB", 0xFF5E, 5, 0, 0, shift) + cs[at:]


def _cap(cs: bytes) -> bytes:
    """A CAP marker segment (Pcap: Part 15; Ccap15 0x0020) before COD, and
    Rsiz's Part 15 bit: what an HTJ2K codestream should carry, and what
    OpenJPEG reads past (it reads HT code blocks by their style bit)."""
    at = cs.index(b"\xff\x52")
    cs = cs[:at] + struct.pack(">HHIH", 0xFF50, 8, 0x00020000, 0x0020) + \
        cs[at:]
    return cs[:6] + b"\x40\x00" + cs[8:]


HT_ODD = {
    "cap_marker": lambda im: _cap(jp2.encode_jp2(
        im, codestream=True, ht=True, refine=2)),
    "missing_msbs_short": lambda im: jp2.encode_jp2(
        im, codestream=True, ht=True, extra_missing=1),
    "missing_msbs_short_refined": lambda im: jp2.encode_jp2(
        im, codestream=True, ht=True, extra_missing=1, refine=2),
    "placeholder_set": lambda im: jp2.encode_jp2(
        im, codestream=True, ht=True, placeholder=1),
    "placeholder_set_refined": lambda im: jp2.encode_jp2(
        im, codestream=True, ht=True, placeholder=1, refine=2),
    "roi_shift_0": lambda im: _rgn(jp2.encode_jp2(
        im, codestream=True, ht=True), 0),
    "roi_shift_3": lambda im: _rgn(jp2.encode_jp2(
        im, codestream=True, ht=True), 3),
    "mb_30": lambda im: _edit(jp2.encode_jp2(
        im, codestream=True, ht=True), b"\xff\x5c", 5, bytes([29 << 3])),
    "mb_31": lambda im: _edit(jp2.encode_jp2(
        im, codestream=True, ht=True), b"\xff\x5c", 5, bytes([30 << 3])),
}


@pytest.mark.parametrize("name", list(HT_ODD))
def test_ht_refusals(name, tmp_path):
    """What OpenJPEG's HT decoder refuses or reads otherwise, as cv2.imread
    does: a CAP marker and Rsiz's Part 15 bit (read: neither is needed,
    and the port's writer writes neither), missing MSBs that leave a
    quad's U_q past the block's bit-planes (None) unless refinement
    passes move the cleanup up, a
    placeholder HT set (more than 3 passes: None; but 4 passes whose
    refinement segment is empty read as a cleanup pass), an ROI shift
    (None) and a shift of 0 (read), Mb 30 (read) and 31 (None)."""
    _check(HT_ODD[name](_frame(24, 40, 3, seed=9)), tmp_path, "o.j2k")


def test_sniff_and_stream_dispatch(tmp_path):
    """Both signatures pick the JPEG 2000 reader whatever the name; a
    directory of .jp2 colour frames and .j2k 16-bit depth reads through
    ``image_io.imread`` as cv2.imread reads it."""
    data = _pillow(_frame())
    assert image_io.sniff(data) == "jp2"
    assert image_io.sniff(_codestream(data)) == "jp2"
    for name, payload in (("a.png", data), ("b.jpg", _codestream(data))):
        _check(payload, tmp_path, name)


@pytest.mark.parametrize("kind", ["bgr8", "gray8", "gray16"])
def test_lossless_writer(kind, tmp_path):
    """``encode_jp2`` (the fixtures' lossless writer: 5/3, the RCT for
    colour, one layer): cv2.imread gives back the array written
    (IMREAD_UNCHANGED), at sizes from 1 x 1 to over a code block, and the
    port reads the JP2 and its raw codestream as cv2 reads them."""
    rng = np.random.default_rng(len(kind))
    for H, W in ((1, 1), (3, 5), (37, 51), (70, 130)):
        im = _frame(H, W, 3, seed=H)
        im[::5] = rng.integers(0, 256, im[::5].shape, np.uint8)
        im = {"bgr8": im, "gray8": im[..., 1],
              "gray16": im[..., 1].astype(np.uint16) * 257 + im[..., 2]
              }[kind]
        data = jp2.encode_jp2(im)
        path = tmp_path / "w.jp2"
        path.write_bytes(data)
        back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back, im)
        same_as_cv2(path)
        _check(jp2.encode_jp2(im, codestream=True), tmp_path, "w.j2k")


def test_boxes(tmp_path):
    """JP2 boxes as OpenJPEG reads them: image-header boxes (cdef, colr,
    ihdr) after jp2h are read, before it ignored; an ihdr whose size is
    not the codestream's is refused (None); unknown boxes are skipped
    after ftyp and refused before it; jp2c of length 0 (to the end) or
    written as an XL box reads."""
    data = _pillow(_frame(40, 56))

    def box(kind, body):
        return struct.pack(">I", 8 + len(body)) + kind + body

    cdef = box(b"cdef", struct.pack(">H", 3) + b"".join(
        struct.pack(">HHH", c, 0, 3 - c) for c in range(3)))
    colr = box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 17))
    ihdr = data[data.index(b"ihdr") - 4:data.index(b"ihdr") + 18]
    jp2h, jp2c = data.index(b"jp2h") - 4, data.index(b"jp2c") - 4
    for k, extra in enumerate((cdef, colr, ihdr, box(b"xml ", b"<a/>"))):
        _check(data[:jp2c] + extra + data[jp2c:], tmp_path, f"after{k}.jp2")
        _check(data[:jp2h] + extra + data[jp2h:], tmp_path, f"before{k}.jp2")
    _check(data[:12] + box(b"xml ", b"<a/>") + data[12:], tmp_path,
           "first.jp2")
    at = data.index(b"ihdr") + 4
    for h in (39, 41):
        _check(data[:at] + struct.pack(">I", h) + data[at + 4:], tmp_path,
               f"ihdr{h}.jp2")
    body = data[jp2c + 8:]
    _check(data[:jp2c] + struct.pack(">I", 0) + b"jp2c" + body, tmp_path,
           "len0.jp2")
    _check(data[:jp2c] + struct.pack(">I4sII", 1, b"jp2c", 0,
                                     16 + len(body)) + body, tmp_path,
           "xl.jp2")
