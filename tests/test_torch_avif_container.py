"""AVIF containers the port's reader (lgu_slam_tpu_torch/data/avif.py)
reads, against OpenCV's (libavif 1.4.2 over libaom 3.14.1):
grid images (ImageGrid in idat or mdat, 16- or 32-bit sizes, dimg order,
tiles copied into one image before YUV to RGB, alpha grids, libavif's
checks of the tiles against the output), the first frame of avis image
sequences (the moov sample tables, the colour track and its auxl alpha
track), frames scaled to their ispe by libyuv's ScalePlane (data/
yuv_scale.py), and the file layouts OpenCV refuses without nclx; seeded
damage to the grid, iref and moov boxes with every class exact."""

import os
import struct
import sys

import cv2
import numpy as np
import pytest
from test_torch_avif import QUEUED, _scene
from torch_port import same_as_cv2

from lgu_slam_tpu_torch.data import avif, image_io

DATA = os.path.join(os.path.dirname(__file__), "data", "avif")
sys.path.insert(0, os.path.join(os.path.dirname(DATA), "..", "..",
                                "scripts"))
from make_avif_fixtures_torch import (  # noqa: E402
    encode_avis,
    encode_grid,
    grid_box,
    heif,
)


def _check(path, data: bytes, reads: bool):
    """``data`` reads as cv2.imread reads it in both modes, and cv2 reads
    it (``reads``) or returns None."""
    path.write_bytes(data)
    assert (cv2.imread(str(path)) is not None) == reads
    same_as_cv2(path)


def _tiles(H=128, W=192, seed=22):
    big = _scene(np.random.default_rng(seed), H, W)
    return big, [big[r:r + 64, c:c + 64] for r in range(0, H, 64)
                 for c in range(0, W, 64)]


def _seam(H=128, W=128) -> np.ndarray:
    """Colour that changes at every column and row, tile seams included:
    4:2:0 chroma upsampled across them."""
    y, x = np.mgrid[0:H, 0:W]
    return np.stack([(x * 37 + y * 11) % 256, (x * 5 + (y % 7) * 40) % 256,
                     ((x // 2) % 2 * 200 + y) % 256], -1).astype(np.uint8)


# name: (tiles' source image, encode_grid keywords, cv2 reads)
GRIDS = {
    "1x2": ("scene", dict(cols=2, n=2), True),
    "2x3 cropped": ("scene", dict(size=(150, 100)), True),
    "2x3 ImageGrid in mdat": ("scene", dict(size=(150, 100), idat=False),
                              True),
    "2x3 32-bit sizes": ("scene", dict(size=(150, 100), wide=True), True),
    "2x3 least cover": ("scene", dict(size=(129, 65)), True),
    "2x2 4:2:0 seams": ("seam", dict(cols=2, subsampled="4:2:0"), True),
    "2x2 4:2:0 cropped alpha": ("seam", dict(
        cols=2, size=(120, 100), subsampled="4:2:0", alpha=True), True),
    "2x3 4:2:2 odd height": ("scene", dict(size=(150, 101),
                                           subsampled="4:2:2"), True),
    "2x3 lossy grain": ("scene", dict(size=(150, 100), subsampled="4:2:0",
                                      lossy=dict(base_q=80), grain=3), True),
    "2x3 10-bit": ("scene", dict(size=(150, 100), depth=10), True),
    "2x3 12-bit 4:2:2": ("scene", dict(size=(150, 100), depth=12,
                                       subsampled="4:2:2"), True),
    "2x3 gray": ("gray", dict(size=(150, 100)), True),
    "2x3 scaled tiles": ("scene", dict(size=(150, 100), tile_size=(64, 64)),
                         True),
    "tiles scaled under 64": ("scene", dict(size=(150, 90),
                                            tile_size=(60, 52)), False),
    "last column outside": ("scene", dict(size=(128, 65)), False),
    "not covered": ("scene", dict(size=(193, 100)), False),
    "odd 4:2:0 width": ("scene", dict(size=(151, 100), subsampled="4:2:0"),
                        False),
    "odd 4:2:0 height": ("scene", dict(size=(150, 101),
                                       subsampled="4:2:0"), False),
    "tiles of 32": ("small", dict(cols=2, n=2), False),
    "alpha larger": ("seam", dict(cols=2, size=(120, 100), alpha=True,
                                  alpha_size=(128, 100)), False),
}


def _grid_file(source: str, kw: dict) -> bytes:
    kw = dict(kw)
    n, cols = kw.pop("n", None), kw.pop("cols", 3)
    big, tiles = _tiles()
    if source == "seam":
        big = _seam()
        tiles = [big[r:r + 64, c:c + 64] for r in (0, 64) for c in (0, 64)]
    elif source == "gray":
        tiles = [t[..., 1] for t in tiles]
    elif source == "small":
        tiles = [big[:32, :32], big[:32, 32:64]]
    if kw.get("tile_size"):  # 80 x 72 frames under a smaller ispe
        big80 = _scene(np.random.default_rng(5), 144, 240)
        tiles = [big80[r:r + 72, c:c + 80] for r in (0, 72)
                 for c in (0, 80, 160)]
    depth = kw.pop("depth", 8)
    if depth > 8:
        tiles = [t.astype(np.uint16) << (depth - 8) for t in tiles]
    tiles = tiles[:n] if n else tiles
    if kw.pop("alpha", False):
        kw["alpha_tiles"] = [t[..., 0] for t in tiles]
    alpha_size = kw.pop("alpha_size", None)
    data = encode_grid(tiles, cols, depth=depth, **kw)
    if alpha_size:  # the alpha grid's ImageGrid and ispe
        want = struct.pack(">HH", *kw["size"])
        k = data.rindex(want, 0, data.index(b"mdat"))
        data = data[:k] + struct.pack(">HH", *alpha_size) + data[k + 4:]
    return data


@pytest.mark.parametrize("name", list(GRIDS))
def test_grids(name, tmp_path):
    """Grid images of the writer's tiles: equal to cv2.imread in both
    modes where it reads (tiles in the grid's order, cropped, alpha
    dropped, chroma upsampled across the tile seams, each tile scaled to
    its ispe first), ValueError where it returns None (a last column
    outside the output, an output the tiles do not cover, odd sides
    under 4:2:0, tiles (or their ispe) under 64 x 64, an alpha grid of
    another size)."""
    source, kw, reads = GRIDS[name]
    _check(tmp_path / "g.avif", _grid_file(source, kw), reads)


def test_grid_layouts_and_refusals(tmp_path):
    """The 1 x 2 grid with its tiles named in dimg in the other order
    (the image's halves swap; without nclx OpenCV refuses it: the first
    tile's data then comes second), a
    tile named twice, an ImageGrid of version
    1, of one row too many, its output past libavif's size limits
    (32-bit sizes), the grid's ispe not its output (OpenCV's Mat is the
    ispe's), tiles whose av1C differ, a tile frame deeper than its av1C
    (the tiles' depths differ): as cv2.imread reads them."""
    big = _scene(np.random.default_rng(2), 64, 128)
    base = encode_grid([big[:, :64], big[:, 64:]], 2, nclx=False)
    path = tmp_path / "g.avif"
    dimg = b"dimg" + struct.pack(">HHHH", 1, 2, 2, 3)
    other = b"dimg" + struct.pack(">HHHH", 1, 2, 3, 2)
    _check(path, base.replace(dimg, other), False)
    nclx = encode_grid([big[:, :64], big[:, 64:]], 2)
    _check(path, nclx.replace(dimg, other), True)
    np.testing.assert_array_equal(image_io.imread(str(path)),
                                  np.concatenate([big[:, 64:], big[:, :64]],
                                                 1))
    _check(path, base.replace(dimg, b"dimg" + struct.pack(">HHHH", 1, 2, 2,
                                                          2)), False)
    grid = struct.pack(">BBBBHH", 0, 0, 0, 1, 128, 64)
    for bad in (b"\x01" + grid[1:], grid[:2] + b"\x01" + grid[3:]):
        _check(path, base.replace(grid, bad), False)
    ispe = b"ispe" + bytes(4) + struct.pack(">II", 128, 64)
    _check(path, base.replace(ispe, b"ispe" + bytes(4) + struct.pack(
        ">II", 120, 64)), False)
    _, tiles = _tiles()
    huge = encode_grid(tiles[:2], 2, wide=True).replace(
        struct.pack(">II", 128, 64), struct.pack(">II", 40000, 64))
    _check(path, huge, False)
    t8 = avif.encode_av1(np.stack([tiles[1][..., 1], tiles[1][..., 0],
                                   tiles[1][..., 2]]), 8, 1)
    t10 = avif.encode_av1(np.stack([tiles[1][..., 1], tiles[1][..., 0],
                                    tiles[1][..., 2]]).astype(np.uint16) << 2,
                          10, 1)
    c8, c10 = avif._av1c(8, False), avif._av1c(10, False)
    _check(path, _two_tiles([t8, t10], [c8, c10]), False)
    _check(path, _two_tiles([t8, t10], [c8, c8]), False)
    _check(path, _two_tiles([t8, t8], [c8, c8]), True)


def _two_tiles(obus: list, av1cs: list) -> bytes:
    """A 1 x 2 grid of two 64 x 64 tiles' OBUs, each with its av1C."""
    full = avif._full
    ispe = full(b"ispe", 0, 0, struct.pack(">II", 64, 64))
    items = [dict(id=1, type=b"grid", data=grid_box(1, 2, 128, 64),
                  idat=True, props=[(full(b"ispe", 0, 0, struct.pack(
                      ">II", 128, 64)), False)], refs=[(b"dimg", [2, 3])])]
    for k, (o, c) in enumerate(zip(obus, av1cs)):
        items.append(dict(id=2 + k, type=b"av01", data=o,
                          props=[(ispe, False), (c, True)]))
    return heif(items)


def _damage(data: bytes, lo: int, hi: int, rng, path, n: int) -> dict:
    """``n`` copies of ``data`` with one or two bytes of [lo, hi) replaced
    or bit-flipped, read in both modes against cv2.imread: its bytes where
    it reads, ValueError where it returns None, else NotImplementedError
    naming a feature of QUEUED, whose counts are returned."""
    queued = {}
    for _ in range(n):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            i = int(rng.integers(lo, hi))
            if rng.integers(0, 2):
                d[i] = int(rng.integers(0, 256))
            else:
                d[i] ^= 1 << int(rng.integers(0, 8))
        path.write_bytes(bytes(d))
        for anydepth in (False, True):
            try:  # OpenCV raises for a size it refuses
                ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                                 else cv2.IMREAD_COLOR)
            except cv2.error:
                ref = None
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
    return queued


def _box_span(data: bytes, kind: bytes, after: int = 0) -> tuple:
    k = data.index(kind, after)
    return k - 4, k - 4 + int.from_bytes(data[k - 4:k], "big")


# (file, box): (rng seed, copies, {(feature, cv2 reads): reads}) as
# measured with OpenCV 5.0.0 (libavif 1.4.2, libaom 3.14.1)
GRID_DAMAGE = {("port_grid_2x2_alpha.avif", b"iref"): (2, 200, {}),
               ("port_grid_2x2_alpha.avif", b"idat"): (2, 200, {}),
               ("port_grid_2x2_alpha.avif", b"iinf"): (2, 200, {}),
               ("port_grid_2x2_alpha.avif", b"ipma"): (2, 200, {}),
               ("port_grid_2x2_alpha.avif", b"iloc"): (2, 200, {}),
               ("port_grid_1x2.avif", b"iref"): (3, 200, {}),
               ("port_grid_1x2.avif", b"idat"): (3, 200, {})}


@pytest.mark.parametrize("key", sorted(GRID_DAMAGE))
def test_grid_damage(key, tmp_path):
    """Copies of a committed grid file with one or two bytes of one box
    (the ImageGrid in idat, iref's dimg and auxl, iinf, ipma, iloc)
    changed: every class as cv2.imread's, NotImplementedError at the
    measured counts."""
    name, box = key
    seed, n, want = GRID_DAMAGE[key]
    data = open(os.path.join(DATA, name), "rb").read()
    got = _damage(data, *_box_span(data, box), np.random.default_rng(seed),
                  tmp_path / "d.avif", n)
    assert got == want


def test_pillow_sequences(tmp_path):
    """Pillow's avis sequences (its first frame is read): 4:4:4 lossless,
    4:2:0 lossy, gray, with film grain, RGBA (an alpha track, auxl with
    auxi): equal to cv2.imread in both modes; the committed two-frame file
    reads its first frame."""
    from PIL import Image

    img = _scene(np.random.default_rng(2), 40, 56)
    rgb = Image.fromarray(img[..., ::-1].copy())
    others = [Image.fromarray(255 - img), Image.fromarray(img // 2)]
    path = tmp_path / "s.avif"
    for kw in (dict(quality=100, subsampling="4:4:4"), dict(quality=60),
               dict(quality=50, advanced=[("film-grain-test", "3")])):
        rgb.save(path, save_all=True, append_images=others, **kw)
        _check(path, path.read_bytes(), True)
    Image.fromarray(img[..., 1].copy()).save(
        path, save_all=True, append_images=[Image.fromarray(img[..., 2])],
        quality=70)
    _check(path, path.read_bytes(), True)
    rgba = Image.fromarray(np.concatenate([img[..., ::-1], img[..., :1]],
                                          -1).copy(), "RGBA")
    rgba.save(path, save_all=True, append_images=[rgba], quality=70)
    _check(path, path.read_bytes(), True)
    want = image_io.imread(os.path.join(DATA, "pillow_avis.avif"))
    assert want.shape == (48, 64, 3)


def test_writer_sequences(tmp_path):
    """The writer's sequences (encode_avis): one sample to a chunk
    (stco or co64), three to a chunk, an alpha track, the tracks' tkhd
    size smaller and larger than the frames (libavif scales the first
    frame to it), 12-bit, gray, lossy 4:2:0 with film grain: equal to
    cv2.imread; refused as cv2 refuses them: chunks that name more
    samples than stsz holds, no av01 sample entry, a first sample past the
    file's end, a tkhd of width 0, a colour track whose sample entry has
    no av1C; an auxiliary track whose auxi names another URN is no alpha
    (its damaged sample is not decoded)."""
    img = _scene(np.random.default_rng(3), 40, 56)
    frames = [img, 255 - img, img // 2]
    path = tmp_path / "s.avif"
    for kw in (dict(), dict(co64=True), dict(per_chunk=3),
               dict(alpha=[f[..., 0] for f in frames]),
               dict(size=(40, 30)), dict(size=(70, 50)),
               dict(subsampled="4:2:0", lossy=dict(base_q=60), grain=2)):
        _check(path, encode_avis(frames, **kw), True)
    _check(path, encode_avis([f.astype(np.uint16) << 4 for f in frames],
                                  12, size=(70, 50)), True)
    _check(path, encode_avis([f[..., 1] for f in frames]), True)
    data = encode_avis(frames)
    _check(path, encode_avis(frames, per_chunk=2), False)
    _check(path, data.replace(b"av01", b"av02", 1), False)
    stco = data.index(b"stco")
    _check(path, data[:stco + 12] + struct.pack(">I", len(data) - 10)
           + data[stco + 16:], False)
    tkhd = data.index(b"tkhd")
    _check(path, data[:tkhd + 80] + bytes(4) + data[tkhd + 84:], False)
    _check(path, data.replace(b"av1C", b"av1X", 1), False)
    two = encode_avis(frames, alpha=[f[..., 0] for f in frames])
    urn = avif.ALPHA_URNS[0]
    sizes = two.index(b"stsz", two.index(b"auxi"))
    first = int.from_bytes(two[sizes + 16:sizes + 20], "big")
    offset = int.from_bytes(two[two.index(b"stco", sizes) + 12:
                                two.index(b"stco", sizes) + 16], "big")
    broken = bytearray(two)
    broken[offset + first - 3] ^= 0xFF
    broken[offset + first - 9] ^= 0x5A
    _check(path, bytes(broken), False)
    other = bytes(broken).replace(urn, b"urn:other".ljust(len(urn), b"\0"))
    _check(path, other, True)


# (file, box, after): (rng seed, copies, counts) as measured with OpenCV
# 5.0.0 (libavif 1.4.2, libaom 3.14.1); "moov" the whole box
MOOV_DAMAGE = {("pillow_avis.avif", b"moov"): (4, 400, {}),
               ("pillow_avis.avif", b"stsd"): (5, 150, {}),
               ("pillow_avis.avif", b"stsc"): (5, 150, {}),
               ("pillow_avis.avif", b"stsz"): (5, 150, {}),
               ("pillow_avis.avif", b"stco"): (5, 150, {}),
               ("pillow_avis.avif", b"tkhd"): (5, 150, {}),
               ("pillow_avis.avif", b"hdlr"): (6, 150, {}),
               ("writer_alpha", b"moov"): (7, 400, {})}


@pytest.mark.parametrize("key", sorted(MOOV_DAMAGE, key=str))
def test_moov_damage(key, tmp_path):
    """Copies of an image sequence (Pillow's committed one; the writer's
    with an alpha track) with one or two bytes of its moov box or of one
    sample table box (stsd, stsc, stsz, stco), tkhd or the track's hdlr
    changed: every class as cv2.imread's, NotImplementedError at the
    measured counts."""
    name, box = key
    seed, n, want = MOOV_DAMAGE[key]
    if name == "writer_alpha":
        img = _scene(np.random.default_rng(3), 40, 56)
        data = encode_avis([img, 255 - img], alpha=[img[..., 0]] * 2)
    else:
        data = open(os.path.join(DATA, name), "rb").read()
    after = data.index(b"moov") if box == b"hdlr" else 0
    got = _damage(data, *_box_span(data, box, after),
                  np.random.default_rng(seed), tmp_path / "d.avif", n)
    assert got == want


# (source, destination) sizes (W, H) of frames libavif scales to their
# ispe: every ScalePlane path at 8 bits and ScalePlane_12's at 10 and 12
# (box, bilinear up and down, 1/2, 1/4, 3/4 and 3/8 with their SIMD rows,
# the vertical-only and horizontal-only filters, 2x up)
SCALES = [((128, 96), (64, 48)), ((128, 96), (48, 36)), ((128, 96), (32, 24)),
          ((128, 96), (96, 72)), ((128, 96), (100, 80)), ((128, 96), (40, 30)),
          ((128, 96), (20, 15)), ((128, 96), (128, 60)), ((128, 96), (60, 96)),
          ((128, 96), (200, 150)), ((128, 96), (256, 192)),
          ((128, 96), (255, 191)), ((128, 96), (128, 32)),
          ((128, 96), (42, 32)),
          ((80, 60), (60, 45)), ((24, 16), (9, 6)), ((37, 29), (20, 11)),
          ((37, 29), (50, 61)), ((65, 33), (129, 65)), ((64, 48), (64, 100)),
          ((64, 48), (200, 48)), ((96, 64), (32, 64)), ((200, 150), (13, 7))]


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("layout", ["gray", "4:4:4", "4:2:0", "4:2:2"])
def test_scaled_frames(depth, layout, tmp_path):
    """A frame whose ispe names another size, down and up, luma and
    chroma: equal to cv2.imread in both modes (libavif scales each plane
    with libyuv's ScalePlane, kFilterBox, ScalePlane_12 above 8 bits)."""
    path = tmp_path / "s.avif"
    for k, ((W, H), size) in enumerate(SCALES):
        if (k + depth + len(layout)) % 2:  # half the sizes per case
            continue
        img = _scene(np.random.default_rng(k), H, W)
        if layout == "gray":
            img = img[..., 1].copy()
        if depth > 8:
            img = img.astype(np.uint16) * (1 << (depth - 8)) + 1
        kw = {} if layout in ("gray", "4:4:4") else dict(subsampling=layout)
        data = avif.encode_avif(img, depth, k, **kw)
        ispe = b"ispe" + bytes(4) + struct.pack(">II", W, H)
        _check(path, data.replace(ispe, b"ispe" + bytes(4) + struct.pack(
            ">II", *size)), True)


# the file layouts of the storage-order rule, probed: (nclx, layout of
# the colour (c) and alpha (a) items' extents in mdat; c1 / c2, a1 / a2:
# two extents in iloc order) -> cv2 reads
LAYOUTS = [(False, "c a", True), (False, "a c", False),
           (False, "c1 a c2", True), (False, "a c1 c2", False),
           (False, "c2 a c1", False), (False, "c1 c2 a", True),
           (False, "a1 c a2", False), (False, "c a1 a2", True),
           (False, "a2 c a1", False), (False, "c2 c1 a", False),
           (False, "c2 c1", False), (False, "c1 c2", True),
           (True, "a c", True), (True, "c2 a c1", True),
           (True, "a2 c a1", True), (True, "c2 c1", True)]


def _layout_file(nclx: bool, layout: str) -> bytes:
    img = _scene(np.random.default_rng(3), 24, 36)
    c = avif.encode_av1([img[..., 1], img[..., 0], img[..., 2]], 8, 0)
    a = avif.encode_av1(img[..., 0][None], 8, 1)
    parts = {"c": c, "a": a, "c1": c[:len(c) // 2], "c2": c[len(c) // 2:],
             "a1": a[:len(a) // 2], "a2": a[len(a) // 2:]}
    order = layout.split()
    full, box = avif._full, avif._box
    ispe = full(b"ispe", 0, 0, struct.pack(">II", 36, 24))
    props = [ispe, avif._av1c(8, False), avif._av1c(8, True),
             full(b"auxC", 0, 0, avif.ALPHA_URNS[0] + b"\0"),
             box(b"colr", b"nclx" + struct.pack(">HHHB", 2, 2, 0, 0x80))]
    lists = [(1, [1, 0x82] + ([5] if nclx else []))]
    has_alpha = any(p.startswith("a") for p in order)
    if has_alpha:
        lists.append((2, [1, 0x83, 4]))
    ipma = struct.pack(">I", len(lists)) + b"".join(
        struct.pack(">HB", i, len(v)) + bytes(v) for i, v in lists)
    infe = b"".join(full(b"infe", 2, 0, struct.pack(">HH", i, 0) + b"av01\0")
                    for i, _ in lists)
    iref = full(b"iref", 0, 0, box(b"auxl", struct.pack(">HHH", 2, 1, 1))) \
        if has_alpha else b""

    def meta(off):
        iloc = struct.pack(">HH", 0x4400, len(lists))
        for iid, _ in lists:
            ext = [p for p in order if p.startswith("ca"[iid - 1])]
            ext.sort()
            iloc += struct.pack(">HHHH", iid, 0, 0, len(ext)) + b"".join(
                struct.pack(">II", off[p], len(parts[p])) for p in ext)
        return full(b"meta", 0, 0, full(b"hdlr", 0, 0, bytes(4) + b"pict"
                                        + bytes(13))
                    + full(b"pitm", 0, 0, struct.pack(">H", 1))
                    + full(b"iloc", 1, 0, iloc)
                    + full(b"iinf", 0, 0, struct.pack(">H", len(lists))
                           + infe) + iref
                    + box(b"iprp", box(b"ipco", b"".join(props))
                          + full(b"ipma", 0, 0, ipma)))

    ftyp = box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")
    pos, off = len(ftyp) + len(meta({p: 0 for p in order})) + 8, {}
    for p in order:
        off[p] = pos
        pos += len(parts[p])
    return ftyp + meta(off) + box(b"mdat", b"".join(parts[p] for p in order))


# a 2 x 2 grid's items' data stored in the order of their indices (the
# grid 0, its tiles 1-4, its alpha grid 5 and alpha tiles 6-9), with or
# without nclx, its ImageGrid in idat or in mdat -> cv2 reads
GRID_ORDERS = [(False, True, (0, 1, 2, 3, 4), True),
               (False, True, (0, 4, 3, 2, 1), False),
               (False, True, (0, 2, 1, 3, 4), False),
               (False, True, (0, 1, 2, 4, 3), True),
               (True, True, (0, 4, 3, 2, 1), True),
               (True, False, (0, 4, 1, 2, 3), True),
               (False, False, (0, 4, 1, 2, 3), False),
               (True, False, (1, 0, 2, 3, 4), False),
               (True, False, (4, 0, 1, 2, 3), False),
               (True, False, (1, 2, 3, 4, 0), False),
               (False, True, (0, 5, 6, 7, 8, 9, 1, 2, 3, 4), True),
               (True, False, (0, 1, 2, 3, 4, 9, 5, 6, 7, 8), True),
               (True, False, (0, 5, 1, 2, 3, 4, 6, 7, 8, 9), True)]


@pytest.mark.parametrize("nclx,idat,stored,reads", GRID_ORDERS)
def test_grid_storage_order(nclx, idat, stored, reads, tmp_path):
    """OpenCV refuses a grid whose ImageGrid, stored in mdat, comes after
    one of its tiles, and, without nclx, one whose first tile's data
    comes after another tile's (its alpha grid's items take no part):
    the port follows each order probed."""
    big = _scene(np.random.default_rng(2), 128, 128)
    tiles = [big[:64, :64], big[:64, 64:], big[64:, :64], big[64:, 64:]]
    alpha = [t[..., 0] for t in tiles] if len(stored) > 5 else None
    _check(tmp_path / "o.avif", encode_grid(
        tiles, 2, alpha_tiles=alpha, nclx=nclx, idat=idat, stored=stored),
        reads)


@pytest.mark.parametrize("nclx,layout,reads", LAYOUTS)
def test_colour_first_extent_without_nclx(nclx, layout, reads, tmp_path):
    """OpenCV returns None for a file whose colour item's first extent is
    stored after another extent (of it or of its alpha item) in the file,
    where no nclx names the colour; with nclx, or with the data in idat
    (tests/test_torch_avif_lossy.py), it reads: the port follows each
    layout probed."""
    _check(tmp_path / "l.avif", _layout_file(nclx, layout), reads)
