"""AVIF files as ``cv2.imread`` (OpenCV 5.0 over libavif 1.4.2 and libaom
3.14) reads them, for the port's data layer, and a writer for fixtures.

The HEIF (ISOBMFF) container is parsed here as libavif's ``read.c`` parses
it, rule for rule where a rule decides between a read and a failure: the
file-level boxes up to those the brands need (``ftyp``, ``meta``,
``moov``; a major brand ``avis``, or a ``moov`` without the ``avif``
major brand, names a sequence), then ``meta`` (``hdlr`` first, ``pitm``,
``iloc`` versions 0-2 with construction methods 0 (file) and 1
(``idat``), ``iinf`` / ``infe`` versions 2-3, ``iref``, ``iprp`` /
``ipco`` / ``ipma``: ``ispe``, ``av1C``, ``pixi``, ``colr`` (nclx or
ICC), ``irot``, ``imir``, ``clap``, ``auxC``, ``pasp``, ``clli``,
``a1op``, ``lsel``, ``a1lx``), every property checked whether associated
or not.  libavif skips an item without extents, one with an unknown
essential property, a thumbnail and one of an unknown type; each item it
keeps needs an ``ispe`` (but an alpha item: strict checks are off) within
its limits, and a ``pixi`` of its ``av1C``'s depth, whatever the image's
source.  The image is the primary ``av01`` item, or a ``grid`` item over
``av01`` tiles (its ImageGrid; the tiles copied into one image), and its
alpha item (``auxl`` with an alpha ``auxC``, an item or a grid); in a
sequence, the first sample of the colour track and of its ``auxl`` alpha
track (``moov``'s ``trak`` / ``tkhd`` / ``mdia`` / ``minf`` / ``stbl``
sample tables).  Their OBUs are decoded in C (``csrc/host/av1_decode.c``:
AV1 key, intra-only and inter frames (``av1_inter.h``: the layers of the
layered items libavif writes, one reference each), lossless or lossy, 8
to 12 bits, monochrome, 4:4:4, 4:2:2 or 4:2:0, intra block copy,
segmentation, deblocking, CDEF, superres and loop restoration, then the
frame's film grain (``av1_grain.h``); of an item of several frames the
last one shown, ``show_existing_frame`` included, as libaom outputs it, or
with an ``lsel`` layer the first of that spatial layer, under ``a1op``'s
operating point, as libavif has libaom output it; the OBUs checked as
libaom checks them; the alpha is decoded and dropped, as OpenCV drops it),
and a frame of another size than its item's (or track's) is scaled to it
with libyuv's ScalePlane (:mod:`yuv_scale`), as libavif scales it.

What OpenCV's reader then returns, which :func:`decode_avif` repeats:

- its Mat from the container: ``av1C``'s depth (8 bits, or 16 for a 10-
  or 12-bit ``av1C`` under ``IMREAD_ANYDEPTH``) and format (one channel
  for 4:0:0, three for colour, one more for alpha: a 4:0:0 image with
  alpha, two channels, is None); its size the ``ispe``'s (a grid whose
  output is another size is None);
- a colour read: ``uint8 [H, W, 3]`` BGR.  4:4:4 under the identity matrix
  (how libavif writes lossless colour): G = Y, B = U, R = V; 10- and
  12-bit samples become 8 bits as ``rint(float32(v) * float32(255 / max))``
  (round half to even).  4:4:4, 4:2:2 and 4:2:0 under a matrix libyuv
  has constants for (BT.601, BT.709, BT.2020, chroma-derived under their
  primaries; full or limited range): libyuv's fixed-point conversion
  with bilinear chroma (4:2:2: along rows), of 10- and 12-bit samples
  shifted to 8 bits, but with an alpha item other paths at 10 and 12
  bits; under another matrix (FCC, SMPTE 240, YCgCo, YCgCo-R,
  chroma-derived under other primaries) and identity at limited range,
  libavif's float32 conversion (:func:`_yuv_to_bgr`).  4:0:0: three equal
  channels of Y as stored, whatever its range, 10- and 12-bit samples
  ``rint(v / 2 ** (depth - 8))`` (all measured on every sample value);
- an ``IMREAD_ANYDEPTH`` read: 4:0:0 Y as stored; colour ``cvtColor``'s
  gray of the BGR samples at the Mat's depth (``(3735 B + 19235 G + 9798
  R + 16384) >> 15``), YUV colour of a deeper frame converted by
  libavif's float32 code at that depth; the frame's own depth decides the
  conversion;
- ``irot``, ``imir`` and ``clap`` are not applied, nor an Exif
  orientation.

Refused: a file cv2 returns None for raises ``ValueError`` (a cut or
damaged container or stream, an item without ``ispe``, no usable primary
item, matrix coefficients libavif's YUV to RGB refuses, subsampled
colour labelled identity, item data stored in an order OpenCV's reader
refuses (:func:`_stored_before`), a grid's tiles that do not fit its
output, ...); what OpenCV reads and this module does not yet read raises
``NotImplementedError`` naming it: the AV1 inter tools no layered item
here uses (compound prediction, skip mode, switch frames,
``frame_refs_short_signaling``, a reference replaced by its order hint;
and, once a decode libaom's checks pass has ended, a frame size taken
from a reference, segmentation of an inter frame, film grain of a
reference frame, a reference frame other than LAST, a block predicted
from a reference with global motion, dual interpolation filters, a vector
candidate of the extra search, a wedge inter-intra block with 4:2:2
chroma), a frame of more samples than its image and than
``SCALED_PIXELS`` (the guard against a damaged header), and an 8-bit
frame under a deeper ``av1C`` in an ``IMREAD_ANYDEPTH`` colour read
(OpenCV reads uninitialised memory there).

:func:`encode_avif` writes still images (lossless colour under the
identity matrix at 4:4:4 or subsampled at 4:2:0 or 4:2:2, gray at 4:0:0,
and lossy 4:4:4, 4:2:0, 4:2:2 or gray with deblocking, CDEF and loop
restoration; any matrix, primaries and range; 8, 10 or 12 bits; film
grain, segmentation, superres, tile columns; key and intra-only frames
of full headers, which :func:`frames_av1` strings into items of several
frames; ``csrc/host/av1_encode.c``), for the tests and for the card
machine, which has no AVIF writer (``scripts/make_avif_fixtures_torch.py``
builds grids and image sequences of its frames).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from lgu_slam_tpu_torch.data import yuv_scale
from lgu_slam_tpu_torch.ops import _build

STATUS = {1: ValueError, 2: NotImplementedError, 3: MemoryError}
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# libavif's default imageSizeLimit (16384 * 16384) and imageDimensionLimit
MAX_PIXELS, MAX_SIDE = 1 << 28, 32768
# the most samples of a frame that libavif would scale that are decoded
SCALED_PIXELS = 1 << 22
# transformative properties: libavif requires them marked essential (and
# OpenCV applies none of them)
TRANSFORMS = (b"irot", b"imir", b"clap")
# the item properties libavif parses and keeps; an unknown one marked
# essential makes libavif skip its item
KNOWN = (b"ispe", b"av1C", b"pixi", b"colr", b"auxC", b"pasp", b"clli",
         b"a1op", b"a1lx", b"lsel") + TRANSFORMS
# the meta boxes libavif allows once
UNIQUE = (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref")
# matrix coefficients libavif's YUV to RGB refuses (at any depth and
# range; 16, YCgCo-Re, only where the samples are two bits deeper than
# the output; 8, YCgCo, under limited range), measured through cv2.imread
REFUSED_MATRICES = (3, 10, 11, 13, 14)


def is_avif(data: bytes) -> bool:
    """OpenCV's AVIF signature check (``avifPeekCompatibleFileType``): an
    ``ftyp`` box first whose major or compatible brands name ``avif`` or
    ``avis``."""
    if len(data) < 16 or data[4:8] != b"ftyp":
        return False
    size = int.from_bytes(data[:4], "big")
    if size < 16 or size > len(data):
        return size >= 16 and b"avif" in data[8:min(len(data), 64)]
    brands = [data[8:12]] + [data[k:k + 4] for k in range(16, size - 3, 4)]
    return b"avif" in brands or b"avis" in brands


class _Stream:
    """libavif's ``avifROStream`` over ``data[pos:end]``: a read past the
    end fails."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def left(self) -> int:
        return self.end - self.pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise ValueError("AVIF: a box ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self, versions=None):
        """A full box's (version, flags); ``versions``: those libavif
        reads."""
        v = self.u(4)
        if versions is not None and v >> 24 not in versions:
            raise ValueError(f"AVIF: a box of version {v >> 24}")
        return v >> 24, v & 0xFFFFFF

    def string(self) -> bytes:
        k = self.data.find(b"\0", self.pos, self.end)
        if k < 0:
            raise ValueError("AVIF: a string without its end")
        out = self.data[self.pos:k]
        self.pos = k + 1
        return out

    def box(self, top: bool = False):
        """A box header (``avifROStreamReadBoxHeader``): (type, body start,
        body end), the stream left at the body.  Size 0 runs to the end
        at the top level and fails inside a box; a box inside another must
        fit in it."""
        start = self.pos
        size, kind = self.u(4), self.take(4)
        if size == 1:
            size = self.u(8)
        if kind == b"uuid":
            self.take(16)
        head = self.pos - start
        if size == 0:
            if not top:
                raise ValueError("AVIF: a box of size 0 inside another")
            size = self.end - start
        if size < head:
            raise ValueError(f"AVIF: box {kind!r} is smaller than its header")
        if not top and size - head > self.left():
            raise ValueError(f"AVIF: box {kind!r} runs past its container")
        return kind, self.pos, start + size


def _top(data: bytes) -> tuple:
    """libavif's file-level loop: (brands, meta's body span or None,
    moov's or None), stopping once the boxes the brands need are seen."""
    st = _Stream(data, 0, len(data))
    brands, meta, moov = None, None, None
    while True:
        if st.pos > len(data):
            raise ValueError("AVIF: a box runs past the end of the file")
        if st.pos == len(data):
            break
        start = st.pos
        kind, s, e = st.box(top=True)
        if kind in (b"ftyp", b"meta", b"moov") and e > len(data):
            raise ValueError(f"AVIF: the {kind.decode()} box is cut")
        st.pos = e
        if kind == b"ftyp":
            if brands is not None:
                raise ValueError("AVIF: two ftyp boxes")
            b = _Stream(data, s, e)
            major = b.take(4)
            b.take(4)
            if b.left() % 4:
                raise ValueError("AVIF: ftyp's brands")
            brands = [major] + [b.take(4) for _ in range(b.left() // 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise ValueError("AVIF: neither an avif nor an avis brand")
        elif kind == b"meta":
            if meta is not None:
                raise ValueError("AVIF: two meta boxes")
            if data[start:start + 4] == bytes(4):
                # OpenCV's signature check parses a prefix of the file, in
                # which such a meta box's last child is cut
                raise ValueError("AVIF: a meta box of size 0")
            meta = (s, e)
        elif kind == b"moov":
            if moov:
                raise ValueError("AVIF: two moov boxes")
            moov = (s, e)
        if brands is not None and (b"avif" not in brands or meta) and \
                (b"avis" not in brands or moov):
            return brands, meta, moov
    if brands is None:
        raise ValueError("AVIF: no ftyp box")
    raise ValueError("AVIF: the file ends before the boxes its brands need")


# the bytes of a VisualSampleEntry before its child boxes
VISUAL_SAMPLE_ENTRY = 78


def _children(data: bytes, start: int, end: int, parse: dict,
              where: str) -> None:
    """The child boxes of a box, each kind in ``parse`` (kind: function of
    its body's span) at most once, each handed to its function."""
    st, seen = _Stream(data, start, end), set()
    while st.left():
        kind, s, e = st.box()
        if kind in parse:
            if kind in seen:
                raise ValueError(f"AVIF: two {kind.decode()} boxes in "
                                 f"{where}")
            seen.add(kind)
            parse[kind](s, e)
        st.pos = e


def _track(data: bytes, start: int, end: int) -> dict:
    """A ``trak`` box as libavif's avifParseTrackBox reads it: ``tkhd``
    (versions 0 and 1: the track ID and its size, 16.16 fixed point, not
    0 and within the limits), ``mdia`` (``mdhd`` versions 0 and 1,
    ``hdlr`` of any handler, ``minf`` / ``stbl``: ``stsd``'s sample
    entries (version 0 or 1) with the properties of an ``av01`` one,
    ``stsc``, ``stsz``, ``stco`` or ``co64``, ``stss`` and ``stts``, each
    a version 0 box read to its counts), ``tref`` (``auxl``: the first
    track ID), ``edts`` (one ``elst``: one entry and a duration other
    than 0 where it repeats)."""
    t = dict(id=0, size=None, aux_for=0, formats=[], props=None,
             chunks=[], to_chunk=[], sizes=[], all_size=0, stbl=False)

    def v0(s, e):
        b = _Stream(data, s, e)
        b.full((0,))
        return b

    def tkhd(s, e):
        b = _Stream(data, s, e)
        v, _ = b.full((0, 1))
        n = 8 if v else 4
        b.u(2 * n)
        t["id"] = b.u(4)
        b.u(4)
        b.u(n)
        b.take(52)
        W, H = b.u(4) >> 16, b.u(4) >> 16
        if not W or not H or W > MAX_SIDE or H > MAX_SIDE or \
                W * H > MAX_PIXELS:
            raise ValueError(f"AVIF: a track of {W} x {H}")
        t["size"] = (W, H)

    def mdhd(s, e):
        b = _Stream(data, s, e)
        v, _ = b.full((0, 1))
        n = 8 if v else 4
        b.u(2 * n)
        b.u(4)
        b.u(n)

    def stsd(s, e):
        b = _Stream(data, s, e)
        b.full((0, 1))
        for _ in range(b.u(4)):
            kind, bs, be = b.box()
            t["formats"].append(kind)
            if kind == b"av01":
                if be - bs < VISUAL_SAMPLE_ENTRY:
                    raise ValueError("AVIF: a short VisualSampleEntry")
                props = _properties(data, bs + VISUAL_SAMPLE_ENTRY, be)
                if t["props"] is None:
                    t["props"] = props
            b.pos = be

    def offsets(s, e, n):
        b = v0(s, e)
        t["chunks"] = [b.u(n) for _ in range(b.u(4))]

    def stsc(s, e):
        b, prev = v0(s, e), 0
        for k in range(b.u(4)):
            first, per = b.u(4), b.u(4)
            b.u(4)
            if (k == 0 and first != 1) or (k and first <= prev):
                raise ValueError("AVIF: stsc's chunks do not start at 1 "
                                 "and increase")
            prev = first
            t["to_chunk"].append((first, per))

    def stsz(s, e):
        b = v0(s, e)
        t["all_size"], n = b.u(4), b.u(4)
        if not t["all_size"]:
            t["sizes"] = [b.u(4) for _ in range(n)]

    def counted(s, e, fields):
        b = v0(s, e)
        for _ in range(b.u(4)):
            b.u(4 * fields)

    def stbl(s, e):
        t["stbl"] = True
        _children(data, s, e, {
            b"stco": lambda s, e: offsets(s, e, 4),
            b"co64": lambda s, e: offsets(s, e, 8), b"stsc": stsc,
            b"stsz": stsz, b"stss": lambda s, e: counted(s, e, 1),
            b"stts": lambda s, e: counted(s, e, 2), b"stsd": stsd}, "stbl")

    def minf(s, e):
        _children(data, s, e, {b"stbl": stbl}, "minf")

    def hdlr(s, e):
        _handler(_Stream(data, s, e))

    def mdia(s, e):
        _children(data, s, e, {b"mdhd": mdhd, b"hdlr": hdlr,
                               b"minf": minf}, "mdia")

    def tref(s, e):
        b = _Stream(data, s, e)
        while b.left():
            kind, bs, be = b.box()
            if kind == b"auxl":
                t["aux_for"] = b.u(4)
            b.pos = be

    def elst(s, e):
        t["elst"] = True
        b = _Stream(data, s, e)
        v, flags = b.full()
        if flags & 1:
            if b.u(4) != 1:
                raise ValueError("AVIF: an elst of other than one entry")
            if v > 1:
                raise ValueError(f"AVIF: elst version {v}")
            if not b.u(8 if v else 4):
                raise ValueError("AVIF: an elst segment of duration 0")

    def edts(s, e):
        _children(data, s, e, {b"elst": elst}, "edts")
        if not t.get("elst"):
            raise ValueError("AVIF: an edts box without elst")

    _children(data, start, end, {b"tkhd": tkhd, b"mdia": mdia,
                                 b"tref": tref, b"edts": edts}, "trak")
    if t["size"] is None:
        raise ValueError("AVIF: a trak box without tkhd")
    return t


def _samples(t: dict, size: int) -> list:
    """libavif's avifCodecDecodeInputFillFromSampleTable: (offset, size) of
    every sample of a track, chunk by chunk (each chunk's count from the
    last stsc entry that starts at or before it; a chunk of none, a
    sample past stsz's sizes or past the file's end fails)."""
    out, k = [], 0
    for c, offset in enumerate(t["chunks"]):
        per = next((n for first, n in reversed(t["to_chunk"])
                    if first <= c + 1), 0)
        if not per:
            raise ValueError("AVIF: a chunk of no samples")
        if len(out) + per > 86400:  # libavif's imageCountLimit
            raise ValueError("AVIF: more samples than libavif's limit")
        for _ in range(per):
            n = t["all_size"]
            if not n:
                if k >= len(t["sizes"]):
                    raise ValueError("AVIF: a sample table that ends early")
                n = t["sizes"][k]
            if offset + n > size:
                raise ValueError("AVIF: a sample past the end of the file")
            out.append((offset, n))
            offset += n
            k += 1
    return out


def _tracks(data: bytes, moov: tuple) -> tuple:
    """The colour and alpha tracks of an image sequence as libavif picks
    them (the first track with an ID, a sample table of chunks, an av01
    sample entry and no auxl reference; the first such track auxiliary to
    it whose ``auxi``, if any, names alpha), each as an item of its first
    sample (``track``: only the colour's properties are checked)."""
    tracks = []
    st = _Stream(data, *moov)
    while st.left():
        kind, s, e = st.box()
        if kind == b"trak":
            tracks.append(_track(data, s, e))
        st.pos = e

    def usable(t):
        return t["stbl"] and t["id"] and t["chunks"] and b"av01" in \
            t["formats"]

    color = next((t for t in tracks if usable(t) and not t["aux_for"]),
                 None)
    if color is None:
        raise ValueError("AVIF: no AV1 colour track")
    if color["props"] is None:
        raise ValueError("AVIF: the colour track's sample entry has no "
                         "properties")
    # an auxiliary track's auxi (where it has one) names the alpha URN
    alpha = next((t for t in tracks if usable(t) and t["aux_for"] ==
                  color["id"] and next((v for k, v in t["props"] or ()
                                        if k == b"auxi"), ALPHA_URNS[0])
                  in ALPHA_URNS), None)
    out = []
    for t in (color, alpha):
        if t is None:
            out.append(None)
            continue
        samples = _samples(t, len(data))
        W, H = t["size"]
        props = list(t["props"] or []) + [(b"ispe", (W, H))]
        out.append(dict(id=t["id"], type=b"av01", method=0,
                        extents=samples[:1], props=props, track=True,
                        aux_for=t["aux_for"]))
    return out[0], out[1]


def _properties(data: bytes, start: int, end: int) -> list:
    """The ``ipco`` properties in order: (type, parsed fields), each
    checked as libavif checks it (associated or not)."""
    st, out = _Stream(data, start, end), []
    while st.left():
        kind, s, e = st.box()
        r, value = _Stream(data, s, e), None
        if kind == b"ispe":
            r.full((0,))
            value = (r.u(4), r.u(4))
        elif kind in (b"auxC", b"auxi"):
            r.full((0,))
            value = r.string()
        elif kind == b"colr":
            ctype = r.take(4)
            if ctype == b"nclx":
                value = (ctype, r.u(2), r.u(2), r.u(2), r.u(1))
                if value[4] & 0x7F:
                    raise ValueError("AVIF: colr's reserved bits")
                value = value[:4] + (value[4] >> 7,)
            elif ctype in (b"rICC", b"prof"):
                value = (b"ICC",)
        elif kind == b"av1C":
            value = r.take(4)
            if value[0] != 0x81:
                raise ValueError("AVIF: av1C marker or version")
        elif kind == b"pixi":
            r.full((0,))
            n = r.u(1)
            if not 1 <= n <= 4:
                raise ValueError(f"AVIF: pixi with {n} planes")
            value = tuple(r.take(n))
        elif kind in (b"irot", b"imir"):
            if r.u(1) & (0xFC if kind == b"irot" else 0xFE):
                raise ValueError(f"AVIF: {kind.decode()}'s reserved bits")
        elif kind == b"a1op":
            value = r.u(1)
            if value > 31:
                raise ValueError("AVIF: a1op's operating point")
        elif kind == b"lsel":
            value = r.u(2)
            if value != 0xFFFF and value >= 4:
                raise ValueError("AVIF: lsel's layer")
        elif kind == b"a1lx":
            x = r.u(1)
            if x & 0xFE:
                raise ValueError("AVIF: a1lx's reserved bits")
            r.take(12 if x & 1 else 6)
        elif kind in (b"pasp", b"clap", b"clli"):
            r.take({b"pasp": 8, b"clap": 32, b"clli": 4}[kind])
        out.append((kind, value))
        st.pos = e
    return out


def _new_item(items: dict, iid: int) -> dict:
    """libavif's ``avifMetaFindOrCreateItem``: items keep the order in
    which the boxes first name them."""
    if iid not in items:
        items[iid] = dict(id=iid, type=None, extents=[], method=0, props=[],
                          unsupported=False, ipma=False, aux_for=0,
                          thumb_for=0, dimg_for=0, dimg_idx=0)
    return items[iid]


def _iloc(b: _Stream, items: dict):
    v, _ = b.full()
    if v > 2:
        raise ValueError(f"AVIF: iloc version {v}")
    sizes = b.u(2)
    off_size, len_size = sizes >> 12, (sizes >> 8) & 15
    base_size, idx_size = (sizes >> 4) & 15, sizes & 15 if v else 0
    if any(n not in (0, 4, 8) for n in (off_size, len_size, base_size,
                                         idx_size)):
        raise ValueError("AVIF: iloc field size")
    for _ in range(b.u(2 if v < 2 else 4)):
        iid = b.u(2 if v < 2 else 4)
        if iid == 0:
            raise ValueError("AVIF: item ID 0")
        item = _new_item(items, iid)
        if item["extents"]:
            raise ValueError("AVIF: an item located twice")
        if v:
            x = b.u(2)
            if x >> 4:
                raise ValueError("AVIF: iloc's reserved bits")
            item["method"] = x & 15
            if x & 15 not in (0, 1):
                raise ValueError(f"AVIF: iloc construction method {x & 15}")
        b.u(2)  # data_reference_index
        base = b.u(base_size)
        for _ in range(b.u(2)):
            b.u(idx_size)
            extent = (base + b.u(off_size), b.u(len_size))
            if not idx_size:  # libavif drops an extent that has an index
                item["extents"].append(extent)


def _iinf(data: bytes, b: _Stream, items: dict):
    v, _ = b.full((0, 1))
    for _ in range(b.u(2 if v == 0 else 4)):  # libavif reads count boxes
        kind, s, e = b.box()
        if kind != b"infe":
            raise ValueError("AVIF: iinf holds a box other than infe")
        ib = _Stream(data, s, e)
        iv, _ = ib.full((2, 3))
        iid = ib.u(2 if iv == 2 else 4)
        if iid == 0:
            raise ValueError("AVIF: item ID 0")
        ib.u(2)  # item_protection_index
        kind = ib.take(4)
        ib.string()  # item_name
        if kind == b"mime":
            ib.string()  # content_type
        _new_item(items, iid)["type"] = kind
        b.pos = e


def _iref(b: _Stream, items: dict):
    """References as libavif reads them: each box's header is checked,
    its fields read on from the header whatever its size; versions past 1
    are skipped whole."""
    v, _ = b.full()
    n = 2 if v == 0 else 4
    while v <= 1 and b.left():
        kind, _, _ = b.box()
        src = b.u(n)
        for k in range(b.u(2)):
            dst = b.u(n)
            if src and dst:
                item = _new_item(items, src)
                if kind == b"thmb":
                    item["thumb_for"] = dst
                elif kind == b"auxl":
                    item["aux_for"] = dst
                elif kind == b"dimg":  # the tile's grid and its place
                    tile = _new_item(items, dst)
                    tile["dimg_for"], tile["dimg_idx"] = src, k


def _ipma(b: _Stream, props: list, items: dict):
    v, flags = b.full()
    prev = 0
    for _ in range(b.u(4)):
        iid = b.u(2 if v == 0 else 4)
        if iid == 0 or iid <= prev:
            raise ValueError("AVIF: ipma's item IDs do not increase")
        prev = iid
        item = _new_item(items, iid)
        if item["ipma"]:
            raise ValueError("AVIF: an item in two ipma entries")
        item["ipma"] = True
        bits = 15 if flags & 1 else 7
        for _ in range(b.u(1)):
            x = b.u(2 if flags & 1 else 1)
            essential, k = x >> bits, x & ((1 << bits) - 1)
            if k == 0:
                if essential:
                    raise ValueError("AVIF: property index 0 marked "
                                     "essential")
                continue
            if k > len(props):
                raise ValueError("AVIF: a property index past ipco")
            kind, value = props[k - 1]
            if kind not in KNOWN:
                item["unsupported"] |= bool(essential)
                continue
            if essential and kind == b"a1lx":
                raise ValueError("AVIF: a1lx marked essential")
            if not essential and kind in (b"a1op", b"lsel") + TRANSFORMS:
                raise ValueError(f"AVIF: a {kind.decode()} property not "
                                 "marked essential")
            item["props"].append((kind, value))
    return v, flags


def _iprp(data: bytes, b: _Stream, items: dict) -> list:
    kind, s, e = b.box()
    if kind != b"ipco":
        raise ValueError("AVIF: iprp does not start with ipco")
    props = _properties(data, s, e)
    b.pos = e
    seen = []
    while b.left():
        kind, s, e = b.box()
        if kind != b"ipma":
            raise ValueError("AVIF: iprp holds a box other than ipma")
        vf = _ipma(_Stream(data, s, e), props, items)
        if vf in seen:
            raise ValueError("AVIF: two ipma boxes of one version and flags")
        seen.append(vf)
        b.pos = e
    return props


def _handler(b: _Stream) -> bytes:
    """A ``hdlr`` box's handler type (version 0, pre_defined 0, a name
    that ends)."""
    b.full((0,))
    if b.u(4):
        raise ValueError("AVIF: hdlr pre_defined is not 0")
    kind = b.take(4)
    b.take(12)
    b.string()
    return kind


def _meta(data: bytes, start: int, end: int) -> tuple:
    """(items, primary item ID, idat) of the meta box, as libavif's
    ``avifParseMetaBox`` reads them."""
    st = _Stream(data, start, end)
    st.full((0,))
    items, primary, idat, seen = {}, 0, None, []
    while st.left():
        kind, s, e = st.box()
        if not seen and kind != b"hdlr":
            raise ValueError("AVIF: meta does not start with hdlr")
        if kind in seen and kind in UNIQUE:
            raise ValueError(f"AVIF: two {kind.decode()} boxes")
        seen.append(kind)
        b = _Stream(data, s, e)
        if kind == b"hdlr":
            if _handler(b) != b"pict":
                raise ValueError("AVIF: the handler is not pict")
        elif kind == b"pitm":
            v, _ = b.full()
            primary = b.u(2 if v == 0 else 4)
        elif kind == b"iloc":
            _iloc(b, items)
        elif kind == b"idat":
            idat = data[s:e]
        elif kind == b"iinf":
            _iinf(data, b, items)
        elif kind == b"iref":
            _iref(b, items)
        elif kind == b"iprp":
            _iprp(data, b, items)
        st.pos = e
    if not seen:
        raise ValueError("AVIF: an empty meta box")
    return items, primary, idat


def prop(item: dict, kind: bytes):
    """The first ``kind`` property associated with ``item`` (None)."""
    return next((v for k, v in item["props"] if k == kind), None)


def _depth(av1c: bytes) -> int:
    """libavif's bit depth of an ``av1C``: twelve_bit, else
    high_bitdepth."""
    return 12 if av1c[2] & 0x20 else 10 if av1c[2] & 0x40 else 8


def _usable(items: dict) -> list:
    """The items libavif keeps, each checked for its ``ispe`` and its
    ``pixi`` against its ``av1C`` (whatever the image's source: a
    sequence's file is refused for them too)."""
    usable = []
    for item in items.values():
        # libavif skips an empty item, one with an unknown essential
        # property, a thumbnail and an item of an unknown type
        if sum(n for _, n in item["extents"]) and not item["unsupported"] \
                and not item["thumb_for"] and item["type"] in (b"av01",
                                                               b"grid"):
            usable.append(item)
    for item in usable:
        size = prop(item, b"ispe")
        if size is None:
            if prop(item, b"auxC") not in ALPHA_URNS:  # strict checks off
                raise ValueError(f"AVIF: item {item['id']} without ispe")
        elif 0 in size or size[0] > MAX_SIDE or size[1] > MAX_SIDE or \
                size[0] * size[1] > MAX_PIXELS:
            raise ValueError(f"AVIF: item {item['id']} of size {size}")
        av1c = prop(item, b"av1C")
        if av1c is not None and any(d != _depth(av1c) for d in
                                    prop(item, b"pixi") or ()):
            raise ValueError("AVIF: pixi's depths are not av1C's")
    return usable


def _items(usable: list, primary: int, meta) -> tuple:
    """The primary item and its alpha item as libavif picks them."""
    if meta is None:
        raise ValueError("AVIF: no meta box")
    color = next((it for it in usable if it["id"] == primary), None)
    if color is None:
        raise ValueError("AVIF: no primary image item")
    alpha = next((it for it in usable if it["aux_for"] == primary and
                  prop(it, b"auxC") in ALPHA_URNS), None)
    return color, alpha


def parse(data: bytes) -> dict:
    """The container of an AVIF image as libavif 1.4.2 reads it under
    OpenCV: ``{"items": {id: item}, "primary": id, "color": item, "alpha":
    item or None, "idat": bytes}`` (an image sequence: its colour and
    alpha tracks' first samples as items); ``ValueError`` where libavif
    fails, ``NotImplementedError`` for what it reads and this module does
    not."""
    brands, meta, moov = _top(data)
    items, primary, idat = _meta(data, *meta) if meta else ({}, 0, None)
    usable = _usable(items)
    if brands[0] == b"avis" or (brands[0] != b"avif" and moov):
        color, alpha = _tracks(data, moov)
        primary = color["id"]
    else:
        color, alpha = _items(usable, primary, meta)
    for item in (color, alpha):
        if item is not None and item["type"] == b"grid":
            _grid(data, items, idat, item)
    for item in (color, alpha):
        if item is None or (item is alpha and item.get("track")):
            continue
        av1c = prop(item, b"av1C")
        if av1c is None:
            raise ValueError("AVIF: an av01 item without av1C")
        if any(d != _depth(av1c) for d in prop(item, b"pixi") or ()):
            raise ValueError("AVIF: pixi's depths are not av1C's")
    colr = [v[0] for k, v in color["props"] if k == b"colr" and v]
    if colr.count(b"nclx") > 1 or colr.count(b"ICC") > 1:
        raise ValueError("AVIF: two colr properties of one kind")
    return dict(items=items, primary=primary, color=color, alpha=alpha,
                idat=idat)


def _grid(data: bytes, items: dict, idat, item: dict):
    """A grid item as libavif's parser takes it: its ImageGrid (version 0,
    16- or 32-bit output sizes, nothing after them, within the size
    limits) as ``item["grid"]`` (rows, columns, W, H), and as
    ``item["tiles"]`` the items that name it in ``dimg``, in their order
    there: as many as the grid's cells, each an ``av01`` item without an
    unknown essential property and with the first tile's ``av1C``, which
    the grid takes as its own."""
    payload = _payload(data, dict(idat=idat), item)
    st = _Stream(payload, 0, len(payload))
    try:
        if st.u(1):
            raise ValueError("AVIF: an ImageGrid of version other than 0")
        n = 4 if st.u(1) & 1 else 2
        rows, cols = st.u(1) + 1, st.u(1) + 1
        W, H = st.u(n), st.u(n)
    except ValueError as e:
        raise ValueError(f"AVIF: the ImageGrid: {e}") from None
    if not W or not H or W > MAX_SIDE or H > MAX_SIDE or \
            W * H > MAX_PIXELS or st.left():
        raise ValueError(f"AVIF: an ImageGrid of {W} x {H} (or bytes "
                         "after it)")
    tiles = sorted((it for it in items.values()
                    if it["dimg_for"] == item["id"]),
                   key=lambda it: it["dimg_idx"])
    if len(tiles) != rows * cols:
        raise ValueError(f"AVIF: a grid of {rows} x {cols} with "
                         f"{len(tiles)} tiles")
    av1c = prop(tiles[0], b"av1C")
    for t in tiles:
        if t["type"] != b"av01" or t["unsupported"]:
            raise ValueError("AVIF: a grid tile that is not a usable av01 "
                             "item")
        if av1c is None or prop(t, b"av1C") != av1c:
            raise ValueError("AVIF: grid tiles without the first tile's "
                             "av1C")
    item["grid"], item["tiles"] = (rows, cols, W, H), tiles
    item["props"].append((b"av1C", av1c))


def _payload(data: bytes, box: dict, item: dict) -> bytes:
    if item["method"] == 1 and box["idat"] is None:
        raise ValueError("AVIF: an item in idat without an idat box")
    src = data if item["method"] == 0 else box["idat"]
    out = []
    for off, length in item["extents"]:
        if off > len(src) or length > len(src) - off:
            raise ValueError("AVIF: an item's extent runs past the data")
        out.append(src[off:off + length])
    return b"".join(out)


def _lib():
    lib = _build.load("av1_decode")
    i64, ptr, cint = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    lib.av1_info.argtypes = [ctypes.c_char_p, i64, cint, cint, ptr,
                             ctypes.c_char_p, cint]
    lib.av1_decode.argtypes = [ctypes.c_char_p, i64, cint, cint, ptr, cint,
                               i64, i64, ctypes.c_char_p, cint]
    lib.av1_lr_stats.argtypes = [ctypes.c_char_p, i64, ptr, ptr,
                                 ctypes.c_char_p, cint]
    lib.av1_grain_params.argtypes = [ctypes.c_char_p, i64, ptr,
                                     ctypes.c_char_p, cint]
    lib.av1_decode_ms.argtypes = [ctypes.c_char_p, i64, ptr, ptr,
                                  ctypes.c_char_p, cint]
    lib.av1_info.restype = lib.av1_decode.restype = cint
    lib.av1_lr_stats.restype = lib.av1_grain_params.restype = cint
    lib.av1_decode_ms.restype = cint
    return lib


def _call(fn, *args):
    err = ctypes.create_string_buffer(256)
    status = fn(*args, err, len(err))
    if status:
        raise STATUS.get(status, RuntimeError)(err.value.decode(
            errors="replace"))


def av1_info(obus: bytes, op: int = 0, layer: int = -1) -> dict:
    """The frame header of the frame an AV1 item's OBUs output: under
    operating point ``op`` (``a1op``), the last frame shown, or with
    ``layer`` (``lsel``) the first shown of that spatial layer."""
    v = np.zeros(20, np.int32)
    _call(_lib().av1_info, obus, len(obus), op, layer, v.ctypes.data)
    keys = ("width", "height", "depth", "mono", "ssx", "ssy", "matrix",
            "full_range", "primaries", "transfer", "profile", "still",
            "base_q", "tx_mode_select", "cdef_bits")
    info = {k: int(x) for k, x in zip(keys, v)}
    # FrameRestorationType of each plane (0 none, 1 Wiener, 2 self-guided,
    # 3 switchable), the luma unit size and lr_uv_shift
    info["lr_types"] = tuple(int(x) for x in v[15:18])
    info["lr_unit"], info["lr_uv_shift"] = int(v[18]), int(v[19])
    return info


def av1_planes(obus: bytes, info: dict = None, op: int = 0,
               layer: int = -1) -> tuple:
    """(planes: a list of ``uint16`` arrays, Y ``[H, W]`` then U and V at
    their subsampled size, frame header) of the frame an AV1 item outputs
    (:func:`av1_info`'s ``op`` and ``layer``), decoded in C; ``info``: its
    :func:`av1_info`, where known."""
    info = info or av1_info(obus, op, layer)
    n = 1 if info["mono"] else 3
    H, W = info["height"], info["width"]
    Hc, Wc = (H + info["ssy"]) >> info["ssy"], (W + info["ssx"]) >> info["ssx"]
    out = np.empty(H * W + (n - 1) * Hc * Wc, np.uint16)
    _call(_lib().av1_decode, obus, len(obus), op, layer, out.ctypes.data, n,
          H, W)
    planes = [out[:H * W].reshape(H, W)]
    for k in range(n - 1):
        start = H * W + k * Hc * Wc
        planes.append(out[start:start + Hc * Wc].reshape(Hc, Wc))
    return planes, info


def lr_stats(obus: bytes) -> tuple:
    """(counts, ms) of an AV1 frame's loop restoration, decoded in C:
    ``counts[plane]`` the plane's restoration units that take no filter,
    the Wiener filter and the self-guided filter; ``ms`` the milliseconds
    the decoder spent in the restoration filter."""
    counts = np.zeros(9, np.int32)
    ms = np.zeros(1, np.float64)
    _call(_lib().av1_lr_stats, obus, len(obus), counts.ctypes.data,
          ms.ctypes.data)
    return counts.reshape(3, 3), float(ms[0])


def grain_params(obus: bytes) -> np.ndarray:
    """The film grain of an AV1 frame, ``int32 [162]`` in the order of
    libaom's ``aom_film_grain_t`` (``av1_tables.h``
    ``film_grain_test_vectors``; the last entry the grain seed): zeros
    where the frame has none."""
    v = np.zeros(162, np.int32)
    _call(_lib().av1_grain_params, obus, len(obus), v.ctypes.data)
    return v


def _decode_ms(obus: bytes, counts=None) -> np.ndarray:
    """ms of the decode of AV1 data, of its film grain, of its superres
    upscaling and of its inter prediction, decoded in C; ``counts`` (an
    int32 array of len(:data:`INTER_TOOLS`)) takes the inter frames' blocks
    by tool."""
    ms = np.zeros(4, np.float64)
    _call(_lib().av1_decode_ms, obus, len(obus), ms.ctypes.data,
          None if counts is None else counts.ctypes.data)
    return ms


def grain_ms(obus: bytes) -> tuple:
    """(ms of the decode, ms of adding its film grain) of an AV1 frame,
    decoded in C."""
    ms = _decode_ms(obus)
    return float(ms[0]), float(ms[1])


# the counts of av1_decode_ms: the inter frames' blocks by tool
INTER_TOOLS = ("inter", "intra", "newmv", "globalmv", "obmc", "local_warp",
               "global_warp", "interintra", "wedge", "scaled", "sub8x8",
               "dual_filter", "projected", "temporal")


def inter_stats(obus: bytes) -> tuple:
    """(counts, ms of the decode, ms of its inter prediction) of AV1 data
    decoded in C: ``counts`` by :data:`INTER_TOOLS`: the inter frames'
    inter and intra blocks, NEWMV and GLOBALMV ones, OBMC, valid local
    warps, global warps, inter-intra with and without a wedge; predictions
    from a reference of another size and chroma predicted from several
    luma blocks' vectors, counted per prediction; blocks of two
    interpolation filters; motion field units projected
    (use_ref_frame_mvs); temporal candidates added to a block's vector
    stack.  A decode that reaches a refused tool raises."""
    counts = np.zeros(len(INTER_TOOLS), np.int32)
    ms = _decode_ms(obus, counts)
    return dict(zip(INTER_TOOLS, counts.tolist())), float(ms[0]), float(ms[3])


def superres_ms(obus: bytes) -> tuple:
    """(ms of the decode, ms of its superres upscaling: 0 where the frame
    is coded at its width) of AV1 data, decoded in C."""
    ms = _decode_ms(obus)
    return float(ms[0]), float(ms[2])


def _decode(data: bytes, box: dict, item: dict, size, alpha=False
            ) -> tuple:
    """(planes, frame header, deferred NotImplementedError) of an item
    whose image is ``size`` (its ``ispe``, a track's ``tkhd`` size).
    libavif scales a frame of another size to it (libyuv's ScalePlane,
    :mod:`yuv_scale`; it refuses a frame wider or taller than 16384).  A
    frame of more samples than the image and than ``SCALED_PIXELS`` is not
    decoded (NotImplementedError): a damaged header cannot make the port
    allocate more.  An ``alpha`` item is decoded for its faults only
    (OpenCV's reader drops it): its planes are None."""
    payload = _payload(data, box, item)
    # libavif decodes the item under its a1op's operating point; with an
    # lsel layer libaom outputs every layer and libavif takes that one
    op, layer = prop(item, b"a1op") or 0, prop(item, b"lsel")
    layer = -1 if layer in (None, 0xFFFF) else layer
    try:
        info = av1_info(payload, op, layer)
    except NotImplementedError as e:
        return None, None, e
    W, H = info["width"], info["height"]
    if W * H > max(size[0] * size[1], SCALED_PIXELS):
        return None, info, NotImplementedError(
            "AVIF: a frame larger than its image (libavif scales it)")
    planes = av1_planes(payload, info, op, layer)[0]
    if (W, H) != tuple(size) and (W > 16384 or H > 16384):
        raise ValueError("AVIF: a frame wider or taller than 16384 that "
                         "libavif would scale")
    if alpha:
        return None, dict(info, width=size[0], height=size[1]), None
    if (W, H) == tuple(size):
        return planes, info, None
    dw, dh = size
    out = []
    for p, plane in enumerate(planes):
        sx, sy = (info["ssx"], info["ssy"]) if p else (0, 0)
        out.append(yuv_scale.scale_plane(plane, (dw + sx) >> sx,
                                         (dh + sy) >> sy, info["depth"] > 8))
    return out, dict(info, width=dw, height=dh), None


# the frame properties every tile of a grid shares with the first
TILE_KEYS = ("depth", "mono", "ssx", "ssy", "full_range", "primaries",
             "transfer", "matrix")


def _decode_grid(data: bytes, box: dict, item: dict, size, alpha=False
                 ) -> tuple:
    """(planes, frame header, deferred NotImplementedError) of a grid item
    (libavif's avifDecoderDataFillImageGrid): each tile decoded (and
    scaled to its ``ispe``), every tile like the first (size, depth,
    format, range, colour description), the tiles covering the output and
    those of the last row and column reaching into it, tiles of at least
    64 x 64 and even sides and output where the chroma is subsampled
    (alpha: its format is none, and its planes None); the tiles copied
    into one image cropped to the output size, which must be the image's
    (OpenCV's Mat is ``ispe``'s)."""
    rows, cols, W, H = item["grid"]
    later, infos, tiles = None, [], []
    for t in item["tiles"]:
        planes, info, e = _decode(data, box, t, prop(t, b"ispe") or size,
                                  alpha)
        later = later or e
        infos.append(info)
        tiles.append(planes)
    if any(i is None for i in infos):
        return None, None, later
    # a tile's size is its ispe's: libavif scales the frame to it
    dims = [tuple(prop(t, b"ispe") or (i["width"], i["height"]))
            for t, i in zip(item["tiles"], infos)]
    first = infos[0]
    tw, th = dims[0]
    if any(d != dims[0] or any(i[k] != first[k] for k in TILE_KEYS)
           for d, i in zip(dims, infos)):
        raise ValueError("AVIF: a grid of mismatched tiles")
    if tw * cols < W or th * rows < H or tw * (cols - 1) >= W or \
            th * (rows - 1) >= H:
        raise ValueError("AVIF: grid tiles that do not cover the output, "
                         "or a last row or column outside it")
    ssx, ssy = (0, 0) if alpha or first["mono"] else (first["ssx"],
                                                      first["ssy"])
    if tw < 64 or th < 64 or (ssx and (W % 2 or tw % 2)) or (
            ssy and (H % 2 or th % 2)):
        raise ValueError("AVIF: grid tiles smaller than 64 x 64, or odd "
                         "sides under subsampled chroma")
    if (W, H) != tuple(size):
        raise ValueError("AVIF: a grid whose output is not its image's "
                         "size (OpenCV's reader refuses it)")
    if later or alpha:
        return None, first, later
    out = []
    for p in range(len(tiles[0])):
        sx, sy = (ssx, ssy) if p else (0, 0)
        plane = np.empty(((H + sy) >> sy, (W + sx) >> sx), np.uint16)
        for k, planes in enumerate(tiles):
            r, c = divmod(k, cols)
            y0, x0 = (r * th) >> sy, (c * tw) >> sx
            h = min(th, H - r * th)
            w = min(tw, W - c * tw)
            h, w = (h + sy) >> sy, (w + sx) >> sx
            plane[y0:y0 + h, x0:x0 + w] = planes[p][:h, :w]
        out.append(plane)
    return out, dict(first, width=W, height=H), None


def _to8(v: np.ndarray, depth: int) -> np.ndarray:
    """libavif's 10- and 12-bit samples to 8 bits in its YUV to RGB."""
    scale = np.float32(255.0 / ((1 << depth) - 1))
    return np.clip(np.rint(v.astype(np.float32) * scale), 0, 255).astype(
        np.uint8)


def _chroma_up(c: np.ndarray, H: int, W: int, ssx: int, ssy: int
               ) -> np.ndarray:
    """libyuv's upsampling of a chroma plane to [H, W]."""
    return yuv_scale.up2_bilinear(c, H, W) if ssy else \
        yuv_scale.up2_linear(c, W) if ssx else c


# libyuv's YuvConstants as libavif 1.4.2's build holds them (yg, yb, ub,
# ug, vg, vr: kYuv<name>Constants of cv2's libavif)
LIBYUV = {"JPEG": (16320, 32, 113, 22, 46, 90),
          "F709": (16320, 32, 119, 12, 30, 101),
          "V2020": (16320, 32, 120, 11, 37, 94),
          "I601": (18997, -1160, 128, 25, 52, 102),
          "H709": (18997, -1160, 128, 14, 34, 115),
          "2020": (19003, -1160, 128, 12, 42, 107)}
# libavif's matrixCoefficientsTables (kr, kb) and avifColorPrimariesTables
# (rx, ry, gx, gy, bx, by, wx, wy), float32 in the library
MATRIX_KR_KB = {1: (0.2126, 0.0722), 4: (0.3, 0.11), 5: (0.299, 0.114),
                6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}
PRIMARIES = {
    1: (0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.31, 0.316),
    5: (0.64, 0.33, 0.29, 0.6, 0.15, 0.06, 0.3127, 0.329),
    6: (0.63, 0.34, 0.31, 0.595, 0.155, 0.07, 0.3127, 0.329),
    7: (0.63, 0.34, 0.31, 0.595, 0.155, 0.07, 0.3127, 0.329),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.31, 0.316),
    9: (0.708, 0.292, 0.17, 0.797, 0.131, 0.046, 0.3127, 0.329),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.68, 0.32, 0.265, 0.69, 0.15, 0.06, 0.314, 0.351),
    12: (0.68, 0.32, 0.265, 0.69, 0.15, 0.06, 0.3127, 0.329),
    22: (0.63, 0.34, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.329)}


def _libyuv_constants(matrix: int, full: bool, primaries: int):
    """The libyuv constants libavif's getLibYUVConstants picks, or None
    (libavif's own conversion)."""
    if matrix == 12:  # chroma-derived: by the primaries
        matrix = {1: 1, 2: 1, 5: 6, 6: 6, 9: 9}.get(primaries, 0)
    names = {1: ("F709", "H709"), 2: ("JPEG", "I601"), 5: ("JPEG", "I601"),
             6: ("JPEG", "I601"), 9: ("V2020", "2020")}.get(matrix)
    return LIBYUV[names[0 if full else 1]] if names else None


def _kr_kb(matrix: int, primaries: int) -> tuple:
    """libavif's (kr, kb) of a matrix, float32: its table's, BT.601's for
    one it lacks, and for 12 (chroma-derived) computed from the primaries
    (avifColorPrimariesComputeYCoeffs; BT.709's for unknown primaries)."""
    F = np.float32
    if matrix != 12:
        kr, kb = MATRIX_KR_KB.get(matrix, (0.299, 0.114))
        return F(kr), F(kb)
    rX, rY, gX, gY, bX, bY, wX, wY = (F(v) for v in PRIMARIES.get(
        primaries, PRIMARIES[1]))
    one = F(1)
    rZ, gZ, bZ, wZ = (one - (rX + rY), one - (gX + gY), one - (bX + bY),
                      one - (wX + wY))
    den = wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ)
                + bX * (rY * gZ - gY * rZ))
    kr = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ)
                + wZ * (gX * bY - bX * gY))) / den
    kb = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ)
                + wZ * (rX * gY - gX * rY))) / den
    return F(kr), F(kb)


def _libyuv(y, u, v, consts, depth: int = 8) -> np.ndarray:
    """libyuv's I444ToARGBRow (YuvPixel, 6-bit fixed point) with
    ``consts`` of 8-bit samples, or its YuvPixel10 / YuvPixel12 of 10- or
    12-bit ones (Y widened to 16 bits, U and V narrowed to 8): uint8
    BGR."""
    # int32 holds every product: y widened to 16 bits, times 19003
    y, u, v = (a.astype(np.int32) for a in (y, u, v))
    if depth > 8:
        sh = depth - 8
        y = (y << (16 - depth)) | (y >> (2 * depth - 16))
        u, v = np.minimum(u >> sh, 255), np.minimum(v >> sh, 255)
    else:
        y = y * 0x0101
    yg, yb, ub, ug, vg, vr = consts
    y1 = (y * yg) >> 16
    b = y1 + u * ub - (ub * 128 - yb)
    g = y1 + (ug * 128 + vg * 128 + yb) - (u * ug + v * vg)
    r = y1 + v * vr - (vr * 128 - yb)
    return np.clip(np.stack([b, g, r], -1) >> 6, 0, 255).astype(np.uint8)


def _float_rgb(planes, depth: int, rgb_depth: int, ssx: int, ssy: int,
               matrix: int, full: bool, primaries: int) -> np.ndarray:
    """libavif's own YUV to RGB (avifImageYUVAnyToRGBAnySlow, and its fast
    paths where the chroma is not subsampled), float32 as it computes: the
    unorm tables of the range, chroma upsampled bilinearly (9/16, 3/16,
    3/16, 1/16 of the nearest chroma samples, the edge's repeated; 4:2:2
    along rows only), R = Y + 2 (1 - kr) Cr, B = Y + 2 (1 - kb) Cb, G = Y -
    2 (kr (1 - kr) Cr + kb (1 - kb) Cb) / kg (YCgCo: G = Y + Cg, B = Y -
    Cg - Co, R = Y - Cg + Co), clamped and stored as 0.5 + x * max
    truncated: BGR at ``rgb_depth`` (uint8 or uint16)."""
    F = np.float32
    mx = F((1 << depth) - 1)
    cps = np.arange(1 << depth, dtype=F)
    s = 1 << (depth - 8)
    bias_y, range_y, range_uv = (0, mx, mx) if full else (
        16 * s, 219 * s, 224 * s)
    ty = (cps - F(bias_y)) / F(range_y)
    tuv = (cps - F(1 << (depth - 1))) / F(range_uv)
    Y = ty[planes[0]]
    H, W = Y.shape
    if ssx:
        i, j = np.arange(W), np.arange(H)
        ui, uj = i >> 1, j >> ssy
        ac = np.where((i == 0) | ((i == W - 1) & (i % 2 == 1)), 0,
                      np.where(i % 2 == 1, 1, -1))
        ar = np.where((j == 0) | ((j == H - 1) & (j % 2 == 1)), 0,
                      np.where(j % 2 == 1, 1, -1)) if ssy else 0 * j

        def chroma(p):
            t = tuv[p]
            return ((t[uj[:, None], ui[None, :]] * F(9.0 / 16.0))
                    + (t[uj[:, None], (ui + ac)[None, :]] * F(3.0 / 16.0))
                    + (t[(uj + ar)[:, None], ui[None, :]] * F(3.0 / 16.0))
                    + (t[(uj + ar)[:, None], (ui + ac)[None, :]]
                       * F(1.0 / 16.0)))
        cb, cr = chroma(planes[1]), chroma(planes[2])
    else:
        cb, cr = tuv[planes[1]], tuv[planes[2]]
    out = F((1 << rgb_depth) - 1)
    if matrix == 0:  # identity, limited range: Y's table for each
        g, b, r = Y, ty[planes[1]], ty[planes[2]]
    elif matrix == 16:  # YCgCo-Re, in integers of the unrounded chroma
        cg, co = (np.floor(c * mx + F(0.5)).astype(np.int64)
                  for c in (cb, cr))  # avifRoundf
        t = planes[0].astype(np.int64) - (cg >> 1)
        top = (1 << rgb_depth) - 1
        g = np.clip(t + cg, 0, top)
        b = np.clip(t - (co >> 1), 0, top)
        r = np.clip(b + co, 0, top)
        g, b, r = (x.astype(F) / out for x in (g, b, r))
    elif matrix == 8:
        t = Y - cb
        g, b, r = Y + cb, t - cr, t + cr
    else:
        kr, kb = _kr_kb(matrix, primaries)
        kg = F(1) - kr - kb
        r = Y + (F(2) * (F(1) - kr)) * cr
        b = Y + (F(2) * (F(1) - kb)) * cb
        g = Y - ((F(2) * ((kr * (F(1) - kr) * cr) + (kb * (F(1) - kb)
                                                      * cb))) / kg)
    return np.stack([np.floor(F(0.5) + np.clip(c, F(0), F(1)) * out)
                     for c in (b, g, r)], -1).astype(
        np.uint8 if rgb_depth == 8 else np.uint16)


def _yuv_to_bgr(planes, info: dict, rgb_depth: int, alpha: bool,
                matrix: int, full: bool, primaries: int) -> np.ndarray:
    """Colour (4:4:4, 4:2:2 or 4:2:0) under a YUV matrix as OpenCV's reader
    gets it from libavif 1.4.2 (measured on every path through
    cv2.imread).  To the frame's own depth, and to 8 bits under a matrix
    libyuv has no constants for: libavif's float32 conversion.  To 8 bits
    otherwise, libyuv: 8-bit samples, and deeper ones shifted down to 8
    bits, upsampled (4:2:0 bilinearly, 4:2:2 along rows) and converted at
    8 bits; but with an alpha item (OpenCV asks for BGRA) 10-bit samples
    upsampled at 10 bits and converted by YuvPixel10, 12-bit 4:2:0 ones
    with each chroma sample repeated over its 2 x 2 block and converted by
    YuvPixel12 (12-bit 4:2:2 and 4:4:4 take the 8-bit path)."""
    depth, ssx, ssy = info["depth"], info["ssx"], info["ssy"]
    consts = _libyuv_constants(matrix, full, primaries)
    if rgb_depth != 8 or consts is None:
        return _float_rgb(planes, depth, rgb_depth, ssx, ssy, matrix, full,
                          primaries)
    y, u, v = planes
    H, W = y.shape
    if depth == 10 and alpha:
        u, v = (_chroma_up(c, H, W, ssx, ssy) for c in (u, v))
        return _libyuv(y, u, v, consts, 10)
    if depth == 12 and alpha and ssy:
        u, v = (np.repeat(np.repeat(c, 2, 0), 2, 1)[:H, :W] for c in (u, v))
        return _libyuv(y, u, v, consts, 12)
    y, u, v = (p >> (depth - 8) for p in planes)
    u, v = (_chroma_up(c, H, W, ssx, ssy) for c in (u, v))
    return _libyuv(y, u, v, consts)


def _file_extents(*items) -> list:
    """The extents in the file (not idat) of ``items`` (None skipped)."""
    return [e for it in items if it is not None and it["method"] == 0
            for e in it["extents"]]


def _stored_before(color: dict, alpha, nclx: bool) -> bool:
    """OpenCV's reader returns None for a file whose data is stored in an
    order it does not take (probed on every order of one- and two-extent
    items and of a grid's items; an extent in idat takes no part): a grid
    whose ImageGrid, in the file, comes after one of its tiles' data;
    where no nclx names the colour, a colour item whose first extent
    comes after another of its extents or of its alpha item's, or a grid
    whose first tile's first extent comes after another extent of its
    tiles (its alpha's take no part)."""
    if color.get("track"):
        return False
    if color.get("grid"):
        tiles = color["tiles"]
        first = _file_extents(color)[:1]
        if first and any(off < first[0][0] for off, _ in
                         _file_extents(*tiles)):
            return True
        lead, others = tiles[0], _file_extents(*tiles[1:])
    else:
        lead, others = color, _file_extents(alpha)
    first = _file_extents(lead)
    return not nclx and bool(first) and any(
        off < first[0][0] for off, _ in first[1:] + others)


def decode_avif(data: bytes, path="<bytes>", gray: bool = False
                ) -> np.ndarray:
    """AVIF bytes -> what ``cv2.imread`` returns for a file of them (module
    docstring): ``uint8 [H, W, 3]`` BGR, or with ``gray`` ``[H, W]``
    (``uint8``, ``uint16`` where ``av1C`` names 10 or 12 bits)."""
    try:
        box = parse(data)
        color, alpha = box["color"], box["alpha"]
        av1c = prop(color, b"av1C")
        depth, mono = _depth(av1c), bool(av1c[2] & 0x10)
        # OpenCV's channel count: av1C's format, and one for alpha
        if mono and alpha is not None:
            raise ValueError("AVIF: a gray image with alpha (OpenCV's "
                             "reader refuses two channels)")
        size = prop(color, b"ispe")
        if size is None:  # an image of 0 x 0: OpenCV refuses it
            raise ValueError("AVIF: the image item has no ispe")
        has_nclx = any(k == b"colr" and v and v[0] == b"nclx"
                       for k, v in color["props"])
        if _stored_before(color, alpha, has_nclx):
            # measured through cv2.imread (libavif itself decodes it)
            raise ValueError("AVIF: item data stored in an order OpenCV's "
                             "reader refuses")
        planes, info, later = (_decode_grid if color.get("grid") else
                               _decode)(data, box, color, size)
        if alpha is not None:
            if (prop(alpha, b"ispe") or size) != size:
                raise ValueError("AVIF: the alpha item's size is not the "
                                 "image's")
            _, a_info, a_later = (_decode_grid if alpha.get("grid") else
                                  _decode)(data, box, alpha, size, True)
            if info and a_info and a_info["depth"] != info["depth"]:
                raise ValueError("AVIF: the alpha's bit depth is not the "
                                 "image's")
            later = later or a_later
        if later:
            raise later
    except (ValueError, NotImplementedError) as e:
        raise type(e)(f"{path}: {e}") from None
    frame_depth = info["depth"]
    if mono:  # OpenCV copies Y, scaled down where the Mat is 8-bit
        y = planes[0]
        if gray and depth > 8:
            if frame_depth == 8:
                raise ValueError(f"{path}: AVIF: an 8-bit frame under a "
                                 "deeper av1C (OpenCV's reader refuses it)")
            return y
        if frame_depth > 8:
            y = np.clip(np.rint(y / float(1 << (frame_depth - 8))), 0, 255)
        y = y.astype(np.uint8)
        return y if gray else np.repeat(y[..., None], 3, -1)
    # libavif's YUV to RGB, to the Mat's depth (OpenCV: 8 bits, or the
    # frame's own under IMREAD_ANYDEPTH of a deeper av1C)
    rgb_depth = frame_depth if gray and depth > 8 else 8
    nclx = next((v for k, v in color["props"] if k == b"colr" and v and
                 v[0] == b"nclx"), None)
    primaries, matrix, full = (nclx[1], nclx[3], nclx[4]) if nclx else (
        info["primaries"], info["matrix"], info["full_range"])
    if matrix in REFUSED_MATRICES or matrix >= 17 or (
            matrix == 16 and (not full or frame_depth != rgb_depth + 2)) \
            or (matrix == 8 and not full):
        raise ValueError(f"{path}: AVIF: matrix coefficients {matrix} "
                         "(libavif's YUV to RGB refuses them)")
    if matrix == 0 and len(planes) == 3 and info["ssx"]:
        raise ValueError(f"{path}: AVIF: subsampled colour under the "
                         "identity matrix (libavif's YUV to RGB refuses it)")
    if gray and depth > 8 and frame_depth == 8:
        raise NotImplementedError(
            f"{path}: AVIF: an 8-bit frame under a deeper av1C (OpenCV "
            "reads uninitialised memory)")
    mono_frame = len(planes) == 1
    if mono_frame:  # no chroma: R = G = B = Y where libavif converts
        if matrix == 0:
            planes = planes * 3
        else:
            mid = np.full_like(planes[0], 1 << (frame_depth - 1))
            planes, info = [planes[0], mid, mid], dict(info, ssx=0, ssy=0)
    if mono_frame and (matrix != 0 or not full) and (
            frame_depth > 8 or not full):
        bgr = _float_rgb(planes, frame_depth, rgb_depth, 0, 0,
                         6 if matrix == 16 else matrix, full, primaries)
    elif matrix != 0 or not full:
        bgr = _yuv_to_bgr(planes, info, rgb_depth, alpha is not None,
                          matrix, full, primaries)
    else:
        bgr = np.stack([planes[1], planes[0], planes[2]], -1)
        if rgb_depth == 8:
            bgr = bgr.astype(np.uint8) if frame_depth == 8 else _to8(
                bgr, frame_depth)
    if gray:
        b, g, r = (bgr[..., c].astype(np.int64) for c in range(3))
        return ((3735 * b + 19235 * g + 9798 * r + 16384) >> 15).astype(
            bgr.dtype)
    return np.ascontiguousarray(bgr)


# -- the writer ------------------------------------------------------------


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + body)


def _chroma(subsampling) -> int:
    """av1_encode.c's OPT_SUBSAMPLED: 0 4:4:4, 1 4:2:0 (``True`` too), 2
    4:2:2."""
    return {None: 0, 0: 0, "4:4:4": 0, 1: 1, "4:2:0": 1, 2: 2,
            "4:2:2": 2}[subsampling]


def _av1c(depth: int, mono: bool, sub=False) -> bytes:
    """The av1C box of the writer's sequence header (profile 0 gray or
    4:2:0, 1 colour at 4:4:4, 2 at 12 bits or 4:2:2; seq_level_idx 31);
    ``sub``: as :func:`_chroma` takes it."""
    chroma = _chroma(sub)
    profile = 2 if depth == 12 or chroma == 2 else 0 if mono or chroma \
        else 1
    ssx, ssy = mono or chroma > 0, mono or chroma == 1
    return _box(b"av1C", bytes([
        0x81, profile << 5 | 31, (depth > 8) << 6 | (depth == 12) << 5
        | mono << 4 | ssx << 3 | ssy << 2, 0]))


def _encoder():
    lib = _build.load("av1_encode")
    i64, ptr, cint = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    lib.av1_encode.argtypes = [ptr, cint, i64, i64, cint, cint, ptr, ptr,
                               ptr, ptr, i64, ptr, ptr, ctypes.c_char_p,
                               cint]
    lib.av1_grain_vector.argtypes = [cint, ptr]
    lib.av1_encode.restype = lib.av1_grain_vector.restype = cint
    return lib


# the offsets of aom_film_grain_t's scalar fields among its ints
# (grain_params), for the writer's grain overrides
GRAIN_AT = {"num_y_points": 30, "num_cb_points": 51, "num_cr_points": 72,
            "scaling_shift": 73, "ar_coeff_lag": 74, "ar_coeff_shift": 149,
            "cb_mult": 150, "cb_luma_mult": 151, "cb_offset": 152,
            "cr_mult": 153, "cr_luma_mult": 154, "cr_offset": 155,
            "overlap_flag": 156, "clip_to_restricted_range": 157,
            "chroma_scaling_from_luma": 159, "grain_scale_shift": 160,
            "random_seed": 161}


def grain_vector(grain) -> np.ndarray:
    """A film grain for the writer, ``int32 [162]`` in libaom's
    ``aom_film_grain_t`` order: libaom's test vector ``grain`` (1-16, as
    its encoder's ``film-grain-test`` option), or a dict: ``vector`` and
    fields of :data:`GRAIN_AT` changed (a smaller ``ar_coeff_lag`` writes
    the first coefficients), or the 162 ints as they are."""
    if isinstance(grain, dict):
        v = grain_vector(grain.get("vector", 1))
        for k, x in grain.items():
            if k != "vector":
                v[GRAIN_AT[k]] = x
        return v
    if np.ndim(grain):
        return np.ascontiguousarray(grain, np.int32)
    v = np.zeros(162, np.int32)
    if _encoder().av1_grain_vector(int(grain), v.ctypes.data):
        raise ValueError(f"grain_vector: no test vector {grain}")
    return v


# av1_encode.c's options: 11, then 8 CDEF strengths of 4, the colour
# description (primaries, transfer, matrix, full range), 128 x 128
# superblocks, the three planes' restoration types, lr_unit_shift and
# lr_uv_shift, segmentation_enabled and each segment's 8 features
# (enabled, value), then full headers, the sequence's largest frame (W, H),
# frame_type, show_frame, showable_frame, refresh_frame_flags,
# SuperresDenom, tile_cols_log2, allow_screen_content_tools and
# allow_intrabc
OPT_COUNT = 193
# the segment features the writer sets (SEG_LVL_*): alt q, the four loop
# filter levels' deltas, skip
SEG_FEATURES = {"alt_q": 0, "lf_y_v": 1, "lf_y_h": 2, "lf_u": 3, "lf_v": 4,
                "skip": 6}
LR_TYPES = {"none": 0, "wiener": 1, "sgrproj": 2, "switchable": 3}


def _lr_units(lr) -> np.ndarray:
    """av1_encode.c's lr[] of ``lossy["lr"]["units"]``: for each plane a
    list of units, each ``("none",)``, ``("wiener", (v0, v1, v2), (h0, h1,
    h2))`` (taps 0-2 of the vertical and the horizontal pass, the outer
    first; tap 0 is ignored for chroma) or ``("sgrproj", set, (xqd0,
    xqd1))``; the plane's units take them in turn, in raster order."""
    units = list(lr.get("units", ((), (), ()))) if lr else []
    units += [()] * (3 - len(units))
    rows = []
    for plane in units:
        for u in plane:
            row = [LR_TYPES[u[0]]] + [0] * 9
            if u[0] == "wiener":
                row[1:7] = list(u[1]) + list(u[2])
            elif u[0] == "sgrproj":
                row[7], row[8:10] = u[1], list(u[2])
            rows += row
    return np.array([len(p) for p in units] + rows, np.int32)


def _options(subsampled, lossy, colour=None, sb128=False, frame=None,
             superres=0, tile_cols_log2=0, intrabc=False) -> np.ndarray:
    """av1_encode.c's opts[] of the writer's keywords (``lossy``: dict of
    ``base_q``, ``qm`` (15: none), ``block`` (8, 16 or 32), ``lf`` (the
    four loop filter levels), ``sharpness``, ``cdef_damping`` (3-6),
    ``cdef`` (a list of (y primary, y secondary, uv primary, uv secondary)
    strengths, secondary 0, 1, 2 or 4) and ``lr``: dict of ``types`` (of
    Y, U and V: "none", "wiener", "sgrproj" or "switchable"),
    ``unit_shift`` (units of 256 >> (2 - shift) luma samples),
    ``uv_shift`` (4:2:0 chroma units halved) and ``units``
    (:func:`_lr_units`)) and ``segments``: a list of at most 8 dicts of
    :data:`SEG_FEATURES` and their values (``skip``: True), each block
    taking one of the segments up to the last with a feature;
    ``colour``: (primaries, transfer, matrix, full range) of the sequence
    header; ``frame`` (full sequence and frame headers, not the reduced
    still picture header): dict of ``type`` ("key" or "intra"), ``show``,
    ``showable``, ``refresh`` (refresh_frame_flags), ``max_size`` (the
    sequence's largest frame, (W, H): frame_size_override), ``sct``
    (screen content tools on); ``superres``: SuperresDenom (9-16);
    ``tile_cols_log2``: uniform tile columns; ``intrabc``: intra block
    copy allowed (screen content tools on, no in-loop filter or superres),
    two blocks in three copied from up or left where libaom's delay
    allows."""
    o = np.zeros(OPT_COUNT, np.int32)
    o[0] = _chroma(subsampled)
    o[2] = 15
    o[43:47] = colour
    o[47] = int(sb128)
    if lossy and lossy.get("lr"):
        lr = lossy["lr"]
        o[48:51] = [LR_TYPES[t] for t in lr["types"]]
        o[51], o[52] = lr.get("unit_shift", 0), lr.get("uv_shift", 0)
    if lossy:
        cdef = list(lossy.get("cdef", ()))
        lf = list(lossy.get("lf", (0, 0, 0, 0)))
        o[1] = lossy["base_q"]
        o[2] = lossy.get("qm", 15)
        o[3] = {8: 3, 16: 4, 32: 5}.get(lossy.get("block", 16), 0)
        o[4:8] = lf + [0] * (4 - len(lf))
        o[8] = lossy.get("sharpness", 0)
        o[9] = lossy.get("cdef_damping", 3)
        o[10] = len(cdef)
        for k, strengths in enumerate(cdef[:8]):
            o[11 + 4 * k:15 + 4 * k] = strengths
        segments = lossy.get("segments")
        if segments:
            o[53] = 1
            for i, seg in enumerate(segments[:8]):
                for name, v in seg.items():
                    k = 54 + 2 * (8 * i + SEG_FEATURES[name])
                    o[k], o[k + 1] = 1, 0 if name == "skip" else int(v)
    if frame is not None:
        o[182] = 1
        o[183:185] = frame.get("max_size", (0, 0))
        o[185] = {"key": 0, "intra": 2}[frame.get("type", "key")]
        o[186] = int(frame.get("show", True))
        o[187] = int(frame.get("showable", False))
        o[188] = frame.get("refresh", 0xFF)
        o[191] = int(frame.get("sct", False))
    o[189], o[190], o[192] = superres, tile_cols_log2, int(intrabc)
    return o


def default_colour(planes: int, subsampled) -> tuple:
    """The writer's colour description (primaries, transfer, matrix, full
    range): BT.709 primaries, sRGB transfer and BT.601 for subsampled
    colour, else unspecified and identity (gray: unspecified)."""
    if _chroma(subsampled):
        return (1, 13, 6, 1)
    return (2, 2, 2 if planes == 1 else 0, 1)


def encode_av1(planes, depth: int = 8, seed: int = 0,
               subsampled=False, lossy: dict = None,
               recon: bool = False, colour: tuple = None,
               sb128: bool = False, grain=None, frame: dict = None,
               superres: int = 0, tile_cols_log2: int = 0,
               intrabc: bool = False):
    """AV1 OBUs (a sequence header and one frame, the reduced still picture
    header) of ``uint16`` planes: ``[1 or 3, H, W]`` (Y or Y, U, V at 4:4:4)
    or, with ``subsampled`` (``True`` or "4:2:0", or "4:2:2"), a list Y
    ``[H, W]``, U, V ``[(H + 1) // 2, (W + 1) // 2]`` (4:2:2: ``[H, (W +
    1) // 2]``), written in C (``csrc/host/av1_encode.c``); ``colour``:
    the sequence header's (primaries, transfer, matrix, full range),
    :func:`default_colour` by default.  Lossless by default: 64 x 64
    superblocks (``sb128``: 128 x 128), a partition and an intra mode for
    each block picked from ``seed`` and the image (DC, directional with
    angle deltas, smooth, Paeth, CfL, filter intra), 4 x 4
    Walsh-Hadamard residuals.  ``lossy`` (:func:`_options`; gray, 4:4:4, 4:2:0
    or 4:2:2): blocks of one size, one DCT_DCT each, deblocking, CDEF and
    loop restoration as given.  ``grain`` (:func:`grain_vector`): the
    frame's film grain, which a decoder adds to it.  ``frame``,
    ``superres`` (the frame coded at 8 / ``superres`` of its width, its
    columns sampled from the planes', and upscaled by the decoder),
    ``tile_cols_log2`` and ``intrabc``: :func:`_options`.  With
    ``recon``:
    (OBUs, the writer's reconstruction (without grain), planes as
    given)."""
    if isinstance(planes, np.ndarray) and planes.ndim == 3:
        planes = list(planes)
    planes = [np.ascontiguousarray(p, np.uint16) for p in planes]
    n = len(planes)
    H, W = planes[0].shape
    sub = _chroma(subsampled)
    chroma = ((H + 1) // 2 if sub == 1 else H, (W + 1) // 2 if sub else W)
    if n not in (1, 3) or depth not in (8, 10, 12) or any(
            p.max(initial=0) >= 1 << depth for p in planes) or any(
            p.shape != chroma for p in planes[1:]):
        raise ValueError("encode_av1: 1 or 3 planes of 8-, 10- or 12-bit "
                         "samples")
    flat = np.concatenate([p.ravel() for p in planes])
    cap = 64 * flat.size * 2 + 4096
    out = np.empty(cap, np.uint8)
    size = np.zeros(1, np.int64)
    rec = np.empty_like(flat) if recon else None
    # alive through the call
    opts = _options(subsampled, lossy, colour or default_colour(
        n, subsampled), sb128, frame, superres, tile_cols_log2, intrabc)
    lr = _lr_units(lossy.get("lr") if lossy else None)
    fg = None if grain is None else grain_vector(grain)
    _call(_encoder().av1_encode, flat.ctypes.data, n, H, W, depth, seed,
          opts.ctypes.data, lr.ctypes.data,
          None if fg is None else fg.ctypes.data, out.ctypes.data, cap,
          size.ctypes.data, rec.ctypes.data if recon else None)
    data = out[:int(size[0])].tobytes()
    if not recon:
        return data
    parts, pos = [], 0
    for p in planes:
        parts.append(rec[pos:pos + p.size].reshape(p.shape))
        pos += p.size
    return data, parts


def split_obus(data: bytes) -> list:
    """[(OBU type, the OBU's bytes)] of AV1 OBUs that carry their
    sizes."""
    out, pos = [], 0
    while pos < len(data):
        p, v, i = pos + 1 + (data[pos] >> 2 & 1), 0, 0
        while True:
            b = data[p]
            p += 1
            v |= (b & 0x7F) << (7 * i)
            i += 1
            if not b & 0x80:
                break
        out.append((data[pos] >> 3 & 15, data[pos:p + v]))
        pos = p + v
    return out


def show_existing_obu(slot: int) -> bytes:
    """A frame header OBU of show_existing_frame showing reference slot
    ``slot`` (of a sequence the writer's full headers start: no frame ids,
    no decoder model)."""
    return bytes([3 << 3 | 2, 1, 0x80 | slot << 4 | 0x08])


def frames_av1(frames) -> bytes:
    """One item's AV1 data of several frames: each of ``frames`` a dict of
    :func:`encode_av1`'s arguments (``planes`` and the rest; ``frame`` for
    full headers, the same sequence for all) or an int, show_existing_frame
    of that slot; the first frame's sequence header alone is kept."""
    out = []
    for k, fr in enumerate(frames):
        if isinstance(fr, int):
            out.append(show_existing_obu(fr))
            continue
        out += [o for t, o in split_obus(encode_av1(**fr))
                if t != 1 or not k]
    return b"".join(out)


# (kr, kb) of the matrices the writer converts with other than BT.601,
# whose literals below it has always used (5, 6 and the rest)
KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 7: (0.212, 0.087),
         9: (0.2627, 0.0593), 10: (0.2627, 0.0593)}


def yuv_planes(img: np.ndarray, depth: int = 8, subsampling="4:2:0",
               matrix: int = 6, full: bool = True) -> list:
    """The writer's planes of ``[H, W, 3]`` BGR under ``matrix``
    (:data:`KR_KB`, else BT.601) at full or limited range: Y, then Cb and
    Cr averaged over 2 x 2 samples (4:2:0) or 2 x 1 (4:2:2), the edge's
    repeated."""
    x = np.asarray(img, np.float64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    if matrix in KR_KB:
        kr, kb = KR_KB[matrix]
        kg, db, dr = 1 - kr - kb, 2 * (1 - kb), 2 * (1 - kr)
    else:
        kr, kg, kb, db, dr = 0.299, 0.587, 0.114, 1.772, 1.402
    half, top = 1 << (depth - 1), (1 << depth) - 1
    y = kr * r + kg * g + kb * b
    cb = (b - y) / db + half
    cr = (r - y) / dr + half
    if not full:
        s = 1 << (depth - 8)
        y = y * (219 * s) / top + 16 * s
        cb, cr = ((c - half) * (224 * s) / top + half for c in (cb, cr))
    H, W = y.shape
    sy = 2 if _chroma(subsampling) == 1 else 1
    out = [y]
    for c in (cb, cr):
        c = np.pad(c, ((0, H % sy), (0, W % 2)), mode="edge")
        out.append(sum(c[i::sy, j::2] for j in range(2)
                       for i in range(sy)) / (2 * sy))
    return [np.clip(np.rint(p), 0, top).astype(np.uint16) for p in out]


def yuv420(img: np.ndarray, depth: int = 8) -> list:
    """The writer's BT.601 full-range 4:2:0 planes of ``[H, W, 3]`` BGR
    (:func:`yuv_planes`)."""
    return yuv_planes(img, depth)


def encode_avif(img: np.ndarray, depth: int = 8, seed: int = 0,
                alpha: np.ndarray = None, extra_props=(),
                essential: bool = False, subsampling: str = None,
                lossy: dict = None, recon: bool = False,
                colour: tuple = None, sb128: bool = False, planes=None,
                grain=None, alpha_grain=None, av1: bytes = None,
                **frame_kw):
    """An AVIF still image of ``img``: ``[H, W, 3]`` BGR or ``[H, W]`` gray
    (4:0:0), ``uint8`` at depth 8, else ``uint16`` samples below ``1 <<
    depth`` (10 or 12).  Colour is lossless 4:4:4 under the identity matrix
    (Y = G, U = B, V = R), or with ``subsampling`` ("4:2:0", or "4:2:2")
    or ``lossy`` (:func:`encode_av1`; 4:2:0 unless "4:2:2" or "4:4:4" is asked)
    subsampled (:func:`yuv_planes`) under ``colour`` (primaries, transfer,
    matrix, full range: the sequence header's and the colr box's; BT.601
    full range by default); ``planes`` (Y, U, V) are then written as
    given instead of ``img``'s; ``frame_kw``: :func:`encode_av1`'s
    ``frame``, ``superres``, ``tile_cols_log2``, ``intrabc``; ``av1`` (e.g.
    :func:`frames_av1`'s): the colour item's AV1 data as given, ``img``
    only naming its size and format.  ``grain`` / ``alpha_grain``
    (:func:`grain_vector`): the film grain of the image's / the alpha's
    frame.  ``alpha`` ([H, W], the same depth) adds a
    lossless alpha item; ``extra_props`` (boxes, e.g. ``irot``) are
    associated with the image too, marked essential with ``essential``.
    cv2.imread reads the lossless identity colour file back as ``img``
    (8-bit) and the lossless gray one under IMREAD_ANYDEPTH as ``img``.
    With ``recon``: (bytes, the writer's reconstruction of the image's
    planes)."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    mono = img.ndim == 2
    sub = 0 if mono else int(bool(lossy)) if subsampling is None else \
        _chroma(subsampling)
    colour = tuple(colour or default_colour(1 if mono else 3, sub))
    if planes is None:
        planes = [img] if mono else yuv_planes(
            img, depth, sub, colour[2], colour[3]) if sub else \
            [img[..., 1], img[..., 0], img[..., 2]]
    color = av1 if av1 is not None else encode_av1(
        planes, depth, seed, sub, lossy, recon, colour, sb128, grain,
        **frame_kw)
    if recon:
        color, rec = color
    items = [(1, color)]
    if alpha is not None:
        items.append((2, encode_av1(np.asarray(alpha)[None], depth, seed,
                                    grain=alpha_grain)))
    chans = 1 if mono else 3
    props = [_full(b"ispe", 0, 0, struct.pack(">II", W, H)),
             _full(b"pixi", 0, 0, bytes([chans] + [depth] * chans)),
             _av1c(depth, mono, sub),
             _box(b"colr", b"nclx" + struct.pack(">HHHB", *colour[:3],
                                                 0x80 * bool(colour[3])))]
    assoc = [(1, [1, 0x80 | 2, 0x80 | 3, 4] + [
        5 + k | (0x80 if essential else 0) for k in range(len(extra_props))])]
    props += list(extra_props)
    refs = b""
    infe = _full(b"infe", 2, 0, struct.pack(">HH", 1, 0) + b"av01Color\0")
    if alpha is not None:
        props.append(_full(b"pixi", 0, 0, bytes([1, depth])))
        props.append(_av1c(depth, True))
        props.append(_full(b"auxC", 0, 0, ALPHA_URNS[0] + b"\0"))
        k = len(props)
        assoc.append((2, [1, 0x80 | (k - 1), k - 2, k]))
        infe += _full(b"infe", 2, 0, struct.pack(">HH", 2, 0)
                      + b"av01Alpha\0")
        refs = _full(b"iref", 0, 0, _box(b"auxl", struct.pack(
            ">HHH", 2, 1, 1)))
    ipma = struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", iid, len(lst)) + bytes(lst) for iid, lst in assoc)
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props))
                + _full(b"ipma", 0, 0, ipma))
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")

    def meta(offsets):
        iloc = struct.pack(">HH", 0x4400, len(items)) + b"".join(
            struct.pack(">HHHII", iid, 0, 1, off, len(d))
            for (iid, d), off in zip(items, offsets))
        return _full(b"meta", 0, 0, _full(b"hdlr", 0, 0, bytes(4) + b"pict"
                                          + bytes(13))
                     + _full(b"pitm", 0, 0, struct.pack(">H", 1))
                     + _full(b"iloc", 0, 0, iloc)
                     + _full(b"iinf", 0, 0, struct.pack(">H", len(items))
                             + infe) + refs + iprp)
    start = len(ftyp) + len(meta([0] * len(items))) + 8
    offsets, pos = [], start
    for _, d in items:
        offsets.append(pos)
        pos += len(d)
    data = ftyp + meta(offsets) + _box(b"mdat", b"".join(
        d for _, d in items))
    return (data, rec) if recon else data
