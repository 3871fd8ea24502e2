"""JPEG 2000 files, JP2 and raw codestreams, as ``cv2.imread`` (OpenCV 5.0
over OpenJPEG 2.5) reads them, for the port's data layer.

The codestream is decoded in C (``csrc/host/j2k_decode.c``) to the
component planes OpenJPEG hands to OpenCV, HTJ2K code blocks (T.814) as
OpenJPEG's HT decoder reads them.  The JP2 boxes are read here in
OpenJPEG's steps: the signature box first and ``ftyp`` second, ``jp2h``
(``ihdr`` required, whose size must be the codestream's; the first
``colr``; ``pclr`` with ``cmap``; ``cdef``) before ``jp2c``, whose
codestream runs to the end of the file; other boxes are skipped.  After
decoding, a palette is applied and the channel definitions reorder the
components, as OpenJPEG applies them.

What OpenCV's reader then does, which :func:`decode_jp2` repeats:

- it refuses (``ValueError``: cv2 returns None) 0 or more than 4
  components, signed components, components all of fewer than 8 bits,
  subsampled components, an image or component origin other than 0, and, for ``IMREAD_ANYDEPTH``, components of more than 16 bits;
- the colour space is the ``colr`` box's (sRGB, gray, sYCC); a raw
  codestream, or any other ``colr`` (CIE L*a*b*, an ICC profile, none), is
  taken as sRGB; CMYK and e-sYCC are refused;
- samples are shifted right by the largest precision of the codestream's
  components less the output's (8 bits, or 16 with ``IMREAD_ANYDEPTH``
  above 8 bits), then cast (a palette's wider entries wrap);
- sRGB: 3 or more components read as the BGR of the first three; fewer
  are refused in colour and read as component 0 in gray; a gray read of
  3 or more is ``COLOR_BGR2GRAY`` of them (``cvtColor``'s 15-bit gray, at
  8 or 16 bits);
- gray: component 0, in three equal channels for a colour read;
- sYCC: component 0 for a gray read; in colour the first three through
  ``COLOR_YUV2BGR``.

:func:`encode_jp2` writes JP2 files (by default lossless: 5/3, the RCT for
colour, one layer; also tiles, code-block sizes, 9/7 with the ICT and
HTJ2K code blocks; ``csrc/host/j2k_encode.c``) for fixtures, on machines
that have no JPEG 2000 encoder.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from lgu_slam_tpu_torch.data import pnm
from lgu_slam_tpu_torch.ops import _build

SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
CODESTREAM = b"\xff\x4f\xff\x51"
STATUS = {1: ValueError, 3: MemoryError}
# OpenJPEG's colour spaces by the colr box's enumerated value
ENUMCS = {16: "srgb", 17: "gray", 18: "sycc", 24: "esycc", 12: "cmyk"}
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def _lib():
    lib = _build.load("j2k_decode")
    i64, ptr, cint = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    lib.j2k_header.argtypes = [ctypes.c_char_p, i64, ptr, ctypes.c_char_p,
                               cint]
    lib.j2k_decode.argtypes = [ctypes.c_char_p, i64, ptr, ctypes.c_char_p,
                               cint]
    lib.j2k_header.restype = lib.j2k_decode.restype = cint
    return lib


def _encoder():
    lib = _build.load("j2k_encode")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.j2k_encode.argtypes = [ptr, i64, i64, i64, i64, i64, ptr, i64, ptr,
                               i64, ptr]
    lib.j2k_encode.restype = ctypes.c_int
    return lib


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def encode_jp2(img: np.ndarray, codestream: bool = False, ht: bool = False,
               refine: int = 0, skip: int = 0, irreversible: bool = False,
               cblk=(64, 64), tile=None, levels=None, vcausal: bool = False,
               extra_missing: int = 0, placeholder: int = 0) -> bytes:
    """``uint8 [H, W, 3]`` BGR, or ``uint8`` / ``uint16 [H, W]`` gray ->
    a JP2 file (sRGB or gray ``colr``), or with ``codestream`` the raw
    codestream, written in C (``csrc/host/j2k_encode.c``).  By default
    lossless: one tile, the RCT for colour, the 5/3 wavelet at up to 5
    levels, 64 x 64 EBCOT code blocks, one layer.

    - ``ht``: HTJ2K code blocks (T.814), the cleanup pass at bit-plane
      ``skip`` (lossless at 0), or with ``refine`` 1 or 2 at ``skip + 1``
      followed by SigProp (and MagRef) at ``skip``; ``vcausal``: SigProp
      vertically causal; ``extra_missing`` missing MSBs added to each
      block and ``placeholder`` HT sets of placeholder passes declared
      (files OpenJPEG refuses or misreads, for tests);
    - ``irreversible``: the 9/7 wavelet (and the ICT for colour), every
      band quantised at a step of 1/2;
    - ``cblk``: the code blocks' (width, height), powers of 2 of 4 to
      1024, at most 4096 samples; ``tile``: (height, width), multiples of
      2^levels; ``levels``: the decomposition levels."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3
                              and img.dtype == np.uint8)):
        raise ValueError(f"JPEG 2000 fixtures are uint8 BGR or uint8 / "
                         f"uint16 gray, not {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    planes = (img[..., ::-1].transpose(2, 0, 1) if img.ndim == 3
              else img[None]).astype(np.int32)
    planes = np.ascontiguousarray(planes)
    prec = 8 * img.dtype.itemsize
    th, tw = tile if tile is not None else (0, 0)
    opts = np.array([int(ht), refine, skip, int(irreversible),
                     int(cblk[0]).bit_length() - 1,
                     int(cblk[1]).bit_length() - 1, tw, th,
                     -1 if levels is None else levels, int(vcausal),
                     extra_missing, placeholder], np.int64)
    cap = planes.size * 5 + 65536
    out = np.empty(cap, np.uint8)
    size = ctypes.c_int64()
    status = _encoder().j2k_encode(
        planes.ctypes.data, len(planes), H, W, prec, int(len(planes) == 3),
        opts.ctypes.data, len(opts), out.ctypes.data, cap,
        ctypes.byref(size))
    if status:
        raise STATUS.get(status, RuntimeError)("JPEG 2000: encoding failed")
    cs = out[:size.value].tobytes()
    if codestream:
        return cs
    ihdr = struct.pack(">IIHBBBB", H, W, len(planes), prec - 1, 7, 0, 0)
    colr = bytes([1, 0, 0]) + struct.pack(">I", 16 if len(planes) == 3
                                          else 17)
    return (SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", _box(b"ihdr", ihdr) + _box(b"colr", colr))
            + _box(b"jp2c", cs))


def _call(fn, data: bytes, out: np.ndarray):
    err = ctypes.create_string_buffer(256)
    status = fn(data, len(data), out.ctypes.data, err, len(err))
    if status:
        raise STATUS.get(status, RuntimeError)(
            f"JPEG 2000: {err.value.decode(errors='replace')}")


def codestream_header(cs: bytes) -> dict:
    """The main header of a codestream: image corners, components and
    each one's precision, signedness and subsampling (the first 4)."""
    info = np.zeros(22, np.int64)
    _call(_lib().j2k_header, cs, info)
    x0, y0, x1, y1, n = (int(v) for v in info[:5])
    comps = [tuple(int(v) for v in info[5 + 4 * c:9 + 4 * c])
             for c in range(min(n, 4))]
    return dict(x0=x0, y0=y0, x1=x1, y1=y1, ncomp=n, comps=comps)


def decode_codestream(cs: bytes, head: dict) -> np.ndarray:
    """The component planes of a codestream whose components are not
    subsampled and whose origin is 0: ``int32 [C, H, W]``, as OpenJPEG
    returns them (after the DC shift and the clamp)."""
    H, W = head["y1"] - head["y0"], head["x1"] - head["x0"]
    out = np.zeros((head["ncomp"], H, W), np.int32)
    _call(_lib().j2k_decode, cs, out)
    return out


def _boxes(data: bytes, pos: int, end: int, inner: bool):
    """(type, payload start, payload end, box start) of the boxes in
    [pos, end); a box of length 0 runs to ``end`` (not inside ``jp2h``)."""
    while pos < end:
        if end - pos < 8:
            if inner:
                raise ValueError("JP2: a box of fewer than 8 bytes")
            return
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if end - pos < 16:
                raise ValueError("JP2: an XL box cut short")
            hi, length = struct.unpack_from(">II", data, pos + 8)
            if hi:
                raise ValueError("JP2: a box of 2^32 bytes or more")
            head = 16
            if inner and length == 0:
                raise ValueError("JP2: a box of undefined size")
        elif length == 0:
            if inner:
                raise ValueError("JP2: a box of undefined size")
            length = end - pos
        if length < head:
            raise ValueError("JP2: a box shorter than its header")
        if inner and length > end - pos:
            raise ValueError("JP2: a box longer than jp2h")
        yield kind, pos + head, pos + length, pos
        pos += length


def _read_jp2h(data: bytes, start: int, end: int, jp2: dict,
               whole: bool = True) -> None:
    """The image-header boxes in [start, end) into ``jp2``: a ``jp2h``
    box's contents (``whole``: it must hold an ihdr), or one such box
    found after it, which OpenJPEG reads as well."""
    has_ihdr = False
    for kind, a, b, _ in _boxes(data, start, end, True):
        body = data[a:b]
        if kind == b"ihdr":
            has_ihdr = True
            if "ihdr" in jp2:
                continue
            if len(body) != 14:
                raise ValueError("JP2: bad ihdr size")
            h, w, n = struct.unpack_from(">IIH", body)
            if not 1 <= n <= 16384:
                raise ValueError("JP2: ihdr component count")
            jp2["ihdr"] = (w, h)
        elif kind == b"colr":
            if len(body) < 3:
                raise ValueError("JP2: bad colr size")
            if "colr" in jp2:
                continue
            meth = body[0]
            if meth == 1:
                if len(body) < 7:
                    raise ValueError("JP2: bad colr size")
                jp2["colr"] = struct.unpack_from(">I", body, 3)[0]
            elif meth == 2:
                jp2["colr"] = 0  # an ICC profile: no enumerated space
        elif kind == b"pclr":
            if "pclr" in jp2 or len(body) < 3:
                raise ValueError("JP2: bad pclr box")
            entries, nch = struct.unpack_from(">HB", body)
            if not 1 <= entries <= 1024 or not nch or len(body) < 3 + nch:
                raise ValueError("JP2: bad pclr box")
            bits = [(v & 0x7f) + 1 for v in body[3:3 + nch]]
            signs = [v >> 7 for v in body[3:3 + nch]]
            widths = [min((s + 7) >> 3, 4) for s in bits]
            need = 3 + nch + entries * sum(widths)
            if len(body) < need:
                raise ValueError("JP2: pclr box cut short")
            table = np.zeros((entries, nch), np.int64)
            at = 3 + nch
            for j in range(entries):
                for i, wd in enumerate(widths):
                    table[j, i] = int.from_bytes(body[at:at + wd], "big")
                    at += wd
            jp2["pclr"] = dict(table=table, bits=bits, signs=signs)
        elif kind == b"cmap":
            if "pclr" not in jp2:
                raise ValueError("JP2: cmap before pclr")
            if "cmap" in jp2:
                raise ValueError("JP2: a second cmap box")
            nch = jp2["pclr"]["table"].shape[1]
            if len(body) < 4 * nch:
                raise ValueError("JP2: cmap box cut short")
            jp2["cmap"] = [struct.unpack_from(">HBB", body, 4 * i)
                           for i in range(nch)]
        elif kind == b"cdef":
            if "cdef" in jp2:
                raise ValueError("JP2: a second cdef box")
            if len(body) < 2:
                raise ValueError("JP2: cdef box cut short")
            n, = struct.unpack_from(">H", body)
            if not n or len(body) < 2 + 6 * n:
                raise ValueError("JP2: bad cdef box")
            jp2["cdef"] = [list(struct.unpack_from(">HHH", body, 2 + 6 * i))
                           for i in range(n)]
    if whole and not has_ihdr:
        raise ValueError("JP2: jp2h without ihdr")


def read_boxes(data: bytes) -> dict:
    """The JP2 boxes OpenJPEG reads before the codestream, and where the
    codestream starts (``offset``)."""
    jp2: dict = {}
    state = 0  # 1 signature, 2 file type, 4 header
    for kind, a, b, box in _boxes(data, 0, len(data), False):
        body = data[a:b]
        if kind == b"jp2c":
            if not state & 4:
                raise ValueError("JP2: jp2c before jp2h")
            jp2["offset"] = a
            return jp2
        if kind == b"jP  ":
            if state or body != b"\r\n\x87\n":
                raise ValueError("JP2: bad signature box")
            state |= 1
        elif kind == b"ftyp":
            if state != 1 or len(body) < 8 or (len(body) - 8) % 4:
                raise ValueError("JP2: bad ftyp box")
            state |= 2
        elif kind == b"jp2h":
            if not state & 2:
                raise ValueError("JP2: jp2h before ftyp")
            if b > len(data):
                raise ValueError("JP2: jp2h runs past the file")
            _read_jp2h(data, a, b, jp2)
            state |= 4
        elif kind in (b"ihdr", b"colr", b"pclr", b"cmap", b"cdef", b"bpcc"):
            # outside jp2h: read once jp2h has been, else skipped
            if state & 4:
                if b > len(data):
                    raise ValueError("JP2: a box runs past the file")
                _read_jp2h(data, box, b, jp2, whole=False)
        else:
            if not state & 1 or not state & 2:
                raise ValueError("JP2: the signature and ftyp boxes come "
                                 "first")
            if b > len(data):
                raise ValueError("JP2: a box runs past the file")
    raise ValueError("JP2: no codestream box")


def _apply_palette(planes: list, jp2: dict) -> list:
    """opj_jp2_apply_pclr: each cmap channel is a component as it is, or
    the palette's column of the clamped index component."""
    pal = jp2["pclr"]
    table = pal["table"]
    out = []
    for i, (cmp, mtyp, pcol) in enumerate(jp2["cmap"]):
        src = planes[cmp][0]
        if mtyp == 0:
            out.append((src, pal["bits"][i], pal["signs"][i]))
        else:
            idx = np.clip(src, 0, len(table) - 1)
            out.append((table[idx, pcol].astype(np.int64), pal["bits"][i],
                        pal["signs"][i]))
    return out


def _check_color(jp2: dict, ncomp: int) -> None:
    """opj_jp2_check_color: channel definitions and the component mapping
    must name components that exist."""
    nch = ncomp
    if "pclr" in jp2 and "cmap" in jp2:
        nch = jp2["pclr"]["table"].shape[1]
    if "cdef" in jp2:
        for cn, _, asoc in jp2["cdef"]:
            if cn >= nch or (asoc not in (0, 65535) and asoc - 1 >= nch):
                raise ValueError("JP2: cdef names a missing channel")
        for k in range(nch):
            if not any(cn == k for cn, _, _ in jp2["cdef"]):
                raise ValueError("JP2: incomplete channel definitions")
    if "pclr" in jp2 and "cmap" in jp2:
        cmap = jp2["cmap"]
        sane = all(cmp < ncomp for cmp, _, _ in cmap)
        used = [False] * nch
        for i, (cmp, mtyp, pcol) in enumerate(cmap):
            if mtyp not in (0, 1) or pcol >= nch or (used[pcol] and mtyp) \
                    or (mtyp == 0 and pcol) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        if any(not used[i] and cmap[i][1] for i in range(nch)):
            sane = False
        if sane and ncomp == 1 and not all(used):
            jp2["cmap"] = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(cmap)]
        if not sane:
            raise ValueError("JP2: bad component mapping")


def _apply_cdef(planes: list, jp2: dict) -> list:
    """opj_jp2_apply_cdef: colour channels move to their association;
    each channel's type marks alpha (any type but 0)."""
    planes = [list(p) + [0] for p in planes]
    info = [list(v) for v in jp2["cdef"]]
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= len(planes):
            continue
        if asoc in (0, 65535):
            planes[cn][3] = typ
            continue
        acn = asoc - 1
        if acn >= len(planes):
            continue
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for j in range(i + 1, len(info)):
                if info[j][0] == cn:
                    info[j][0] = acn
                elif info[j][0] == acn:
                    info[j][0] = cn
        planes[cn][3] = typ
    return planes


def yuv_bgr(yuv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR)`` of ``uint8`` Y, U, V:
    OpenCV's fixed-point YUV -> RGB (14-bit coefficients, the chroma
    centred on 128), saturated."""
    y, u, v = (yuv[..., c].astype(np.int64) for c in range(3))
    u, v = u - 128, v - 128
    rnd = 1 << 13
    b = y + ((u * 33292 + rnd) >> 14)
    g = y + ((u * -6472 + v * -9519 + rnd) >> 14)
    r = y + ((v * 18678 + rnd) >> 14)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def decode_jp2(data: bytes, path="<bytes>", gray: bool = False
               ) -> np.ndarray:
    """JP2 or codestream bytes -> ``uint8 [H, W, 3]`` BGR as ``cv2.imread``
    returns them, or with ``gray`` ``[H, W]`` (``uint16`` above 8 bits) as
    ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` returns them (module
    docstring).  Files OpenCV returns None for raise ``ValueError``."""
    try:
        return _decode(data, gray)
    except (ValueError, MemoryError) as e:
        raise type(e)(f"{path}: {e}") from None


def _decode(data: bytes, gray: bool) -> np.ndarray:
    jp2: dict = {}
    if data.startswith(SIGNATURE):
        jp2 = read_boxes(data)
        cs = data[jp2["offset"]:]
    else:
        cs = data
    head = codestream_header(cs)
    W, H, n = head["x1"] - head["x0"], head["y1"] - head["y0"], head["ncomp"]
    if "ihdr" in jp2 and jp2["ihdr"] != (W, H):
        raise ValueError("JP2: ihdr and SIZ give different sizes")
    # OpenCV's readHeader
    if not 1 <= n <= 4:
        raise ValueError(f"JPEG 2000 of {n} components")
    if any(c[1] for c in head["comps"]):
        raise ValueError("JPEG 2000 of signed components")
    max_prec = max(c[0] for c in head["comps"])
    if max_prec < 8:
        raise ValueError(f"JPEG 2000 of {max_prec}-bit components")
    if gray and max_prec > 16:
        raise ValueError(f"JPEG 2000 of {max_prec}-bit components read "
                         "with IMREAD_ANYDEPTH")
    if W > MAX_SIDE or H > MAX_SIDE or W * H > MAX_PIXELS:
        raise ValueError(f"JPEG 2000 of {W} x {H} pixels is more than "
                         "cv2.imread reads")
    # OpenCV's readData checks the component geometry after decoding:
    # what it refuses is refused here before
    if head["x0"] or head["y0"] or any(c[2] != 1 or c[3] != 1
                                       for c in head["comps"]):
        raise ValueError("JPEG 2000 with an image origin or subsampled "
                         "components")
    space = "srgb" if not jp2 else ENUMCS.get(jp2.get("colr", 0), "srgb")
    if space in ("cmyk", "esycc"):
        raise ValueError(f"JPEG 2000 in the {space} colour space")
    raw = decode_codestream(cs, head)
    planes = [(raw[c].astype(np.int64), head["comps"][c][0],
               head["comps"][c][1]) for c in range(n)]
    if jp2:
        _check_color(jp2, n)
        if "pclr" in jp2 and "cmap" in jp2:
            planes = _apply_palette(planes, jp2)
        if "cdef" in jp2:
            planes = [tuple(p[:3]) for p in _apply_cdef(planes, jp2)]
    nin = len(planes)
    depth = np.uint16 if gray and max_prec > 8 else np.uint8
    out_prec = 16 if depth == np.uint16 else 8
    shift = 0 if out_prec > max_prec else max_prec - out_prec

    def comps(*idx):  # cast, not saturated: a palette's wider entries wrap
        return np.stack([planes[i][0] >> shift for i in idx], -1).astype(depth)

    if space == "gray":
        one = comps(0)
        return one[..., 0] if gray else np.repeat(one, 3, -1)
    if space == "sycc":
        if gray:
            return comps(0)[..., 0]
        if nin < 3:
            raise ValueError("sYCC JPEG 2000 of fewer than 3 components")
        return yuv_bgr(comps(0, 1, 2))
    if gray:
        return comps(0)[..., 0] if nin <= 2 else pnm.cvt_gray(
            comps(2, 1, 0))
    if nin < 3:
        raise ValueError(f"sRGB JPEG 2000 of {nin} components read in "
                         "colour")
    return comps(2, 1, 0)
