#!/usr/bin/env python
"""Write the committed JPEG 2000 fixtures of ``tests/data/jp2/``: JP2 files
and raw codestreams written by encoders independent of the port (Pillow,
``cv2.imwrite`` and, for the coding options neither of them exposes,
Pillow's own OpenJPEG library called through ctypes), for the tests and
for machines that have neither Pillow nor OpenCV (the card machine of
``chip_smoke.py``).

    python scripts/make_jp2_fixtures_torch.py [--out tests/data/jp2]

Each is a 96 x 128 crop of a rendered frame, but for two whole 480 x 640
frames (``chip_smoke.py`` phase 16 times their decoding):

- ``pillow_53.jp2``: lossless 5/3 with the RCT, LRCP, 6 resolutions;
- ``pillow_97_mct.jp2``: 9/7 with the ICT, two quality layers;
- ``pillow_tiles_rpcl.jp2``: 40 x 56 tiles (partial edge tiles), RPCL,
  32 x 32 precincts, 16 x 16 code blocks, 4 resolutions, 3 layers;
- ``pillow_cprl.j2k``: a raw codestream, 9/7, CPRL, 64 x 64 tiles,
  16 x 16 precincts, 8 x 8 code blocks, PLT markers;
- ``pillow_gray16.jp2``: 16-bit gray (a depth map's values);
- ``pillow_rgba.jp2``: RGBA with its channel definitions;
- ``pillow_palette.jp2``: an 8-bit gray codestream whose JP2 header adds a
  256-entry RGB palette (``pclr``, ``cmap``);
- ``cv2_default.jp2``, ``cv2_x100.jp2``: ``cv2.imwrite`` at its default
  and at ``IMWRITE_JPEG2000_COMPRESSION_X1000`` 100 (code blocks cut
  short by rate allocation);
- ``opj_styles.j2k``: all six code-block styles (BYPASS, RESET, TERMALL,
  VSC, PTERM, SEGSYM), SOP and EPH markers, 3 layers;
- ``opj_bypass_97.jp2``: BYPASS, VSC and SEGSYM under 9/7, 3 layers;
- ``opj_poc.jp2``: two progression order changes (RLCP, then LRCP for the
  rest) over 64 x 48 tiles;
- ``opj_roi_12bit.jp2``: 12-bit components, an ROI shift on component 0;
- ``opj_styles_ppt.j2k``: ``opj_styles.j2k`` with its packet headers moved
  into PPT marker segments; ``opj_tiles_ppm.j2k``: 48 x 40 tiles with SOP
  and EPH, their packet headers moved into PPM marker segments
  (:func:`packed_headers`);
- ``frame_cv2_default.jp2``: ``cv2.imwrite``'s default of a 480 x 640
  frame; ``frame_97.jp2``: the frame in 9/7 with the ICT at a 16:1 rate.

and HTJ2K files of the port's own HT writer (``jp2.encode_jp2(...,
ht=True)``; no library here writes HT code blocks), each read by
``cv2.imread`` before its hash is written (:func:`ht_files`):

- ``ht_53.jp2``: the crop losslessly, the cleanup pass alone;
- ``ht_53_magref.jp2``: the cleanup at bit-plane 1, then SigProp and
  MagRef;
- ``ht_97_sigprop.j2k``: 9/7 with the ICT, the cleanup at bit-plane 1 and
  SigProp, a raw codestream;
- ``ht_gray16_tiles.jp2``: the 16-bit depth in 48 x 64 tiles of 4 x 1024
  code blocks;
- ``ht_gray8_1024x4_vcausal.j2k``: the green channel, 1024 x 4 code
  blocks, the vertically causal SigProp and MagRef;
- ``ht_damaged.j2k``: ``ht_53``'s codestream with three seeded bytes of
  its tile data changed (as cv2 reads it);
- ``ht_cut.j2k``: that codestream cut inside its tile (None: null hashes).

Beside them ``hashes.json``: the SHA-256 of ``cv2.imread``'s array in both
read modes (colour, ``IMREAD_ANYDEPTH``), its shape and dtype, which
``tests/test_torch_jp2.py`` and ``chip_smoke.py`` phase 16 hold the port's
decoder to.  Needs OpenCV and Pillow (with its bundled libopenjp2).
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 256 * 1024  # bytes per file


def array_hash(a: np.ndarray) -> dict:
    """The SHA-256, shape and dtype of an array; None for None."""
    if a is None:
        return None
    return dict(sha256=hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                      ).hexdigest(),
                shape=list(a.shape), dtype=str(a.dtype))


class OpenJPEG:
    """Pillow's bundled libopenjp2 as an encoder with the options Pillow
    does not pass on: code-block styles (``mode``), SOP / EPH (``csty``),
    progression order changes and ROI shifts.  The offsets into
    ``opj_cparameters_t`` are found from the defaults that
    ``opj_set_default_encoder_parameters`` writes."""

    SIZE = 1 << 15

    def __init__(self):
        import PIL

        libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
            PIL.__file__)), "pillow.libs", "libopenjp2-*.so*"))
        if not libs:
            raise RuntimeError("Pillow's libopenjp2 was not found")
        self.lib = lib = ctypes.CDLL(libs[0])
        vp = ctypes.c_void_p
        lib.opj_image_create.restype = vp
        lib.opj_create_compress.restype = vp
        lib.opj_stream_create_default_file_stream.restype = vp
        for name, n in (("opj_setup_encoder", 3), ("opj_start_compress", 3),
                        ("opj_encode", 2), ("opj_end_compress", 2),
                        ("opj_stream_destroy", 1), ("opj_destroy_codec", 1),
                        ("opj_image_destroy", 1)):
            getattr(lib, name).argtypes = [vp] * n
        params = ctypes.create_string_buffer(self.SIZE)
        lib.opj_set_default_encoder_parameters(params)
        # numresolution 6, cblockw/h 64, mode 0, irreversible 0,
        # roi_compno -1, in this order
        at = bytes(params).find(struct.pack("<6i", 6, 64, 64, 0, 0, -1))
        if at != 5600:
            raise RuntimeError(f"unexpected opj_cparameters_t layout ({at})")
        self.off = dict(tile_size_on=0, cp_tdx=12, cp_tdy=16,
                        cp_disto_alloc=20, csty=48, prog_order=52, poc=56,
                        numpocs=4792, tcp_numlayers=4796, tcp_rates=4800,
                        numresolution=5600, cblockw_init=5604,
                        cblockh_init=5608, mode=5612, irreversible=5616,
                        roi_compno=5620, roi_shift=5624, res_spec=5628,
                        prcw_init=5632, prch_init=5764)

    def encode(self, path, planes, prec=8, j2k=False, irreversible=False,
               mode=0, csty=0, numres=6, cblk=(64, 64), prog=0,
               rates=(0,), tiles=None, pocs=(), roi=None):
        """Write ``planes`` ([C, H, W] integers) with these options;
        ``pocs``: (resno0, compno0, layno1, resno1, compno1, order)."""
        lib, off = self.lib, self.off
        planes = np.asarray(planes)
        C, H, W = planes.shape
        params = ctypes.create_string_buffer(self.SIZE)
        lib.opj_set_default_encoder_parameters(params)

        def put(name, value, fmt="<i", k=0):
            struct.pack_into(fmt, params, off[name] + k, value)

        put("numresolution", numres)
        put("cblockw_init", cblk[0])
        put("cblockh_init", cblk[1])
        put("mode", mode)
        put("irreversible", int(irreversible))
        put("prog_order", prog)
        put("csty", csty)
        put("tcp_numlayers", len(rates))
        put("cp_disto_alloc", 1)
        for i, rate in enumerate(rates):
            put("tcp_rates", float(rate), "<f", 4 * i)
        if tiles:
            put("tile_size_on", 1)
            put("cp_tdx", tiles[0])
            put("cp_tdy", tiles[1])
        if roi:
            put("roi_compno", roi[0])
            put("roi_shift", roi[1])
        put("numpocs", len(pocs))
        for i, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
            base = off["poc"] + 148 * i  # sizeof(opj_poc_t)
            struct.pack_into("<5I", params, base, r0, c0, l1, r1, c1)
            struct.pack_into("<2i", params, base + 32, order, order)
            struct.pack_into("<I", params, base + 48, 1)  # tile 1 = all

        class Cmpt(ctypes.Structure):
            _fields_ = [(n, ctypes.c_uint32) for n in (
                "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]

        cmpts = (Cmpt * C)(*[Cmpt(1, 1, W, H, 0, 0, prec, prec, 0)
                             for _ in range(C)])
        image = lib.opj_image_create(C, cmpts, 1 if C >= 3 else 2)
        struct.pack_into("<4I", (ctypes.c_char * 16).from_address(image), 0,
                         0, 0, W, H)
        comps = ctypes.c_void_p.from_address(image + 24).value
        for c in range(C):  # opj_image_comp_t: 64 bytes, data at 48
            data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
            plane = np.ascontiguousarray(planes[c], np.int32)
            ctypes.memmove(data, plane.ctypes.data, plane.nbytes)
        codec = lib.opj_create_compress(0 if j2k else 2)
        stream = None
        try:
            if not lib.opj_setup_encoder(codec, params, image):
                raise RuntimeError(f"{path}: opj_setup_encoder failed")
            stream = lib.opj_stream_create_default_file_stream(
                str(path).encode(), 0)
            if not (lib.opj_start_compress(codec, image, stream)
                    and lib.opj_encode(codec, stream)
                    and lib.opj_end_compress(codec, stream)):
                raise RuntimeError(f"{path}: encoding failed")
        finally:
            if stream:
                lib.opj_stream_destroy(stream)
            lib.opj_destroy_codec(codec)
            lib.opj_image_destroy(image)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def packed_headers(cs: bytes, kind: str, chunk: int = 60000) -> bytes:
    """A codestream with SOP and EPH markers, each tile in one tile-part,
    rewritten with its packet headers (each up to its EPH) moved into PPT
    marker segments of their tile-part (``kind`` "ppt") or PPM segments of
    the main header ("ppm", each tile-part's headers after its Nppm
    length), ``chunk`` bytes to a segment; the SOP markers stay before the
    packet bodies.  The EPH marker (0xFF92) cannot occur in coded data, so
    it delimits them."""
    first = cs.index(b"\xff\x90")
    main, pos, parts = cs[:first], first, []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot, = struct.unpack_from(">I", cs, pos + 6)
        part = cs[pos:pos + psot]
        sod = part.index(b"\xff\x93")
        data, heads, bodies, i = part[sod + 2:], b"", b"", 0
        while i < len(data):
            assert data[i:i + 2] == b"\xff\x91", "a packet without SOP"
            eph = data.index(b"\xff\x92", i + 6) + 2
            nxt = data.find(b"\xff\x91", eph)
            nxt = len(data) if nxt < 0 else nxt
            heads += data[i + 6:eph]
            bodies += data[i:i + 6] + data[eph:nxt]
            i = nxt
        parts.append((part[:12], part[12:sod], heads, bodies))
        pos += psot
    chunks = range(0, 1 << 30, chunk)
    out = []
    for sot, markers, heads, bodies in parts:
        if kind == "ppt":
            markers += b"".join(
                _segment(0xFF61, bytes([z]) + heads[k:k + chunk])
                for z, k in zip(range(256), chunks) if k < len(heads))
        body = markers + b"\xff\x93" + bodies
        out.append(sot[:6] + struct.pack(">I", 12 + len(body)) + sot[10:]
                   + body)
    if kind == "ppm":
        blob = b"".join(struct.pack(">I", len(h)) + h for _, _, h, _ in parts)
        main += b"".join(_segment(0xFF60, bytes([z]) + blob[k:k + chunk])
                         for z, k in zip(range(256), chunks) if k < len(blob))
    return main + b"".join(out) + cs[pos:]


def add_palette(jp2: bytes, palette: np.ndarray) -> bytes:
    """A gray JP2 whose header boxes become ihdr, colr (sRGB), pclr (the
    [N, 3] palette, 8 bits) and cmap (each channel from component 0)."""
    def box(kind, body):
        return struct.pack(">I", 8 + len(body)) + kind + body

    at = jp2.index(b"jp2h") - 4
    length, = struct.unpack_from(">I", jp2, at)
    ihdr = jp2.index(b"ihdr") - 4
    n = len(palette)
    inner = (jp2[ihdr:ihdr + 22]
             + box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 16))
             + box(b"pclr", struct.pack(">HB", n, 3) + bytes([7, 7, 7])
                   + palette.astype(np.uint8).tobytes())
             + box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                     for i in range(3))))
    return jp2[:at] + box(b"jp2h", inner) + jp2[at + length:]


def ht_files(bgr: np.ndarray, depth: np.ndarray) -> dict:
    """The HTJ2K files of the port's writer (module docstring)."""
    from lgu_slam_tpu_torch.data import jp2

    files = {
        "ht_53.jp2": jp2.encode_jp2(bgr, ht=True),
        "ht_53_magref.jp2": jp2.encode_jp2(bgr, ht=True, refine=2),
        "ht_97_sigprop.j2k": jp2.encode_jp2(bgr, codestream=True, ht=True,
                                            irreversible=True, refine=1),
        "ht_gray16_tiles.jp2": jp2.encode_jp2(depth, ht=True, tile=(48, 64),
                                              levels=4, cblk=(4, 1024)),
        "ht_gray8_1024x4_vcausal.j2k": jp2.encode_jp2(
            np.ascontiguousarray(bgr[..., 1]), codestream=True, ht=True,
            cblk=(1024, 4), vcausal=True, refine=2),
    }
    cs = jp2.encode_jp2(bgr, codestream=True, ht=True)
    raw = bytearray(cs)
    rng = np.random.default_rng(18)
    start = cs.index(b"\xff\x93") + 2
    for at in rng.integers(start, len(cs) - 2, 3):
        raw[at] ^= 1 << int(rng.integers(0, 8))
    files["ht_damaged.j2k"] = bytes(raw)
    files["ht_cut.j2k"] = cs[:(start + len(cs)) // 2]
    return files


def main(argv=None) -> dict:
    import cv2
    from PIL import Image

    sys.path.insert(0, REPO)
    from lgu_slam_tpu_torch.data.fixtures import TUM_FR1, render_sequence

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "jp2"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    frame = render_sequence(8, 1, 480, 640, TUM_FR1, 0.02, 0.004)[0][0]
    bgr = np.ascontiguousarray(frame[::4, ::4][20:116, :128])
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    depth = (bgr.astype(np.uint16) @ np.uint16([3, 5, 7]) * 13 + 500
             ).astype(np.uint16)

    def pillow(image, **kw) -> bytes:
        buf = io.BytesIO()
        image.save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    def cv2_file(name, params=()) -> bytes:
        path = os.path.join(args.out, name)
        assert cv2.imwrite(path, bgr, list(params))
        with open(path, "rb") as fh:
            return fh.read()

    image = Image.fromarray(rgb)
    files = {
        "pillow_53.jp2": pillow(image, mct=1),
        "pillow_97_mct.jp2": pillow(image, irreversible=True, mct=1,
                                    quality_layers=[24, 8]),
        "pillow_tiles_rpcl.jp2": pillow(
            image, tile_size=(56, 40), progression="RPCL",
            num_resolutions=4, precinct_size=(32, 32),
            codeblock_size=(16, 16), quality_layers=[30, 10, 3]),
        "pillow_cprl.j2k": pillow(
            image, no_jp2=True, irreversible=True, progression="CPRL",
            tile_size=(64, 64), precinct_size=(16, 16), num_resolutions=4,
            codeblock_size=(8, 8), plt=True, quality_layers=[6]),
        "pillow_gray16.jp2": pillow(Image.fromarray(depth, "I;16")),
        "pillow_rgba.jp2": pillow(Image.fromarray(np.dstack(
            [rgb, rgb[..., 1] ^ 0x5A]), "RGBA"), quality_layers=[8]),
        "cv2_default.jp2": cv2_file("cv2_default.jp2"),
        "cv2_x100.jp2": cv2_file("cv2_x100.jp2", (
            cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 100)),
    }
    palette = np.random.default_rng(16).integers(0, 256, (256, 3))
    files["pillow_palette.jp2"] = add_palette(
        pillow(Image.fromarray(rgb[..., 1] & 0xF0)), palette)
    opj = OpenJPEG()
    planes = rgb.transpose(2, 0, 1).astype(np.int32)
    coded = {
        "opj_styles.j2k": dict(j2k=True, mode=63, csty=6, numres=4,
                               cblk=(32, 16), rates=(40, 12, 4)),
        "opj_bypass_97.jp2": dict(irreversible=True, mode=1 | 8 | 32,
                                  numres=5, rates=(30, 10, 3)),
        "opj_poc.jp2": dict(numres=3, tiles=(64, 48), rates=(20, 6),
                            pocs=((0, 0, 1, 2, 3, 1), (0, 0, 2, 3, 3, 0))),
        "opj_roi_12bit.jp2": dict(planes=planes * 16 + 7, prec=12, numres=4,
                                  roi=(0, 4), rates=(10,)),
        "opj_tiles_ppm.j2k": dict(j2k=True, csty=6, numres=3, tiles=(48, 40),
                                  rates=(16, 4)),
    }
    for name, kw in coded.items():
        path = os.path.join(args.out, name)
        opj.encode(path, kw.pop("planes", planes), **kw)
        with open(path, "rb") as fh:
            files[name] = fh.read()
    whole = np.ascontiguousarray(frame)
    path = os.path.join(args.out, "frame_cv2_default.jp2")
    assert cv2.imwrite(path, whole)
    with open(path, "rb") as fh:
        files["frame_cv2_default.jp2"] = fh.read()
    files["frame_97.jp2"] = pillow(Image.fromarray(whole[..., ::-1]),
                                   irreversible=True, mct=1,
                                   quality_layers=[16])
    files["opj_styles_ppt.j2k"] = packed_headers(files["opj_styles.j2k"],
                                                 "ppt")
    files["opj_tiles_ppm.j2k"] = packed_headers(files["opj_tiles_ppm.j2k"],
                                                "ppm")
    files.update(ht_files(bgr, depth))
    hashes = {}
    for name, data in files.items():
        assert len(data) <= LIMIT, (name, len(data))
        path = os.path.join(args.out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        hashes[name] = dict(
            bytes=len(data),
            color=array_hash(cv2.imread(path, cv2.IMREAD_COLOR)),
            anydepth=array_hash(cv2.imread(path, cv2.IMREAD_ANYDEPTH)))
    assert sum(len(d) for d in files.values()) <= 640 * 1024
    with open(os.path.join(args.out, "hashes.json"), "w") as fh:
        json.dump(hashes, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return hashes


if __name__ == "__main__":
    print(json.dumps({k: v["bytes"] for k, v in main().items()}, indent=1))
