#!/usr/bin/env python
"""Carry two sets of tables out of OpenCV's own library into the port's
host C, as C headers:

- ``lgu_slam_tpu_torch/csrc/host/tiff_uvtable.h``: libtiff's ``uv_row``
  table (``uvcode.h``: ``{float ustart; short nus, ncum;}`` for each of the
  163 rows of the (u', v') plane), which the SGI LogLuv24 decoder
  (``tiff_lzw.c``) needs to turn a 14-bit colour index into (u', v');
- ``lgu_slam_tpu_torch/csrc/host/ht_tables.h``: OpenJPEG's tables of the
  HTJ2K block decoder (``ht_dec.c``): the CxtVLC tables ``vlc_tbl0`` (the
  first line pair of quads) and ``vlc_tbl1`` (the others), 1024 entries
  each (a 3-bit context and 7 bits of codeword -> codeword length, u_off,
  rho, e_1, e_k), and the MEL coder's exponents.  The UVLC tables are not
  stored in the library (OpenJPEG fills them at run time), so
  ``j2k_decode.c`` decodes UVLC codes from their definition in T.814.

    python scripts/extract_cv2_tables_torch.py [--check]

The tables are found by their structure, not by an offset, so another
build of OpenCV 5 (which links libtiff and OpenJPEG statically) serves as
well: ``uv_row`` as the one run of 163 little-endian records whose
``ncum`` is the running sum of ``nus``, whose last ``ncum + nus`` is
16,289 (``UV_NDIVS``) and whose first ``ustart`` lies in (0.1, 0.4); the
VLC tables as the one run of 2 x 1024 16-bit entries in which every
entry's e_1 bits lie within its e_k bits and those within its rho bits,
with a codeword length of 1 to 7, each table a prefix code (the entries
that share a codeword's bits are equal), ``vlc_tbl0`` the one whose first
entries are OpenJPEG's ``0x0023, 0x00a5, 0x0043, 0x0066``; the MEL
exponents as the 13 int32 ``{0,0,0,1,1,1,2,2,2,3,3,4,5}`` next to them.
``--check`` compares the committed headers with what the library gives
and exits 1 where they differ.  Needs ``cv2`` (the card machine has none:
the headers are committed).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(REPO, "lgu_slam_tpu_torch", "csrc", "host")
UV_HEADER = os.path.join(HOST, "tiff_uvtable.h")
HT_HEADER = os.path.join(HOST, "ht_tables.h")

UV_NVS = 163
UV_NDIVS = 16289
MEL_EXP = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5], np.int32)
VLC_TBL0_HEAD = (0x0023, 0x00a5, 0x0043, 0x0066)

LIBTIFF_NOTICE = """\
 * The table is libtiff's (libtiff/uvcode.h, used by tif_luv.c):
 *
 * Copyright (c) 1997 Greg Ward Larson
 * Copyright (c) 1997 Silicon Graphics, Inc.
 *
 * Permission to use, copy, modify, distribute, and sell this software and
 * its documentation for any purpose is hereby granted without fee, provided
 * that (i) the above copyright notices and this permission notice appear in
 * all copies of the software and related documentation, and (ii) the names
 * of Sam Leffler, Greg Larson and Silicon Graphics may not be used in any
 * advertising or publicity relating to the software without the specific,
 * prior written permission of Sam Leffler, Greg Larson and Silicon
 * Graphics.
 *
 * THE SOFTWARE IS PROVIDED "AS-IS" AND WITHOUT WARRANTY OF ANY KIND,
 * EXPRESS, IMPLIED OR OTHERWISE, INCLUDING WITHOUT LIMITATION, ANY
 * WARRANTY OF MERCHANTABILITY OR FITNESS FOR A PARTICULAR PURPOSE.
 *
 * IN NO EVENT SHALL SAM LEFFLER, GREG LARSON OR SILICON GRAPHICS BE LIABLE
 * FOR ANY SPECIAL, INCIDENTAL, INDIRECT OR CONSEQUENTIAL DAMAGES OF ANY
 * KIND, OR ANY DAMAGES WHATSOEVER RESULTING FROM LOSS OF USE, DATA OR
 * PROFITS, WHETHER OR NOT ADVISED OF THE POSSIBILITY OF DAMAGE, AND ON ANY
 * THEORY OF LIABILITY, ARISING OUT OF OR IN CONNECTION WITH THE USE OR
 * PERFORMANCE OF THIS SOFTWARE.
"""

OPENJPEG_NOTICE = """\
 * The tables are OpenJPEG's (src/lib/openjp2/t1_ht_luts.h, used by
 * ht_dec.c):
 *
 * Copyright (c) 2021, Aous Naman
 * Copyright (c) 2021, Kakadu Software Pty Ltd, Australia
 * Copyright (c) 2021, The University of New South Wales, Australia
 *
 * Redistribution and use in source and binary forms, with or without
 * modification, are permitted provided that the following conditions are
 * met:
 * 1. Redistributions of source code must retain the above copyright
 *    notice, this list of conditions and the following disclaimer.
 * 2. Redistributions in binary form must reproduce the above copyright
 *    notice, this list of conditions and the following disclaimer in the
 *    documentation and/or other materials provided with the distribution.
 *
 * THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS `AS
 * IS' AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED
 * TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A
 * PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
 * OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
 * SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED
 * TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
 * PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
 * LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
 * NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
 * SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""


def library_bytes() -> bytes:
    """The bytes of OpenCV's Python extension (the libraries it links
    statically included)."""
    import cv2

    path = cv2.__file__
    if os.path.basename(path).startswith("__init__"):
        folder = os.path.dirname(path)
        path = next(os.path.join(folder, f) for f in sorted(os.listdir(folder))
                    if f.startswith("cv2") and f.endswith(".so"))
    with open(path, "rb") as f:
        return f.read()


def find_uv_row(lib: bytes) -> np.ndarray:
    """libtiff's ``uv_row``: 163 records of ``<f4 ustart, <i2 nus, <i2
    ncum``; exactly one run in the library must pass the checks."""
    rec = np.dtype([("ustart", "<f4"), ("nus", "<i2"), ("ncum", "<i2")])
    u8 = np.frombuffer(lib, np.uint8)
    hits = []
    for align in range(4):
        n = (len(lib) - align) // 8
        recs = u8[align:align + 8 * n].view(rec)
        first = np.flatnonzero((recs["ncum"] == 0) & (recs["nus"] > 0)
                               & (recs["ustart"] > 0.1)
                               & (recs["ustart"] < 0.4))
        for k in first:
            if k + UV_NVS > n:
                continue
            t = recs[k:k + UV_NVS]
            nus = t["nus"].astype(np.int64)
            if (nus > 0).all() and (t["ncum"] == np.concatenate(
                    [[0], np.cumsum(nus)[:-1]])).all() and \
                    int(t["ncum"][-1]) + int(nus[-1]) == UV_NDIVS:
                hits.append(t.copy())
    if len(hits) != 1:
        raise SystemExit(f"uv_row: {len(hits)} candidates in the library")
    return hits[0]


def _prefix_code(tbl: np.ndarray) -> bool:
    """Each context's 128 entries: the entry at index i has the codeword
    of its length's low bits of i, so entries sharing them are equal."""
    idx = np.arange(1024)
    length = tbl & 7
    base = (idx & ~127) | (idx & ((1 << length) - 1))
    return bool((tbl == tbl[base]).all())


def find_vlc_tables(lib: bytes) -> tuple:
    """``(vlc_tbl0, vlc_tbl1)``, 1024 uint16 each: the one run of 2048
    valid entries in the library, split in two (each a prefix code), the
    table that starts with :data:`VLC_TBL0_HEAD` being ``vlc_tbl0``."""
    hits = []
    for align in (0, 1):
        a = np.frombuffer(lib, "<u2", (len(lib) - align) // 2, align)
        a = a.astype(np.int64)
        length, rho = a & 7, (a >> 4) & 15
        e1, ek = (a >> 8) & 15, (a >> 12) & 15
        ok = ((e1 & ~ek) == 0) & ((ek & ~rho) == 0) & (length > 0)
        edge = np.diff(np.concatenate([[0], ok.astype(np.int8), [0]]))
        for s, e in zip(np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)):
            if e - s == 2048:
                hits.append(a[s:e].astype(np.uint16))
    if len(hits) != 1:
        raise SystemExit(f"VLC tables: {len(hits)} candidate runs")
    halves = hits[0][:1024], hits[0][1024:]
    if not all(_prefix_code(h.astype(np.int64)) for h in halves):
        raise SystemExit("VLC tables: not prefix codes")
    first = [h for h in halves if tuple(int(v) for v in h[:4])
             == VLC_TBL0_HEAD]
    if len(first) != 1:
        raise SystemExit("VLC tables: no table starts as vlc_tbl0 does")
    other = halves[1] if first[0] is halves[0] else halves[0]
    return first[0], other


def find_mel_exponents(lib: bytes) -> np.ndarray:
    """The MEL exponents, which must be in the library as int32."""
    if lib.find(MEL_EXP.astype("<i4").tobytes()) < 0:
        raise SystemExit("the MEL exponents are not in the library")
    return MEL_EXP


def _rows(values, per_line: int, fmt) -> str:
    items = [fmt(v) for v in values]
    lines = [", ".join(items[i:i + per_line])
             for i in range(0, len(items), per_line)]
    return ",\n".join("    " + line for line in lines)


def uv_header(uv: np.ndarray) -> str:
    body = _rows(uv, 2, lambda r: "{%.9gF, %d, %d}" % (
        float(r["ustart"]), int(r["nus"]), int(r["ncum"])))
    return f"""/* libtiff's uv_row table for the SGI LogLuv24 decoder of
 * tiff_lzw.c: for each of the UV_NVS rows of the (u', v') plane, the u'
 * of its first cell, its number of cells and the number of cells before
 * it.
 *
 * Written by scripts/extract_cv2_tables_torch.py, which finds the table in
 * OpenCV's library (libtiff linked statically); do not edit.
 *
{LIBTIFF_NOTICE} */
#ifndef TIFF_UVTABLE_H
#define TIFF_UVTABLE_H

#define UV_SQSIZ (float)0.003500
#define UV_NDIVS {UV_NDIVS}
#define UV_VSTART (float)0.016940
#define UV_NVS {UV_NVS}

static const struct {{
    float ustart;
    short nus, ncum;
}} uv_row[UV_NVS] = {{
{body}
}};

#endif
"""


def ht_header(tbl0: np.ndarray, tbl1: np.ndarray, mel: np.ndarray) -> str:
    def table(name, t):
        return (f"static const uint16_t {name}[1024] = {{\n"
                + _rows(t, 8, lambda v: "0x%04x" % int(v)) + "\n};\n")
    return f"""/* OpenJPEG's tables of the HTJ2K block decoder (T.814), for
 * j2k_decode.c and the HT block coder of j2k_encode.c.
 *
 * vlc_tbl0 (the first line pair of quads) and vlc_tbl1 (the others) are
 * indexed by (context << 7) | the next 7 bits of the VLC stream; an entry
 * holds the codeword length (bits 0-2), u_off (bit 3), rho (bits 4-7),
 * e_1 (bits 8-11) and e_k (bits 12-15).  mel_exp: the MEL coder's
 * exponent of each of its 13 states.
 *
 * Written by scripts/extract_cv2_tables_torch.py, which finds the tables
 * in OpenCV's library (OpenJPEG linked statically); do not edit.
 *
{OPENJPEG_NOTICE} */
#ifndef HT_TABLES_H
#define HT_TABLES_H

#include <stdint.h>

static const int mel_exp[13] = {{{", ".join(str(int(v)) for v in mel)}}};

{table("vlc_tbl0", tbl0)}
{table("vlc_tbl1", tbl1)}
#endif
"""


def render() -> dict:
    """``{path: text}`` of both headers, from the installed OpenCV."""
    lib = library_bytes()
    tbl0, tbl1 = find_vlc_tables(lib)
    return {UV_HEADER: uv_header(find_uv_row(lib)),
            HT_HEADER: ht_header(tbl0, tbl1, find_mel_exponents(lib))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="compare the committed headers, write nothing")
    args = parser.parse_args(argv)
    stale = []
    for path, text in render().items():
        if args.check:
            with open(path) as f:
                if f.read() != text:
                    stale.append(path)
        else:
            with open(path, "w") as f:
                f.write(text)
            print(f"wrote {os.path.relpath(path, REPO)}")
    for path in stale:
        print(f"{os.path.relpath(path, REPO)} differs from the library's "
              "tables", file=sys.stderr)
    return 1 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
