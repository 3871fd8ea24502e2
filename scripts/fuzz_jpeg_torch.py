#!/usr/bin/env python
"""Memory-safety check of the port's host decoders in C: the JPEG decoder
(``csrc/host/jpeg_decode.c``), the TIFF LZW (both codings) / PackBits /
SGI LogL / LogLuv32 / LogLuv24 decoders and predictors
(``csrc/host/tiff_lzw.c``),
the TIFF CCITT decoder (``csrc/host/ccitt_decode.c``), the TIFF colour
conversions (``csrc/host/tiff_color.c``), the BMP RLE decoder
(``csrc/host/bmp_rle.c``), the WebP decoders (``csrc/host/webp_decode.c``:
VP8L, VP8, ALPH), the GIF LZW decoder (``csrc/host/gif_lzw.c``), the
Radiance HDR scanline reader and float gray (``csrc/host/hdr_rgbe.c``) and
the JPEG 2000 codestream decoder (``csrc/host/j2k_decode.c``: its header
read, then the whole decode where the header allows it), that decoder
again over small HTJ2K codestreams (its HT cleanup, SigProp and MagRef
decoders), and the lossless AV1 intra decoder of the AVIF reader
(``csrc/host/av1_decode.c``: its header read, then the decode), seeded
with the AV1 streams of ``tests/data/avif`` and of the port's AV1 writer.
Builds each with AddressSanitizer and UndefinedBehavior Sanitizer beside a
small C harness, then decodes every truncation of a few seed streams and
``--mutations`` copies of each with 1-4 random bytes overwritten (JPEG:
to the colour and to the gray output; TIFF: into strips of the seed's
size and of a random one, then both predictors over the output; CCITT: at
the seed's row width and count and random ones, either bit order, the
run arrays kept from input to input as libtiff keeps them from strip to
strip; the colour conversions: over the inputs' bytes as samples; RLE: as
RLE8 and RLE4 at the seed's size and a random one; WebP, GIF and HDR: at
the seed's image size and a random one; JPEG 2000: as they are).  Any
out-of-bounds access or undefined behaviour aborts the harness; otherwise
it prints, per decoder, how many inputs decoded (JPEG: in each of the four
output colour spaces, BGR, gray, YCbCr to RGB and as stored) or were
refused as corrupt (JPEG 2000 also: not decoded, a feature it names).
The 32-bit BMP bit-mask path (``data/image_io.py``, numpy) runs the same
loop in Python over BMPs of every header size and mask kind: anything
raised but ValueError is a finding.

    python scripts/fuzz_jpeg_torch.py [--mutations 20000] [--seed 1]

The JPEG seeds are files of the port's encoder: baseline Huffman (4:2:0
with restart markers, 4:4:4, 4:1:1, 4:4:0, gray, CMYK and YCCK),
arithmetic-coded (sequential and progressive, with restart markers and
DAC conditioning), lossless (gray and RGB, predictors 1-7, a point
transform, restart markers), the strips of a JPEG-compressed TIFF with
its tables, and two baseline files damaged as libjpeg reads past (restart
markers out of order, bytes before a marker); ``--files`` adds others
(progressive Huffman files, whose truncations drive the block smoothing,
say).  The TIFF seeds are the LZW (6.0 and pre-6.0), PackBits and LogL
strips of the port's TIFF encoder, among them a BigTIFF's float64 strip
(its predictors on 8-byte samples), the CCITT seeds its RLE, RLEW, Group 3
(1-D, 2-D, with fill bits) and Group 4 strips, the RLE seeds its RLE8 and
RLE4 data; the JPEG and TIFF seeds also hold the one-component strips of
JPEG TIFFs of separate planes and short strips and the LZW tiles of
predicted YCbCr data units (:func:`tiff_leftover_seeds`).  The WebP
seeds are the bitstreams of the port's lossless encoder (subtract-green,
predictor, colour cache; with alpha) and of the committed libwebp files of
``tests/data/webp`` (the lossy frame's VP8 and ALPH of
``lossy_alpha.webp``, the VP8L of ``lossless_alpha.webp``), the GIF seeds
the LZW data of the port's encoder at minimum code sizes 2, 4 and 8, the
HDR seeds run-length and flat pixel data, the JPEG 2000 seeds the
codestreams of the committed files of ``tests/data/jp2`` (96 x 128:
Pillow's, cv2.imwrite's and OpenJPEG's, with tiles, precincts, layers,
every code-block style, SOP / EPH, POC, ROI, PPT and PPM, and the HT
files of the port's writer); the HT seeds 32 x 48 codestreams of the
port's HT writer (cleanup only, SigProp, SigProp and MagRef, lossy
cleanups, 9/7, 4 x 1024 and 1024 x 4 code blocks, tiles, the vertically
causal SigProp, 16-bit gray), the LogLuv24 seeds strips of random 24-bit
codes (uv indices past libtiff's table among them) (:func:`ht_seeds`,
:func:`logluv24_seeds`).  Needs a C
compiler with the
sanitizers (gcc or clang); runs on the host only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.image_io import (  # noqa: E402
    _rle_rows,
    encode_jpeg,
)
from lgu_slam_tpu_torch.data.tiff import (  # noqa: E402
    _ifd,
    _jpeg_tables,
    ccitt_encode,
    encode_tiff,
    logl_encode,
    lzw_encode,
    packbits_encode,
)
from lgu_slam_tpu_torch.data import gif, hdr, webp  # noqa: E402
from lgu_slam_tpu_torch.ops._build import CSRC, _cc  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# the common loop of the harnesses below: every truncation of each seed,
# then `mutations` copies with 1-4 bytes overwritten; DECODE(d, m, it) is
# the harness's call on the m bytes at d (`it` odd: a random image size)
LOOP = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
static uint8_t *load(const char *path, long *n)
{
    FILE *fp = fopen(path, "rb");
    uint8_t *base;
    fseek(fp, 0, SEEK_END);
    *n = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    base = malloc((size_t)(*n > 0 ? *n : 1));
    if (fread(base, 1, (size_t)*n, fp) != (size_t)*n)
        exit(2);
    fclose(fp);
    return base;
}
#define FOR_EACH_INPUT(base, n, mutations, BODY)                         \
    for (long it = 0; it < (n) + (mutations); it++) {                    \
        long m = it < (n) ? it : (n);                                    \
        uint8_t *d = malloc((size_t)(m > 0 ? m : 1));                    \
        memcpy(d, base, (size_t)m);                                      \
        if (it >= (n))                                                   \
            for (int k = 1 + rand() % 4; k > 0; k--)                     \
                d[rand() % m] = (uint8_t)rand();                         \
        BODY;                                                            \
        free(d);                                                         \
    }
"""

WEBP_HARNESS = LOOP + r"""
int webp_vp8l_decode(const uint8_t *, int64_t, int64_t, int64_t,
                     uint32_t *);
int webp_vp8_decode(const uint8_t *, int64_t, int64_t, int64_t, uint8_t *);
int webp_alpha_decode(const uint8_t *, int64_t, int64_t, int64_t,
                      uint8_t *);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[4] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f + 3 < argc; f += 4) {
        long n, W = atol(argv[f + 2]), H = atol(argv[f + 3]);
        uint8_t *base = load(argv[f], &n);
        char kind = argv[f + 1][0];
        FOR_EACH_INPUT(base, n, mutations, {
            int64_t w = it & 1 ? 1 + rand() % 64 : W;
            int64_t h = it & 1 ? 1 + rand() % 64 : H;
            uint8_t *o = malloc((size_t)(w * h * 4));
            int st = kind == 'l' ? webp_vp8l_decode(d, m, w, h, (uint32_t *)o)
                   : kind == 'v' ? webp_vp8_decode(d, m, w, h, o)
                                 : webp_alpha_decode(d, m, w, h, o);
            counts[st]++;
            free(o);
        })
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld, \"out_of_memory\": "
           "%ld}\n", counts[0], counts[1], counts[3]);
    return 0;
}
"""

GIF_HARNESS = LOOP + r"""
int gif_lzw_decode(const uint8_t *, int64_t, int, int64_t, uint8_t *);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[2] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f + 2 < argc; f += 3) {
        long n, npix0 = atol(argv[f + 2]);
        int mcs0 = atoi(argv[f + 1]);
        uint8_t *base = load(argv[f], &n);
        FOR_EACH_INPUT(base, n, mutations, {
            int64_t npix = it & 1 ? 1 + rand() % (2 * npix0) : npix0;
            int mcs = it & 2 ? rand() % 13 : mcs0;
            uint8_t *o = malloc((size_t)npix);
            counts[gif_lzw_decode(d, m, mcs, npix, o)]++;
            free(o);
        })
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld}\n", counts[0], counts[1]);
    return 0;
}
"""

HDR_HARNESS = LOOP + r"""
int hdr_read_pixels(const uint8_t *, int64_t, int64_t, int64_t, float *);
void hdr_gray(const float *, int64_t, int64_t, float *);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[4] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f + 2 < argc; f += 3) {
        long n, W = atol(argv[f + 1]), H = atol(argv[f + 2]);
        uint8_t *base = load(argv[f], &n);
        FOR_EACH_INPUT(base, n, mutations, {
            int64_t w = it & 1 ? 1 + rand() % 64 : W;
            int64_t h = it & 1 ? 1 + rand() % 16 : H;
            float *o = malloc(sizeof(float) * (size_t)(w * h * 3));
            float *g = malloc(sizeof(float) * (size_t)(w * h));
            int st = hdr_read_pixels(d, m, w, h, o);
            if (st == 0)
                hdr_gray(o, h, w, g);
            counts[st]++;
            free(o);
            free(g);
        })
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld}\n", counts[0], counts[1]);
    return 0;
}
"""

HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int jpeg_info(const uint8_t *, int64_t, int32_t *, char *, int);
int jpeg_decode_as(const uint8_t *, int64_t, uint8_t *, int64_t, int64_t,
                   int, char *, int);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[4] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f < argc; f++) {
        FILE *fp = fopen(argv[f], "rb");
        fseek(fp, 0, SEEK_END);
        long n = ftell(fp);
        fseek(fp, 0, SEEK_SET);
        uint8_t *base = malloc((size_t)n);
        if (fread(base, 1, (size_t)n, fp) != (size_t)n)
            return 2;
        fclose(fp);
        for (long it = 0; it < n + mutations; it++) {
            long m = it < n ? it : n; /* every truncation, then mutations */
            uint8_t *d = malloc((size_t)(m > 0 ? m : 1));
            memcpy(d, base, (size_t)m);
            if (it >= n)
                for (int k = 1 + rand() % 4; k > 0; k--)
                    d[2 + rand() % (m - 2)] = (uint8_t)rand();
            int32_t info[7];
            char err[256];
            int st = jpeg_info(d, m, info, err, 256);
            /* a mutated frame header can name an image of up to 2^32
             * pixels, which now decodes (gray past the data's end): such
             * files count as refused, sparing the sanitizers' memory */
            if (st == 0 && (int64_t)info[0] * info[1] > (1 << 22))
                st = 1;
            if (st == 0) { /* each output colour space, up to 4 channels */
                uint8_t *o = malloc((size_t)info[0] * info[1] * 4);
                for (int mode = 0; mode < 4; mode++)
                    counts[jpeg_decode_as(d, m, o, info[0], info[1], mode,
                                          err, 256)]++;
                free(o);
            } else {
                counts[st]++;
            }
            free(d);
        }
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld, \"out_of_memory\": "
           "%ld}\n", counts[0], counts[1], counts[3]);
    return 0;
}
"""


# one stream per file: argv[3...]; each decoded into `occ` bytes (the
# seed's own size, given in the file name's stem, then a random one)
TIFF_HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int tiff_lzw_decode(const uint8_t *, int64_t, uint8_t *, int64_t, int);
int tiff_packbits_decode(const uint8_t *, int64_t, uint8_t *, int64_t);
int tiff_logl_decode(const uint8_t *, int64_t, uint8_t *, int64_t, int64_t);
int tiff_logluv32_decode(const uint8_t *, int64_t, uint8_t *, int64_t,
                         int64_t);
int tiff_logluv24_decode(const uint8_t *, int64_t, uint8_t *, int64_t,
                         int64_t);
void tiff_hpredict(uint8_t *, int64_t, int64_t, int64_t, int, int);
int tiff_fpredict(uint8_t *, int64_t, int64_t, int64_t, int);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[4] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f + 1 < argc; f += 2) {
        long occ0 = atol(argv[f + 1]);
        FILE *fp = fopen(argv[f], "rb");
        fseek(fp, 0, SEEK_END);
        long n = ftell(fp);
        fseek(fp, 0, SEEK_SET);
        uint8_t *base = malloc((size_t)n);
        if (fread(base, 1, (size_t)n, fp) != (size_t)n)
            return 2;
        fclose(fp);
        int packbits = strstr(argv[f], "packbits") != NULL;
        int old = strstr(argv[f], "lzwold") != NULL;
        int logluv24 = strstr(argv[f], "logluv24") != NULL;
        int logluv = !logluv24 && strstr(argv[f], "logluv") != NULL;
        int logl = !logluv && strstr(argv[f], "logl") != NULL;
        for (long it = 0; it < n + mutations; it++) {
            long m = it < n ? it : n;
            uint8_t *d = malloc((size_t)(m > 0 ? m : 1));
            memcpy(d, base, (size_t)m);
            if (it >= n)
                for (int k = 1 + rand() % 4; k > 0; k--)
                    d[rand() % m] = (uint8_t)rand();
            long occ = it & 1 ? 1 + rand() % (2 * occ0) : occ0;
            occ = (occ + 7) & ~7L; /* whole 64-bit samples */
            uint8_t *o = malloc((size_t)occ);
            int64_t width = it & 1 ? 1 + rand() % 64 : 40;
            int st = packbits ? tiff_packbits_decode(d, m, o, occ)
                     : logl   ? tiff_logl_decode(d, m, o, occ / width, width)
                     : logluv ? tiff_logluv32_decode(d, m, o,
                                                     occ / (3 * width), width)
                     : logluv24 ? tiff_logluv24_decode(d, m, o,
                                                       occ / (3 * width),
                                                       width)
                              : tiff_lzw_decode(d, m, o, occ, old);
            int64_t rowbytes = 8 * (1 + rand() % 8);
            int64_t rows = occ / rowbytes;
            tiff_hpredict(o, rows, rowbytes, 1 + rand() % 4,
                          1 << (rand() % 4), rand() & 1);
            if (tiff_fpredict(o, rows, rowbytes, 1 + rand() % 4,
                              4 << (rand() & 1)) != 0)
                return 4;
            counts[st]++;
            free(o);
            free(d);
        }
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld, \"unsupported\": %ld, "
           "\"out_of_memory\": %ld}\n", counts[0], counts[1], counts[2],
           counts[3]);
    return 0;
}
"""

# one strip per file: argv[3...] as (file, scheme, 2-D, width, rows); each
# decoded at its own width and row count with one state kept across the
# inputs, and at random ones (odd inputs) with a state of their own
CCITT_HARNESS = LOOP + r"""
int64_t ccitt_state_size(int64_t, int);
int ccitt_decode(const uint8_t *, int64_t, uint8_t *, int64_t, int64_t,
                 int64_t, int, int, int, int, uint32_t *);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[2] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f + 4 < argc; f += 5) {
        int scheme = atoi(argv[f + 1]), two_d = atoi(argv[f + 2]);
        int64_t W = atol(argv[f + 3]), H = atol(argv[f + 4]);
        long n;
        uint8_t *base = load(argv[f], &n);
        int64_t size = ccitt_state_size(W, scheme == 4 || two_d);
        uint32_t *kept = calloc((size_t)size, sizeof(uint32_t));
        FOR_EACH_INPUT(base, n, mutations, {
            int64_t w = it & 1 ? 1 + rand() % 300 : W;
            int64_t h = it & 1 ? 1 + rand() % 40 : H;
            int64_t rowbytes = (w + 7) / 8;
            uint32_t *state = kept;
            if (it & 1)
                state = calloc((size_t)ccitt_state_size(w, scheme == 4 ||
                                                        two_d),
                               sizeof(uint32_t));
            uint8_t *o = calloc((size_t)(h * rowbytes), 1);
            counts[ccitt_decode(d, m, o, h, w, rowbytes, scheme, two_d,
                                rand() & 1, rand() & 1, state)]++;
            free(o);
            if (state != kept)
                free(state);
        });
        free(kept);
        free(base);
    }
    printf("{\"decoded\": %ld, \"damaged\": %ld}\n", counts[0],
           counts[1]);
    return 0;
}
"""

# the inputs' bytes as L*a*b* (8 and 16 bits), CMYK and YCbCr samples
COLOR_HARNESS = LOOP + r"""
void tiff_lab_to_rgb(const void *, int64_t, int, float, float, float,
                     const float *, uint8_t *);
void tiff_cmyk_to_rgb(const uint8_t *, int64_t, uint8_t *);
void tiff_ycbcr_to_rgb(const uint8_t *, int64_t, const int32_t *,
                       uint8_t *);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), pixels = 0;
    srand((unsigned)atoi(argv[2]));
    float ramp[1501];
    int32_t tab[1280];
    for (int i = 0; i < 1501; i++)
        ramp[i] = 255.0F * (float)i / 1500;
    for (int i = 0; i < 1280; i++)
        tab[i] = (i % 256 - 128) * (i < 768 ? 1 : 65536);
    for (int f = 3; f < argc; f++) {
        long n;
        uint8_t *base = load(argv[f], &n);
        FOR_EACH_INPUT(base, n, mutations, {
            uint8_t *o = malloc((size_t)(m + 3));
            tiff_lab_to_rgb(d, m / 3, 8, 96.4F, 100.0F, 82.5F, ramp, o);
            tiff_lab_to_rgb(d, m / 6, 16, 96.4F, 100.0F, 82.5F, ramp, o);
            tiff_cmyk_to_rgb(d, m / 4, o);
            tiff_ycbcr_to_rgb(d, m / 3, tab, o);
            pixels += m / 3;
            free(o);
        });
        free(base);
    }
    printf("{\"pixels\": %ld}\n", pixels);
    return 0;
}
"""

RLE_HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int bmp_rle_decode(const uint8_t *, int64_t, int, int64_t, int64_t,
                   uint8_t *);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[2] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f + 2 < argc; f += 3) {
        int64_t W = atol(argv[f + 1]), H = atol(argv[f + 2]);
        FILE *fp = fopen(argv[f], "rb");
        fseek(fp, 0, SEEK_END);
        long n = ftell(fp);
        fseek(fp, 0, SEEK_SET);
        uint8_t *base = malloc((size_t)n);
        if (fread(base, 1, (size_t)n, fp) != (size_t)n)
            return 2;
        fclose(fp);
        for (long it = 0; it < n + mutations; it++) {
            long m = it < n ? it : n;
            uint8_t *d = malloc((size_t)(m > 0 ? m : 1));
            memcpy(d, base, (size_t)m);
            if (it >= n)
                for (int k = 1 + rand() % 4; k > 0; k--)
                    d[rand() % m] = (uint8_t)rand();
            int64_t w = it & 1 ? 1 + rand() % 64 : W;
            int64_t h = it & 1 ? 1 + rand() % 64 : H;
            uint8_t *o = malloc((size_t)(w * h));
            counts[bmp_rle_decode(d, m, (int)(it >> 1 & 1), w, h, o)]++;
            free(o);
            free(d);
        }
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld}\n", counts[0], counts[1]);
    return 0;
}
"""


def seeds(rng) -> list:
    """Small files of the port's encoder in several modes, and the same
    with the damage libjpeg reads past: restart markers out of order and
    bytes before markers (the decoder's resync and skip paths); every
    seed's truncations drive the zero-bit padding."""
    im = rng.integers(0, 256, (37, 53, 3), np.uint8)
    cmyk = np.concatenate([im, im[..., :1]], axis=-1)
    files = [encode_jpeg(im, 90, "420", 2), encode_jpeg(im, 75, "444"),
             encode_jpeg(im, 95, "411", 3), encode_jpeg(im, 50, "440"),
             encode_jpeg(im[..., 1], 90, restart_interval=1),
             encode_jpeg(cmyk, 80, "444", 2, adobe_transform=0),
             encode_jpeg(cmyk, 85, "420", 0, adobe_transform=2)]
    def restarts(data):
        return [i for i in range(len(data) - 1)
                if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]

    rst = bytearray(files[0])
    for k, i in enumerate(restarts(rst)[:6]):  # RSTn -> RSTn+1..n+3
        rst[i + 1] = 0xD0 + ((rst[i + 1] - 0xD0 + 1 + k % 3) & 7)
    at = restarts(files[4])[0]
    junk = files[4][:at] + b"\x12\x34\xff\x00\x56" + files[4][at:]
    small = im[:19, :27]
    files += [encode_jpeg(im, 80, "420", 3, arithmetic=True),
              encode_jpeg(im, 90, "422", arithmetic=True, progressive=True,
                          restart_interval=4),
              encode_jpeg(im[..., 0], 70, arithmetic=True, progressive=True,
                          conditioning=(1, 4, 8)),
              encode_jpeg(cmyk, 85, "420", arithmetic=True,
                          adobe_transform=2),
              encode_jpeg(small[..., 1], lossless=True, predictor=5),
              encode_jpeg(small, lossless=True, predictor=7,
                          point_transform=2, restart_interval=3),
              encode_jpeg(small[..., 2] >> 2, lossless=True, predictor=4,
                          precision=6)]
    # a JPEG-compressed TIFF's strips, each behind the file's tables, as
    # libtiff hands them to the decoder
    tif = encode_tiff(im, "jpeg", rows_per_strip=16, quality=85)
    tags = _ifd(tif, "")[0]
    tables = _jpeg_tables(tags)
    for off, n in zip(tags["strip_offsets"], tags["strip_counts"]):
        files.append(b"\xff\xd8" + tables + tif[off + 2:off + n])
    return files + [bytes(rst), junk]


def tiff_seeds(rng) -> list:
    """(stream, decoded size, codec) of LZW and PackBits strips, and the
    LZW strip of a float64 BigTIFF (the floating-point predictor's bytes
    of 8-byte samples)."""
    im = rng.integers(0, 256, (16, 40), np.uint8)
    im[:, 20:] = im[:, 20:21]  # runs
    raw = im.tobytes()
    depth = rng.uniform(0.5, 8.0, (8, 24))
    big = encode_tiff(depth, "lzw", 3, bigtiff=True)
    tags = _ifd(big, "")[0]
    off, n = tags["strip_offsets"][0], tags["strip_counts"][0]
    codes = (np.cumsum(rng.integers(-3, 4, (16, 40)), 1) + 16000).astype(
        np.int16)
    return [(lzw_encode(raw), len(raw), "lzw"),
            (packbits_encode(raw), len(raw), "packbits"),
            (lzw_encode(raw * 9), 9 * len(raw), "lzw"),
            (big[off:off + n], depth.nbytes, "lzw"),
            (lzw_encode(raw * 9, old_style=True), 9 * len(raw), "lzwold"),
            (logl_encode(codes), codes.size, "logl")]


def tiff_leftover_seeds(rng) -> tuple:
    """The strips of the TIFF kinds read since the decoder's separate JPEG
    planes, predicted YCbCr tiles and LogLuv32: (the one-component JPEG
    streams of a JPEG TIFF of separate planes, each behind the file's
    tables, and of one whose strips hold fewer rows than RowsPerStrip; the
    LZW tiles of YCbCr 2 x 2 data units under the horizontal predictor and
    a LogLuv32 strip 40 pixels wide, as :func:`tiff_seeds` gives its
    strips)."""
    im = rng.integers(0, 256, (32, 40, 3), np.uint8)
    im[:, 20:] = np.cumsum(rng.integers(-3, 4, (32, 20, 3)), 1) % 256
    jpeg = []
    tif = encode_tiff(im, "jpeg", planar=2, photometric=2, rows_per_strip=16)
    tags = _ifd(tif, "")[0]
    tables = _jpeg_tables(tags)
    for off, n in zip(tags["strip_offsets"], tags["strip_counts"]):
        jpeg.append(b"\xff\xd8" + tables + tif[off + 2:off + n])
    jpeg.append(encode_jpeg(np.ascontiguousarray(im[:12, :, 1]), 90))
    tif = encode_tiff(im, "lzw", predictor=2, photometric=6,
                      subsampling=(2, 2), tile=(16, 16))
    tags = _ifd(tif, "")[0]
    strips = [(tif[off:off + n], 8 * 8 * 6, "lzw") for off, n in zip(
        tags["tile_offsets"], tags["tile_counts"])][:2]
    codes = rng.integers(0, 1 << 32, (16, 40), dtype=np.uint64).astype(
        np.uint32)
    codes[:, 20:] = codes[:, 20:21]  # runs
    strips.append((logl_encode(codes, planes=4), codes.size * 3, "logluv"))
    return jpeg, strips


def ccitt_seeds(rng) -> list:
    """(strip, scheme, 2-D, width, rows) of each CCITT scheme over blobs
    and noise."""
    yy, xx = np.mgrid[:24, :150]
    bits = (np.sin(xx / 5.0) * np.cos(yy / 3.0) > 0.2).astype(np.uint8)
    bits[12:] = rng.integers(0, 2, (12, 150))
    out = []
    for scheme, options in ((2, 0), (32771, 0), (3, 0), (3, 1), (3, 5),
                            (4, 0)):
        out.append((ccitt_encode(bits, scheme, options), scheme,
                    options & 1, 150, 24))
    return out


def rle_seeds(rng) -> list:
    """(data, width, height) of RLE8 and RLE4 rows."""
    idx = rng.integers(0, 16, (12, 30), np.uint8)
    idx[:, 10:] = idx[:, 10:11]
    return [(_rle_rows(idx, False), 30, 12), (_rle_rows(idx, True), 30, 12)]


def webp_seeds(rng) -> list:
    """(bitstream, kind: l VP8L / v VP8 / a ALPH, width, height)."""
    im = rng.integers(0, 256, (13, 21, 4), np.uint8)
    im[:, 10:] = im[:, 10:11]
    out = []
    for img, cache in ((im[..., :3], 6), (im, 0), (im[..., :3] // 64, 3)):
        data = webp.encode_webp_lossless(img, cache)
        f = webp.parse_headers(data, True, True)
        out.append((data[f["offset"]:], "l", f["width"], f["height"]))
    for name in ("lossy_alpha.webp", "lossless_alpha.webp"):
        with open(os.path.join(REPO, "tests", "data", "webp", name),
                  "rb") as fh:
            data = fh.read()
        f = webp.parse_headers(data, True, True)
        W, H = f["width"], f["height"]
        out.append((data[f["offset"]:], "l" if f["lossless"] else "v", W,
                    H))
        if f["alpha"] is not None:
            start, size = f["alpha"]
            out.append((data[start:start + size], "a", W, H))
    out.append((bytes([0]) + im[..., 3].tobytes(), "a", 21, 13))
    return out


def gif_seeds(rng) -> list:
    """(LZW data, minimum code size, pixels)."""
    out = []
    for mcs in (2, 4, 8):
        idx = rng.integers(0, 1 << mcs, (9, 17), np.uint8)
        idx[:, 8:] = idx[:, 8:9]
        out.append((gif._lzw(idx.ravel(), mcs), mcs, idx.size))
    return out


def hdr_seeds(rng) -> list:
    """(pixel data, width, height): run-length and flat scanlines."""
    f = (rng.random((4, 19, 3)) * 3).astype(np.float32)
    out = []
    for rle in ("new", "flat"):
        data = hdr.encode_hdr(f, rle=rle)
        out.append((data[hdr.header(data)[2]:], 19, 4))
    return out


J2K_HARNESS = LOOP + r"""
int j2k_header(const uint8_t *, int64_t, int64_t *, char *, int);
int j2k_decode(const uint8_t *, int64_t, int32_t *, char *, int);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[4] = {0}, skipped = 0;
    char err[256];
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f < argc; f++) {
        long n;
        uint8_t *base = load(argv[f], &n);
        FOR_EACH_INPUT(base, n, mutations, {
            int64_t info[22];
            int st = j2k_header(d, m, info, err, sizeof err);
            if (!st && info[21] > (1 << 22))
                skipped++;  /* more samples than the seeds: not decoded */
            else {
                if (!st) {
                    int32_t *o = malloc(sizeof(int32_t)
                                        * (size_t)(info[21] ? info[21] : 1));
                    st = j2k_decode(d, m, o, err, sizeof err);
                    free(o);
                }
                counts[st]++;
            }
        })
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld, \"not_decoded\": %ld, "
           "\"out_of_memory\": %ld, \"too_large\": %ld}\n", counts[0],
           counts[1], counts[2], counts[3], skipped);
    return 0;
}
"""


AV1_HARNESS = LOOP + r"""
int av1_info(const uint8_t *, int64_t, int, int, int32_t *, char *, int);
int av1_decode(const uint8_t *, int64_t, int, int, uint16_t *, int, int64_t,
               int64_t, char *, int);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[4] = {0}, skipped = 0;
    char err[256];
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f < argc; f++) {
        long n;
        uint8_t *base = load(argv[f], &n);
        FOR_EACH_INPUT(base, n, mutations, {
            int32_t info[20];
            int st = av1_info(d, m, 0, -1, info, err, sizeof err);
            int planes = info[3] ? 1 : 3;
            if (!st && (int64_t)info[0] * info[1] > (1 << 20))
                skipped++;  /* more samples than the seeds: not decoded */
            else {
                if (!st) {
                    uint16_t *o = malloc(sizeof(uint16_t) * (size_t)planes
                                         * (size_t)info[0] * info[1]);
                    st = av1_decode(d, m, 0, -1, o, planes, info[1],
                                    info[0], err, sizeof err);
                    free(o);
                }
                counts[st]++;
            }
        })
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld, \"not_decoded\": %ld, "
           "\"out_of_memory\": %ld, \"too_large\": %ld}\n", counts[0],
           counts[1], counts[2], counts[3], skipped);
    return 0;
}
"""


def av1_seeds(rng) -> list:
    """The AV1 streams of the committed AVIF files of ``tests/data/avif``
    (every av01 item, alpha included; the 480 x 640 frames left out: each
    of their truncations decodes for a tenth of a second) and of the
    port's writer: lossless colour and gray, 8 / 10 / 12 bits, 24 x 40 and
    17 x 9, lossless 4:2:0 and 4:2:2, lossy 4:2:0 at 8 and 10 bits, 4:2:2
    and gray with quantiser matrices, deblocking and CDEF, and 70 x 98
    frames with loop restoration (every type, 8 to 12 bits, 4:2:0 and
    4:2:2, 128 x 128 superblocks, gray), and frames with film grain (the
    committed grain files, Pillow's and the writer's, the grid tiles and
    the sequences' first samples among the above; the writer's 10- and
    12-bit grain at 4:4:4, 4:2:2, 4:2:0 and gray, lags 0-3, chroma scaling
    from luma, no overlap, the clip)."""
    from lgu_slam_tpu_torch.data import avif

    folder = os.path.join(REPO, "tests", "data", "avif")
    out = []
    for name in sorted(os.listdir(folder)):
        if not name.endswith(".avif") or "480x640" in name:
            continue
        with open(os.path.join(folder, name), "rb") as fh:
            data = fh.read()
        try:
            box = avif.parse(data)
            out += [avif._payload(data, box, item) for item in
                    box["items"].values() if item.get("type") == b"av01"]
            # a sequence's first samples (its colour and alpha tracks)
            out += [avif._payload(data, box, item) for item in
                    (box["color"], box["alpha"]) if item is not None and
                    item.get("track")]
        except (ValueError, NotImplementedError):
            continue
    for k, (shape, depth) in enumerate((((3, 24, 40), 8), ((1, 24, 40), 8),
                                        ((3, 17, 9), 10), ((1, 17, 9), 12))):
        planes = rng.integers(0, 1 << depth, shape).astype(np.uint16)
        planes[:, :8] = planes[:, :1]  # flat rows: predictions that hit
        out.append(avif.encode_av1(planes, depth, k))
    img = np.cumsum(rng.integers(-6, 7, (24, 40, 3)), 1) + 128
    img = img.clip(0, 255).astype(np.uint16)
    lossy = [dict(base_q=90, qm=6, block=8, lf=(12, 9, 4, 3), sharpness=2,
                  cdef_damping=4, cdef=[(3, 1, 2, 0), (6, 4, 1, 1)]),
             dict(base_q=200, block=16, lf=(40, 40, 20, 20), cdef_damping=6,
                  cdef=[(15, 4, 15, 4)])]
    for depth in (8, 10):
        planes = avif.yuv420(img << (depth - 8), depth)
        out.append(avif.encode_av1(planes, depth, depth, True))
        for k, opts in enumerate(lossy):
            out.append(avif.encode_av1(planes, depth, k, True, opts))
    out.append(avif.encode_av1([img[..., 1]], 8, 3, False, lossy[0]))
    grains = [dict(vector=2, ar_coeff_lag=0), dict(vector=4, ar_coeff_lag=1),
              dict(vector=3, chroma_scaling_from_luma=1),
              dict(vector=9, clip_to_restricted_range=1, overlap_flag=0),
              dict(vector=16, grain_scale_shift=3, scaling_shift=8), 5]
    for k, grain in enumerate(grains):
        depth, sub = (10, 12)[k % 2], (0, "4:2:2", "4:2:0")[k % 3]
        if k == 5:
            out.append(avif.encode_av1([img[..., 1] << 4], 12, k,
                                       grain=grain))
            continue
        planes = [p << (depth - 8) for p in avif.yuv_planes(
            img, 8, sub)] if sub else list(np.moveaxis(img, -1, 0)
                                           << (depth - 8))
        out.append(avif.encode_av1(planes, depth, k, sub, grain=grain))
    # 4:2:2, lossless and lossy; loop restoration of every type on each
    # plane, units of 64 and 128 samples, 128 x 128 superblocks
    units = [[("wiener", (3, -7, 15), (-5, 8, 46)), ("sgrproj", 10, (0, 95)),
              ("none",), ("sgrproj", 14, (-96, 0))],
             [("sgrproj", 3, (31, -32)), ("wiener", (0, -23, -17),
                                          (0, 8, 46))],
             [("wiener", (0, 4, 2), (0, -1, 9)), ("none",)]]
    wide = np.cumsum(rng.integers(-6, 7, (70, 98, 3)), 1) + 128
    wide = wide.clip(0, 255).astype(np.uint16)
    for depth, sub, sb128, shift in ((8, "4:2:0", False, 0),
                                     (10, "4:2:2", True, 1),
                                     (12, "4:2:0", True, 1)):
        planes = avif.yuv_planes(wide << (depth - 8), depth, sub)
        lr = dict(types=("switchable", "switchable", "wiener"),
                  unit_shift=shift, uv_shift=int(sub == "4:2:0"),
                  units=units)
        out.append(avif.encode_av1(planes, depth, depth, sub,
                                   dict(lossy[0], lr=lr), sb128=sb128))
    planes = avif.yuv_planes(img, 8, "4:2:2")
    out.append(avif.encode_av1(planes, 8, 5, "4:2:2"))
    out.append(avif.encode_av1(planes, 8, 6, "4:2:2", lossy[1]))
    out.append(avif.encode_av1([wide[..., 1]], 8, 7, False, dict(
        lossy[1], lr=dict(types=("wiener", "none", "none"),
                          units=[units[0][:1] + [("none",)]]))))
    out += tools_seeds(img, wide)
    return out


def tools_seeds(img, wide) -> list:
    """Slice 23's writer seeds: segmented frames (alt q with a lossless
    segment, alt loop filter levels, skip: SegIdPreSkip 0 and 1; 4:2:0,
    4:4:4, 12-bit gray), superres frames (with restoration, two tile
    columns, a frame 14 samples wide) and items of several frames (a
    hidden key frame, an intra-only frame of another size, show_existing
    of each; a second sequence header).  The committed files add cv2's
    and Pillow's lossy and lossless intra block copy."""
    from lgu_slam_tpu_torch.data import avif

    out = []
    segs = [dict(base_q=80, lf=(8, 8, 4, 4), segments=[
                dict(alt_q=-80), dict(lf_y_v=9, lf_v=-3), dict(alt_q=40)]),
            dict(base_q=60, lf=(6, 6, 3, 3), cdef=[(4, 1, 2, 1)],
                 segments=[dict(skip=True), dict(alt_q=-20, lf_y_h=5)])]
    planes = avif.yuv_planes(wide, 8, "4:2:0")
    for k, seg in enumerate(segs):
        out.append(avif.encode_av1(planes, 8, k, "4:2:0", seg))
    out.append(avif.encode_av1(list(np.moveaxis(img, -1, 0)), 8, 2, 0,
                               segs[0]))
    out.append(avif.encode_av1([wide[..., 1] << 4], 12, 3, False, segs[1]))
    big = np.concatenate([wide, wide[:, ::-1]], 1)
    lr = dict(types=("switchable", "sgrproj", "wiener"), units=[
        [("wiener", (3, -7, 15), (-5, 8, 46)), ("sgrproj", 10, (0, 95))],
        [("sgrproj", 3, (31, -32))], [("wiener", (0, 4, 2), (0, -1, 9))]])
    out.append(avif.encode_av1(avif.yuv_planes(big, 8, "4:2:0"), 8, 4,
                               "4:2:0", dict(segs[0], lr=lr), superres=11,
                               tile_cols_log2=1))
    out.append(avif.encode_av1(avif.yuv_planes(wide[:, :14], 8, "4:2:0"),
                               8, 5, "4:2:0", dict(base_q=70, lr=lr),
                               superres=16))
    hidden = dict(type="key", show=False, showable=True, refresh=1,
                  max_size=(98, 70))
    small = list(np.moveaxis(img, -1, 0))
    out.append(avif.frames_av1([
        dict(planes=list(np.moveaxis(wide, -1, 0)), frame=hidden),
        dict(planes=small, seed=1, frame=dict(
            type="intra", refresh=2, max_size=(98, 70))), 0, 1]))
    out.append(avif.encode_av1(small, 8, 6) + avif.encode_av1(
        [img[..., 1] << 2], 10, 7))
    return out


def jp2_seeds() -> list:
    """The codestreams of the committed 96 x 128 JPEG 2000 files."""
    folder = os.path.join(REPO, "tests", "data", "jp2")
    out = []
    for name in sorted(os.listdir(folder)):
        if name.startswith("frame_") or not name.endswith((".jp2", ".j2k")):
            continue
        with open(os.path.join(folder, name), "rb") as fh:
            data = fh.read()
        out.append(data[data.index(b"\xff\x4f\xff\x51"):])
    return out


def ht_seeds(rng) -> list:
    """HTJ2K codestreams of the port's writer (module docstring)."""
    from lgu_slam_tpu_torch.data.jp2 import encode_jp2

    im = np.cumsum(rng.integers(-6, 7, (32, 48, 3)), 1) + 128
    im = (im + rng.integers(-9, 10, im.shape)).clip(0, 255).astype(np.uint8)
    gray16 = im[..., 1].astype(np.uint16) * 257 + im[..., 2]
    kinds = [dict(), dict(refine=1), dict(refine=2), dict(skip=2),
             dict(refine=2, skip=1), dict(irreversible=True, refine=2),
             dict(cblk=(4, 1024)), dict(cblk=(1024, 4), refine=2),
             dict(tile=(16, 32), levels=2, refine=1),
             dict(vcausal=True, refine=2, cblk=(8, 8))]
    return [encode_jp2(im, codestream=True, ht=True, **kw) for kw in kinds] \
        + [encode_jp2(gray16, codestream=True, ht=True, refine=2)]


def logluv24_seeds(rng) -> list:
    """(stream, decoded size, codec) of LogLuv24 strips: random 24-bit
    codes, some uv indices past the table; decoded to 8-bit RGB."""
    codes = rng.integers(0, 1 << 24, (16, 40)).astype(np.uint32)
    codes[:, :4] = (codes[:, :4] & np.uint32(0xffc000)) | rng.integers(
        16280, 16384, (16, 4)).astype(np.uint32)
    raw = codes.astype(">u4").view(np.uint8).reshape(16, 40, 4)[..., 1:]
    return [(raw.tobytes(), 3 * codes.size, "logluv24")]


def fuzz_bmp_masks(rng, mutations: int) -> str:
    """32-bit BI_BITFIELDS BMPs (40-, 56-, 108- and 124-byte headers;
    BGRA, RGBA-order, 10-10-10, 5-6-5, odd and zero masks) cut at every
    length and mutated in 1-4 bytes, through ``decode_bmp`` in both modes:
    only ValueError may be raised."""
    from lgu_slam_tpu_torch.data.image_io import decode_bmp, encode_bmp

    im = rng.integers(0, 256, (5, 7, 4), np.uint8)
    masks = [(0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000),
             (0x3FF00000, 0xFFC00, 0x3FF), (0xF800, 0x7E0, 0x1F),
             (0x1F0, 0x7, 0xE0000), (0, 0xFF00, 0xFF)]
    seeds = [encode_bmp(im, top, masks32=m, header=h) for h in
             (40, 56, 108, 124) for m in masks for top in (False, True)]
    counts = {"decoded": 0, "corrupt": 0}
    per_seed = max(1, mutations // len(seeds))
    for data in seeds:
        cases = [data[:k] for k in range(len(data))]
        for _ in range(per_seed):
            d = bytearray(data)
            for _ in range(int(rng.integers(1, 5))):
                d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
            cases.append(bytes(d))
        for case in cases:
            for gray in (False, True):
                try:
                    decode_bmp(case, gray=gray)
                    counts["decoded"] += 1
                except ValueError:
                    counts["corrupt"] += 1
    return "{" + ", ".join(f'"{k}": {v}' for k, v in counts.items()) + "}"


def fuzz_av1(tmp, args) -> str:
    """The AV1 decoder's harness over :func:`av1_seeds` (a generator of
    its own, so that the other seeds stay as they were)."""
    paths = []
    for k, data in enumerate(av1_seeds(np.random.default_rng(args.seed
                                                             + 19))):
        paths.append(os.path.join(tmp, f"av1_{k}"))
        with open(paths[-1], "wb") as fh:
            fh.write(data)
    return _run(tmp, "fuzz_av1", AV1_HARNESS, ["av1_decode.c"], paths,
                args.mutations, args.seed)


def _run(tmp, name, harness, sources, args, mutations, seed) -> str:
    """Build ``harness`` with ``sources`` under the sanitizers and run it
    on ``args`` (files and their parameters)."""
    path = os.path.join(tmp, f"{name}.c")
    with open(path, "w") as fh:
        fh.write(harness)
    exe = os.path.join(tmp, name)
    subprocess.run([_cc(), "-O1", "-g", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=all", "-o", exe, path,
                    *[str(CSRC / "host" / s) for s in sources], "-lm"],
                   check=True)
    out = subprocess.run([exe, str(mutations), str(seed), *args],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"the sanitizers stopped {name}:\n"
                         f"{out.stderr[-4000:]}")
    return out.stdout.strip()


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--mutations", type=int, default=20000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--files", nargs="*", default=[],
                   help="more JPEG seed files")
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    # the TIFF leftovers' seeds from a generator of their own, so that the
    # other seeds stay as they were
    more_jpeg, more_tiff = tiff_leftover_seeds(
        np.random.default_rng(args.seed + 17))
    more_tiff += logluv24_seeds(np.random.default_rng(args.seed + 18))
    with tempfile.TemporaryDirectory() as tmp:
        def write(name, data):
            path = os.path.join(tmp, name)
            with open(path, "wb") as fh:
                fh.write(data)
            return path

        jpeg = [write(f"seed{k}.jpg", d) for k, d in enumerate(
            seeds(rng) + more_jpeg)]
        tiff_args = []
        for k, (data, size, codec) in enumerate(tiff_seeds(rng) + more_tiff):
            tiff_args += [write(f"strip{k}_{codec}", data), str(size)]
        rle_args = []
        for k, (data, w, h) in enumerate(rle_seeds(rng)):
            rle_args += [write(f"rle{k}", data), str(w), str(h)]
        lines = [
            "jpeg " + _run(tmp, "fuzz_jpeg", HARNESS, ["jpeg_decode.c"],
                           jpeg + args.files, args.mutations, args.seed),
            "tiff " + _run(tmp, "fuzz_tiff", TIFF_HARNESS, ["tiff_lzw.c"],
                           tiff_args, args.mutations, args.seed),
            "bmp_rle " + _run(tmp, "fuzz_rle", RLE_HARNESS, ["bmp_rle.c"],
                              rle_args, args.mutations, args.seed)]
        ccitt_args = []
        for k, (data, scheme, two_d, w, h) in enumerate(ccitt_seeds(rng)):
            ccitt_args += [write(f"ccitt{k}", data), str(scheme), str(two_d),
                           str(w), str(h)]
        lines += [
            "ccitt " + _run(tmp, "fuzz_ccitt", CCITT_HARNESS,
                            ["ccitt_decode.c"], ccitt_args, args.mutations,
                            args.seed),
            "tiff_color " + _run(tmp, "fuzz_color", COLOR_HARNESS,
                                 ["tiff_color.c"], jpeg[:3] + tiff_args[::2],
                                 args.mutations, args.seed)]
        webp_args, gif_args, hdr_args = [], [], []
        for k, (data, kind, w, h) in enumerate(webp_seeds(rng)):
            webp_args += [write(f"webp{k}", data), kind, str(w), str(h)]
        for k, (data, mcs, npix) in enumerate(gif_seeds(rng)):
            gif_args += [write(f"gif{k}", data), str(mcs), str(npix)]
        for k, (data, w, h) in enumerate(hdr_seeds(rng)):
            hdr_args += [write(f"hdr{k}", data), str(w), str(h)]
        lines += [
            "webp " + _run(tmp, "fuzz_webp", WEBP_HARNESS,
                           ["webp_decode.c"], webp_args, args.mutations,
                           args.seed),
            "gif " + _run(tmp, "fuzz_gif", GIF_HARNESS, ["gif_lzw.c"],
                          gif_args, args.mutations, args.seed),
            "hdr " + _run(tmp, "fuzz_hdr", HDR_HARNESS, ["hdr_rgbe.c"],
                          hdr_args, args.mutations, args.seed)]
        j2k_args = [write(f"j2k{k}", d) for k, d in enumerate(jp2_seeds())]
        ht_args = [write(f"ht{k}", d) for k, d in enumerate(
            ht_seeds(np.random.default_rng(args.seed + 18)))]
        lines += [
            "j2k " + _run(tmp, "fuzz_j2k", J2K_HARNESS, ["j2k_decode.c"],
                          j2k_args, args.mutations, args.seed),
            "ht " + _run(tmp, "fuzz_ht", J2K_HARNESS, ["j2k_decode.c"],
                         ht_args, args.mutations, args.seed),
            "bmp_masks " + fuzz_bmp_masks(rng, args.mutations),
            "av1 " + fuzz_av1(tmp, args)]
    out = "\n".join(lines)
    print(out)
    return out


if __name__ == "__main__":
    main()
