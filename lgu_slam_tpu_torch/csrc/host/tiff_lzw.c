/* TIFF strip and tile decoding for the port's data layer: the LZW and
 * PackBits decoders, the SGI LogL, LogLuv32 and LogLuv24 decoders (LogLuv
 * to libtiff's 8-bit RGB; LogLuv24's colour index through libtiff's uv
 * table, tiff_uvtable.h) and the inverse of the horizontal
 * (predictor 2) and floating-point (predictor 3) predictors, as libtiff 4.7
 * (tif_lzw.c, tif_packbits.c, tif_luv.c, tif_predict.c) applies them for
 * cv2.imread.
 *
 * Each decoder fills exactly `occ` bytes (a strip or a tile) and returns
 * TIFF_OK, or TIFF_CORRUPT where libtiff reports an error (the data ends
 * before the strip is full, a code past the table); the bytes it could not
 * decode are then zero.  Extra data past `occ` is ignored, as libtiff
 * ignores it.  Every read of the input is bounds-checked.
 *
 * Built by the host C compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/data/tiff.py).
 */
#define _DEFAULT_SOURCE /* M_LN2 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "tiff_uvtable.h"

#define TIFF_OK 0
#define TIFF_CORRUPT 1
#define TIFF_UNSUPPORTED 2
#define TIFF_NOMEM 3

#define LZW_CLEAR 256
#define LZW_EOI 257
#define LZW_FIRST 258
#define LZW_BITS_MAX 12
/* libtiff's table: 2^12 codes plus 1024 slack entries for encoders that
 * are late to emit a clear code (tif_lzw.c CSIZE) */
#define LZW_CSIZE ((1 << LZW_BITS_MAX) - 1 + 1024)

typedef struct {
    int64_t at;      /* where the output holds the string but its last byte */
    uint32_t length;
    uint8_t last;    /* its last byte */
    uint8_t first;   /* its first byte */
} lzw_entry;

/* LZW of TIFF 6.0 section 13: codes of 9 to 12 bits, most significant bit
 * first, the code width growing one code early (at 511, 1023, 2047).
 * With `old_style`, the pre-6.0 coding libtiff still reads
 * (tif_lzw.c LZWDecodeCompat): codes least significant bit first, the
 * width growing when the table reaches 512, 1024, 2048.  libtiff takes a
 * strip that starts with the bytes 0x00 and an odd byte for old-style,
 * and decodes every strip of the image as its first strip is coded; the
 * caller decides (tiff_lzw_old_style on that strip). */
int tiff_lzw_old_style(const uint8_t *src, int64_t n)
{
    return n >= 2 && src[0] == 0 && (src[1] & 1);
}

int tiff_lzw_decode(const uint8_t *src, int64_t n, uint8_t *dst, int64_t occ,
                    int old_style)
{
    /* the table's last entry before the code width grows */
    const int early = old_style ? 1 : 2;
    lzw_entry *tab = malloc(sizeof(lzw_entry) * LZW_CSIZE);
    if (tab == NULL)
        return TIFF_NOMEM;
    for (int i = 0; i < 256; i++) {
        tab[i].at = 0;
        tab[i].last = tab[i].first = (uint8_t)i;
        tab[i].length = 1;
    }
    int64_t pos = 0, out = 0;
    uint64_t acc = 0;
    /* old: the previous code; -1 right after a clear code, -2 before the
     * first (libtiff: "Using code not yet in table" for any other code) */
    int accbits = 0, nbits = 9, free_ent = LZW_FIRST, old = -2;
    int status = TIFF_OK;
    while (out < occ) {
        while (accbits < nbits && pos < n) {
            if (old_style)
                acc |= (uint64_t)src[pos++] << accbits;
            else
                acc = acc << 8 | src[pos++];
            accbits += 8;
        }
        if (accbits < nbits)
            break; /* the data ends without an EOI code: libtiff's warning */
        int code;
        if (old_style) {
            code = (int)(acc & ((1u << nbits) - 1));
            acc >>= nbits;
        } else {
            code = (int)(acc >> (accbits - nbits)) & ((1 << nbits) - 1);
        }
        accbits -= nbits;
        if (code == LZW_EOI)
            break;
        if (code == LZW_CLEAR) {
            nbits = 9;
            free_ent = LZW_FIRST;
            old = -1;
            continue;
        }
        if (old < 0) { /* the first code after a clear: a byte */
            if (code > 255 || old == -2) {
                status = TIFF_CORRUPT;
                break;
            }
            dst[out++] = (uint8_t)code;
            old = code;
            continue;
        }
        if (code > free_ent || free_ent >= LZW_CSIZE) {
            status = TIFF_CORRUPT; /* "Corrupted LZW table" */
            break;
        }
        /* the new entry: the previous string, which the output ends with,
         * and the first byte of this one (of the previous one where this
         * code is the new entry) */
        lzw_entry *e = &tab[free_ent];
        e->at = out - tab[old].length;
        e->first = tab[old].first;
        e->last = code == free_ent ? tab[old].first : tab[code].first;
        e->length = tab[old].length + 1;
        free_ent++;
        if (free_ent > (1 << nbits) - early && nbits < LZW_BITS_MAX)
            nbits++;
        /* the string of code, copied from where the output holds it but
         * its last byte (its first bytes only where the output ends) */
        int64_t len = tab[code].length, room = occ - out;
        int64_t head = len - 1 < room ? len - 1 : room;
        if (head < 16)
            for (int64_t k = 0; k < head; k++)
                dst[out + k] = dst[tab[code].at + k];
        else
            memcpy(dst + out, dst + tab[code].at, (size_t)head);
        if (len <= room)
            dst[out + head] = tab[code].last;
        out += len <= room ? len : room;
        old = code;
    }
    if (status == TIFF_OK && out < occ)
        status = TIFF_CORRUPT; /* "Not enough data at scanline" */
    if (out < occ)
        memset(dst + out, 0, (size_t)(occ - out));
    free(tab);
    return status;
}

/* PackBits (tif_packbits.c PackBitsDecode): a header byte n, then n + 1
 * literal bytes (0 <= n <= 127) or one byte repeated 1 - n times
 * (-127 <= n <= -1); -128 is skipped.  Runs longer than the space left
 * are cut to it. */
int tiff_packbits_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                         int64_t occ)
{
    int64_t pos = 0, out = 0;
    while (pos < n && out < occ) {
        int h = (int8_t)src[pos++];
        if (h == -128)
            continue;
        if (h < 0) {
            int64_t run = 1 - h;
            if (run > occ - out)
                run = occ - out;
            if (pos >= n)
                break; /* "Terminating PackBitsDecode due to lack of data" */
            memset(dst + out, src[pos++], (size_t)run);
            out += run;
        } else {
            int64_t run = h + 1;
            if (run > occ - out)
                run = occ - out;
            if (n - pos < run)
                break;
            memcpy(dst + out, src + pos, (size_t)run);
            out += run;
            pos += run;
        }
    }
    if (out < occ) {
        memset(dst + out, 0, (size_t)(occ - out));
        return TIFF_CORRUPT; /* "Not enough data for scanline" */
    }
    return TIFF_OK;
}

static inline uint16_t swap16(uint16_t v) { return (uint16_t)(v << 8 | v >> 8); }

static inline uint32_t swap32(uint32_t v)
{
    return v << 24 | (v & 0xFF00) << 8 | (v >> 8 & 0xFF00) | v >> 24;
}

static inline uint64_t swap64(uint64_t v)
{
    return (uint64_t)swap32((uint32_t)v) << 32 | swap32((uint32_t)(v >> 32));
}

/* Undo the horizontal predictor in place (tif_predict.c horAcc8/16/32/64,
 * swabHorAcc16/32/64): `rows` rows of `rowbytes` bytes, samples of `bytes`
 * bytes (1, 2, 4 or 8), `stride` samples per pixel.  With `swap` the samples
 * are byte-swapped first (a file of the other byte order); the result is
 * in the host's byte order. */
void tiff_hpredict(uint8_t *buf, int64_t rows, int64_t rowbytes,
                   int64_t stride, int bytes, int swap)
{
    int64_t count = rowbytes / bytes;
    for (int64_t y = 0; y < rows; y++) {
        uint8_t *row = buf + y * rowbytes;
        if (bytes == 1) {
            for (int64_t i = stride; i < count; i++)
                row[i] = (uint8_t)(row[i] + row[i - stride]);
        } else if (bytes == 2) {
            uint16_t *w = (uint16_t *)row;
            if (swap)
                for (int64_t i = 0; i < count; i++)
                    w[i] = swap16(w[i]);
            for (int64_t i = stride; i < count; i++)
                w[i] = (uint16_t)(w[i] + w[i - stride]);
        } else if (bytes == 4) {
            uint32_t *w = (uint32_t *)row;
            if (swap)
                for (int64_t i = 0; i < count; i++)
                    w[i] = swap32(w[i]);
            for (int64_t i = stride; i < count; i++)
                w[i] = w[i] + w[i - stride];
        } else {
            uint64_t *w = (uint64_t *)row;
            if (swap)
                for (int64_t i = 0; i < count; i++)
                    w[i] = swap64(w[i]);
            for (int64_t i = stride; i < count; i++)
                w[i] = w[i] + w[i - stride];
        }
    }
}

/* Undo the floating-point predictor in place (tif_predict.c fpAcc): each
 * row holds the bytes of its samples as `bytes` planes, most significant
 * first, each byte differenced against the byte `stride` before it.  The
 * result is the samples in the host's (little-endian) byte order.  Returns
 * TIFF_NOMEM, or TIFF_OK. */
int tiff_fpredict(uint8_t *buf, int64_t rows, int64_t rowbytes,
                  int64_t stride, int bytes)
{
    uint8_t *tmp = malloc((size_t)(rowbytes > 0 ? rowbytes : 1));
    if (tmp == NULL)
        return TIFF_NOMEM;
    int64_t wc = rowbytes / bytes;
    for (int64_t y = 0; y < rows; y++) {
        uint8_t *row = buf + y * rowbytes;
        for (int64_t i = stride; i < rowbytes; i++)
            row[i] = (uint8_t)(row[i] + row[i - stride]);
        memcpy(tmp, row, (size_t)rowbytes);
        for (int64_t k = 0; k < wc; k++)
            for (int b = 0; b < bytes; b++)
                row[bytes * k + b] = tmp[(int64_t)(bytes - b - 1) * wc + k];
    }
    free(tmp);
    return TIFF_OK;
}

/* SGI Log (tif_luv.c LogL16Decode / LogLuvDecode32, then L16toGry /
 * Luv32toRGB as libtiff's RGBA interface asks for them,
 * SGILOGDATAFMT_8BIT): `rows` rows of `width` pixels, each row `planes`
 * run-length coded byte planes (LogL: the high bytes of the 16-bit log
 * luminances, then the low; LogLuv32: the four bytes of each 32-bit
 * pixel, most significant first), a byte >= 128 a run of (byte - 126)
 * copies of the next byte, else that many literal bytes.  Decoding stops
 * at the first row the data does not fill (TIFF_CORRUPT); that row and
 * those after it are left as they are (zeros). */

/* LogL16toY */
static double logl16_y(int p16)
{
    int le = p16 & 0x7fff;
    double y = le ? exp(M_LN2 / 256. * (le + .5) - M_LN2 * 64.) : 0.;
    return (p16 & 0x8000) ? -y : y;
}

/* 256 sqrt(v), 0 at or below 0 and 255 at or above 1 (L16toGry and
 * XYZtoRGB24's gamma of 2) */
static uint8_t gamma2(double v)
{
    return (uint8_t)(v <= 0. ? 0 : v >= 1. ? 255 : (int)(256. * sqrt(v)));
}

static uint8_t logl_gray[1 << 16];

__attribute__((constructor)) static void logl_table(void)
{
    for (int p = 0; p < 1 << 16; p++)
        logl_gray[p] = gamma2(logl16_y(p));
}

/* LogLuv32toXYZ, then XYZtoRGB24 (CCIR-709 primaries): one pixel to RGB */
static void logluv32_rgb(uint32_t p, uint8_t *rgb)
{
    float xyz[3] = {0.F, 0.F, 0.F};
    double l = logl16_y((int)p >> 16);
    if (l > 0.) {
        double u = 1. / 410. * ((p >> 8 & 0xff) + .5);
        double v = 1. / 410. * ((p & 0xff) + .5);
        double s = 1. / (6. * u - 16. * v + 12.);
        double x = 9. * u * s;
        double y = 4. * v * s;
        xyz[0] = (float)(x / y * l);
        xyz[1] = (float)l;
        xyz[2] = (float)((1. - x - y) / y * l);
    }
    rgb[0] = gamma2(2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2]);
    rgb[1] = gamma2(-1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2]);
    rgb[2] = gamma2(0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2]);
}

/* LogL10toY */
static double logl10_y(int p10)
{
    return p10 ? exp(M_LN2 * ((p10 + .5) / 64. - 12.)) : 0.;
}

/* uv_decode: the (u', v') of cell c of the uv table; -1 for an index past
 * the table (the caller then takes the neutral colour) */
static int uv_decode(double *up, double *vp, int c)
{
    int upper, lower, ui, vi;
    if (c < 0 || c >= UV_NDIVS)
        return -1;
    lower = 0;
    upper = UV_NVS;
    while (upper - lower > 1) {
        vi = (lower + upper) >> 1;
        ui = c - uv_row[vi].ncum;
        if (ui > 0)
            lower = vi;
        else if (ui < 0)
            upper = vi;
        else {
            lower = vi;
            break;
        }
    }
    vi = lower;
    ui = c - uv_row[vi].ncum;
    *up = uv_row[vi].ustart + (ui + .5) * UV_SQSIZ;
    *vp = UV_VSTART + (vi + .5) * UV_SQSIZ;
    return 0;
}

/* LogLuv24toXYZ, then XYZtoRGB24: one 24-bit pixel (10-bit log luminance,
 * 14-bit uv index) to RGB */
static void logluv24_rgb(uint32_t p, uint8_t *rgb)
{
    float xyz[3] = {0.F, 0.F, 0.F};
    double l = logl10_y((int)(p >> 14 & 0x3ff)), u, v;
    if (l > 0.) {
        double s, x, y;
        if (uv_decode(&u, &v, (int)(p & 0x3fff)) < 0) {
            u = 0.210526316; /* U_NEU, V_NEU */
            v = 0.473684211;
        }
        s = 1. / (6. * u - 16. * v + 12.);
        x = 9. * u * s;
        y = 4. * v * s;
        xyz[0] = (float)(x / y * l);
        xyz[1] = (float)l;
        xyz[2] = (float)((1. - x - y) / y * l);
    }
    rgb[0] = gamma2(2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2]);
    rgb[1] = gamma2(-1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2]);
    rgb[2] = gamma2(0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2]);
}

/* One row's `planes` byte planes into tp (zeroed first); 0 where the data
 * ends before the row does ("Not enough data at row"). */
static int sgilog_row(const uint8_t **bpp, int64_t *ccp, uint32_t *tp,
                      int64_t width, int planes)
{
    const uint8_t *bp = *bpp;
    int64_t cc = *ccp;
    memset(tp, 0, sizeof(uint32_t) * (size_t)width);
    for (int shft = 8 * (planes - 1); shft >= 0; shft -= 8) {
        int64_t i = 0;
        while (i < width && cc > 0) {
            if (*bp >= 128) { /* a run */
                if (cc < 2)
                    break;
                int rc = *bp++ + (2 - 128);
                uint32_t b = (uint32_t)*bp++ << shft;
                cc -= 2;
                while (rc-- && i < width)
                    tp[i++] |= b;
            } else { /* literal bytes; a count of 0 does nothing */
                int rc = *bp++;
                while (--cc && rc-- && i < width)
                    tp[i++] |= (uint32_t)*bp++ << shft;
            }
        }
        if (i != width)
            return 0;
    }
    *bpp = bp;
    *ccp = cc;
    return 1;
}

/* LogL: 8-bit gray rows of `width` */
int tiff_logl_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                     int64_t rows, int64_t width)
{
    uint32_t *tp = malloc(sizeof(uint32_t) * (size_t)(width > 0 ? width : 1));
    if (tp == NULL)
        return TIFF_NOMEM;
    const uint8_t *bp = src;
    int64_t cc = n;
    int status = TIFF_OK;
    for (int64_t y = 0; y < rows; y++) {
        if (!sgilog_row(&bp, &cc, tp, width, 2)) {
            status = TIFF_CORRUPT;
            break;
        }
        for (int64_t i = 0; i < width; i++)
            dst[y * width + i] = logl_gray[(uint16_t)tp[i]];
    }
    free(tp);
    return status;
}

/* LogLuv32: 8-bit RGB rows of `width` pixels */
int tiff_logluv32_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                         int64_t rows, int64_t width)
{
    uint32_t *tp = malloc(sizeof(uint32_t) * (size_t)(width > 0 ? width : 1));
    if (tp == NULL)
        return TIFF_NOMEM;
    const uint8_t *bp = src;
    int64_t cc = n;
    int status = TIFF_OK;
    for (int64_t y = 0; y < rows; y++) {
        if (!sgilog_row(&bp, &cc, tp, width, 4)) {
            status = TIFF_CORRUPT;
            break;
        }
        for (int64_t i = 0; i < width; i++)
            logluv32_rgb(tp[i], dst + 3 * (y * width + i));
    }
    free(tp);
    return status;
}

/* LogLuv24 (LogLuvDecode24): 8-bit RGB rows of `width` pixels, each pixel
 * three bytes, most significant first, uncoded; a row the data does not
 * fill stops the decoding, as in the other SGI Log decoders */
int tiff_logluv24_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                         int64_t rows, int64_t width)
{
    int64_t y, i;
    for (y = 0; y < rows; y++) {
        if (n < 3 * width)
            return TIFF_CORRUPT;
        for (i = 0; i < width; i++, src += 3)
            logluv24_rgb((uint32_t)src[0] << 16 | (uint32_t)src[1] << 8
                         | src[2], dst + 3 * (y * width + i));
        n -= 3 * width;
    }
    return TIFF_OK;
}
