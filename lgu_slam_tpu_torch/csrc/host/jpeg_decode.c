/* JPEG decoder for the port's data layer (ITU-T T.81): baseline, extended
 * sequential and progressive Huffman coding of 8-bit samples, 1 component
 * (gray) or 3 (YCbCr, or RGB by the Adobe marker or the component ids),
 * every integral sampling factor, restart intervals and the EXIF
 * orientation tag of the first APP1 segment.
 *
 * The output is what cv2.imread returns, which decodes with libjpeg-turbo's
 * defaults: the integer ISLOW inverse DCT (jidctint.c), fancy upsampling
 * (jdsample.c: a triangle filter for h2v1, h1v2 and h2v2 with the edge
 * rules there, replication otherwise) and the fixed-point YCbCr -> RGB
 * tables of jdcolor.c.  The arithmetic below follows those files step for
 * step, so the samples are the same bit for bit.
 *
 * Arithmetic coding, lossless and hierarchical files, other sample
 * precisions than 8 bits, 2 or 4 components (CMYK / YCCK), fractional
 * sampling ratios and progressive files that leave coefficients incomplete
 * (libjpeg's block smoothing would then estimate them) return
 * JPEG_UNSUPPORTED.  A truncated or corrupt stream returns JPEG_CORRUPT
 * where libjpeg would only warn and go on: every read is bounds-checked.
 *
 * Built by the host C compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/data/image_io.py).
 */
#include <setjmp.h>
#include <stdarg.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define JPEG_OK 0
#define JPEG_CORRUPT 1
#define JPEG_UNSUPPORTED 2
#define JPEG_NOMEM 3

/* zigzag index -> natural (row-major) index; 16 extra entries as libjpeg */
static const uint8_t NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

/* Annex K.3 tables, which libjpeg-turbo uses where a scan names a table
 * that no DHT defined (Motion-JPEG frames carry none) */
static const uint8_t STD_DC_BITS[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
static const uint8_t STD_DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t STD_AC_BITS[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
static const uint8_t STD_AC_VALS[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

#define FAST_BITS 9

typedef struct {
    int32_t maxcode[17]; /* last code of each length, -1 if none */
    int32_t valoff[17];  /* value index of a code: valoff[len] + code */
    uint16_t fast[1 << FAST_BITS]; /* (len << 8) | value; 0: longer code */
    uint8_t vals[256];
    int nvals, defined;
} huff_t;

typedef struct {
    int id, h, v, tq;
    int wib, hib; /* blocks that hold samples (libjpeg's width_in_blocks) */
    int bw, bh;   /* blocks stored: whole MCUs */
    int dw, dh;   /* samples of the component (libjpeg's downsampled_*) */
    int16_t *coef; /* bw * bh blocks of 64, natural order */
    uint16_t q[64]; /* quantisation table, latched at the first scan */
    int latched;
    int coef_bits[64]; /* progressive: Al of the last scan, -1 before */
    int dc_pred;
} comp_t;

typedef struct {
    const uint8_t *d;
    size_t n, pos;
    /* entropy-coded data: acc holds nbits bits, MSB first; the last fake of
     * them are zeros supplied past a marker or the end of the data */
    uint64_t acc;
    int nbits, fake, at_marker;
    uint16_t qt[4][64];
    int qt_def[4];
    huff_t hdc[4], hac[4];
    int restart;
    int sof, progressive, width, height, ncomp;
    int hmax, vmax, mcux, mcuy;
    comp_t comp[4];
    int jfif, adobe, adobe_transform;
    int orientation, app1_seen, sos_seen;
    int eobrun;
    uint8_t *planes[4], *full[4];
    int *sum;        /* h2v2 column sums */
    int want_h, want_w; /* the output buffer's size */
    jmp_buf jb;
    char *err;
    int errlen;
} dec_t;

static void fail(dec_t *s, int code, const char *fmt, ...)
    __attribute__((noreturn, format(printf, 3, 4)));

static void fail(dec_t *s, int code, const char *fmt, ...)
{
    if (s->err != NULL && s->errlen > 0) {
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(s->err, (size_t)s->errlen, fmt, ap);
        va_end(ap);
    }
    longjmp(s->jb, code);
}

static void *alloc(dec_t *s, size_t bytes)
{
    void *p = calloc(bytes ? bytes : 1, 1);
    if (p == NULL)
        fail(s, JPEG_NOMEM, "out of memory (%zu bytes)", bytes);
    return p;
}

/* -- marker segments ----------------------------------------------------- */

static int next_byte(dec_t *s)
{
    if (s->pos >= s->n)
        fail(s, JPEG_CORRUPT, "the data ends before the EOI marker "
             "(truncated at byte %zu)", s->n);
    return s->d[s->pos++];
}

static int next_marker(dec_t *s)
{
    int c = next_byte(s);
    if (c != 0xFF)
        fail(s, JPEG_CORRUPT, "byte %zu: 0x%02x where a marker should start",
             s->pos - 1, c);
    do
        c = next_byte(s);
    while (c == 0xFF); /* fill bytes */
    if (c == 0)
        fail(s, JPEG_CORRUPT, "byte %zu: a stuffed zero outside entropy-coded "
             "data", s->pos - 1);
    return c;
}

/* the payload of a marker segment: its length field counts itself */
static const uint8_t *segment(dec_t *s, size_t *len)
{
    int hi = next_byte(s), lo = next_byte(s);
    size_t L = ((size_t)hi << 8) | (size_t)lo;
    if (L < 2)
        fail(s, JPEG_CORRUPT, "byte %zu: segment length %zu", s->pos - 2, L);
    if (L - 2 > s->n - s->pos)
        fail(s, JPEG_CORRUPT, "a marker segment of %zu bytes runs past the "
             "end of the data (truncated)", L);
    const uint8_t *p = s->d + s->pos;
    s->pos += L - 2;
    *len = L - 2;
    return p;
}

static void read_dqt(dec_t *s, const uint8_t *p, size_t L)
{
    while (L > 0) {
        int pq = p[0] >> 4, tq = p[0] & 15;
        if (tq > 3 || pq > 1)
            fail(s, JPEG_CORRUPT, "DQT: table %d of precision %d", tq, pq);
        size_t need = 1 + 64 * (size_t)(pq + 1);
        if (L < need)
            fail(s, JPEG_CORRUPT, "DQT: segment too short");
        for (int k = 0; k < 64; k++)
            s->qt[tq][NATURAL[k]] = pq ? (uint16_t)(p[1 + 2 * k] << 8 |
                                                    p[2 + 2 * k])
                                       : p[1 + k];
        s->qt_def[tq] = 1;
        p += need;
        L -= need;
    }
}

static void build_huff(dec_t *s, huff_t *h, const uint8_t *bits,
                       const uint8_t *vals)
{
    int code = 0, k = 0;
    memset(h->fast, 0, sizeof h->fast);
    for (int len = 1; len <= 16; len++) {
        int cnt = bits[len - 1];
        h->valoff[len] = k - code;
        h->maxcode[len] = cnt ? code + cnt - 1 : -1;
        for (int i = 0; i < cnt; i++, code++, k++) {
            h->vals[k] = vals[k];
            if (len <= FAST_BITS) {
                int lo = code << (FAST_BITS - len);
                int hi = (code + 1) << (FAST_BITS - len);
                for (int j = lo; j < hi; j++)
                    h->fast[j] = (uint16_t)(len << 8 | vals[k]);
            }
        }
        /* libjpeg: no code may be all ones */
        if (code >= (1 << len))
            fail(s, JPEG_CORRUPT, "bad Huffman table");
        code <<= 1;
    }
    h->nvals = k;
    h->defined = 1;
}

static void read_dht(dec_t *s, const uint8_t *p, size_t L)
{
    while (L > 0) {
        if (L < 17)
            fail(s, JPEG_CORRUPT, "DHT: segment too short");
        int tc = p[0] >> 4, th = p[0] & 15;
        if (tc > 1 || th > 3)
            fail(s, JPEG_CORRUPT, "DHT: table class %d, id %d", tc, th);
        size_t total = 0;
        for (int i = 0; i < 16; i++)
            total += p[1 + i];
        if (total > 256 || L < 17 + total)
            fail(s, JPEG_CORRUPT, "DHT: bad table size");
        build_huff(s, tc ? &s->hac[th] : &s->hdc[th], p + 1, p + 17);
        p += 17 + total;
        L -= 17 + total;
    }
}

static int u16_at(const uint8_t *p, size_t n, size_t off, int le, int *ok)
{
    if (off + 1 >= n) {
        *ok = 0;
        return 0;
    }
    return le ? p[off] | p[off + 1] << 8 : p[off] << 8 | p[off + 1];
}

/* OpenCV's ExifReader on the first APP1 segment past its 6-byte header:
 * the TIFF header, IFD0's entries, the first orientation tag (0x0112) */
static void read_exif(dec_t *s, const uint8_t *p, size_t n)
{
    int ok = 1;
    int le = n > 1 && p[0] == p[1] && p[0] == 'I';
    if (u16_at(p, n, 2, le, &ok) != 0x2A || !ok)
        return;
    if (n < 8)
        return;
    size_t off = le ? (size_t)p[4] | (size_t)p[5] << 8 |
                          (size_t)p[6] << 16 | (size_t)p[7] << 24
                    : (size_t)p[4] << 24 | (size_t)p[5] << 16 |
                          (size_t)p[6] << 8 | (size_t)p[7];
    int entries = u16_at(p, n, off, le, &ok);
    for (int e = 0; ok && e < entries; e++) {
        size_t at = off + 2 + 12 * (size_t)e;
        int tag = u16_at(p, n, at, le, &ok);
        if (ok && tag == 0x0112) {
            int value = u16_at(p, n, at + 8, le, &ok);
            if (ok)
                s->orientation = value;
            return;
        }
    }
}

static void read_app(dec_t *s, int marker, const uint8_t *p, size_t L)
{
    if (marker == 0xE0 && L >= 14 && memcmp(p, "JFIF\0", 5) == 0)
        s->jfif = 1;
    if (marker == 0xEE && L >= 12 && memcmp(p, "Adobe", 5) == 0) {
        s->adobe = 1;
        s->adobe_transform = p[11];
    }
    if (marker == 0xE1 && !s->app1_seen && !s->sos_seen) {
        s->app1_seen = 1;
        if (L > 6)
            read_exif(s, p + 6, L - 6);
    }
}

static void read_sof(dec_t *s, int marker, const uint8_t *p, size_t L)
{
    if (s->sof)
        fail(s, JPEG_CORRUPT, "a second frame header (SOF)");
    if (L < 6)
        fail(s, JPEG_CORRUPT, "SOF: segment too short");
    if (p[0] != 8)
        fail(s, JPEG_UNSUPPORTED, "%d-bit samples (only 8-bit JPEG is "
             "decoded)", p[0]);
    s->height = p[1] << 8 | p[2];
    s->width = p[3] << 8 | p[4];
    s->ncomp = p[5];
    if (s->height == 0)
        fail(s, JPEG_CORRUPT, "image height 0 (a DNL-defined height)");
    if (s->width == 0)
        fail(s, JPEG_CORRUPT, "image width 0");
    if (s->ncomp == 4)
        fail(s, JPEG_UNSUPPORTED, "4 components (CMYK or YCCK)");
    if (s->ncomp != 1 && s->ncomp != 3)
        fail(s, JPEG_UNSUPPORTED, "%d components (gray and 3-component "
             "files are decoded)", s->ncomp);
    if (L != 6 + 3 * (size_t)s->ncomp)
        fail(s, JPEG_CORRUPT, "SOF: bad segment length");
    s->progressive = marker == 0xC2;
    s->hmax = s->vmax = 1;
    for (int i = 0; i < s->ncomp; i++) {
        comp_t *c = &s->comp[i];
        c->id = p[6 + 3 * i];
        c->h = p[7 + 3 * i] >> 4;
        c->v = p[7 + 3 * i] & 15;
        c->tq = p[8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            fail(s, JPEG_CORRUPT, "SOF: component %d: sampling %dx%d, "
                 "table %d", i, c->h, c->v, c->tq);
        if (c->h > s->hmax)
            s->hmax = c->h;
        if (c->v > s->vmax)
            s->vmax = c->v;
    }
    s->mcux = (s->width + 8 * s->hmax - 1) / (8 * s->hmax);
    s->mcuy = (s->height + 8 * s->vmax - 1) / (8 * s->vmax);
    for (int i = 0; i < s->ncomp; i++) {
        comp_t *c = &s->comp[i];
        if (s->hmax % c->h || s->vmax % c->v)
            fail(s, JPEG_UNSUPPORTED, "fractional sampling (%dx%d against "
                 "%dx%d)", c->h, c->v, s->hmax, s->vmax);
        long long w = (long long)s->width * c->h, h = (long long)s->height *
                                                      c->v;
        c->dw = (int)((w + s->hmax - 1) / s->hmax);
        c->dh = (int)((h + s->vmax - 1) / s->vmax);
        c->wib = (int)((w + 8LL * s->hmax - 1) / (8LL * s->hmax));
        c->hib = (int)((h + 8LL * s->vmax - 1) / (8LL * s->vmax));
        c->bw = s->mcux * c->h;
        c->bh = s->mcuy * c->v;
        for (int k = 0; k < 64; k++)
            c->coef_bits[k] = -1;
    }
    s->sof = 1;
}

/* -- entropy-coded data -------------------------------------------------- */

static void fill(dec_t *s)
{
    while (s->nbits <= 56) {
        uint64_t b = 0;
        if (!s->at_marker) {
            if (s->pos >= s->n) {
                s->at_marker = 1;
            } else if (s->d[s->pos] != 0xFF) {
                b = s->d[s->pos++];
            } else if (s->pos + 1 < s->n && s->d[s->pos + 1] == 0) {
                b = 0xFF;
                s->pos += 2;
            } else {
                s->at_marker = 1; /* a marker: stop before its 0xFF */
            }
        }
        if (s->at_marker)
            s->fake += 8;
        s->acc |= b << (56 - s->nbits);
        s->nbits += 8;
    }
}

static inline void consume(dec_t *s, int n)
{
    s->acc <<= n;
    s->nbits -= n;
    if (s->nbits < s->fake)
        fail(s, JPEG_CORRUPT, "entropy-coded data ends early (truncated or "
             "corrupt)");
}

static inline int get_bits(dec_t *s, int n)
{
    if (n == 0)
        return 0;
    if (s->nbits < n)
        fill(s);
    int v = (int)(s->acc >> (64 - n));
    consume(s, n);
    return v;
}

static inline int extend(int v, int n)
{
    return n == 0 ? 0 : (v < (1 << (n - 1)) ? v - (1 << n) + 1 : v);
}

static inline int decode_huff(dec_t *s, const huff_t *h)
{
    if (s->nbits < 16)
        fill(s);
    uint32_t peek = (uint32_t)(s->acc >> 48);
    uint16_t f = h->fast[peek >> (16 - FAST_BITS)];
    if (f) {
        consume(s, f >> 8);
        return f & 0xFF;
    }
    for (int len = FAST_BITS + 1; len <= 16; len++) {
        int32_t code = (int32_t)(peek >> (16 - len));
        if (code <= h->maxcode[len]) {
            consume(s, len);
            return h->vals[h->valoff[len] + code];
        }
    }
    fail(s, JPEG_CORRUPT, "bad Huffman code");
}

static void reset_bits(dec_t *s)
{
    s->acc = 0;
    s->nbits = s->fake = s->at_marker = 0;
}

/* the end of an entropy-coded segment: only the padding bits of the last
 * byte may be left, and a marker must follow */
static void end_segment(dec_t *s)
{
    if (s->nbits - s->fake >= 8)
        fail(s, JPEG_CORRUPT, "extraneous bytes in entropy-coded data");
    if (s->pos >= s->n)
        fail(s, JPEG_CORRUPT, "the data ends in entropy-coded data "
             "(truncated)");
    if (s->d[s->pos] != 0xFF)
        fail(s, JPEG_CORRUPT, "extraneous bytes in entropy-coded data");
    reset_bits(s);
}

static void restart(dec_t *s, int *next_rst)
{
    end_segment(s);
    int m = next_marker(s);
    if (m != 0xD0 + *next_rst)
        fail(s, JPEG_CORRUPT, "marker 0x%02x where RST%d should be", m,
             *next_rst);
    *next_rst = (*next_rst + 1) & 7;
    for (int i = 0; i < s->ncomp; i++)
        s->comp[i].dc_pred = 0;
    s->eobrun = 0;
}

static void block_sequential(dec_t *s, comp_t *c, int16_t *blk,
                             const huff_t *dc, const huff_t *ac)
{
    int t = decode_huff(s, dc);
    int diff = extend(get_bits(s, t), t);
    c->dc_pred = (int)((unsigned)c->dc_pred + (unsigned)diff);
    blk[0] = (int16_t)c->dc_pred;
    for (int k = 1; k < 64; k++) {
        int rs = decode_huff(s, ac);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
            k += r;
            if (k > 63)
                fail(s, JPEG_CORRUPT, "AC run past coefficient 63");
            blk[NATURAL[k]] = (int16_t)extend(get_bits(s, sz), sz);
        } else {
            if (r != 15)
                break;
            k += 15;
        }
    }
}

static void block_dc_first(dec_t *s, comp_t *c, int16_t *blk,
                           const huff_t *dc, int al)
{
    int t = decode_huff(s, dc);
    int diff = extend(get_bits(s, t), t);
    c->dc_pred = (int)((unsigned)c->dc_pred + (unsigned)diff);
    blk[0] = (int16_t)(uint16_t)((unsigned)c->dc_pred << al);
}

static void block_dc_refine(dec_t *s, int16_t *blk, int al)
{
    if (get_bits(s, 1))
        blk[0] = (int16_t)(blk[0] | (1 << al));
}

static void block_ac_first(dec_t *s, int16_t *blk, const huff_t *ac, int ss,
                           int se, int al)
{
    if (s->eobrun > 0) {
        s->eobrun--;
        return;
    }
    for (int k = ss; k <= se; k++) {
        int rs = decode_huff(s, ac);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
            k += r;
            if (k > se)
                fail(s, JPEG_CORRUPT, "AC run past the end of the band");
            int v = extend(get_bits(s, sz), sz);
            blk[NATURAL[k]] = (int16_t)(uint16_t)((unsigned)v << al);
        } else if (r == 15) {
            k += 15;
        } else {
            s->eobrun = (1 << r) + get_bits(s, r) - 1;
            break;
        }
    }
}

/* correction bit of an already-nonzero coefficient (jdphuff.c) */
static inline void refine(dec_t *s, int16_t *coef, int p1)
{
    if (get_bits(s, 1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef - p1);
}

static void block_ac_refine(dec_t *s, int16_t *blk, const huff_t *ac, int ss,
                            int se, int al)
{
    int p1 = 1 << al;
    int k = ss;
    if (s->eobrun == 0) {
        for (; k <= se; k++) {
            int rs = decode_huff(s, ac);
            int r = rs >> 4, sz = rs & 15, v = 0;
            if (sz) {
                if (sz != 1)
                    fail(s, JPEG_CORRUPT, "refinement coefficient of size "
                         "%d", sz);
                v = get_bits(s, 1) ? p1 : -p1;
            } else if (r != 15) {
                s->eobrun = (1 << r) + get_bits(s, r);
                break;
            }
            /* skip r zero coefficients, refining the nonzero ones */
            do {
                int16_t *coef = blk + NATURAL[k];
                if (*coef != 0)
                    refine(s, coef, p1);
                else if (--r < 0)
                    break;
                k++;
            } while (k <= se);
            if (v) {
                if (k > se)
                    fail(s, JPEG_CORRUPT, "AC run past the end of the band");
                blk[NATURAL[k]] = (int16_t)v;
            }
        }
    }
    if (s->eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *coef = blk + NATURAL[k];
            if (*coef != 0)
                refine(s, coef, p1);
        }
        s->eobrun--;
    }
}

static void decode_scan(dec_t *s, int ns, comp_t *const *cs,
                        const huff_t *const *dct, const huff_t *const *act,
                        int ss, int se, int ah, int al);

/* a scan header: its components and tables, the progression's checks */
static void read_sos(dec_t *s, const uint8_t *p, size_t L)
{
    if (!s->sof)
        fail(s, JPEG_CORRUPT, "a scan (SOS) before the frame header (SOF)");
    if (L < 1)
        fail(s, JPEG_CORRUPT, "SOS: segment too short");
    int ns = p[0];
    if (ns < 1 || ns > 4 || L != 4 + 2 * (size_t)ns)
        fail(s, JPEG_CORRUPT, "SOS: %d components in a %zu-byte segment",
             ns, L);
    comp_t *cs[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; i++) {
        int id = p[1 + 2 * i], ci;
        for (ci = 0; ci < s->ncomp && s->comp[ci].id != id; ci++)
            ;
        if (ci == s->ncomp)
            fail(s, JPEG_CORRUPT, "SOS: unknown component id %d", id);
        for (int j = 0; j < i; j++)
            if (cs[j] == &s->comp[ci])
                fail(s, JPEG_CORRUPT, "SOS: component %d twice", id);
        cs[i] = &s->comp[ci];
        td[i] = p[2 + 2 * i] >> 4;
        ta[i] = p[2 + 2 * i] & 15;
        if (td[i] > 3 || ta[i] > 3)
            fail(s, JPEG_CORRUPT, "SOS: Huffman table id above 3");
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
    int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;

    int dc_band = ss == 0;
    if (s->progressive) {
        int bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
        if ((ah != 0 && al != ah - 1) || al > 13 || bad)
            fail(s, JPEG_CORRUPT, "bad progression parameters Ss=%d Se=%d "
                 "Ah=%d Al=%d", ss, se, ah, al);
        for (int i = 0; i < ns; i++) {
            if (!dc_band && cs[i]->coef_bits[0] < 0)
                fail(s, JPEG_CORRUPT, "an AC scan before the DC scan");
            for (int k = ss; k <= se; k++) {
                int expected = cs[i]->coef_bits[k] < 0 ? 0 :
                               cs[i]->coef_bits[k];
                if (ah != expected)
                    fail(s, JPEG_CORRUPT, "scans out of order (coefficient "
                         "%d)", k);
                cs[i]->coef_bits[k] = al;
            }
        }
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        fail(s, JPEG_CORRUPT, "a sequential scan with Ss=%d Se=%d Ah=%d "
             "Al=%d", ss, se, ah, al);
    }

    if (ns > 1) {
        int blocks = 0;
        for (int i = 0; i < ns; i++)
            blocks += cs[i]->h * cs[i]->v;
        if (blocks > 10)
            fail(s, JPEG_CORRUPT, "%d blocks in an MCU (10 at most)", blocks);
    }
    const huff_t *dct[4] = {0}, *act[4] = {0};
    for (int i = 0; i < ns; i++) {
        comp_t *c = cs[i];
        if (!c->latched) {
            if (!s->qt_def[c->tq])
                fail(s, JPEG_CORRUPT, "quantisation table %d is not defined",
                     c->tq);
            memcpy(c->q, s->qt[c->tq], sizeof c->q);
            c->latched = 1;
        }
        int uses_dc = s->progressive ? dc_band && ah == 0 : 1;
        int uses_ac = s->progressive ? !dc_band : 1;
        if (uses_dc) {
            huff_t *h = &s->hdc[td[i]];
            if (!h->defined && td[i] < 2)
                build_huff(s, h, STD_DC_BITS[td[i]], STD_DC_VALS);
            if (!h->defined)
                fail(s, JPEG_CORRUPT, "DC Huffman table %d is not defined",
                     td[i]);
            dct[i] = h;
        }
        if (uses_ac) {
            huff_t *h = &s->hac[ta[i]];
            if (!h->defined && ta[i] < 2)
                build_huff(s, h, STD_AC_BITS[ta[i]], STD_AC_VALS[ta[i]]);
            if (!h->defined)
                fail(s, JPEG_CORRUPT, "AC Huffman table %d is not defined",
                     ta[i]);
            act[i] = h;
        }
        c->dc_pred = 0;
    }
    for (int i = 0; i < ns; i++)
        for (int k = 0; dct[i] != NULL && k < dct[i]->nvals; k++)
            if (dct[i]->vals[k] > 15)
                fail(s, JPEG_CORRUPT, "bad Huffman table (DC category %d)",
                     dct[i]->vals[k]);

    s->sos_seen = 1;
    decode_scan(s, ns, cs, dct, act, ss, se, ah, al);
}

/* the scan's entropy-coded data: MCUs in raster order (one block each in a
 * single-component scan), a restart marker every s->restart of them */
static void decode_scan(dec_t *s, int ns, comp_t *const *cs,
                        const huff_t *const *dct, const huff_t *const *act,
                        int ss, int se, int ah, int al)
{
    int dc_band = ss == 0;
    reset_bits(s);
    s->eobrun = 0;
    int mx_n = ns > 1 ? s->mcux : cs[0]->wib;
    int my_n = ns > 1 ? s->mcuy : cs[0]->hib;
    long long total = (long long)mx_n * my_n;
    int left = s->restart, next_rst = 0;
    for (long long m = 0; m < total; m++) {
        if (s->restart) {
            if (left == 0) {
                restart(s, &next_rst);
                left = s->restart;
            }
            left--;
        }
        int my = (int)(m / mx_n), mx = (int)(m % mx_n);
        for (int i = 0; i < ns; i++) {
            comp_t *c = cs[i];
            int nv = ns > 1 ? c->v : 1, nh = ns > 1 ? c->h : 1;
            for (int v = 0; v < nv; v++)
                for (int h = 0; h < nh; h++) {
                    size_t by = (size_t)my * nv + v, bx = (size_t)mx * nh + h;
                    int16_t *blk = c->coef + (by * c->bw + bx) * 64;
                    if (!s->progressive)
                        block_sequential(s, c, blk, dct[i], act[i]);
                    else if (dc_band && ah == 0)
                        block_dc_first(s, c, blk, dct[i], al);
                    else if (dc_band)
                        block_dc_refine(s, blk, al);
                    else if (ah == 0)
                        block_ac_first(s, blk, act[i], ss, se, al);
                    else
                        block_ac_refine(s, blk, act[i], ss, se, al);
                }
        }
    }
    end_segment(s);
}

/* -- samples ------------------------------------------------------------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* libjpeg's post-IDCT range limit: the value, masked to 10 bits, indexes a
 * table that clamps -384..383 to 0..255 around the +128 level shift */
static uint8_t RANGE[1024];

static void init_range(void)
{
    for (int i = 0; i < 1024; i++) {
        int v = i < 512 ? i : i - 1024; /* the signed value of the index */
        v += 128;
        RANGE[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
}

/* jpeg_idct_islow (jidctint.c): coefficients times the quantisation table,
 * columns then rows, into 8 x 8 samples at out (row stride `stride`) */
static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                       size_t stride)
{
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *x = in + c;
        const uint16_t *qc = q + c;
        int *w = ws + c;
        if (x[8] == 0 && x[16] == 0 && x[24] == 0 && x[32] == 0 &&
            x[40] == 0 && x[48] == 0 && x[56] == 0) {
            int dc = (int)((unsigned)(x[0] * qc[0]) << PASS1_BITS);
            for (int r = 0; r < 8; r++)
                w[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = x[16] * qc[16];
        z3 = x[48] * qc[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * -FIX_1_847759065;
        t3 = z1 + z2 * FIX_0_765366865;
        z2 = x[0] * qc[0];
        z3 = x[32] * qc[32];
        t0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
        t1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = x[56] * qc[56];
        t1 = x[40] * qc[40];
        t2 = x[24] * qc[24];
        t3 = x[8] * qc[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 *= FIX_0_298631336;
        t1 *= FIX_2_053119869;
        t2 *= FIX_3_072711026;
        t3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        w[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
        w[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
        w[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
        w[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
        w[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
        w[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
        w[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
        w[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int *w = ws + 8 * r;
        uint8_t *o = out + r * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            uint8_t dc = RANGE[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) &
                               1023];
            memset(o, dc, 8);
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = w[2];
        z3 = w[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * -FIX_1_847759065;
        t3 = z1 + z2 * FIX_0_765366865;
        t0 = ((int64_t)w[0] + w[4]) * ((int64_t)1 << CONST_BITS);
        t1 = ((int64_t)w[0] - w[4]) * ((int64_t)1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = w[7];
        t1 = w[5];
        t2 = w[3];
        t3 = w[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 *= FIX_0_298631336;
        t1 *= FIX_2_053119869;
        t2 *= FIX_3_072711026;
        t3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        o[0] = RANGE[(int)DESCALE(t10 + t3, sh) & 1023];
        o[7] = RANGE[(int)DESCALE(t10 - t3, sh) & 1023];
        o[1] = RANGE[(int)DESCALE(t11 + t2, sh) & 1023];
        o[6] = RANGE[(int)DESCALE(t11 - t2, sh) & 1023];
        o[2] = RANGE[(int)DESCALE(t12 + t1, sh) & 1023];
        o[5] = RANGE[(int)DESCALE(t12 - t1, sh) & 1023];
        o[3] = RANGE[(int)DESCALE(t13 + t0, sh) & 1023];
        o[4] = RANGE[(int)DESCALE(t13 - t0, sh) & 1023];
    }
}

/* component samples at full size, W x H (jdsample.c's choice of method) */
static void upsample(const comp_t *c, const uint8_t *in, size_t stride,
                     int hexp, int vexp, uint8_t *out, int W, int H, int *sum)
{
    const int dw = c->dw, dh = c->dh;
    if (hexp == 2 && vexp == 1 && dw > 2) { /* h2v1 fancy */
        for (int y = 0; y < H; y++) {
            const uint8_t *r = in + (size_t)y * stride;
            uint8_t *o = out + (size_t)y * W;
            for (int x = 0; x < W; x++) {
                int i = x >> 1;
                if (x & 1)
                    o[x] = i == dw - 1 ? r[i]
                                       : (uint8_t)((3 * r[i] + r[i + 1] + 2)
                                                   >> 2);
                else
                    o[x] = i == 0 ? r[0]
                                  : (uint8_t)((3 * r[i] + r[i - 1] + 1) >> 2);
            }
        }
    } else if (hexp == 1 && vexp == 2) { /* h1v2 fancy */
        for (int y = 0; y < H; y++) {
            int i = y >> 1;
            int nb = y & 1 ? (i + 1 < dh ? i + 1 : dh - 1)
                           : (i > 0 ? i - 1 : 0);
            int bias = y & 1 ? 2 : 1;
            const uint8_t *r0 = in + (size_t)i * stride;
            const uint8_t *r1 = in + (size_t)nb * stride;
            uint8_t *o = out + (size_t)y * W;
            for (int x = 0; x < W; x++)
                o[x] = (uint8_t)((3 * r0[x] + r1[x] + bias) >> 2);
        }
    } else if (hexp == 2 && vexp == 2 && dw > 2) { /* h2v2 fancy */
        for (int y = 0; y < H; y++) {
            int i = y >> 1;
            int nb = y & 1 ? (i + 1 < dh ? i + 1 : dh - 1)
                           : (i > 0 ? i - 1 : 0);
            const uint8_t *r0 = in + (size_t)i * stride;
            const uint8_t *r1 = in + (size_t)nb * stride;
            for (int j = 0; j < dw; j++)
                sum[j] = 3 * r0[j] + r1[j];
            uint8_t *o = out + (size_t)y * W;
            for (int x = 0; x < W; x++) {
                int j = x >> 1;
                if (x & 1)
                    o[x] = j == dw - 1
                               ? (uint8_t)((sum[j] * 4 + 7) >> 4)
                               : (uint8_t)((3 * sum[j] + sum[j + 1] + 7) >> 4);
                else
                    o[x] = j == 0 ? (uint8_t)((sum[0] * 4 + 8) >> 4)
                                  : (uint8_t)((3 * sum[j] + sum[j - 1] + 8)
                                              >> 4);
            }
        }
    } else { /* replication (int_upsample, h2v1 / h2v2 of narrow planes) */
        for (int y = 0; y < H; y++) {
            const uint8_t *r = in + (size_t)(y / vexp) * stride;
            uint8_t *o = out + (size_t)y * W;
            for (int x = 0; x < W; x++)
                o[x] = r[x / hexp];
        }
    }
}

/* progressive files whose coefficients are not all complete would go
 * through libjpeg's block smoothing (jdcoefct.c smoothing_ok) */
static void check_smoothing(dec_t *s)
{
    static const int Q[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    int useful = 0;
    for (int i = 0; i < s->ncomp; i++) {
        const comp_t *c = &s->comp[i];
        if (c->coef_bits[0] < 0 || !c->latched)
            return;
        for (int k = 0; k < 10; k++)
            if (c->q[Q[k]] == 0)
                return;
        for (int k = 1; k < 10; k++)
            if (c->coef_bits[k] != 0)
                useful = 1;
    }
    if (useful)
        fail(s, JPEG_UNSUPPORTED, "a progressive file that leaves "
             "coefficients incomplete (libjpeg's block smoothing)");
}

static void output(dec_t *s, uint8_t *out)
{
    const int W = s->width, H = s->height;
    const uint8_t *ch[3];
    for (int i = 0; i < s->ncomp; i++) {
        comp_t *c = &s->comp[i];
        size_t stride = (size_t)c->wib * 8;
        uint8_t *pl = s->planes[i] = alloc(s, stride * (size_t)c->hib * 8);
        for (int by = 0; by < c->hib; by++)
            for (int bx = 0; bx < c->wib; bx++)
                idct_islow(c->coef + ((size_t)by * c->bw + bx) * 64, c->q,
                           pl + (size_t)by * 8 * stride + (size_t)bx * 8,
                           stride);
        int hexp = s->hmax / c->h, vexp = s->vmax / c->v;
        if (hexp == 1 && vexp == 1) {
            uint8_t *full = s->full[i] = alloc(s, (size_t)W * H);
            for (int y = 0; y < H; y++)
                memcpy(full + (size_t)y * W, pl + (size_t)y * stride,
                       (size_t)W);
        } else {
            s->full[i] = alloc(s, (size_t)W * H);
            free(s->sum);
            s->sum = alloc(s, sizeof(int) * (size_t)c->dw);
            upsample(c, pl, stride, hexp, vexp, s->full[i], W, H, s->sum);
        }
        ch[i] = s->full[i];
    }
    size_t npx = (size_t)W * H;
    if (s->ncomp == 1) {
        for (size_t k = 0; k < npx; k++)
            out[3 * k] = out[3 * k + 1] = out[3 * k + 2] = ch[0][k];
        return;
    }
    int rgb;
    if (s->jfif)
        rgb = 0;
    else if (s->adobe)
        rgb = s->adobe_transform == 0;
    else
        rgb = s->comp[0].id == 'R' && s->comp[1].id == 'G' &&
              s->comp[2].id == 'B';
    if (rgb) {
        for (size_t k = 0; k < npx; k++) {
            out[3 * k] = ch[2][k];
            out[3 * k + 1] = ch[1][k];
            out[3 * k + 2] = ch[0][k];
        }
        return;
    }
    /* jdcolor.c build_ycc_rgb_table, ycc_rgb_convert */
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = (int64_t)1 << 15;
    for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        cr_r[i] = (int)((91881 * x + half) >> 16);  /* FIX(1.40200) */
        cb_b[i] = (int)((116130 * x + half) >> 16); /* FIX(1.77200) */
        cr_g[i] = -46802 * x;                       /* FIX(0.71414) */
        cb_g[i] = -22554 * x + half;                /* FIX(0.34414) */
    }
    for (size_t k = 0; k < npx; k++) {
        int y = ch[0][k], cb = ch[1][k], cr = ch[2][k];
        int r = y + cr_r[cr];
        int g = y + (int)((cb_g[cb] + cr_g[cr]) >> 16);
        int b = y + cb_b[cb];
        out[3 * k] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
        out[3 * k + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
        out[3 * k + 2] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
    }
}

/* -- the file ------------------------------------------------------------ */

static void run(dec_t *s, int header_only, uint8_t *out)
{
    if (s->n < 2 || s->d[0] != 0xFF || s->d[1] != 0xD8)
        fail(s, JPEG_CORRUPT, "not a JPEG file (no SOI marker)");
    s->pos = 2;
    int scans = 0;
    for (;;) {
        int m = next_marker(s);
        size_t L;
        const uint8_t *p;
        if (m == 0xD9) { /* EOI */
            if (!scans)
                fail(s, JPEG_CORRUPT, "EOI before any scan");
            break;
        }
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01)
            continue; /* stray RSTn / TEM: libjpeg skips them */
        if (m == 0xD8)
            fail(s, JPEG_CORRUPT, "a second SOI marker");
        p = segment(s, &L);
        switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
            read_sof(s, m, p, L);
            break;
        case 0xC3:
            fail(s, JPEG_UNSUPPORTED, "lossless JPEG (SOF3)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
            fail(s, JPEG_UNSUPPORTED, "hierarchical JPEG (SOF%d)", m - 0xC0);
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
            fail(s, JPEG_UNSUPPORTED, "arithmetic coding (marker 0x%02x)", m);
        case 0xC4:
            read_dht(s, p, L);
            break;
        case 0xDB:
            read_dqt(s, p, L);
            break;
        case 0xDD:
            if (L != 2)
                fail(s, JPEG_CORRUPT, "DRI: bad segment length");
            s->restart = p[0] << 8 | p[1];
            break;
        case 0xDA:
            if (header_only) {
                if (!s->sof)
                    fail(s, JPEG_CORRUPT, "a scan (SOS) before the frame "
                         "header (SOF)");
                return;
            }
            if (scans == 0 && (s->height != s->want_h ||
                               s->width != s->want_w))
                fail(s, JPEG_CORRUPT, "the output is %dx%d, the image %dx%d",
                     s->want_h, s->want_w, s->height, s->width);
            if (scans == 0)
                for (int i = 0; i < s->ncomp; i++) {
                    comp_t *c = &s->comp[i];
                    c->coef = alloc(s, (size_t)c->bw * c->bh * 64 *
                                           sizeof(int16_t));
                }
            read_sos(s, p, L);
            scans++;
            break;
        case 0xDC: /* DNL: skipped, as libjpeg does */
        case 0xFE: /* COM */
            break;
        default:
            if (m >= 0xE0 && m <= 0xEF) {
                read_app(s, m, p, L);
                break;
            }
            fail(s, JPEG_CORRUPT, "unknown marker 0x%02x", m);
        }
    }
    if (s->progressive)
        check_smoothing(s);
    output(s, out);
}

static void release(dec_t *s)
{
    for (int i = 0; i < 4; i++) {
        free(s->comp[i].coef);
        free(s->planes[i]);
        free(s->full[i]);
    }
    free(s->sum);
}

static void start(dec_t *s, const uint8_t *data, int64_t len, char *err,
                 int errlen)
{
    memset(s, 0, sizeof *s);
    s->d = data;
    s->n = len < 0 ? 0 : (size_t)len;
    s->err = err;
    s->errlen = errlen;
    if (err != NULL && errlen > 0)
        err[0] = 0;
    if (RANGE[1023] == 0) /* index -1 -> 127: the table is built */
        init_range();
}

/* Parse the markers up to the first scan.  info: height, width, EXIF
 * orientation (0 without the tag).  Returns a JPEG_* status; err holds the
 * reason of a failure. */
int jpeg_info(const uint8_t *data, int64_t len, int32_t *info, char *err,
              int errlen)
{
    dec_t s;
    start(&s, data, len, err, errlen);
    int status = setjmp(s.jb);
    if (status == 0) {
        run(&s, 1, NULL);
        info[0] = s.height;
        info[1] = s.width;
        info[2] = s.orientation;
    }
    release(&s);
    return status;
}

/* Decode into out, height x width x 3 bytes in BGR order (jpeg_info's
 * height and width; the orientation is not applied here). */
int jpeg_decode(const uint8_t *data, int64_t len, uint8_t *out,
                int64_t height, int64_t width, char *err, int errlen)
{
    dec_t s;
    start(&s, data, len, err, errlen);
    s.want_h = (int)height;
    s.want_w = (int)width;
    int status = setjmp(s.jb);
    if (status == 0)
        run(&s, 0, out);
    release(&s);
    return status;
}
