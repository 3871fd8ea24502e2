/* JPEG decoder for the port's data layer (ITU-T T.81): baseline, extended
 * sequential and progressive Huffman coding of 8-bit samples, 1 component
 * (gray) or 3 (YCbCr, or RGB by the Adobe marker or the component ids),
 * every integral sampling factor, restart intervals and the EXIF
 * orientation tag of the first APP1 segment.
 *
 * The output is what cv2.imread returns, which decodes with libjpeg-turbo's
 * defaults: the integer ISLOW inverse DCT (jidctint.c, as its x86 SIMD
 * code computes it), fancy upsampling (jdsample.c: a triangle filter for
 * h2v1, h1v2 and h2v2 with the edge rules there, replication otherwise),
 * the fixed-point YCbCr -> RGB tables of jdcolor.c, or with a gray output
 * its JCS_GRAYSCALE conversion (cv2.IMREAD_ANYDEPTH), and block smoothing
 * of a progressive file's incomplete coefficients (jdcoefct.c).  The
 * arithmetic below follows those files step for step, so the samples are
 * the same bit for bit.
 *
 * Damaged data is read as cv2.imread reads a file (libjpeg-turbo 3.1 with
 * its stdio source): past the end of the data the source supplies "FF D9"
 * (a fake EOI) again and again (jdatasrc.c); the entropy decoder pads a
 * segment cut short by a marker with zero bits and leaves the MCUs after
 * that one at zero coefficients (jdhuff.c insufficient_data), reads a bad
 * Huffman code as 17 bits of symbol 0, skips bytes before a marker
 * (jdmarker.c next_marker) and resynchronises out-of-order restart markers
 * as jpeg_resync_to_restart does.  A sequential file whose first scan holds
 * every component is output from that scan alone, as libjpeg's single-pass
 * decoder does, whatever follows it.  Where libjpeg stops with an error
 * (OpenCV then returns None) the decoder returns JPEG_CORRUPT.
 *
 * Arithmetic coding, lossless and hierarchical files, other sample
 * precisions than 8 bits, 2 or 4 components (CMYK / YCCK) and fractional
 * sampling ratios return JPEG_UNSUPPORTED.  Every read of the data is
 * bounds-checked.
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

/* Annex K.3 tables, which libjpeg-turbo's sequential decoder uses where a
 * scan names a table that no DHT defined (Motion-JPEG frames carry none);
 * its progressive decoder fails there */
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
    int nvals, defined, bad; /* bad: fails the scan that uses it */
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
    int prev_bits[64]; /* coef_bits before the component's last scan */
    int latch[10], prev_latch[10]; /* the two at the output (smoothing) */
    int dc_pred;
} comp_t;

typedef struct {
    const uint8_t *d;
    size_t n, pos; /* pos may pass n: see byte_at */
    /* entropy-coded data: acc holds nbits bits, MSB first; the last fake of
     * them are zeros supplied past a marker.  unread_marker: the marker the
     * entropy decoder stopped at, not yet read by the marker reader;
     * insufficient: the segment's data ran out (libjpeg's
     * insufficient_data), so its remaining MCUs are left as they are */
    uint64_t acc;
    int nbits, fake, unread_marker, insufficient;
    uint8_t *segbuf; /* a scan header that runs past the end of the data */
    uint16_t qt[4][64];
    int qt_def[4];
    huff_t hdc[4], hac[4];
    int restart;
    int sof, progressive, width, height, ncomp;
    int hmax, vmax, mcux, mcuy;
    comp_t comp[4];
    int jfif, adobe, adobe_transform;
    int rgb; /* no colour conversion: decided at the first scan */
    int scans;
    int orientation, app1_seen, sos_seen;
    int eobrun;
    int last_good; /* libjpeg's last_good_iMCU_row */
    int smooth;    /* block smoothing at the output (smoothing_ok) */
    uint8_t *planes[4], *full[4];
    int *sum;        /* h2v2 column sums */
    int want_h, want_w; /* the output buffer's size */
    int gray_out;       /* one output channel: libjpeg's JCS_GRAYSCALE */
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

/* byte i of the input as libjpeg's stdio source delivers it: the data,
 * then FF D9 (a fake EOI) without end */
static inline int byte_at(const dec_t *s, size_t i)
{
    return i < s->n ? s->d[i] : ((i - s->n) & 1 ? 0xD9 : 0xFF);
}

static inline int next_byte(dec_t *s)
{
    return byte_at(s, s->pos++);
}

/* jdmarker.c next_marker: skip bytes up to an FF, FF fill bytes and
 * stuffed zeros (libjpeg warns of the bytes it skips) */
static int scan_marker(dec_t *s)
{
    for (;;) {
        int c = next_byte(s);
        while (c != 0xFF)
            c = next_byte(s);
        do
            c = next_byte(s);
        while (c == 0xFF);
        if (c != 0)
            return c;
    }
}

/* the next marker: the one the entropy decoder stopped at, else the next
 * one in the data */
static int next_marker(dec_t *s)
{
    int m = s->unread_marker;
    s->unread_marker = 0;
    return m ? m : scan_marker(s);
}

/* the payload of a marker segment: its length field counts itself.  Past
 * the end of the data it holds the fake EOI markers, as libjpeg reads
 * them. */
static const uint8_t *segment(dec_t *s, int marker, size_t *len)
{
    int hi = next_byte(s), lo = next_byte(s);
    size_t L = ((size_t)hi << 8) | (size_t)lo;
    if (L < 2)
        fail(s, JPEG_CORRUPT, "byte %zu: segment length %zu", s->pos - 2, L);
    *len = L - 2;
    if (s->pos <= s->n && L - 2 <= s->n - s->pos) {
        const uint8_t *p = s->d + s->pos;
        s->pos += L - 2;
        return p;
    }
    /* before the first scan, libjpeg fails on every such segment: only
     * the fake EOI markers follow it, and an EOI before a scan is an
     * error */
    if (marker != 0xDA && s->scans == 0)
        fail(s, JPEG_CORRUPT, "a marker segment of %zu bytes runs past the "
             "end of the data (truncated)", L);
    free(s->segbuf);
    s->segbuf = alloc(s, L - 2);
    for (size_t i = 0; i < L - 2; i++)
        s->segbuf[i] = (uint8_t)next_byte(s);
    return s->segbuf;
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

static void build_huff(huff_t *h, const uint8_t *bits, const uint8_t *vals)
{
    int code = 0, k = 0;
    memset(h->fast, 0, sizeof h->fast);
    h->bad = 0;
    for (int len = 1; len <= 16; len++) {
        int cnt = bits[len - 1];
        /* libjpeg: no code may be all ones; it checks a table where a scan
         * uses it (jpeg_make_d_derived_tbl), so a bad one is kept, unbuilt,
         * to fail that scan */
        if (code + cnt >= (1 << len)) {
            h->bad = 1;
            break;
        }
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
        build_huff(tc ? &s->hac[th] : &s->hdc[th], p + 1, p + 17);
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
    if (L != 6 + 3 * (size_t)s->ncomp) /* checked first, as libjpeg does */
        fail(s, JPEG_CORRUPT, "SOF: bad segment length");
    if (s->ncomp == 4)
        fail(s, JPEG_UNSUPPORTED, "4 components (CMYK or YCCK)");
    if (s->ncomp != 1 && s->ncomp != 3)
        fail(s, JPEG_UNSUPPORTED, "%d components (gray and 3-component "
             "files are decoded)", s->ncomp);
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

/* jdhuff.c jpeg_fill_bit_buffer: FF 00 (after any FF fill bytes) is a
 * data byte FF; any other FF xx is a marker, which ends the data: zero
 * bits follow it */
static void fill(dec_t *s)
{
    while (s->nbits <= 56) {
        int c = -1;
        if (!s->unread_marker) {
            c = next_byte(s);
            if (c == 0xFF) {
                do
                    c = next_byte(s);
                while (c == 0xFF);
                if (c == 0) {
                    c = 0xFF;
                } else {
                    s->unread_marker = c;
                    c = -1;
                }
            }
        }
        if (c < 0) {
            s->fake += 8;
            c = 0;
        }
        s->acc |= (uint64_t)c << (56 - s->nbits);
        s->nbits += 8;
    }
}

/* drop n bits; reading into the zero bits after a marker marks the
 * segment's data as insufficient (the rest of this MCU reads zeros) */
static inline void consume(dec_t *s, int n)
{
    s->acc <<= n;
    s->nbits -= n;
    if (s->nbits < s->fake) {
        s->insufficient = 1;
        s->fake = s->nbits;
    }
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
    if (s->nbits < 17)
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
    /* jpeg_huff_decode: a code past 16 bits is read as 17 bits of
     * symbol 0 (JWRN_HUFF_BAD_CODE) */
    consume(s, 17);
    return 0;
}

/* drop the bits left in the buffer; an unread marker stays unread */
static void reset_bits(dec_t *s)
{
    s->acc = 0;
    s->nbits = s->fake = 0;
}

/* jdmarker.c jpeg_resync_to_restart: the marker found where RST<desired>
 * should be is either discarded (decoding goes on), or left unread (the
 * segment decodes as empty), or skipped for the next marker */
static void resync(dec_t *s, int desired)
{
    for (;;) {
        int m = s->unread_marker, action;
        if (m < 0xC0)
            action = 2;
        else if (m < 0xD0 || m > 0xD7)
            action = 3;
        else if (m == 0xD0 + ((desired + 1) & 7) ||
                 m == 0xD0 + ((desired + 2) & 7))
            action = 3;
        else if (m == 0xD0 + ((desired - 1) & 7) ||
                 m == 0xD0 + ((desired - 2) & 7))
            action = 2;
        else
            action = 1;
        if (action == 1)
            s->unread_marker = 0;
        if (action != 2)
            return;
        s->unread_marker = scan_marker(s);
    }
}

/* jdhuff.c process_restart */
static void restart(dec_t *s, int *next_rst)
{
    reset_bits(s);
    if (!s->unread_marker)
        s->unread_marker = scan_marker(s);
    if (s->unread_marker == 0xD0 + *next_rst)
        s->unread_marker = 0;
    else
        resync(s, *next_rst);
    *next_rst = (*next_rst + 1) & 7;
    for (int i = 0; i < s->ncomp; i++)
        s->comp[i].dc_pred = 0;
    s->eobrun = 0;
    if (!s->unread_marker)
        s->insufficient = 0;
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
            k += r; /* past 63 on corrupt data: NATURAL's extra entries */
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
            k += r; /* past se on corrupt data, as libjpeg writes it */
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
            if (sz) { /* of size 1; libjpeg warns of any other */
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
            if (v)
                blk[NATURAL[k]] = (int16_t)v;
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
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
    int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;

    int dc_band = ss == 0;
    if (s->progressive) {
        int bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
        if ((ah != 0 && al != ah - 1) || al > 13 || bad)
            fail(s, JPEG_CORRUPT, "bad progression parameters Ss=%d Se=%d "
                 "Ah=%d Al=%d", ss, se, ah, al);
        /* scans out of order only draw a warning (JWRN_BOGUS_PROGRESSION);
         * the bits before the scan are kept for block smoothing (jdphuff.c
         * start_pass_phuff_decoder), 0 at the first scan */
        for (int i = 0; i < ns; i++) {
            for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); k++)
                cs[i]->prev_bits[k] = s->scans > 0 ? cs[i]->coef_bits[k] : 0;
            for (int k = ss; k <= se; k++)
                cs[i]->coef_bits[k] = al;
        }
    }
    /* a sequential scan's Ss, Se, Ah and Al are not used: libjpeg warns
     * where they differ from 0, 63, 0, 0 (JWRN_NOT_SEQUENTIAL) */

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
        /* only the tables the scan uses are checked, as libjpeg does */
        if (uses_dc) {
            if (td[i] > 3)
                fail(s, JPEG_CORRUPT, "SOS: Huffman table id above 3");
            huff_t *h = &s->hdc[td[i]];
            if (!h->defined && td[i] < 2 && !s->progressive)
                build_huff(h, STD_DC_BITS[td[i]], STD_DC_VALS);
            if (!h->defined)
                fail(s, JPEG_CORRUPT, "DC Huffman table %d is not defined",
                     td[i]);
            if (h->bad)
                fail(s, JPEG_CORRUPT, "bad Huffman table");
            dct[i] = h;
        }
        if (uses_ac) {
            if (ta[i] > 3)
                fail(s, JPEG_CORRUPT, "SOS: Huffman table id above 3");
            huff_t *h = &s->hac[ta[i]];
            if (!h->defined && ta[i] < 2 && !s->progressive)
                build_huff(h, STD_AC_BITS[ta[i]], STD_AC_VALS[ta[i]]);
            if (!h->defined)
                fail(s, JPEG_CORRUPT, "AC Huffman table %d is not defined",
                     ta[i]);
            if (h->bad)
                fail(s, JPEG_CORRUPT, "bad Huffman table");
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
    s->insufficient = 0;
    int mx_n = ns > 1 ? s->mcux : cs[0]->wib;
    int my_n = ns > 1 ? s->mcuy : cs[0]->hib;
    long long total = (long long)mx_n * my_n;
    int left = s->restart, next_rst = 0;
    for (long long m = 0; m < total; m++) {
        int my = (int)(m / mx_n), mx = (int)(m % mx_n);
        /* jdcoefct.c consume_data: the iMCU row of the last MCU started
         * with data, checked before the MCU's restart marker is read */
        if (!s->insufficient)
            s->last_good = ns > 1 ? my : my / cs[0]->v;
        if (s->restart) {
            if (left == 0) {
                restart(s, &next_rst);
                left = s->restart;
            }
            left--;
        }
        if (s->insufficient)
            continue; /* the MCU keeps its coefficients (zero, or those of
                         earlier scans): uniform gray where nothing came */
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
    reset_bits(s); /* the next marker: unread_marker, else the data's */
}

/* -- samples ------------------------------------------------------------- */

/* jpeg_idct_islow as libjpeg-turbo runs it on x86-64, in SIMD
 * (simd/x86_64/jidctint-sse2.asm and -avx2.asm, which compute alike):
 * jidctint.c's arithmetic, regrouped into pairs of 16-bit products
 * (pmaddwd), on 16-bit lanes.  On coefficients a valid file holds this is
 * jidctint.c's result; on those of damaged data it is what cv2.imread
 * returns, which differs from the C code's: the dequantised coefficient
 * keeps its low 16 bits (pmullw), in0 + in4 and the odd part's z3 and z4
 * are 16-bit sums, each pass saturates its outputs to 16 bits (packssdw),
 * and the samples saturate to -128..127 before the +128 level shift
 * (packsswb, paddb) where jidctint.c masks them into a range table.  The
 * first pass takes libjpeg-turbo's shortcut when rows 1-7 of the block are
 * zero: the dequantised DC shifted left by 2 in 16 bits. */
#define DESCALE_P1 11 /* CONST_BITS - PASS1_BITS */
#define DESCALE_P2 18 /* CONST_BITS + PASS1_BITS + 3 */

static inline int16_t wrap16(uint32_t v)
{
    return (int16_t)(uint16_t)v;
}

static inline int16_t sat16(int32_t v)
{
    return (int16_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

/* one 8-point pass over x[0], x[st], ..., x[7 st]: 16-bit outputs,
 * descaled by d bits with rounding, saturated (32-bit sums wrap as paddd
 * wraps) */
static void idct_pass(const int16_t *x, int st, int16_t *out, int d)
{
    const int32_t in0 = x[0], in1 = x[st], in2 = x[2 * st], in3 = x[3 * st];
    const int32_t in4 = x[4 * st], in5 = x[5 * st], in6 = x[6 * st],
                  in7 = x[7 * st];
    /* even part */
    uint32_t t3 = (uint32_t)(in2 * 10703 + in6 * 4433);
    uint32_t t2 = (uint32_t)(in2 * 4433 + in6 * -10704);
    uint32_t t0 = (uint32_t)(int32_t)wrap16((uint32_t)(in0 + in4)) << 13;
    uint32_t t1 = (uint32_t)(int32_t)wrap16((uint32_t)(in0 - in4)) << 13;
    uint32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    /* odd part */
    const int32_t z3 = wrap16((uint32_t)(in7 + in3));
    const int32_t z4 = wrap16((uint32_t)(in5 + in1));
    uint32_t zz3 = (uint32_t)(z3 * -6436) + (uint32_t)(z4 * 9633);
    uint32_t zz4 = (uint32_t)(z3 * 9633) + (uint32_t)(z4 * 6437);
    uint32_t o0 = (uint32_t)(in7 * -4927 + in1 * -7373) + zz3;
    uint32_t o3 = (uint32_t)(in7 * -7373 + in1 * 4926) + zz4;
    uint32_t o1 = (uint32_t)(in5 * -4176 + in3 * -20995) + zz4;
    uint32_t o2 = (uint32_t)(in5 * -20995 + in3 * 4177) + zz3;
    const uint32_t r = 1u << (d - 1);
    const uint32_t v[8] = {t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                           t13 - o0, t12 - o1, t11 - o2, t10 - o3};
    for (int i = 0; i < 8; i++)
        out[i] = sat16((int32_t)(v[i] + r) >> d);
}

/* coefficients times the quantisation table (both 16-bit, as libjpeg's
 * ISLOW_MULT_TYPE), columns then rows, into 8 x 8 samples at out (row
 * stride `stride`) */
static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                       size_t stride)
{
    int16_t deq[64], ws[64], col[8], row[8];
    int ac = 0;
    for (int k = 0; k < 64; k++) {
        deq[k] = wrap16((uint32_t)((int32_t)in[k] * (int16_t)q[k]));
        if (k >= 8)
            ac |= in[k];
    }
    if (!ac) {
        for (int c = 0; c < 8; c++) {
            int16_t dc = wrap16((uint32_t)(int32_t)deq[c] << 2);
            for (int r = 0; r < 8; r++)
                ws[8 * r + c] = dc;
        }
    } else {
        for (int c = 0; c < 8; c++) {
            idct_pass(deq + c, 8, col, DESCALE_P1);
            for (int r = 0; r < 8; r++)
                ws[8 * r + c] = col[r];
        }
    }
    for (int r = 0; r < 8; r++) {
        uint8_t *o = out + r * stride;
        idct_pass(ws + 8 * r, 1, row, DESCALE_P2);
        for (int i = 0; i < 8; i++)
            o[i] = (uint8_t)((row[i] < -128 ? -128 : row[i] > 127 ? 127
                                                                  : row[i]) +
                             128);
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

/* -- block smoothing (jdcoefct.c, libjpeg-turbo 3.1) ----------------------- */

/* natural positions of the first 10 zigzag coefficients */
static const int SMOOTH_POS[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

/* smoothing_ok: a progressive file whose every component has data (its DC
 * at least partly known, its quantisation table latched, the 10 first
 * quantisers nonzero) and some of whose first 9 AC coefficients are not
 * exact.  Latches the coefficient bits now and before each component's
 * last scan (-1, unknown, after one scan). */
static int smoothing_ok(dec_t *s)
{
    int useful = 0;
    for (int i = 0; i < s->ncomp; i++) {
        comp_t *c = &s->comp[i];
        if (!c->latched)
            return 0;
        for (int k = 0; k < 10; k++)
            if (c->q[SMOOTH_POS[k]] == 0)
                return 0;
        if (c->coef_bits[0] < 0)
            return 0;
        for (int k = 1; k < 10; k++) {
            c->prev_latch[k] = s->scans > 1 ? c->prev_bits[k] : -1;
            c->latch[k] = c->coef_bits[k];
            if (c->coef_bits[k] != 0)
                useful = 1;
        }
    }
    return useful;
}

/* an estimate of a coefficient from num = Q00 * (a sum of DC values),
 * rounded, for a quantiser q and, where al > 0, below 2^al */
static int16_t predict(int64_t num, int64_t q, int al)
{
    int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
    if (al > 0 && pred >= (1 << al))
        pred = (1 << al) - 1;
    return (int16_t)(num >= 0 ? pred : -pred);
}

/* decompress_smooth_data on block (by, bx) of component c: a copy of its
 * coefficients in ws, the first 9 AC estimated where still zero and not
 * exact from the DC values of its 5 x 5 neighbourhood (with change_dc, as
 * nothing of the 9 came yet, the DC too).  Neighbour rows as libjpeg-turbo
 * picks them: it counts a block row's place in the image by the block rows
 * of the block's own iMCU row, and replaces rows past the image's by the
 * nearer ones; columns past the edges repeat the edge column. */
static void smooth_block(const dec_t *s, const comp_t *c, int by, int bx,
                         int16_t *ws)
{
    const int last = s->mcuy - 1, imcu = by / c->v;
    const int *cb = imcu > s->last_good ? c->prev_latch : c->latch;
    int change_dc = 1;
    for (int k = 1; k < 10; k++)
        if (cb[k] != -1)
            change_dc = 0;
    int rows_here = imcu < last ? c->v : (c->hib % c->v ? c->hib % c->v
                                                         : c->v);
    int ibr = imcu * rows_here + by % c->v, ibrs = rows_here * s->mcuy;
    int row[5];
    row[2] = by;
    row[1] = ibr > 0 ? by - 1 : by;
    row[0] = ibr > 1 ? by - 2 : row[1];
    row[3] = ibr < ibrs - 1 ? by + 1 : by;
    row[4] = ibr < ibrs - 2 ? by + 2 : row[3];
    int64_t D[26]; /* D[1..25]: DC01..DC25, row by row */
    for (int r = 0; r < 5; r++)
        for (int k = 0; k < 5; k++) {
            int x = bx + k - 2;
            x = x < 0 ? 0 : x > c->wib - 1 ? c->wib - 1 : x;
            D[1 + 5 * r + k] = c->coef[((size_t)row[r] * c->bw + x) * 64];
        }
    const int64_t Q00 = c->q[0];
    int64_t num;
    if (cb[1] != 0 && ws[1] == 0) { /* AC01 */
        num = change_dc ? -D[1] - D[2] + D[4] + D[5] - 3 * D[6] +
                              13 * D[7] - 13 * D[9] + 3 * D[10] - 3 * D[11] +
                              38 * D[12] - 38 * D[14] + 3 * D[15] -
                              3 * D[16] + 13 * D[17] - 13 * D[19] +
                              3 * D[20] - D[21] - D[22] + D[24] + D[25]
                        : -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15];
        ws[1] = predict(Q00 * num, c->q[1], cb[1]);
    }
    if (cb[2] != 0 && ws[8] == 0) { /* AC10 */
        num = change_dc ? -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] -
                              D[6] + 13 * D[7] + 38 * D[8] + 13 * D[9] -
                              D[10] + D[16] - 13 * D[17] - 38 * D[18] -
                              13 * D[19] + D[20] + D[21] + 3 * D[22] +
                              3 * D[23] + 3 * D[24] + D[25]
                        : -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23];
        ws[8] = predict(Q00 * num, c->q[8], cb[2]);
    }
    if (cb[3] != 0 && ws[16] == 0) { /* AC20 */
        num = change_dc ? D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                              14 * D[13] - 5 * D[14] + 2 * D[17] +
                              7 * D[18] + 2 * D[19] + D[23]
                        : -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] -
                              D[23];
        ws[16] = predict(Q00 * num, c->q[16], cb[3]);
    }
    if (cb[4] != 0 && ws[9] == 0) { /* AC11 */
        num = change_dc ? -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] +
                              9 * D[19] + D[21] - D[25]
                        : D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] -
                              D[20] + D[22] - D[24] + D[4] - D[6] +
                              10 * D[7] - 10 * D[9];
        ws[9] = predict(Q00 * num, c->q[9], cb[4]);
    }
    if (cb[5] != 0 && ws[2] == 0) { /* AC02 */
        num = change_dc ? 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] +
                              7 * D[12] - 14 * D[13] + 7 * D[14] + D[15] +
                              2 * D[17] - 5 * D[18] + 2 * D[19]
                        : -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] -
                              D[15];
        ws[2] = predict(Q00 * num, c->q[2], cb[5]);
    }
    if (!change_dc)
        return;
    if (cb[6] != 0 && ws[3] == 0) /* AC03 */
        ws[3] = predict(Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] -
                               D[19]), c->q[3], cb[6]);
    if (cb[7] != 0 && ws[10] == 0) /* AC12 */
        ws[10] = predict(Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] -
                                D[19]), c->q[10], cb[7]);
    if (cb[8] != 0 && ws[17] == 0) /* AC21 */
        ws[17] = predict(Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] -
                                D[19]), c->q[17], cb[8]);
    if (cb[9] != 0 && ws[24] == 0) /* AC30 */
        ws[24] = predict(Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] -
                                D[19]), c->q[24], cb[9]);
    num = -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] +
          6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] +
          42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] +
          6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] -
          6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25];
    ws[0] = predict(Q00 * num, Q00, 0);
}

static void output(dec_t *s, uint8_t *out)
{
    const int W = s->width, H = s->height;
    const uint8_t *ch[3];
    /* a gray output of a gray or YCbCr file needs only component 0 */
    const int needed = s->gray_out && !s->rgb ? 1 : s->ncomp;
    for (int i = 0; i < needed; i++) {
        comp_t *c = &s->comp[i];
        size_t stride = (size_t)c->wib * 8;
        uint8_t *pl = s->planes[i] = alloc(s, stride * (size_t)c->hib * 8);
        int16_t ws[64];
        for (int by = 0; by < c->hib; by++)
            for (int bx = 0; bx < c->wib; bx++) {
                const int16_t *blk = c->coef + ((size_t)by * c->bw + bx) * 64;
                if (s->smooth) {
                    memcpy(ws, blk, sizeof ws);
                    smooth_block(s, c, by, bx, ws);
                    blk = ws;
                }
                idct_islow(blk, c->q,
                           pl + (size_t)by * 8 * stride + (size_t)bx * 8,
                           stride);
            }
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
    if (s->gray_out && needed == 1) { /* jdcolor.c grayscale_convert */
        memcpy(out, ch[0], npx);
        return;
    }
    if (s->gray_out) { /* jdcolor.c rgb_gray_convert: FIX(0.299) etc. */
        for (size_t k = 0; k < npx; k++)
            out[k] = (uint8_t)((19595 * ch[0][k] + 38470 * ch[1][k] +
                                7471 * ch[2][k] + 32768) >> 16);
        return;
    }
    if (s->ncomp == 1) {
        for (size_t k = 0; k < npx; k++)
            out[3 * k] = out[3 * k + 1] = out[3 * k + 2] = ch[0][k];
        return;
    }
    if (s->rgb) {
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
    for (;;) {
        int m = next_marker(s);
        size_t L;
        const uint8_t *p;
        if (m == 0xD9) { /* EOI */
            if (!s->scans)
                fail(s, JPEG_CORRUPT, "EOI before any scan");
            break;
        }
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01)
            continue; /* stray RSTn / TEM: libjpeg skips them */
        if (m == 0xD8)
            fail(s, JPEG_CORRUPT, "a second SOI marker");
        p = segment(s, m, &L);
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
            if (s->scans == 0 && (s->height != s->want_h ||
                                  s->width != s->want_w))
                fail(s, JPEG_CORRUPT, "the output is %dx%d, the image %dx%d",
                     s->want_h, s->want_w, s->height, s->width);
            if (s->scans == 0) {
                for (int i = 0; i < s->ncomp; i++) {
                    comp_t *c = &s->comp[i];
                    c->coef = alloc(s, (size_t)c->bw * c->bh * 64 *
                                           sizeof(int16_t));
                }
                /* jdapimin.c default_decompress_parms: markers after the
                 * header do not change the colour space */
                if (s->ncomp == 3 && s->jfif)
                    s->rgb = 0;
                else if (s->ncomp == 3 && s->adobe)
                    s->rgb = s->adobe_transform == 0;
                else if (s->ncomp == 3)
                    s->rgb = s->comp[0].id == 'R' && s->comp[1].id == 'G' &&
                             s->comp[2].id == 'B';
            }
            read_sos(s, p, L);
            s->scans++;
            /* libjpeg's single-pass decoder: the image is this scan's,
             * and what follows it cannot change or fail it */
            if (s->scans == 1 && !s->progressive &&
                L == 4 + 2 * (size_t)s->ncomp)
                goto done;
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
done:
    s->smooth = s->progressive && smoothing_ok(s);
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
    free(s->segbuf);
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

/* Decode into out, height x width x 3 bytes in BGR order, or with gray
 * height x width bytes of libjpeg's JCS_GRAYSCALE output (jpeg_info's
 * height and width; the orientation is not applied here). */
int jpeg_decode_as(const uint8_t *data, int64_t len, uint8_t *out,
                   int64_t height, int64_t width, int gray, char *err,
                   int errlen)
{
    dec_t s;
    start(&s, data, len, err, errlen);
    s.want_h = (int)height;
    s.want_w = (int)width;
    s.gray_out = gray != 0;
    int status = setjmp(s.jb);
    if (status == 0)
        run(&s, 0, out);
    release(&s);
    return status;
}
