/* A JPEG 2000 codestream writer (ITU-T T.800, and T.814's HT block coder)
 * for the port's fixtures: the machines that run the port may have no JPEG
 * 2000 encoder, and data/fixtures.py writes JP2 frames there as a dataset
 * would store them.  By default one tile, the reversible colour transform
 * where asked, the 5/3 wavelet at up to 5 levels, 64 x 64 code blocks, one
 * quality layer in LRCP order, no quantisation (2 guard bits); every
 * coding pass of a code block in one MQ codeword.  Its options add
 * tiles, other code-block sizes and levels, the 9/7 wavelet with the ICT
 * (every band quantised at a step of 1/2), and HTJ2K code blocks: the
 * cleanup pass at bit-plane 0, or at a higher plane followed by SigProp
 * (and MagRef), written so that OpenJPEG's ht_dec.c reads them back.  The
 * JP2 boxes are written by data/jp2.py.
 *
 * j2k_encode: int32 component planes [C][H][W] of ``prec``-bit unsigned
 * samples, and the options -> the codestream.  Built by the host C
 * compiler at first use and called through ctypes.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "ht_tables.h"

#define ENC_OK 0
#define ENC_BAD 1
#define ENC_NOMEM 3

/* ------------------------------------------------------------------ */
/* the MQ coder (T.800 C.2) */

static const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
static const uint8_t NMPS[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t NLPS[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
    18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t SWITCH[47] = {
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

#define CX_SC 9
#define CX_MR 14
#define CX_AGG 17
#define CX_UNI 18
#define NCX 19

typedef struct {
    uint8_t *start, *bp;  /* bp points at the last byte written */
    uint32_t a, c, ct;
    uint8_t st[NCX], mps[NCX];
} mqe_t;

static void mqe_init(mqe_t *m, uint8_t *buf)
{
    /* buf[-1] is a scratch byte that BYTEOUT may carry into */
    memset(m->st, 0, sizeof m->st);
    memset(m->mps, 0, sizeof m->mps);
    m->st[CX_UNI] = 46;
    m->st[CX_AGG] = 3;
    m->st[0] = 4;
    m->start = buf;
    m->bp = buf - 1;
    *m->bp = 0;
    m->a = 0x8000;
    m->c = 0;
    m->ct = 12;
}

static void mqe_byteout(mqe_t *m)
{
    if (*m->bp == 0xff) {
        m->bp++;
        *m->bp = (uint8_t)(m->c >> 20);
        m->c &= 0xfffff;
        m->ct = 7;
    } else if (!(m->c & 0x8000000)) {
        m->bp++;
        *m->bp = (uint8_t)(m->c >> 19);
        m->c &= 0x7ffff;
        m->ct = 8;
    } else {
        (*m->bp)++;
        if (*m->bp == 0xff) {
            m->c &= 0x7ffffff;
            m->bp++;
            *m->bp = (uint8_t)(m->c >> 20);
            m->c &= 0xfffff;
            m->ct = 7;
        } else {
            m->bp++;
            *m->bp = (uint8_t)(m->c >> 19);
            m->c &= 0x7ffff;
            m->ct = 8;
        }
    }
}

static void mqe_renorm(mqe_t *m)
{
    do {
        m->a <<= 1;
        m->c <<= 1;
        if (!--m->ct)
            mqe_byteout(m);
    } while (!(m->a & 0x8000));
}

static void mqe_encode(mqe_t *m, int cx, uint32_t d)
{
    uint32_t s = m->st[cx], qe = QE[s];
    m->a -= qe;
    if (d == m->mps[cx]) {
        if (!(m->a & 0x8000)) {
            if (m->a < qe)
                m->a = qe;
            else
                m->c += qe;
            m->st[cx] = NMPS[s];
            mqe_renorm(m);
        } else
            m->c += qe;
    } else {
        if (m->a < qe)
            m->c += qe;
        else
            m->a = qe;
        if (SWITCH[s])
            m->mps[cx] = (uint8_t)!m->mps[cx];
        m->st[cx] = NLPS[s];
        mqe_renorm(m);
    }
}

/* FLUSH (C.2.9); returns the codeword's length */
static size_t mqe_flush(mqe_t *m)
{
    uint32_t tempc = m->c + m->a;
    m->c |= 0xffff;
    if (m->c >= tempc)
        m->c -= 0x8000;
    m->c <<= m->ct;
    mqe_byteout(m);
    m->c <<= m->ct;
    mqe_byteout(m);
    if (*m->bp != 0xff)
        m->bp++;
    return (size_t)(m->bp - m->start);
}

/* ------------------------------------------------------------------ */
/* tier 1: the three coding passes (D.3), as the decoder reads them */

#define F_SIG 1
#define F_NEG 2
#define F_VIS 4
#define F_REF 8

typedef uint8_t zc_lut_t[4][3][3][5];

static void zc_init(zc_lut_t zc_lut)
{
    int o, h, v, dd;
    for (o = 0; o < 4; ++o)
        for (h = 0; h < 3; ++h)
            for (v = 0; v < 3; ++v)
                for (dd = 0; dd < 5; ++dd) {
                    int hh = o == 1 ? v : h, vv = o == 1 ? h : v, cx;
                    if (o == 3) {
                        int hv = h + v;
                        if (dd >= 3)
                            cx = 8;
                        else if (dd == 2)
                            cx = hv >= 1 ? 7 : 6;
                        else if (dd == 1)
                            cx = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
                        else
                            cx = hv >= 2 ? 2 : hv;
                    } else if (hh == 2)
                        cx = 8;
                    else if (hh == 1)
                        cx = vv >= 1 ? 7 : dd >= 1 ? 6 : 5;
                    else if (vv == 2)
                        cx = 4;
                    else if (vv == 1)
                        cx = 3;
                    else
                        cx = dd >= 2 ? 2 : dd;
                    zc_lut[o][h][v][dd] = (uint8_t)cx;
                }
}

typedef struct {
    uint32_t w, h, stride, orient;
    uint8_t *f;
    const int32_t *v;   /* the code block's coefficients, w x h */
    mqe_t mq;
    zc_lut_t zc;
} t1e_t;

static void nb(const t1e_t *t, uint32_t i, int *h, int *v, int *dd)
{
    const uint8_t *f = t->f;
    uint32_t s = t->stride;
    *h = (f[i - 1] & F_SIG) + (f[i + 1] & F_SIG);
    *v = (f[i - s] & F_SIG) + (f[i + s] & F_SIG);
    *dd = (f[i - s - 1] & F_SIG) + (f[i - s + 1] & F_SIG)
        + (f[i + s - 1] & F_SIG) + (f[i + s + 1] & F_SIG);
}

static int contrib(uint8_t f)
{
    return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0;
}

static void code_sign(t1e_t *t, uint32_t i, uint32_t x, uint32_t y)
{
    const uint8_t *f = t->f;
    uint32_t s = t->stride, neg = t->v[y * t->w + x] < 0, xr = 0;
    int hc = contrib(f[i - 1]) + contrib(f[i + 1]);
    int vc = contrib(f[i - s]) + contrib(f[i + s]), cx;
    hc = hc > 1 ? 1 : hc < -1 ? -1 : hc;
    vc = vc > 1 ? 1 : vc < -1 ? -1 : vc;
    if (hc < 0 || (hc == 0 && vc < 0)) {
        hc = -hc;
        vc = -vc;
        xr = 1;
    }
    cx = hc == 1 ? CX_SC + 3 + vc : CX_SC + (vc != 0);
    mqe_encode(&t->mq, cx, neg ^ xr);
    t->f[i] |= (uint8_t)(F_SIG | (neg ? F_NEG : 0));
}

static uint32_t bit(const t1e_t *t, uint32_t x, uint32_t y, int p)
{
    int32_t v = t->v[y * t->w + x];
    return ((uint32_t)(v < 0 ? -v : v) >> p) & 1u;
}

static void sigpass(t1e_t *t, int p)
{
    uint32_t k, x, y;
    for (k = 0; k < t->h; k += 4)
        for (x = 0; x < t->w; ++x)
            for (y = k; y < k + 4 && y < t->h; ++y) {
                uint32_t i = (y + 1) * t->stride + x + 1, b;
                int h, v, dd;
                if (t->f[i] & (F_SIG | F_VIS))
                    continue;
                nb(t, i, &h, &v, &dd);
                if (!(h | v | dd))
                    continue;
                b = bit(t, x, y, p);
                mqe_encode(&t->mq, t->zc[t->orient][h][v][dd], b);
                if (b)
                    code_sign(t, i, x, y);
                t->f[i] |= F_VIS;
            }
}

static void refpass(t1e_t *t, int p)
{
    uint32_t k, x, y;
    for (k = 0; k < t->h; k += 4)
        for (x = 0; x < t->w; ++x)
            for (y = k; y < k + 4 && y < t->h; ++y) {
                uint32_t i = (y + 1) * t->stride + x + 1;
                int cx;
                if ((t->f[i] & (F_SIG | F_VIS)) != F_SIG)
                    continue;
                if (t->f[i] & F_REF)
                    cx = CX_MR + 2;
                else {
                    int h, v, dd;
                    nb(t, i, &h, &v, &dd);
                    cx = CX_MR + ((h | v | dd) != 0);
                }
                mqe_encode(&t->mq, cx, bit(t, x, y, p));
                t->f[i] |= F_REF;
            }
}

static void cln_step(t1e_t *t, uint32_t x, uint32_t y, int p)
{
    uint32_t i = (y + 1) * t->stride + x + 1, b;
    int h, v, dd;
    if (t->f[i] & (F_SIG | F_VIS))
        return;
    nb(t, i, &h, &v, &dd);
    b = bit(t, x, y, p);
    mqe_encode(&t->mq, t->zc[t->orient][h][v][dd], b);
    if (b)
        code_sign(t, i, x, y);
}

static void clnpass(t1e_t *t, int p)
{
    uint32_t k, x, y;
    for (k = 0; k < t->h; k += 4)
        for (x = 0; x < t->w; ++x) {
            uint32_t start = k;
            if (k + 4 <= t->h) {
                int quiet = 1;
                for (y = k; y < k + 4 && quiet; ++y) {
                    uint32_t i = (y + 1) * t->stride + x + 1;
                    int h, v, dd;
                    nb(t, i, &h, &v, &dd);
                    quiet = !(t->f[i] & (F_SIG | F_VIS)) && !(h | v | dd);
                }
                if (quiet) {
                    uint32_t r = 4;
                    for (y = k; y < k + 4; ++y)
                        if (bit(t, x, y, p)) {
                            r = y - k;
                            break;
                        }
                    mqe_encode(&t->mq, CX_AGG, r < 4);
                    if (r == 4)
                        continue;
                    mqe_encode(&t->mq, CX_UNI, r >> 1);
                    mqe_encode(&t->mq, CX_UNI, r & 1);
                    y = k + r;
                    code_sign(t, (y + 1) * t->stride + x + 1, x, y);
                    start = y + 1;
                }
            }
            for (y = start; y < k + 4 && y < t->h; ++y)
                cln_step(t, x, y, p);
        }
    for (y = 0; y < t->h; ++y)
        for (x = 0; x < t->w; ++x)
            t->f[(y + 1) * t->stride + x + 1] &= (uint8_t)~F_VIS;
}

/* ------------------------------------------------------------------ */
/* packet headers: bits with the decoder's stuffing after 0xFF */

typedef struct {
    uint8_t *p;
    size_t n, cap;
    uint32_t buf, ct;
    int nomem;
} bits_t;

static void put_byte(bits_t *b, uint8_t v)
{
    if (b->n == b->cap) {
        size_t cap = b->cap ? 2 * b->cap : 1024;
        uint8_t *p = realloc(b->p, cap);
        if (!p) {
            b->nomem = 1;
            return;
        }
        b->p = p;
        b->cap = cap;
    }
    b->p[b->n++] = v;
}

static void bits_byteout(bits_t *b)
{
    b->buf = (b->buf << 8) & 0xffff;
    b->ct = b->buf == 0xff00 ? 7 : 8;
    put_byte(b, (uint8_t)(b->buf >> 8));
}

static void put_bit(bits_t *b, uint32_t v)
{
    if (!b->ct)
        bits_byteout(b);
    b->ct--;
    b->buf |= v << b->ct;
}

static void put_bits(bits_t *b, uint32_t v, int n)
{
    int i;
    for (i = n - 1; i >= 0; --i)
        put_bit(b, (v >> i) & 1u);
}

static void bits_flush(bits_t *b)
{
    b->ct = 0;
    bits_byteout(b);
    if (b->ct == 7) {
        b->ct = 0;
        bits_byteout(b);
    }
}

/* a tag tree over w x h leaves (B.10.2): value, low and known per node */
typedef struct {
    int32_t *v, *low, *parent;
    uint8_t *known;
    uint32_t n;
} tgt_t;

static int tgt_build(tgt_t *t, uint32_t w, uint32_t h, const int32_t *leaf)
{
    uint32_t nw[32], nh[32], levels = 0, total = 0, k, i, j, base, next;
    nw[0] = w;
    nh[0] = h;
    do {
        total += nw[levels] * nh[levels];
        nw[levels + 1] = (nw[levels] + 1) / 2;
        nh[levels + 1] = (nh[levels] + 1) / 2;
        ++levels;
    } while (nw[levels - 1] * nh[levels - 1] > 1);
    t->n = total;
    t->v = malloc(total * sizeof(int32_t));
    t->low = calloc(total, sizeof(int32_t));
    t->parent = malloc(total * sizeof(int32_t));
    t->known = calloc(total, 1);
    if (!t->v || !t->low || !t->parent || !t->known)
        return -1;
    for (i = 0; i < total; ++i)
        t->v[i] = INT32_MAX;
    memcpy(t->v, leaf, (size_t)w * h * sizeof(int32_t));
    base = 0;
    for (k = 0; k < levels; ++k) {
        next = base + nw[k] * nh[k];
        for (j = 0; j < nh[k]; ++j)
            for (i = 0; i < nw[k]; ++i) {
                uint32_t me = base + j * nw[k] + i;
                int32_t par = k + 1 < levels ?
                    (int32_t)(next + (j / 2) * nw[k + 1] + i / 2) : -1;
                t->parent[me] = par;
                if (par >= 0 && t->v[me] < t->v[par])
                    t->v[par] = t->v[me];
            }
        base = next;
    }
    return 0;
}

static void tgt_free(tgt_t *t)
{
    free(t->v);
    free(t->low);
    free(t->parent);
    free(t->known);
}

static void tgt_encode(bits_t *b, tgt_t *t, uint32_t leaf, int32_t threshold)
{
    int32_t stk[32], low = 0, idx = (int32_t)leaf;
    int sp = 0;
    while (t->parent[idx] >= 0) {
        stk[sp++] = idx;
        idx = t->parent[idx];
    }
    for (;;) {
        if (low > t->low[idx])
            t->low[idx] = low;
        else
            low = t->low[idx];
        while (low < threshold) {
            if (low >= t->v[idx]) {
                if (!t->known[idx]) {
                    put_bit(b, 1);
                    t->known[idx] = 1;
                }
                break;
            }
            put_bit(b, 0);
            ++low;
        }
        t->low[idx] = low;
        if (!sp)
            break;
        idx = stk[--sp];
    }
}

/* ------------------------------------------------------------------ */
/* the HT block coder (T.814): the cleanup pass (MagSgn forward, MEL
 * forward, VLC and UVLC backward from the segment's end, the tables of
 * ht_tables.h read in reverse), then SigProp and MagRef, in the order
 * OpenJPEG's ht_dec.c reads them back */

/* a forward byte writer (MagSgn, SigProp): bits least significant first,
 * 7 bits in a byte after 0xFF */
typedef struct {
    uint8_t *p;
    size_t n, cap;
    uint32_t tmp;
    int used, max;
} fwe_t;

static void fwe_put(fwe_t *e, uint32_t v, int n)
{
    while (n > 0) {
        int t = e->max - e->used < n ? e->max - e->used : n;
        e->tmp |= (v & ((1u << t) - 1)) << e->used;
        e->used += t;
        v = t < 32 ? v >> t : 0;
        n -= t;
        if (e->used == e->max) {
            if (e->n < e->cap)
                e->p[e->n] = (uint8_t)e->tmp;
            e->n++;
            e->max = e->tmp == 0xff ? 7 : 8;
            e->tmp = 0;
            e->used = 0;
        }
    }
}

/* the last byte, the rest of its bits ones (MagSgn: a final 0xFF is
 * dropped, as the decoder reads 0xFF past the end) or zeros (SigProp) */
static void fwe_end(fwe_t *e, int ones)
{
    if (e->used) {
        if (ones)
            e->tmp |= (0xffu >> e->used) << e->used & ((1u << e->max) - 1);
        if (!(ones && e->tmp == 0xff)) {
            if (e->n < e->cap)
                e->p[e->n] = (uint8_t)e->tmp;
            e->n++;
        }
    } else if (ones && e->max == 7)
        e->n--;  /* a 0xFF last: the decoder reads one past the end */
}

/* a backward byte writer (VLC, MagRef): bits least significant first,
 * bytes from the end; after a byte above 0x8F, 7 bits unless the 8th
 * keeps the byte's low 7 bits from all being set */
typedef struct {
    uint8_t *p;        /* p[0] is the last byte, p[-k] the k-th before */
    size_t n, cap;
    uint32_t tmp;
    int used, gt8f;
} rve_t;

static void rve_put(rve_t *e, uint32_t v, int n)
{
    while (n > 0) {
        int avail = 8 - e->gt8f - e->used;
        int t = avail < n ? avail : n;
        e->tmp |= (v & ((1u << t) - 1)) << e->used;
        e->used += t;
        avail -= t;
        n -= t;
        v = t < 32 ? v >> t : 0;
        if (!avail) {
            if (e->gt8f && e->tmp != 0x7f) {
                e->gt8f = 0;
                continue;
            }
            if (e->n < e->cap)
                e->p[-(ptrdiff_t)e->n] = (uint8_t)e->tmp;
            e->n++;
            e->gt8f = e->tmp > 0x8f;
            e->tmp = 0;
            e->used = 0;
        }
    }
}

static void rve_end(rve_t *e)
{
    if (e->used) {
        if (e->n < e->cap)
            e->p[-(ptrdiff_t)e->n] = (uint8_t)e->tmp;
        e->n++;
    }
}

/* the MEL coder (T.814 7.3.3): its bits most significant first */
typedef struct {
    uint8_t *p;
    size_t n, cap;
    uint32_t tmp;
    int left, max, k, run;  /* left of max bits in the byte being filled */
} mele_t;

static void mel_emit(mele_t *m, int bit)
{
    m->tmp = m->tmp << 1 | (uint32_t)bit;
    if (!--m->left) {
        if (m->n < m->cap)
            m->p[m->n] = (uint8_t)m->tmp;
        m->n++;
        m->left = m->max = m->tmp == 0xff ? 7 : 8;
        m->tmp = 0;
    }
}

static void mel_encode(mele_t *m, int bit)
{
    if (!bit) {
        if (++m->run >= 1 << mel_exp[m->k]) {
            mel_emit(m, 1);
            m->run = 0;
            m->k = m->k < 12 ? m->k + 1 : 12;
        }
    } else {
        int e = mel_exp[m->k];
        mel_emit(m, 0);
        while (e > 0) {
            --e;
            mel_emit(m, (m->run >> e) & 1);
        }
        m->run = 0;
        m->k = m->k > 0 ? m->k - 1 : 0;
    }
}

static void mel_end(mele_t *m)
{
    if (m->run)
        mel_emit(m, 1);
    if (m->left < m->max) {
        if (m->n < m->cap)
            m->p[m->n] = (uint8_t)(m->tmp << m->left);
        m->n++;
    }
}

/* the VLC codes of the decoder's tables, by table, context, rho and
 * u_off: each code's e_k, e_1, codeword and length */
typedef struct {
    uint8_t ek, e1, len;
    uint8_t cwd;
} vlc_code;

typedef struct {
    vlc_code c[2][8][16][2][16];
    uint8_t n[2][8][16][2];
} vlc_enc_t;

static vlc_enc_t *vlc_enc_tables(void)
{
    static vlc_enc_t t;
    static int done;
    int tb, ctx, i;
    if (done)
        return &t;
    memset(&t, 0, sizeof t);
    for (tb = 0; tb < 2; ++tb)
        for (ctx = 0; ctx < 8; ++ctx)
            for (i = 0; i < 128; ++i) {
                uint16_t e = (tb ? vlc_tbl1 : vlc_tbl0)[ctx << 7 | i];
                int len = e & 7, rho = e >> 4 & 15, uoff = e >> 3 & 1, k;
                uint8_t *n = &t.n[tb][ctx][rho][uoff];
                vlc_code c;
                if (!len || (i >> len))
                    continue;  /* each code once: at its own bits */
                c.ek = (uint8_t)(e >> 12);
                c.e1 = (uint8_t)(e >> 8 & 15);
                c.len = (uint8_t)len;
                c.cwd = (uint8_t)i;
                for (k = 0; k < *n; ++k)
                    if (t.c[tb][ctx][rho][uoff][k].cwd == c.cwd
                        && t.c[tb][ctx][rho][uoff][k].len == c.len)
                        break;
                if (k == *n && *n < 16)
                    t.c[tb][ctx][rho][uoff][(*n)++] = c;
            }
    done = 1;
    return &t;
}

static int bitlen(uint32_t v)
{
    int n = 0;
    while (v) {
        v >>= 1;
        ++n;
    }
    return n;
}

/* UVLC (T.814 7.3.6): the prefix and suffix of u >= 1 */
static void uvlc_prefix_put(rve_t *e, uint32_t u)
{
    if (u == 1)
        rve_put(e, 1, 1);
    else if (u == 2)
        rve_put(e, 2, 2);
    else
        rve_put(e, u <= 4 ? 4 : 0, 3);
}

static void uvlc_suffix_put(rve_t *e, uint32_t u)
{
    if (u == 3 || u == 4)
        rve_put(e, u - 3, 1);
    else if (u >= 5)
        rve_put(e, u - 5, 5);
}

typedef struct {
    uint32_t w, h;
    const uint32_t *mag;   /* |coefficient| */
    const uint8_t *neg;
    int pc;                /* the cleanup's bit-plane */
} htb_t;

static uint32_t ht_mu(const htb_t *b, int32_t y, int32_t x)
{
    if (x < 0 || y < 0 || (uint32_t)x >= b->w || (uint32_t)y >= b->h)
        return 0;
    return b->mag[(uint32_t)y * b->w + (uint32_t)x] >> b->pc;
}

static int ht_e(uint32_t mu)
{
    return mu ? 1 + bitlen(mu - 1) : 0;
}

/* one quad (T.814 7.3; samples 0-3: top left, bottom left, top right,
 * bottom right): rho, each sample's exponent E and MagSgn value v =
 * 2 (mu - 1) + sign, the largest E */
typedef struct {
    int rho, e[4], emax;
    uint32_t v[4];
} quad_t;

static void ht_quad(const htb_t *b, int32_t y0, int32_t x0, quad_t *o)
{
    int n;
    memset(o, 0, sizeof *o);
    for (n = 0; n < 4; ++n) {
        int32_t x = x0 + (n >> 1), y = y0 + (n & 1);
        uint32_t mu = ht_mu(b, y, x);
        o->e[n] = ht_e(mu);
        if (mu) {
            o->rho |= 1 << n;
            o->v[n] = 2 * (mu - 1) + b->neg[(uint32_t)y * b->w + (uint32_t)x];
        }
        o->emax = o->e[n] > o->emax ? o->e[n] : o->emax;
    }
}

/* the quad's context and kappa: in the first line pair from its left
 * quad's significance, kappa 1; below it from the significance of the
 * samples to its west and north (T.814 eq. 1, 2) and the largest E of
 * the four above it */
static int ht_context(const htb_t *b, int32_t y0, int32_t x0, int rho,
                      uint32_t *kappa)
{
    int32_t ya = y0 - 1, j;
    int m = 0;
    *kappa = 1;
    if (!y0)
        return (ht_mu(b, 0, x0 - 2) || ht_mu(b, 1, x0 - 2))
            | (ht_mu(b, 0, x0 - 1) != 0) << 1
            | (ht_mu(b, 1, x0 - 1) != 0) << 2;
    for (j = -1; j <= 2; ++j) {
        int e = ht_e(ht_mu(b, ya, x0 + j));
        m = e > m ? e : m;
    }
    if (rho & (rho - 1))  /* gamma: more than one significant sample */
        *kappa = m - 1 > 1 ? (uint32_t)(m - 1) : 1;
    return (ht_mu(b, ya, x0 - 1) || ht_mu(b, ya, x0))
        | (ht_mu(b, y0, x0 - 1) || ht_mu(b, y0 + 1, x0 - 1)) << 1
        | (ht_mu(b, ya, x0 + 1) || ht_mu(b, ya, x0 + 2)) << 2;
}

/* the shortest VLC code of the quad's context, rho and u_off whose e_k /
 * e_1 bits hold for its samples' exponents (NULL: none) */
static const vlc_code *ht_code(int first_row, int c, const quad_t *q,
                               uint32_t U, int uoff)
{
    vlc_enc_t *tb = vlc_enc_tables();
    const vlc_code *codes = tb->c[!first_row][c][q->rho][uoff], *best = NULL;
    int k, n;
    for (k = 0; k < tb->n[!first_row][c][q->rho][uoff]; ++k) {
        int ok = 1;
        for (n = 0; n < 4 && ok; ++n)
            if (codes[k].ek >> n & 1)
                ok = (codes[k].e1 >> n & 1) ? q->e[n] == (int)U
                                            : q->e[n] <= (int)U - 1;
        if (ok && (!best || codes[k].len < best->len))
            best = &codes[k];
    }
    return best;
}

/* the UVLC of a quad pair's u (0 where its u_off is 0); the first line
 * pair codes two u above 2 with a MEL event and u - 2, or a second u of
 * 1 or 2 after a first above 2 in one bit */
static void uvlc_pair_put(rve_t *vlc, mele_t *mel, int first_row,
                          uint32_t u0, uint32_t u1)
{
    if (first_row && u0 && u1) {
        int both = u0 > 2 && u1 > 2;
        mel_encode(mel, both);
        if (both) {
            u0 -= 2;
            u1 -= 2;
        } else {
            uvlc_prefix_put(vlc, u0);
            if (u0 > 2)
                rve_put(vlc, u1 - 1, 1);
            else
                uvlc_prefix_put(vlc, u1);
            uvlc_suffix_put(vlc, u0);
            if (u0 <= 2)
                uvlc_suffix_put(vlc, u1);
            return;
        }
    }
    if (u0)
        uvlc_prefix_put(vlc, u0);
    if (u1)
        uvlc_prefix_put(vlc, u1);
    if (u0)
        uvlc_suffix_put(vlc, u0);
    if (u1)
        uvlc_suffix_put(vlc, u1);
}

/* the cleanup pass: MagSgn, then MEL, then the VLC; *len gets its length
 * (ENC_BAD where a quad has no code or the Scup does not fit) */
static int ht_cleanup(const htb_t *b, uint8_t *out, size_t cap, size_t *len)
{
    uint32_t qw = (b->w + 1) / 2, qh = (b->h + 1) / 2, qx, qy;
    uint8_t *mel_buf = malloc(cap), *vlc_buf = malloc(cap + 1);
    fwe_t ms;
    mele_t mel;
    rve_t vlc;
    size_t scup, i;
    int status = ENC_OK;
    if (!mel_buf || !vlc_buf) {
        free(mel_buf);
        free(vlc_buf);
        return ENC_NOMEM;
    }
    memset(&ms, 0, sizeof ms);
    ms.p = out;
    ms.cap = cap;
    ms.max = 8;
    memset(&mel, 0, sizeof mel);
    mel.p = mel_buf;
    mel.cap = cap;
    mel.left = mel.max = 8;
    memset(&vlc, 0, sizeof vlc);
    vlc.p = vlc_buf + cap;
    vlc.cap = cap;
    vlc.p[0] = 0xff;   /* Scup's high byte, written last */
    vlc.n = 1;
    vlc.tmp = 0xf;     /* Scup's low nibble, below the first VLC bits */
    vlc.used = 4;
    vlc.gt8f = 1;
    for (qy = 0; qy < qh; ++qy)
        for (qx = 0; qx < qw; qx += 2) {
            uint32_t u[2] = {0, 0}, k;
            for (k = 0; k < 2 && qx + k < qw; ++k) {
                int32_t x0 = 2 * (int32_t)(qx + k), y0 = 2 * (int32_t)qy;
                const vlc_code *code;
                uint32_t kappa, U, n;
                quad_t q;
                int c;
                ht_quad(b, y0, x0, &q);
                c = ht_context(b, y0, x0, q.rho, &kappa);
                U = (uint32_t)q.emax > kappa ? (uint32_t)q.emax : kappa;
                u[k] = U - kappa;
                code = ht_code(!qy, c, &q, U, u[k] > 0);
                if (c == 0)
                    mel_encode(&mel, q.rho != 0);
                if (!c && !q.rho)
                    continue;
                if (!code) {
                    status = ENC_BAD;
                    goto done;
                }
                rve_put(&vlc, code->cwd, code->len);
                for (n = 0; n < 4; ++n)
                    if (q.rho >> n & 1) {
                        int m = (int)U - (code->ek >> n & 1);
                        fwe_put(&ms, q.v[n] & (m >= 32 ? ~0u : (1u << m) - 1),
                                m);
                    }
            }
            uvlc_pair_put(&vlc, &mel, !qy, u[0], u[1]);
        }
    fwe_end(&ms, 1);
    mel_end(&mel);
    rve_end(&vlc);
    scup = mel.n + vlc.n;
    if (scup > 4079 || ms.n + scup > cap) {
        status = ENC_BAD;
        goto done;
    }
    memcpy(out + ms.n, mel_buf, mel.n);
    for (i = 0; i < vlc.n; ++i)
        out[ms.n + mel.n + i] = vlc.p[-(ptrdiff_t)(vlc.n - 1 - i)];
    *len = ms.n + scup;
    out[*len - 1] = (uint8_t)(scup >> 4);
    out[*len - 2] = (uint8_t)((out[*len - 2] & 0xf0) | (scup & 0xf));
done:
    free(mel_buf);
    free(vlc_buf);
    return status;
}

/* SigProp (forward) then MagRef (backward) at bit-plane pc - 1, as
 * ht_dec.c reads them back: the refinement segment; passes 2 or 3 */
static int ht_refinement(const htb_t *b, int passes, int causal,
                         uint8_t *out, size_t cap, size_t *len)
{
    uint32_t w = b->w, h = b->h, x, y, g;
    uint32_t mstr = ((w + 3) / 4 + 2 + 7) & ~7u, pr = (uint32_t)b->pc - 1;
    uint16_t *sigma = calloc((size_t)mstr * ((h + 3) / 4 + 1), 2);
    uint8_t *mr = malloc(cap + 1);
    uint16_t prev_row[256 + 8];
    fwe_t sp;
    rve_t rv;
    size_t i;
    if (!sigma || !mr) {
        free(sigma);
        free(mr);
        return ENC_NOMEM;
    }
    for (y = 0; y < h; ++y)
        for (x = 0; x < w; ++x)
            if (b->mag[y * w + x] >> b->pc)
                sigma[(y >> 2) * mstr + (x >> 2)] |=
                    (uint16_t)(1u << (4 * (x & 3) + (y & 3)));
    memset(&sp, 0, sizeof sp);
    sp.p = out;
    sp.cap = cap;
    sp.max = 8;
    memset(&rv, 0, sizeof rv);
    rv.p = mr + cap;
    rv.cap = cap;
    rv.gt8f = 1;
    memset(prev_row, 0, sizeof prev_row);
    for (y = 0; y < h; y += 4) {
        uint32_t pattern = h - y >= 4 ? 0xffffu : h - y == 3 ? 0x7777u
            : h - y == 2 ? 0x3333u : 0x1111u, prev = 0;
        const uint16_t *cur = sigma + (y >> 2) * mstr;
        for (x = 0, g = 0; x < w; x += 4, ++g) {
            int32_t s = (int32_t)(x + 4) - (int32_t)w;
            uint32_t ps, ns, u, cs, mbr, t, new_sig, inv;
            int i4, j;
            static const uint32_t grow[4] = {0x33, 0x76, 0xec, 0xc8};
            s = s > 0 ? s : 0;
            pattern >>= s * 4;
            ps = prev_row[g] | (uint32_t)prev_row[g + 1] << 16;
            ns = cur[mstr + g] | (uint32_t)cur[mstr + g + 1] << 16;
            u = (ps & 0x88888888u) >> 3;
            if (!causal)
                u |= (ns & 0x11111111u) << 3;
            cs = cur[g] | (uint32_t)cur[g + 1] << 16;
            mbr = cs | (cs & 0x77777777u) << 1 | (cs & 0xeeeeeeeeu) >> 1 | u;
            t = mbr;
            mbr |= t << 4 | t >> 4 | prev >> 12;
            mbr &= pattern & ~cs;
            new_sig = mbr;
            inv = ~cs & pattern;
            for (i4 = 0; i4 < 16; i4 += 4)
                for (j = 0; j < 4; ++j) {
                    uint32_t m = 1u << (i4 + j);
                    if (new_sig & m) {
                        uint32_t bit = b->mag[(y + (uint32_t)j) * w + x
                                              + (uint32_t)i4 / 4] >> pr & 1;
                        new_sig &= ~m;
                        if (bit)
                            new_sig |= (grow[j] << i4) & inv;
                        fwe_put(&sp, bit, 1);
                    }
                }
            for (i4 = 0; i4 < 4; ++i4)
                for (j = 0; j < 4; ++j)
                    if (new_sig & (1u << (4 * i4 + j)))
                        fwe_put(&sp, b->neg[(y + (uint32_t)j) * w + x
                                            + (uint32_t)i4], 1);
            new_sig |= cs;
            prev_row[g] = (uint16_t)new_sig;
            t = new_sig;
            new_sig |= (t & 0x7777) << 1 | (t & 0xeeee) >> 1;
            prev = (new_sig | u) & 0xf000;
        }
    }
    fwe_end(&sp, 0);
    if (passes > 2)  /* MagRef */
        for (y = 0; y < h; y += 4)
            for (x = 0; x < w; x += 4) {
                uint32_t sig = sigma[(y >> 2) * mstr + (x >> 2)], col, j;
                for (col = 0; col < 4; ++col, sig >>= 4)
                    for (j = 0; j < 4; ++j)
                        if (sig & (1u << j))
                            rve_put(&rv,
                                    b->mag[(y + j) * w + x + col] >> pr & 1,
                                    1);
            }
    rve_end(&rv);
    if (sp.n + rv.n > cap) {
        free(sigma);
        free(mr);
        return ENC_BAD;
    }
    for (i = 0; i < rv.n; ++i)
        out[sp.n + i] = rv.p[-(ptrdiff_t)(rv.n - 1 - i)];
    *len = sp.n + rv.n;
    free(sigma);
    free(mr);
    return ENC_OK;
}

/* ------------------------------------------------------------------ */
/* the forward wavelets (lines start on even coordinates) */

static void fdwt53_line(int32_t *x, int32_t *tmp, int32_t n)
{
    int32_t sn = (n + 1) / 2, dn = n / 2, i;
    if (n < 2)
        return;
    for (i = 0; i < dn; ++i) {
        int32_t l = x[2 * i], r = 2 * i + 2 < n ? x[2 * i + 2] : x[2 * i];
        x[2 * i + 1] -= (int32_t)(((int64_t)l + r) >> 1);
    }
    for (i = 0; i < sn; ++i) {
        int32_t dl = i > 0 ? x[2 * i - 1] : x[1];
        int32_t dr = i < dn ? x[2 * i + 1] : x[2 * i - 1];
        x[2 * i] += (int32_t)(((int64_t)dl + dr + 2) >> 2);
    }
    for (i = 0; i < sn; ++i)
        tmp[i] = x[2 * i];
    for (i = 0; i < dn; ++i)
        tmp[sn + i] = x[2 * i + 1];
    memcpy(x, tmp, (size_t)n * sizeof(int32_t));
}

/* the 9/7: the decoder's lifting steps undone in reverse, the low samples
 * divided by K and the high ones by 2 / K (the inverse multiplies them
 * back), in double */
static void lift97f(double *w, int32_t n, int par, double c)
{
    int32_t i;
    for (i = par; i < n; i += 2) {
        if (i - 1 >= 0 && i + 1 < n)
            w[i] += c * (w[i - 1] + w[i + 1]);
        else if (i - 1 >= 0 || i + 1 < n)
            w[i] += 2 * c * (i - 1 >= 0 ? w[i - 1] : w[i + 1]);
    }
}

static void fdwt97_line(double *x, double *tmp, int32_t n)
{
    int32_t sn = (n + 1) / 2, i;
    if (n < 2)
        return;
    lift97f(x, n, 1, -1.586134342);
    lift97f(x, n, 0, -0.052980118);
    lift97f(x, n, 1, 0.882911075);
    lift97f(x, n, 0, 0.443506852);
    for (i = 0; i < n; ++i)
        tmp[(i & 1) ? sn + i / 2 : i / 2] =
            (i & 1) ? x[i] * (1.230174105 / 2) : x[i] / 1.230174105;
    memcpy(x, tmp, (size_t)n * sizeof(double));
}

/* ------------------------------------------------------------------ */
/* the codestream */

typedef struct {
    int ht, refine, skip, real, vcausal, extra_missing, placeholder, levels;
    uint32_t xcb, ycb;
    int32_t tw, th;
} eopt_t;

typedef struct {
    int32_t x0, y0, x1, y1;   /* in the tile's buffer */
    int32_t ax, ay;           /* the band's origin on its own grid */
    uint32_t bandno;
    int mb;                   /* Mb: expn + guard bits - 1 */
} eband_t;

static void seg16(bits_t *o, uint32_t marker, uint32_t len)
{
    put_byte(o, (uint8_t)(marker >> 8));
    put_byte(o, (uint8_t)marker);
    put_byte(o, (uint8_t)(len >> 8));
    put_byte(o, (uint8_t)len);
}

static void put32(bits_t *o, uint32_t v)
{
    put_byte(o, (uint8_t)(v >> 24));
    put_byte(o, (uint8_t)(v >> 16));
    put_byte(o, (uint8_t)(v >> 8));
    put_byte(o, (uint8_t)v);
}

#define GUARD 2

static void put_passes(bits_t *hdr, uint32_t passes)
{
    if (passes == 1)
        put_bit(hdr, 0);
    else if (passes == 2)
        put_bits(hdr, 2, 2);
    else if (passes <= 5)
        put_bits(hdr, 0xc | (passes - 3), 4);
    else if (passes <= 36)
        put_bits(hdr, 0x1e0 | (passes - 6), 9);
    else
        put_bits(hdr, 0xff80 | (passes - 37), 16);
}

static uint32_t floorlog2(uint32_t a)
{
    uint32_t l = 0;
    while (a >>= 1)
        ++l;
    return l;
}

/* the packet of one resolution of one component of a tile (one layer,
 * one precinct): its header, then its body, into out */
static int packet(const int32_t *plane, int32_t W, const eband_t *bands,
                  uint32_t nb_, const eopt_t *op, bits_t *out,
                  uint8_t *mqbuf, int32_t *v, t1e_t *t1)
{
    bits_t hdr;
    uint32_t b, any = 0, cbw = 1u << op->xcb, cbh = 1u << op->ycb;
    uint8_t *body = NULL;
    size_t body_n = 0, body_cap = 0;
    uint32_t *mag = malloc(4096 * sizeof(uint32_t));
    uint8_t *neg = malloc(4096);
    int status = ENC_OK;
    memset(&hdr, 0, sizeof hdr);
    hdr.ct = 8;
    if (!mag || !neg) {
        status = ENC_NOMEM;
        goto done;
    }
    for (b = 0; b < nb_ && !any; ++b) {
        const eband_t *bd = &bands[b];
        int32_t x, y;
        for (y = bd->y0; y < bd->y1 && !any; ++y)
            for (x = bd->x0; x < bd->x1; ++x)
                if (plane[(size_t)y * W + x]) {
                    any = 1;
                    break;
                }
    }
    put_bit(&hdr, any);
    if (any)
        for (b = 0; b < nb_; ++b) {
            const eband_t *bd = &bands[b];
            int32_t bw = bd->x1 - bd->x0, bh = bd->y1 - bd->y0;
            int32_t gx0 = bd->ax / (int32_t)cbw, gy0 = bd->ay / (int32_t)cbh;
            uint32_t cw, ch, k;
            int32_t *incl, *zero;
            size_t *lens;
            uint32_t *passes;
            tgt_t ti, tz;
            if (bw <= 0 || bh <= 0)
                continue;
            cw = (uint32_t)((bd->ax + bw + (int32_t)cbw - 1) / (int32_t)cbw
                            - gx0);
            ch = (uint32_t)((bd->ay + bh + (int32_t)cbh - 1) / (int32_t)cbh
                            - gy0);
            incl = malloc(cw * ch * sizeof(int32_t));
            zero = malloc(cw * ch * sizeof(int32_t));
            lens = malloc(2 * cw * ch * sizeof(size_t));
            passes = malloc(cw * ch * sizeof(uint32_t));
            if (!incl || !zero || !lens || !passes) {
                status = ENC_NOMEM;
                goto done;
            }
            /* tier 1 of every block of the band */
            for (k = 0; k < cw * ch; ++k) {
                int32_t ax0 = (gx0 + (int32_t)(k % cw)) * (int32_t)cbw;
                int32_t ay0 = (gy0 + (int32_t)(k / cw)) * (int32_t)cbh;
                int32_t ax1 = ax0 + (int32_t)cbw, ay1 = ay0 + (int32_t)cbh;
                int32_t bx, by;
                uint32_t w, h, i, j, maxm = 0;
                int p, nbp = 0;
                ax0 = ax0 > bd->ax ? ax0 : bd->ax;
                ay0 = ay0 > bd->ay ? ay0 : bd->ay;
                ax1 = ax1 < bd->ax + bw ? ax1 : bd->ax + bw;
                ay1 = ay1 < bd->ay + bh ? ay1 : bd->ay + bh;
                bx = bd->x0 + ax0 - bd->ax;
                by = bd->y0 + ay0 - bd->ay;
                w = (uint32_t)(ax1 - ax0);
                h = (uint32_t)(ay1 - ay0);
                for (j = 0; j < h; ++j)
                    for (i = 0; i < w; ++i) {
                        int32_t c = plane[(size_t)(by + (int32_t)j) * W + bx
                                          + (int32_t)i];
                        uint32_t m = (uint32_t)(c < 0 ? -c : c);
                        v[j * w + i] = c;
                        mag[j * w + i] = m;
                        neg[j * w + i] = c < 0;
                        if (m > maxm)
                            maxm = m;
                    }
                lens[2 * k] = lens[2 * k + 1] = 0;
                passes[k] = 0;
                if (op->ht) {
                    htb_t hb;
                    int pc = (op->refine ? 1 : 0) + op->skip;
                    uint8_t *dst;
                    if (pc > bd->mb - 1) {
                        status = ENC_BAD;
                        goto done;
                    }
                    incl[k] = (maxm >> (op->refine ? op->skip : pc)) ? 0 : 1;
                    zero[k] = bd->mb - 1 - pc + op->extra_missing;
                    if (incl[k])
                        continue;
                    hb.w = w;
                    hb.h = h;
                    hb.mag = mag;
                    hb.neg = neg;
                    hb.pc = pc;
                    if (body_n + 2 * 65536 > body_cap) {
                        size_t cap = body_cap ? 2 * body_cap : 1 << 18;
                        uint8_t *q;
                        while (cap < body_n + 2 * 65536)
                            cap *= 2;
                        q = realloc(body, cap);
                        if (!q) {
                            status = ENC_NOMEM;
                            goto done;
                        }
                        body = q;
                        body_cap = cap;
                    }
                    dst = body + body_n;
                    status = ht_cleanup(&hb, dst, 65536, &lens[2 * k]);
                    if (!status && op->refine)
                        status = ht_refinement(&hb, 1 + op->refine,
                                               op->vcausal,
                                               dst + lens[2 * k], 65536,
                                               &lens[2 * k + 1]);
                    if (status)
                        goto done;
                    passes[k] = 1u + (uint32_t)op->refine
                        + 3u * (uint32_t)op->placeholder;
                    body_n += lens[2 * k] + lens[2 * k + 1];
                    continue;
                }
                while (maxm >> nbp)
                    ++nbp;
                incl[k] = nbp ? 0 : 1;
                zero[k] = bd->mb - nbp;  /* missing bit-planes */
                if (!nbp)
                    continue;
                t1->w = w;
                t1->h = h;
                t1->stride = w + 2;
                t1->orient = bd->bandno;
                t1->v = v;
                memset(t1->f, 0, (size_t)(w + 2) * (h + 2));
                mqe_init(&t1->mq, mqbuf + 1);
                for (p = nbp - 1; p >= 0; --p) {
                    if (p != nbp - 1) {
                        sigpass(t1, p);
                        refpass(t1, p);
                    }
                    clnpass(t1, p);
                }
                lens[2 * k] = mqe_flush(&t1->mq);
                passes[k] = 3u * (uint32_t)nbp - 2;
                if (body_n + lens[2 * k] > body_cap) {
                    size_t cap = body_cap ? 2 * body_cap : 65536;
                    uint8_t *q;
                    while (cap < body_n + lens[2 * k])
                        cap *= 2;
                    q = realloc(body, cap);
                    if (!q) {
                        status = ENC_NOMEM;
                        goto done;
                    }
                    body = q;
                    body_cap = cap;
                }
                memcpy(body + body_n, mqbuf + 1, lens[2 * k]);
                body_n += lens[2 * k];
            }
            if (tgt_build(&ti, cw, ch, incl) || tgt_build(&tz, cw, ch, zero)) {
                status = ENC_NOMEM;
                goto done;
            }
            for (k = 0; k < cw * ch; ++k) {
                uint32_t numlen = 3, n1, n2 = 0, lg2 = 0;
                tgt_encode(&hdr, &ti, k, 1);
                if (!passes[k])
                    continue;
                tgt_encode(&hdr, &tz, k, zero[k] + 1);
                put_passes(&hdr, passes[k]);
                /* HT: the cleanup's length in Lblock bits, the others' in
                 * Lblock + floor(log2(their passes)) */
                n1 = (uint32_t)bitlen((uint32_t)lens[2 * k]);
                if (op->ht && passes[k] > 1) {
                    lg2 = floorlog2(passes[k] - 1);
                    n2 = (uint32_t)bitlen((uint32_t)lens[2 * k + 1]);
                } else if (!op->ht)
                    n1 = n1 > floorlog2(passes[k]) ?
                        n1 - floorlog2(passes[k]) : 0;
                while (numlen < n1 || (op->ht && passes[k] > 1
                                       && numlen + lg2 < n2)) {
                    put_bit(&hdr, 1);
                    ++numlen;
                }
                put_bit(&hdr, 0);
                put_bits(&hdr, (uint32_t)lens[2 * k],
                         (int)(numlen + (op->ht ? 0 : floorlog2(passes[k]))));
                if (op->ht && passes[k] > 1)
                    put_bits(&hdr, (uint32_t)lens[2 * k + 1],
                             (int)(numlen + lg2));
            }
            tgt_free(&ti);
            tgt_free(&tz);
            free(incl);
            free(zero);
            free(lens);
            free(passes);
        }
    bits_flush(&hdr);
    if (hdr.nomem) {
        status = ENC_NOMEM;
        goto done;
    }
    for (b = 0; b < hdr.n; ++b)
        put_byte(out, hdr.p[b]);
    for (b = 0; b < body_n; ++b)
        put_byte(out, body[b]);
    if (out->nomem)
        status = ENC_NOMEM;
done:
    free(hdr.p);
    free(body);
    free(mag);
    free(neg);
    return status;
}

/* the bands of resolution r of a tile of tw x th at (tx0, ty0), whose
 * corners are multiples of 2^levels */
static uint32_t tile_bands(eband_t *bands, int32_t tx0, int32_t ty0,
                           int32_t tw, int32_t th, int levels, int r)
{
    int32_t lw = tw, lh = th, fw = tw, fh = th, sw, sh;
    int k;
    for (k = 0; k < levels; ++k) {
        lw = (lw + 1) / 2;
        lh = (lh + 1) / 2;
    }
    if (r == 0) {
        bands[0].x0 = bands[0].y0 = 0;
        bands[0].x1 = lw;
        bands[0].y1 = lh;
        bands[0].ax = tx0 >> levels;
        bands[0].ay = ty0 >> levels;
        bands[0].bandno = 0;
        return 1;
    }
    for (k = 0; k < levels - r; ++k) {
        fw = (fw + 1) / 2;
        fh = (fh + 1) / 2;
    }
    sw = (fw + 1) / 2;
    sh = (fh + 1) / 2;
    for (k = 0; k < 3; ++k) {
        uint32_t bn = (uint32_t)k + 1;
        int lev = levels - r + 1;
        bands[k].bandno = bn;
        bands[k].x0 = (bn & 1) ? sw : 0;
        bands[k].x1 = (bn & 1) ? fw : sw;
        bands[k].y0 = (bn & 2) ? sh : 0;
        bands[k].y1 = (bn & 2) ? fh : sh;
        bands[k].ax = tx0 >> lev;
        bands[k].ay = ty0 >> lev;
    }
    return 3;
}

/* the encoder; opts (as many as nopts, the rest at their defaults): HT
 * code blocks, HT refinement passes (0-2), LSB planes left out of HT blocks,
 * the irreversible 9/7 with the ICT, code-block width and height
 * exponents, tile width and height (0: the image), decomposition levels
 * (-1: up to 5), vertically causal HT SigProp, missing MSBs added to each
 * HT block, HT placeholder sets declared; out: at least ``cap`` bytes;
 * *size gets the codestream's length */
int j2k_encode(const int32_t *planes, int64_t ncomp, int64_t H, int64_t W,
               int64_t prec, int64_t mct, const int64_t *opts, int64_t nopts,
               uint8_t *out, int64_t cap, int64_t *size)
{
    bits_t o, tile;
    int32_t *buf = NULL, *tmp = NULL, *v = NULL;
    double *fbuf = NULL, *ftmp = NULL;
    uint8_t *mqbuf = NULL;
    t1e_t t1;
    eopt_t op;
    int status = ENC_OK, guard = GUARD, levels, expn_real = (int)prec + 1;
    int32_t c, r, x, y, tw, th, ntx, nty, tx, ty;
    size_t area = (size_t)H * (size_t)W;
    int64_t dflt[12] = {0, 0, 0, 0, 6, 6, 0, 0, -1, 0, 0, 0};
    int64_t i64;
    for (i64 = 0; i64 < nopts && i64 < 12; ++i64)
        dflt[i64] = opts[i64];
    op.ht = (int)dflt[0];
    op.refine = (int)dflt[1];
    op.skip = (int)dflt[2];
    op.real = (int)dflt[3];
    op.xcb = (uint32_t)dflt[4];
    op.ycb = (uint32_t)dflt[5];
    op.tw = (int32_t)(dflt[6] ? dflt[6] : W);
    op.th = (int32_t)(dflt[7] ? dflt[7] : H);
    op.levels = (int)dflt[8];
    op.vcausal = (int)dflt[9];
    op.extra_missing = (int)dflt[10];
    op.placeholder = (int)dflt[11];
    if (ncomp < 1 || ncomp > 4 || H < 1 || W < 1 || prec < 1 || prec > 16
        || (mct && ncomp < 3) || op.xcb < 2 || op.ycb < 2 || op.xcb > 10
        || op.ycb > 10 || op.xcb + op.ycb > 12 || op.refine < 0
        || op.refine > 2 || op.skip < 0 || op.tw < 1 || op.th < 1
        || op.extra_missing < 0 || op.placeholder < 0)
        return ENC_BAD;
    tw = op.tw > W ? (int32_t)W : op.tw;
    th = op.th > H ? (int32_t)H : op.th;
    levels = op.levels;
    if (levels < 0)
        for (levels = 0; levels < 5 && (th >> (levels + 1)) > 0
             && (tw >> (levels + 1)) > 0; ++levels)
            ;
    if (levels > 32 || (tw < W && tw % (1 << levels))
        || (th < H && th % (1 << levels)))
        return ENC_BAD;
    ntx = (int32_t)((W + tw - 1) / tw);
    nty = (int32_t)((H + th - 1) / th);
    memset(&o, 0, sizeof o);
    memset(&t1, 0, sizeof t1);
    zc_init(t1.zc);
    buf = malloc(area * (size_t)ncomp * sizeof(int32_t));
    tmp = malloc((size_t)(H > W ? H : W) * 2 * sizeof(int32_t));
    /* a code block's codeword: at most about a byte per sample and
     * bit-plane */
    mqbuf = malloc(1 + 4096 * 32);
    v = malloc(4096 * sizeof(int32_t));
    t1.f = malloc(8192);
    if (!buf || !tmp || !mqbuf || !v || !t1.f) {
        status = ENC_NOMEM;
        goto done;
    }
    /* DC shift, the colour transform, the wavelet of each tile: columns,
     * then rows, on each level's low band */
    if (!op.real) {
        for (size_t i = 0; i < area * (size_t)ncomp; ++i)
            buf[i] = planes[i] - (1 << (prec - 1));
        if (mct)
            for (size_t i = 0; i < area; ++i) {
                int32_t R = buf[i], G = buf[area + i], B = buf[2 * area + i];
                buf[i] = (int32_t)(((int64_t)R + 2 * G + B) >> 2);
                buf[area + i] = B - G;
                buf[2 * area + i] = R - G;
            }
    } else {
        fbuf = malloc(area * (size_t)ncomp * sizeof(double));
        ftmp = malloc((size_t)(H > W ? H : W) * 2 * sizeof(double));
        if (!fbuf || !ftmp) {
            status = ENC_NOMEM;
            goto done;
        }
        for (size_t i = 0; i < area * (size_t)ncomp; ++i)
            fbuf[i] = planes[i] - (double)(1 << (prec - 1));
        if (mct)
            for (size_t i = 0; i < area; ++i) {
                double R = fbuf[i], G = fbuf[area + i], B = fbuf[2 * area + i];
                fbuf[i] = 0.299 * R + 0.587 * G + 0.114 * B;
                fbuf[area + i] = -0.16875 * R - 0.33126 * G + 0.5 * B;
                fbuf[2 * area + i] = 0.5 * R - 0.41869 * G - 0.08131 * B;
            }
    }
    for (c = 0; c < ncomp; ++c)
        for (ty = 0; ty < nty; ++ty)
            for (tx = 0; tx < ntx; ++tx) {
                size_t base = (size_t)c * area + (size_t)ty * th * W
                    + (size_t)tx * tw;
                int32_t w = tw < (int32_t)W - tx * tw ? tw
                    : (int32_t)W - tx * tw;
                int32_t h = th < (int32_t)H - ty * th ? th
                    : (int32_t)H - ty * th;
                int lv;
                for (lv = 0; lv < levels; ++lv) {
                    for (x = 0; x < w; ++x) {
                        if (op.real) {
                            double *p = fbuf + base;
                            for (y = 0; y < h; ++y)
                                ftmp[H + y] = p[(size_t)y * W + x];
                            fdwt97_line(ftmp + H, ftmp, h);
                            for (y = 0; y < h; ++y)
                                p[(size_t)y * W + x] = ftmp[H + y];
                        } else {
                            int32_t *p = buf + base;
                            for (y = 0; y < h; ++y)
                                tmp[H + y] = p[(size_t)y * W + x];
                            fdwt53_line(tmp + H, tmp, h);
                            for (y = 0; y < h; ++y)
                                p[(size_t)y * W + x] = tmp[H + y];
                        }
                    }
                    for (y = 0; y < h; ++y) {
                        if (op.real)
                            fdwt97_line(fbuf + base + (size_t)y * W, ftmp, w);
                        else
                            fdwt53_line(buf + base + (size_t)y * W, tmp, w);
                    }
                    w = (w + 1) / 2;
                    h = (h + 1) / 2;
                }
            }
    if (op.real) {
        /* every band quantised at a step of 1/2 (exponent prec + 1, no
         * mantissa); the guard bits cover the largest index */
        uint32_t maxq = 0;
        for (size_t i = 0; i < area * (size_t)ncomp; ++i) {
            double q = fbuf[i] * 2;
            uint32_t m = (uint32_t)(q < 0 ? -q : q);
            buf[i] = q < 0 ? -(int32_t)m : (int32_t)m;
            maxq = m > maxq ? m : maxq;
        }
        guard = bitlen(maxq) - expn_real + 1;
        guard = guard < 1 ? 1 : guard;
        if (guard > 7) {
            status = ENC_BAD;
            goto done;
        }
    }
    /* SOC, SIZ, COD, QCD */
    put_byte(&o, 0xff);
    put_byte(&o, 0x4f);
    seg16(&o, 0xff51, (uint32_t)(38 + 3 * ncomp));
    put_byte(&o, 0);
    put_byte(&o, 0);
    put32(&o, (uint32_t)W);
    put32(&o, (uint32_t)H);
    put32(&o, 0);
    put32(&o, 0);
    put32(&o, (uint32_t)tw);
    put32(&o, (uint32_t)th);
    put32(&o, 0);
    put32(&o, 0);
    put_byte(&o, 0);
    put_byte(&o, (uint8_t)ncomp);
    for (c = 0; c < ncomp; ++c) {
        put_byte(&o, (uint8_t)(prec - 1));
        put_byte(&o, 1);
        put_byte(&o, 1);
    }
    seg16(&o, 0xff52, 12);
    put_byte(&o, 0);            /* Scod */
    put_byte(&o, 0);            /* LRCP */
    put_byte(&o, 0);
    put_byte(&o, 1);            /* one layer */
    put_byte(&o, (uint8_t)(mct ? 1 : 0));
    put_byte(&o, (uint8_t)levels);
    put_byte(&o, (uint8_t)(op.xcb - 2));
    put_byte(&o, (uint8_t)(op.ycb - 2));
    put_byte(&o, (uint8_t)((op.ht ? 0x40 : 0) | (op.vcausal ? 0x08 : 0)));
    put_byte(&o, op.real ? 0 : 1);  /* 9/7 or 5/3 */
    if (op.real) {  /* scalar expounded */
        seg16(&o, 0xff5c, (uint32_t)(3 + 2 * (1 + 3 * levels)));
        put_byte(&o, (uint8_t)(guard << 5 | 2));
        for (r = 0; r <= levels * 3; ++r) {
            put_byte(&o, (uint8_t)(expn_real << 3));
            put_byte(&o, 0);
        }
    } else {
        seg16(&o, 0xff5c, (uint32_t)(3 + 1 + 3 * levels));
        put_byte(&o, GUARD << 5);   /* no quantisation */
        for (r = 0; r <= levels * 3; ++r) {
            /* exponent: the precision, the band's gain, one bit for the
             * RCT, one spare */
            int gain = r == 0 ? 0 : ((r - 1) % 3 == 2 ? 2 : 1);
            put_byte(&o, (uint8_t)((prec + gain + 2) << 3));
        }
    }
    /* each tile: SOT, SOD, its packets in LRCP order (resolutions, then
     * components), then EOC */
    for (ty = 0; ty < nty; ++ty)
        for (tx = 0; tx < ntx; ++tx) {
            int32_t w = tw < (int32_t)W - tx * tw ? tw : (int32_t)W - tx * tw;
            int32_t h = th < (int32_t)H - ty * th ? th : (int32_t)H - ty * th;
            memset(&tile, 0, sizeof tile);
            for (r = 0; r <= levels; ++r)
                for (c = 0; c < ncomp; ++c) {
                    eband_t bands[3];
                    uint32_t nb_ = tile_bands(bands, tx * tw, ty * th, w, h,
                                              levels, r), k;
                    for (k = 0; k < nb_; ++k) {
                        uint32_t bn = bands[k].bandno;
                        bands[k].mb = op.real ? expn_real + guard - 1
                            : (int)prec + (bn == 3 ? 2 : bn ? 1 : 0) + 2
                            + GUARD - 1;
                    }
                    status = packet(buf + (size_t)c * area + (size_t)ty * th
                                    * W + (size_t)tx * tw, (int32_t)W, bands,
                                    nb_, &op, &tile, mqbuf, v, &t1);
                    if (status)
                        goto done;
                }
            seg16(&o, 0xff90, 10);
            put_byte(&o, (uint8_t)((ty * ntx + tx) >> 8));
            put_byte(&o, (uint8_t)(ty * ntx + tx));
            put32(&o, (uint32_t)(12 + 2 + tile.n));
            put_byte(&o, 0);
            put_byte(&o, 1);
            put_byte(&o, 0xff);
            put_byte(&o, 0x93);
            for (size_t i = 0; i < tile.n; ++i)
                put_byte(&o, tile.p[i]);
            free(tile.p);
            tile.p = NULL;
            if (tile.nomem) {
                status = ENC_NOMEM;
                goto done;
            }
        }
    put_byte(&o, 0xff);
    put_byte(&o, 0xd9);
    if (o.nomem) {
        status = ENC_NOMEM;
        goto done;
    }
    *size = (int64_t)o.n;
    if ((int64_t)o.n > cap) {
        status = ENC_BAD;
        goto done;
    }
    memcpy(out, o.p, o.n);
done:
    free(buf);
    free(tmp);
    free(fbuf);
    free(ftmp);
    free(mqbuf);
    free(v);
    free(t1.f);
    free(o.p);
    free(tile.p);
    return status;
}
