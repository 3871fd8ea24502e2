/* A lossless JPEG 2000 codestream writer (ITU-T T.800) for the port's
 * fixtures: the machines that run the port may have no JPEG 2000 encoder,
 * and data/fixtures.py writes JP2 frames there as a dataset would store
 * them.  One tile, the reversible colour transform where asked, the 5/3
 * wavelet at up to 5 levels, 64 x 64 code blocks, one quality layer in
 * LRCP order, no quantisation (2 guard bits); every coding pass of a code
 * block in one MQ codeword.  The JP2 boxes are written by data/jp2.py.
 *
 * j2k_encode: int32 component planes [C][H][W] of ``prec``-bit unsigned
 * samples -> the codestream.  Built by the host C compiler at first use
 * and called through ctypes.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

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
/* the 5/3 forward transform (lines start on even coordinates) */

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

/* ------------------------------------------------------------------ */
/* the codestream */

typedef struct {
    int32_t x0, y0, x1, y1;   /* in the component's buffer */
    uint32_t bandno, level;   /* level: decomposition level of the band */
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

/* one packet (one layer, one precinct per resolution) of resolution r of
 * component c: its header into ``hdr``, its body into ``body`` */
static int packet(const int32_t *plane, int32_t W, const eband_t *bands,
                  uint32_t nb_, bits_t *out, uint8_t *mqbuf, int32_t *v,
                  t1e_t *t1)
{
    bits_t hdr;
    uint32_t b, any = 0;
    uint8_t *body = NULL;
    size_t body_n = 0, body_cap = 0;
    memset(&hdr, 0, sizeof hdr);
    hdr.ct = 8;
    /* first: which code blocks carry bits */
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
            uint32_t cw, ch, k;
            int32_t *incl, *zero;
            size_t *lens;
            int *nbps;
            tgt_t ti, tz;
            if (bw <= 0 || bh <= 0)
                continue;
            cw = (uint32_t)(bw + 63) / 64;
            ch = (uint32_t)(bh + 63) / 64;
            incl = malloc(cw * ch * sizeof(int32_t));
            zero = malloc(cw * ch * sizeof(int32_t));
            lens = malloc(cw * ch * sizeof(size_t));
            nbps = malloc(cw * ch * sizeof(int));
            if (!incl || !zero || !lens || !nbps)
                return ENC_NOMEM;
            /* tier 1 of every block of the band */
            for (k = 0; k < cw * ch; ++k) {
                int32_t bx = bd->x0 + (int32_t)(k % cw) * 64;
                int32_t by = bd->y0 + (int32_t)(k / cw) * 64;
                uint32_t w = (uint32_t)(bx + 64 < bd->x1 ? 64 : bd->x1 - bx);
                uint32_t h = (uint32_t)(by + 64 < bd->y1 ? 64 : bd->y1 - by);
                uint32_t i, j, maxm = 0;
                int p, nbp = 0;
                for (j = 0; j < h; ++j)
                    for (i = 0; i < w; ++i) {
                        int32_t c = plane[(size_t)(by + (int32_t)j) * W + bx
                                          + (int32_t)i];
                        uint32_t m = (uint32_t)(c < 0 ? -c : c);
                        v[j * w + i] = c;
                        if (m > maxm)
                            maxm = m;
                    }
                while (maxm >> nbp)
                    ++nbp;
                nbps[k] = nbp;
                incl[k] = nbp ? 0 : 1;
                zero[k] = bd->mb - nbp;  /* missing bit-planes */
                lens[k] = 0;
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
                lens[k] = mqe_flush(&t1->mq);
                if (body_n + lens[k] > body_cap) {
                    size_t cap = body_cap ? 2 * body_cap : 65536;
                    uint8_t *q;
                    while (cap < body_n + lens[k])
                        cap *= 2;
                    q = realloc(body, cap);
                    if (!q)
                        return ENC_NOMEM;
                    body = q;
                    body_cap = cap;
                }
                memcpy(body + body_n, mqbuf + 1, lens[k]);
                body_n += lens[k];
            }
            if (tgt_build(&ti, cw, ch, incl) || tgt_build(&tz, cw, ch, zero))
                return ENC_NOMEM;
            for (k = 0; k < cw * ch; ++k) {
                uint32_t passes, numlen = 3, need = 0, lg = 0;
                tgt_encode(&hdr, &ti, k, 1);
                if (!nbps[k])
                    continue;
                tgt_encode(&hdr, &tz, k, zero[k] + 1);
                passes = 3u * (uint32_t)nbps[k] - 2;
                if (passes == 1)
                    put_bit(&hdr, 0);
                else if (passes == 2)
                    put_bits(&hdr, 2, 2);
                else if (passes <= 5)
                    put_bits(&hdr, 0xc | (passes - 3), 4);
                else if (passes <= 36)
                    put_bits(&hdr, 0x1e0 | (passes - 6), 9);
                else
                    put_bits(&hdr, 0xff80 | (passes - 37), 16);
                while ((passes >> (lg + 1)))
                    ++lg;
                while (lens[k] >> need)
                    ++need;
                while (numlen + lg < need) {
                    put_bit(&hdr, 1);
                    ++numlen;
                }
                put_bit(&hdr, 0);
                put_bits(&hdr, (uint32_t)lens[k], (int)(numlen + lg));
            }
            tgt_free(&ti);
            tgt_free(&tz);
            free(incl);
            free(zero);
            free(lens);
            free(nbps);
        }
    bits_flush(&hdr);
    if (hdr.nomem)
        return ENC_NOMEM;
    for (b = 0; b < hdr.n; ++b)
        put_byte(out, hdr.p[b]);
    for (b = 0; b < body_n; ++b)
        put_byte(out, body[b]);
    free(hdr.p);
    free(body);
    return out->nomem ? ENC_NOMEM : ENC_OK;
}

/* out: at least ``cap`` bytes; *size gets the codestream's length */
int j2k_encode(const int32_t *planes, int64_t ncomp, int64_t H, int64_t W,
               int64_t prec, int64_t mct, uint8_t *out, int64_t cap,
               int64_t *size)
{
    bits_t o, tile;
    int32_t *buf = NULL, *tmp = NULL, *v = NULL;
    uint8_t *mqbuf = NULL;
    t1e_t t1;
    int levels = 0, status = ENC_OK;
    int32_t c, r, x, y;
    size_t area = (size_t)H * (size_t)W;
    if (ncomp < 1 || ncomp > 4 || H < 1 || W < 1 || prec < 1 || prec > 16
        || (mct && ncomp < 3))
        return ENC_BAD;
    while (levels < 5 && (H >> (levels + 1)) > 0 && (W >> (levels + 1)) > 0)
        ++levels;
    memset(&o, 0, sizeof o);
    memset(&tile, 0, sizeof tile);
    memset(&t1, 0, sizeof t1);
    zc_init(t1.zc);
    buf = malloc(area * (size_t)ncomp * sizeof(int32_t));
    tmp = malloc((size_t)(H > W ? H : W) * 2 * sizeof(int32_t));
    /* a code block's codeword: at most about a byte per sample and
     * bit-plane */
    mqbuf = malloc(1 + 4096 * 32);
    v = malloc(4096 * sizeof(int32_t));
    t1.f = malloc(66 * 66);
    if (!buf || !tmp || !mqbuf || !v || !t1.f) {
        status = ENC_NOMEM;
        goto done;
    }
    /* DC shift, RCT */
    for (size_t i = 0; i < area * (size_t)ncomp; ++i)
        buf[i] = planes[i] - (1 << (prec - 1));
    if (mct)
        for (size_t i = 0; i < area; ++i) {
            int32_t R = buf[i], G = buf[area + i], B = buf[2 * area + i];
            buf[i] = (int32_t)(((int64_t)R + 2 * G + B) >> 2);
            buf[area + i] = B - G;
            buf[2 * area + i] = R - G;
        }
    /* the wavelet: columns, then rows, on each level's low band */
    for (c = 0; c < ncomp; ++c) {
        int32_t *p = buf + (size_t)c * area, w = (int32_t)W, h = (int32_t)H;
        int lv;
        for (lv = 0; lv < levels; ++lv) {
            for (x = 0; x < w; ++x) {
                for (y = 0; y < h; ++y)
                    tmp[H + y] = p[(size_t)y * W + x];
                fdwt53_line(tmp + H, tmp, h);
                for (y = 0; y < h; ++y)
                    p[(size_t)y * W + x] = tmp[H + y];
            }
            for (y = 0; y < h; ++y)
                fdwt53_line(p + (size_t)y * W, tmp, w);
            w = (w + 1) / 2;
            h = (h + 1) / 2;
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
    put32(&o, (uint32_t)W);
    put32(&o, (uint32_t)H);
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
    put_byte(&o, 4);            /* 64 x 64 code blocks */
    put_byte(&o, 4);
    put_byte(&o, 0);            /* no code-block style */
    put_byte(&o, 1);            /* 5/3 */
    seg16(&o, 0xff5c, (uint32_t)(3 + 1 + 3 * levels));
    put_byte(&o, GUARD << 5);   /* no quantisation */
    for (r = 0; r <= levels * 3; ++r) {
        /* exponent: the precision, the band's gain, one bit for the RCT,
         * one spare */
        int gain = r == 0 ? 0 : ((r - 1) % 3 == 2 ? 2 : 1);
        put_byte(&o, (uint8_t)((prec + gain + 2) << 3));
    }
    /* the packets, LRCP: resolutions, then components */
    tile.ct = 8;
    for (r = 0; r <= levels; ++r)
        for (c = 0; c < ncomp; ++c) {
            eband_t bands[3];
            uint32_t nb_ = 0, k;
            int32_t lw = (int32_t)W, lh = (int32_t)H, sw, sh;
            for (k = 0; k < (uint32_t)levels; ++k) {  /* the LL band */
                lw = (lw + 1) / 2;
                lh = (lh + 1) / 2;
            }
            if (r == 0) {
                bands[0].x0 = bands[0].y0 = 0;
                bands[0].x1 = lw;
                bands[0].y1 = lh;
                bands[0].bandno = 0;
                bands[0].mb = (int)prec + 2 + GUARD - 1;
                nb_ = 1;
            } else {
                /* resolution r: its low band is lw x lh, the whole is
                 * the next level's size */
                int32_t fw = (int32_t)W, fh = (int32_t)H;
                for (k = 0; k < (uint32_t)(levels - r); ++k) {
                    fw = (fw + 1) / 2;
                    fh = (fh + 1) / 2;
                }
                sw = (fw + 1) / 2;
                sh = (fh + 1) / 2;
                for (k = 0; k < 3; ++k) {
                    uint32_t bn = k + 1;
                    bands[k].bandno = bn;
                    bands[k].x0 = (bn & 1) ? sw : 0;
                    bands[k].x1 = (bn & 1) ? fw : sw;
                    bands[k].y0 = (bn & 2) ? sh : 0;
                    bands[k].y1 = (bn & 2) ? fh : sh;
                    bands[k].mb = (int)prec + (bn == 3 ? 2 : 1) + 2 + GUARD
                        - 1;
                }
                nb_ = 3;
            }
            status = packet(buf + (size_t)c * area, (int32_t)W, bands, nb_,
                            &tile, mqbuf, v, &t1);
            if (status)
                goto done;
        }
    /* SOT, SOD, the tile, EOC */
    seg16(&o, 0xff90, 10);
    put_byte(&o, 0);
    put_byte(&o, 0);
    put32(&o, (uint32_t)(12 + 2 + tile.n));
    put_byte(&o, 0);
    put_byte(&o, 1);
    put_byte(&o, 0xff);
    put_byte(&o, 0x93);
    for (size_t i = 0; i < tile.n; ++i)
        put_byte(&o, tile.p[i]);
    put_byte(&o, 0xff);
    put_byte(&o, 0xd9);
    if (o.nomem || tile.nomem) {
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
    free(mqbuf);
    free(v);
    free(t1.f);
    free(o.p);
    free(tile.p);
    return status;
}
