/* JPEG 2000 codestream decoding (ITU-T T.800) for the port's data layer,
 * as OpenJPEG 2.5 decodes it for cv2.imread.  The JP2 boxes, the palette,
 * the channel definitions and OpenCV's conversion of the component planes
 * are in lgu_slam_tpu_torch/data/jp2.py.
 *
 * - j2k_header: the main header (SOC, SIZ, then every marker segment up
 *   to the first SOT) -> the image and component geometry.
 * - j2k_decode: the whole codestream -> int32 component planes, after the
 *   DC level shift and the clamp to each component's precision.
 *
 * What is decoded: COD / COC (every progression order, precincts, SOP /
 * EPH, code blocks of any legal size and the six code-block styles: BYPASS,
 * RESET, TERMALL, VSC, PTERM, SEGSYM), QCD / QCC (reversible, scalar
 * derived and expounded, guard bits), RGN, POC, packed packet headers (PPM
 * and PPT), several tile-parts per tile, image and tile offsets and partial
 * edge tiles; tier 2 (tag trees, packet headers, layers, code blocks whose
 * passes stop early) and tier 1 (the MQ decoder and the three coding
 * passes); dequantisation, the 5/3 and 9/7 inverse wavelets, the inverse
 * RCT / ICT and the DC shift.  TLM, PLM, PLT, COM, CRG and the Part 2 /
 * Part 15 markers are read past.  The 9/7 path keeps OpenJPEG's float32
 * arithmetic in its order (the lifting constants, K and 2/K scaling, the
 * half-step dequantisation, the ICT constants, lrintf before the DC
 * shift); nothing may contract into an FMA (the pragma below, and
 * -ffp-contract=off in the build), so every product is rounded alone.
 *
 * OpenJPEG runs in its strict mode for cv2: a codestream that ends inside
 * a tile-part, a tile-part length that disagrees with the data, a missing
 * EOC after the last tile (unless nothing follows the marker in its place)
 * or a code-block segment past its packet fails the read; a codestream
 * that ends just after a marker decodes the tiles it holds.  HTJ2K code
 * blocks (T.814: one HT set of cleanup, SigProp and MagRef passes) are
 * decoded as OpenJPEG's ht_dec.c decodes them, its refusals included
 * (more than 3 passes, an ROI shift, Mb above 30, a bad Scup or MEL
 * start, a quad's U_q past its bit-planes); the mixed HT style is
 * refused.
 *
 * Every read of the input is bounds-checked.  Built by the host C compiler
 * at first use and called through ctypes (data/jp2.py).
 */
#include <limits.h>
#include <math.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "ht_tables.h"

#pragma STDC FP_CONTRACT OFF

#define J2K_OK 0
#define J2K_CORRUPT 1
#define J2K_NOMEM 3

#define MAXRES 33
#define MAXBANDS 97

#define CBLK_LAZY 0x01
#define CBLK_RESET 0x02
#define CBLK_TERMALL 0x04
#define CBLK_VSC 0x08
#define CBLK_SEGSYM 0x20
#define CBLK_HT 0x40
#define CBLK_HTMIXED 0x80

/* decoder states, as OpenJPEG tracks where a marker may appear */
#define ST_MHSIZ 2
#define ST_MH 4
#define ST_TPHSOT 8
#define ST_TPH 16
#define ST_EOC 256

typedef struct {
    int expn, mant;
} stepsize;

typedef struct {
    uint32_t csty, numres, cbw, cbh, cblksty, qmfbid;
    uint32_t prcw[MAXRES], prch[MAXRES];
    uint32_t qntsty, numgbits, roishift;
    stepsize steps[MAXBANDS];
} tccp_t;

typedef struct {
    uint32_t resno0, compno0, layno1, resno1, compno1, prg;
} poc_t;

#define MAXPOCS 32

/* the packed packet headers of PPM or PPT marker segments, by their
 * index (Zppm / Zppt) */
typedef struct {
    const uint8_t *seg[256];
    uint32_t len[256];
    int any;
} packed_t;

typedef struct {
    uint32_t csty, prg, numlayers, mct, cod, npoc;
    poc_t pocs[MAXPOCS];
    packed_t *ppt;
    tccp_t *tccps;
    uint8_t *data;
    size_t len, cap;
    int part;            /* last tile-part index read, -1 before any */
    uint32_t nparts;     /* TNsot, 0 where not known */
    int pending;         /* read and not yet decoded */
} tcp_t;

typedef struct {
    const uint8_t *p;
    size_t n, pos;
    char *err;
    int errlen, status;
    uint32_t x0, y0, x1, y1, tdx, tdy, tx0, ty0, ncomp, tw, th;
    uint32_t *prec, *sgnd, *cdx, *cdy;
    tcp_t def;
    tcp_t *tcps;
    int state, last_part;
    uint32_t cur_tile;
    int32_t *out;        /* [ncomp][y1 - y0][x1 - x0], NULL for the header */
    int *comp_done;
    packed_t ppm;
    uint8_t *ppm_buf;    /* the PPM headers of every tile-part, in order */
    size_t ppm_size, ppm_pos;
} j2k;

static int fail(j2k *d, int status, const char *fmt, ...)
{
    if (!d->status) {
        va_list ap;
        d->status = status;
        va_start(ap, fmt);
        vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
        va_end(ap);
    }
    return d->status;
}

static uint32_t rd16(const uint8_t *s)
{
    return (uint32_t)s[0] << 8 | s[1];
}

static uint32_t rd32(const uint8_t *s)
{
    return (uint32_t)s[0] << 24 | (uint32_t)s[1] << 16 | (uint32_t)s[2] << 8
        | s[3];
}

static uint32_t ceildiv(uint32_t a, uint32_t b)
{
    return (uint32_t)(((uint64_t)a + b - 1) / b);
}

static int32_t ceildivpow2(int64_t a, int b)
{
    return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}

static int32_t floordivpow2(int32_t a, int b)
{
    return a >> b;
}

/* ------------------------------------------------------------------ */
/* marker segments */

static void tcp_copy(j2k *d, tcp_t *dst, const tcp_t *src)
{
    tccp_t *t = dst->tccps;
    *dst = *src;
    dst->tccps = t;
    memcpy(t, src->tccps, d->ncomp * sizeof(tccp_t));
    dst->cod = 0;
    dst->ppt = NULL;
    dst->data = NULL;
    dst->len = dst->cap = 0;
    dst->part = -1;
    dst->nparts = 0;
    dst->pending = 0;
}

static tcp_t *cur_tcp(j2k *d)
{
    return d->state == ST_TPH ? &d->tcps[d->cur_tile] : &d->def;
}

static int read_siz(j2k *d, const uint8_t *s, size_t len)
{
    uint32_t i, nb;
    if (len < 36 || (len - 36) % 3)
        return fail(d, J2K_CORRUPT, "Error with SIZ marker size");
    nb = (uint32_t)(len - 36) / 3;
    d->x1 = rd32(s + 2);
    d->y1 = rd32(s + 6);
    d->x0 = rd32(s + 10);
    d->y0 = rd32(s + 14);
    d->tdx = rd32(s + 18);
    d->tdy = rd32(s + 22);
    d->tx0 = rd32(s + 26);
    d->ty0 = rd32(s + 30);
    d->ncomp = rd16(s + 34);
    if (d->ncomp == 0 || d->ncomp > 16384)
        return fail(d, J2K_CORRUPT, "SIZ: %u components", d->ncomp);
    if (d->ncomp != nb)
        return fail(d, J2K_CORRUPT, "SIZ: %u components in %u entries",
                    d->ncomp, nb);
    if (d->x0 >= d->x1 || d->y0 >= d->y1)
        return fail(d, J2K_CORRUPT, "SIZ: negative or zero image size");
    if (!d->tdx || !d->tdy)
        return fail(d, J2K_CORRUPT, "SIZ: invalid tile size");
    if (d->tx0 > d->x0 || d->ty0 > d->y0
        || (uint64_t)d->tx0 + d->tdx <= d->x0
        || (uint64_t)d->ty0 + d->tdy <= d->y0)
        return fail(d, J2K_CORRUPT, "SIZ: illegal tile offset");
    d->prec = calloc(d->ncomp, sizeof(uint32_t));
    d->sgnd = calloc(d->ncomp, sizeof(uint32_t));
    d->cdx = calloc(d->ncomp, sizeof(uint32_t));
    d->cdy = calloc(d->ncomp, sizeof(uint32_t));
    d->def.tccps = calloc(d->ncomp, sizeof(tccp_t));
    if (!d->prec || !d->sgnd || !d->cdx || !d->cdy || !d->def.tccps)
        return fail(d, J2K_NOMEM, "out of memory");
    for (i = 0; i < d->ncomp; ++i) {
        const uint8_t *c = s + 36 + 3 * i;
        d->prec[i] = (c[0] & 0x7f) + 1;
        d->sgnd[i] = c[0] >> 7;
        d->cdx[i] = c[1];
        d->cdy[i] = c[2];
        if (!c[1] || !c[2])
            return fail(d, J2K_CORRUPT, "SIZ: component %u subsampled by "
                        "%u x %u", i, c[1], c[2]);
        if (d->prec[i] > 31)
            return fail(d, J2K_CORRUPT, "SIZ: component %u of %u bits", i,
                        d->prec[i]);
    }
    d->tw = ceildiv(d->x1 - d->tx0, d->tdx);
    d->th = ceildiv(d->y1 - d->ty0, d->tdy);
    if (!d->tw || !d->th || (uint64_t)d->tw * d->th > 65535)
        return fail(d, J2K_CORRUPT, "SIZ: %u x %u tiles", d->tw, d->th);
    d->def.part = -1;
    d->state = ST_MH;
    return J2K_OK;
}

/* SPcod / SPcoc: the coding style of one component; *used gets the bytes
 * read */
static int read_spcod(j2k *d, tccp_t *t, const uint8_t *s, size_t len,
                      size_t *used)
{
    uint32_t i;
    if (len < 5)
        return fail(d, J2K_CORRUPT, "Error reading SPCod SPCoc element");
    t->numres = s[0] + 1u;
    if (t->numres > MAXRES)
        return fail(d, J2K_CORRUPT, "%u decomposition levels", s[0]);
    t->cbw = s[1] + 2u;
    t->cbh = s[2] + 2u;
    if (t->cbw > 10 || t->cbh > 10 || t->cbw + t->cbh > 12)
        return fail(d, J2K_CORRUPT, "code blocks of 2^%u x 2^%u", t->cbw,
                    t->cbh);
    t->cblksty = s[3];
    if (t->cblksty & CBLK_HTMIXED)
        return fail(d, J2K_CORRUPT, "mixed HT code-block style");
    t->qmfbid = s[4];
    if (t->qmfbid > 1)
        return fail(d, J2K_CORRUPT, "wavelet transform %u", t->qmfbid);
    *used = 5;
    if (t->csty & 1) {
        if (len < 5 + t->numres)
            return fail(d, J2K_CORRUPT, "Error reading SPCod SPCoc element");
        for (i = 0; i < t->numres; ++i) {
            uint32_t v = s[5 + i];
            if (i && (!(v & 0xf) || !(v >> 4)))
                return fail(d, J2K_CORRUPT, "Invalid precinct size");
            t->prcw[i] = v & 0xf;
            t->prch[i] = v >> 4;
        }
        *used += t->numres;
    } else {
        for (i = 0; i < t->numres; ++i)
            t->prcw[i] = t->prch[i] = 15;
    }
    return J2K_OK;
}

static void copy_spcod(j2k *d, tcp_t *tcp)
{
    uint32_t i;
    const tccp_t *r = &tcp->tccps[0];
    for (i = 1; i < d->ncomp; ++i) {
        tccp_t *t = &tcp->tccps[i];
        t->numres = r->numres;
        t->cbw = r->cbw;
        t->cbh = r->cbh;
        t->cblksty = r->cblksty;
        t->qmfbid = r->qmfbid;
        memcpy(t->prcw, r->prcw, sizeof t->prcw);
        memcpy(t->prch, r->prch, sizeof t->prch);
    }
}

static int read_cod(j2k *d, const uint8_t *s, size_t len)
{
    tcp_t *tcp = cur_tcp(d);
    uint32_t i;
    size_t used;
    if (tcp->cod)
        return fail(d, J2K_CORRUPT, "a second COD marker");
    tcp->cod = 1;
    if (len < 5)
        return fail(d, J2K_CORRUPT, "Error reading COD marker");
    tcp->csty = s[0];
    if (tcp->csty & ~7u)
        return fail(d, J2K_CORRUPT, "Unknown Scod value in COD marker");
    tcp->prg = s[1];
    if (tcp->prg > 4)
        return fail(d, J2K_CORRUPT, "progression order %u", tcp->prg);
    tcp->numlayers = rd16(s + 2);
    if (!tcp->numlayers)
        return fail(d, J2K_CORRUPT, "0 layers in COD marker");
    tcp->mct = s[4];
    if (tcp->mct > 1)
        return fail(d, J2K_CORRUPT, "Invalid multiple component "
                    "transformation");
    for (i = 0; i < d->ncomp; ++i)
        tcp->tccps[i].csty = tcp->csty & 1;
    if (read_spcod(d, &tcp->tccps[0], s + 5, len - 5, &used))
        return d->status;
    if (used != len - 5)
        return fail(d, J2K_CORRUPT, "Error reading COD marker");
    copy_spcod(d, tcp);
    return J2K_OK;
}

static int read_comp(j2k *d, const uint8_t *s, size_t len, uint32_t *c,
                     size_t *room)
{
    *room = d->ncomp <= 256 ? 1 : 2;
    if (len < *room)
        return fail(d, J2K_CORRUPT, "a marker without its component");
    *c = *room == 1 ? s[0] : rd16(s);
    if (*c >= d->ncomp)
        return fail(d, J2K_CORRUPT, "component %u of %u", *c, d->ncomp);
    return J2K_OK;
}

static int read_coc(j2k *d, const uint8_t *s, size_t len)
{
    tcp_t *tcp = cur_tcp(d);
    uint32_t c;
    size_t room, used;
    if (read_comp(d, s, len, &c, &room))
        return d->status;
    if (len < room + 1)
        return fail(d, J2K_CORRUPT, "Error reading COC marker");
    tcp->tccps[c].csty = s[room];
    if (read_spcod(d, &tcp->tccps[c], s + room + 1, len - room - 1, &used))
        return d->status;
    if (used != len - room - 1)
        return fail(d, J2K_CORRUPT, "Error reading COC marker");
    return J2K_OK;
}

/* SQcd / SQcc; *used gets the bytes read */
static int read_sqcd(j2k *d, tccp_t *t, const uint8_t *s, size_t len,
                     size_t *used)
{
    size_t nb, b;
    if (len < 1)
        return fail(d, J2K_CORRUPT, "Error reading SQcd or SQcc element");
    t->qntsty = s[0] & 0x1f;
    t->numgbits = s[0] >> 5;
    if (t->qntsty == 1)
        nb = 1;
    else
        nb = t->qntsty == 0 ? len - 1 : (len - 1) / 2;
    if (t->qntsty == 0) {
        for (b = 0; b < nb; ++b)
            if (b < MAXBANDS) {
                t->steps[b].expn = s[1 + b] >> 3;
                t->steps[b].mant = 0;
            }
        *used = 1 + nb;
    } else {
        if (1 + 2 * nb > len)
            return fail(d, J2K_CORRUPT, "Error reading SQcd or SQcc element");
        for (b = 0; b < nb; ++b)
            if (b < MAXBANDS) {
                uint32_t v = rd16(s + 1 + 2 * b);
                t->steps[b].expn = (int)(v >> 11);
                t->steps[b].mant = (int)(v & 0x7ff);
            }
        *used = 1 + 2 * nb;
    }
    if (t->qntsty == 1)
        for (b = 1; b < MAXBANDS; ++b) {
            int e = t->steps[0].expn - (int)((b - 1) / 3);
            t->steps[b].expn = e > 0 ? e : 0;
            t->steps[b].mant = t->steps[0].mant;
        }
    return J2K_OK;
}

static int read_qcd(j2k *d, const uint8_t *s, size_t len)
{
    tcp_t *tcp = cur_tcp(d);
    uint32_t i;
    size_t used;
    if (read_sqcd(d, &tcp->tccps[0], s, len, &used))
        return d->status;
    if (used != len)
        return fail(d, J2K_CORRUPT, "Error reading QCD marker");
    for (i = 1; i < d->ncomp; ++i) {
        tccp_t *t = &tcp->tccps[i];
        t->qntsty = tcp->tccps[0].qntsty;
        t->numgbits = tcp->tccps[0].numgbits;
        memcpy(t->steps, tcp->tccps[0].steps, sizeof t->steps);
    }
    return J2K_OK;
}

static int read_qcc(j2k *d, const uint8_t *s, size_t len)
{
    tcp_t *tcp = cur_tcp(d);
    uint32_t c;
    size_t room, used;
    if (read_comp(d, s, len, &c, &room))
        return d->status;
    if (read_sqcd(d, &tcp->tccps[c], s + room, len - room, &used))
        return d->status;
    if (used != len - room)
        return fail(d, J2K_CORRUPT, "Error reading QCC marker");
    return J2K_OK;
}

static int read_rgn(j2k *d, const uint8_t *s, size_t len)
{
    tcp_t *tcp = cur_tcp(d);
    uint32_t c;
    size_t room = d->ncomp <= 256 ? 1 : 2;
    if (len != 2 + room)
        return fail(d, J2K_CORRUPT, "Error reading RGN marker");
    if (read_comp(d, s, len, &c, &room))
        return d->status;
    tcp->tccps[c].roishift = s[room + 1];
    return J2K_OK;
}

/* POC: progression order changes, appended to those read before */
static int read_poc(j2k *d, const uint8_t *s, size_t len)
{
    tcp_t *tcp = cur_tcp(d);
    size_t room = d->ncomp <= 256 ? 1 : 2, chunk = 5 + 2 * room, n, i;
    n = len / chunk;
    if (!n || len % chunk)
        return fail(d, J2K_CORRUPT, "Error reading POC marker");
    if (tcp->npoc + n >= MAXPOCS)
        return fail(d, J2K_CORRUPT, "Too many POCs");
    for (i = 0; i < n; ++i, s += chunk) {
        poc_t *p = &tcp->pocs[tcp->npoc++];
        p->resno0 = s[0];
        p->compno0 = room == 1 ? s[1] : rd16(s + 1);
        p->layno1 = rd16(s + 1 + room);
        p->resno1 = s[3 + room];
        p->compno1 = room == 1 ? s[4 + room] : rd16(s + 4 + room);
        p->prg = s[4 + 2 * room];
        if (p->compno1 > d->ncomp)
            p->compno1 = d->ncomp;
    }
    return J2K_OK;
}

/* PPM (main header) and PPT (tile-part header): kept by index, merged
 * before use */
static int read_packed(j2k *d, packed_t *pk, const uint8_t *s, size_t len)
{
    if (len < 2)
        return fail(d, J2K_CORRUPT, "Error reading PPM / PPT marker");
    if (pk->seg[s[0]])
        return fail(d, J2K_CORRUPT, "Zppm / Zppt %u already read", s[0]);
    pk->seg[s[0]] = s + 1;
    pk->len[s[0]] = (uint32_t)(len - 1);
    pk->any = 1;
    return J2K_OK;
}

static int read_ppt(j2k *d, const uint8_t *s, size_t len)
{
    tcp_t *tcp = &d->tcps[d->cur_tile];
    if (d->ppm.any)
        return fail(d, J2K_CORRUPT, "PPT after a PPM marker");
    if (!tcp->ppt) {
        tcp->ppt = calloc(1, sizeof(packed_t));
        if (!tcp->ppt)
            return fail(d, J2K_NOMEM, "out of memory");
    }
    return read_packed(d, tcp->ppt, s, len);
}

/* opj_j2k_merge_ppm: the Ippm bytes of the PPM segments in index order,
 * each tile-part's Nppm length field taken out (it may straddle two
 * segments) */
static int merge_ppm(j2k *d)
{
    size_t pass, total = 0, at = 0;
    uint32_t i;
    for (pass = 0; pass < 2; ++pass) {
        uint32_t remaining = 0;
        for (i = 0; i < 256; ++i) {
            const uint8_t *p = d->ppm.seg[i];
            size_t n = d->ppm.len[i];
            while (p && n) {
                if (remaining) {
                    size_t k = remaining < n ? remaining : n;
                    if (pass)
                        memcpy(d->ppm_buf + at, p, k);
                    at += k;
                    p += k;
                    n -= k;
                    remaining -= (uint32_t)k;
                    continue;
                }
                if (n < 4)
                    return fail(d, J2K_CORRUPT, "Not enough bytes to read "
                                "Nppm");
                remaining = rd32(p);
                p += 4;
                n -= 4;
                if (!pass) {
                    if (total > UINT32_MAX - remaining)
                        return fail(d, J2K_CORRUPT, "Too large value for "
                                    "Nppm");
                    total += remaining;
                }
            }
        }
        if (remaining)
            return fail(d, J2K_CORRUPT, "Corrupted PPM markers");
        if (!pass) {
            d->ppm_buf = malloc(total ? total : 1);
            if (!d->ppm_buf)
                return fail(d, J2K_NOMEM, "out of memory");
            d->ppm_size = total;
            at = 0;
        }
    }
    return J2K_OK;
}

/* opj_j2k_merge_ppt: a tile's PPT segments in index order */
static uint8_t *merge_ppt(const packed_t *pk, size_t *size)
{
    size_t total = 0, at = 0;
    uint32_t i;
    uint8_t *buf;
    for (i = 0; i < 256; ++i)
        total += pk->len[i];
    buf = malloc(total ? total : 1);
    if (!buf)
        return NULL;
    for (i = 0; i < 256; ++i)
        if (pk->seg[i]) {
            memcpy(buf + at, pk->seg[i], pk->len[i]);
            at += pk->len[i];
        }
    *size = total;
    return buf;
}

static int read_plt(j2k *d, const uint8_t *s, size_t len)
{
    size_t i;
    uint32_t more = 0;
    if (len < 1)
        return fail(d, J2K_CORRUPT, "Error reading PLT marker");
    for (i = 1; i < len; ++i)
        more = s[i] & 0x80;
    if (more)
        return fail(d, J2K_CORRUPT, "Error reading PLT marker");
    return J2K_OK;
}

enum { M_SOT = 0xff90, M_COD = 0xff52, M_COC = 0xff53, M_RGN = 0xff5e,
       M_QCD = 0xff5c, M_QCC = 0xff5d, M_POC = 0xff5f, M_SIZ = 0xff51,
       M_TLM = 0xff55, M_PLM = 0xff57, M_PLT = 0xff58, M_PPM = 0xff60,
       M_PPT = 0xff61, M_SOP = 0xff91, M_CRG = 0xff63, M_COM = 0xff64,
       M_MCT = 0xff74, M_CBD = 0xff78, M_CAP = 0xff50, M_CPF = 0xff59,
       M_MCC = 0xff75, M_MCO = 0xff77, M_SOD = 0xff93, M_EOC = 0xffd9 };

/* the states in which a marker may appear; -1 for an unknown marker */
static int marker_states(uint32_t m)
{
    switch (m) {
    case M_SOT:
        return ST_MH | ST_TPHSOT;
    case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC:
    case M_POC: case M_COM: case M_MCT: case M_MCC: case M_MCO:
        return ST_MH | ST_TPH;
    case M_SIZ:
        return ST_MHSIZ;
    case M_TLM: case M_PLM: case M_PPM: case M_CRG: case M_CBD:
    case M_CAP: case M_CPF:
        return ST_MH;
    case M_PLT: case M_PPT:
        return ST_TPH;
    case M_SOP:
        return 0;
    default:
        return -1;
    }
}

static int read_segment(j2k *d, uint32_t m, const uint8_t *s, size_t len)
{
    switch (m) {
    case M_SIZ:
        return read_siz(d, s, len);
    case M_COD:
        return read_cod(d, s, len);
    case M_COC:
        return read_coc(d, s, len);
    case M_QCD:
        return read_qcd(d, s, len);
    case M_QCC:
        return read_qcc(d, s, len);
    case M_RGN:
        return read_rgn(d, s, len);
    case M_PLT:
        return read_plt(d, s, len);
    case M_CRG:
        if (len != 4 * (size_t)d->ncomp)
            return fail(d, J2K_CORRUPT, "Error reading CRG marker");
        return J2K_OK;
    case M_POC:
        return read_poc(d, s, len);
    case M_PPM:
        return read_packed(d, &d->ppm, s, len);
    case M_PPT:
        return read_ppt(d, s, len);
    default:  /* TLM, PLM, COM and the Part 2 / 15 markers */
        return J2K_OK;
    }
}

/* opj_j2k_read_unk: past an unknown marker, the next known one (read two
 * bytes at a time) */
static int skip_unknown(j2k *d, uint32_t *marker)
{
    for (;;) {
        uint32_t m;
        int st;
        if (d->pos + 2 > d->n)
            return fail(d, J2K_CORRUPT, "Stream too short");
        m = rd16(d->p + d->pos);
        d->pos += 2;
        if (m < 0xff00)
            continue;
        st = marker_states(m);
        if (st < 0)
            st = ST_MH | ST_TPH;
        if (!(d->state & st))
            return fail(d, J2K_CORRUPT, "marker %04x out of place", m);
        if (marker_states(m) >= 0) {
            *marker = m;
            return J2K_OK;
        }
    }
}

static int read_main_header(j2k *d)
{
    uint32_t m;
    int has_siz = 0, has_cod = 0, has_qcd = 0;
    if (d->n < 2 || rd16(d->p) != 0xff4f)
        return fail(d, J2K_CORRUPT, "no SOC marker");
    d->pos = 2;
    d->state = ST_MHSIZ;
    if (d->pos + 2 > d->n)
        return fail(d, J2K_CORRUPT, "Stream too short");
    m = rd16(d->p + 2);
    d->pos = 4;
    while (m != M_SOT) {
        size_t len;
        if (m < 0xff00)
            return fail(d, J2K_CORRUPT, "a marker was expected, not %04x", m);
        if (marker_states(m) < 0) {
            if (skip_unknown(d, &m))
                return d->status;
            if (m == M_SOT)
                break;
        }
        has_siz |= m == M_SIZ;
        has_cod |= m == M_COD;
        has_qcd |= m == M_QCD;
        if (!(d->state & marker_states(m)))
            return fail(d, J2K_CORRUPT, "marker %04x out of place", m);
        if (d->pos + 2 > d->n)
            return fail(d, J2K_CORRUPT, "Stream too short");
        len = rd16(d->p + d->pos);
        if (len < 2)
            return fail(d, J2K_CORRUPT, "Invalid marker size");
        len -= 2;
        d->pos += 2;
        if (d->pos + len > d->n)
            return fail(d, J2K_CORRUPT, "Stream too short");
        if (read_segment(d, m, d->p + d->pos, len))
            return d->status;
        d->pos += len;
        if (d->pos + 2 > d->n)
            return fail(d, J2K_CORRUPT, "Stream too short");
        m = rd16(d->p + d->pos);
        d->pos += 2;
    }
    if (!has_siz)
        return fail(d, J2K_CORRUPT, "required SIZ marker not found");
    if (!has_cod)
        return fail(d, J2K_CORRUPT, "required COD marker not found");
    if (!has_qcd)
        return fail(d, J2K_CORRUPT, "required QCD marker not found");
    if (d->ppm.any && merge_ppm(d))
        return d->status;
    d->state = ST_TPHSOT;
    return J2K_OK;
}

/* ------------------------------------------------------------------ */
/* tile geometry */

typedef struct {
    uint32_t len, numpasses, maxpasses, newlen, numnewpasses;
} seg_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t numbps, numlenbits, numnewpasses, numsegs, segcap;
    seg_t *segs;
    uint8_t *data;
    size_t dlen, dcap;
    uint32_t nchunks;  /* the segment contributions read (OpenJPEG's chunks) */
    uint32_t align;    /* where the first starts in the tile's data, mod 4 */
} cblk_t;

typedef struct {
    int32_t *nodes;      /* value, low, parent per node */
    uint32_t n;
} tgt_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t cw, ch;
    cblk_t *cblks;
    tgt_t incl, imsb;
} prc_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t bandno;
    int numbps;
    float stepsize;
    prc_t *prcs;
} band_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t pdx, pdy, pw, ph, numbands;
    band_t bands[3];
} res_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t numres;
    res_t *res;
    int32_t *data;   /* int32, or float32 bits for the 9/7 transform */
} tilec_t;

static void tgt_free(tgt_t *t)
{
    free(t->nodes);
    t->nodes = NULL;
}

/* a tag tree of w x h leaves: nodes level by level, leaves first; every
 * node's value 999 and low 0 (opj_tgt_reset) */
static int tgt_init(tgt_t *t, uint32_t w, uint32_t h)
{
    uint32_t nw[32], nh[32], levels = 0, total = 0, k, i, j, base, next;
    t->nodes = NULL;
    t->n = 0;
    if (!w || !h)
        return 0;
    nw[0] = w;
    nh[0] = h;
    do {
        total += nw[levels] * nh[levels];
        nw[levels + 1] = (nw[levels] + 1) / 2;
        nh[levels + 1] = (nh[levels] + 1) / 2;
        ++levels;
    } while (nw[levels - 1] * nh[levels - 1] > 1);
    t->nodes = malloc(3 * sizeof(int32_t) * total);
    if (!t->nodes)
        return -1;
    t->n = total;
    base = 0;
    for (k = 0; k < levels; ++k) {
        next = base + nw[k] * nh[k];
        for (j = 0; j < nh[k]; ++j)
            for (i = 0; i < nw[k]; ++i) {
                int32_t *nd = t->nodes + 3 * (base + j * nw[k] + i);
                nd[0] = 999;
                nd[1] = 0;
                nd[2] = k + 1 < levels ?
                    (int32_t)(next + (j / 2) * nw[k + 1] + i / 2) : -1;
            }
        base = next;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* packet header bits (opj_bio: a 0xFF byte is followed by 7 bits) */

typedef struct {
    const uint8_t *start, *bp, *end;
    uint32_t buf, ct;
} bio_t;

static void bio_init(bio_t *b, const uint8_t *p, size_t n)
{
    b->start = b->bp = p;
    b->end = p + n;
    b->buf = 0;
    b->ct = 0;
}

static void bio_bytein(bio_t *b)
{
    b->buf = (b->buf << 8) & 0xffff;
    b->ct = b->buf == 0xff00 ? 7 : 8;
    if (b->bp < b->end)
        b->buf |= *b->bp++;
}

static uint32_t bio_read(bio_t *b, uint32_t n)
{
    uint32_t v = 0;
    int i;
    for (i = (int)n - 1; i >= 0; --i) {
        if (!b->ct)
            bio_bytein(b);
        b->ct--;
        v |= ((b->buf >> b->ct) & 1u) << i;
    }
    return v;
}

static uint32_t tgt_decode(bio_t *b, tgt_t *t, uint32_t leaf,
                           int32_t threshold)
{
    int32_t stk[32], *node;
    int sp = 0;
    int32_t low = 0, idx = (int32_t)leaf;
    while (t->nodes[3 * idx + 2] >= 0) {
        stk[sp++] = idx;
        idx = t->nodes[3 * idx + 2];
    }
    for (;;) {
        node = t->nodes + 3 * idx;
        if (low > node[1])
            node[1] = low;
        else
            low = node[1];
        while (low < threshold && low < node[0]) {
            if (bio_read(b, 1))
                node[0] = low;
            else
                ++low;
        }
        node[1] = low;
        if (!sp)
            break;
        idx = stk[--sp];
    }
    return t->nodes[3 * idx] < threshold;
}

/* ------------------------------------------------------------------ */
/* tier 2 */

static int init_seg(cblk_t *cb, uint32_t index, uint32_t cblksty, int first)
{
    seg_t *seg;
    if (index >= cb->segcap) {
        uint32_t cap = cb->segcap ? 2 * cb->segcap : 4;
        seg_t *s;
        while (cap <= index)
            cap *= 2;
        s = realloc(cb->segs, cap * sizeof(seg_t));
        if (!s)
            return -1;
        cb->segs = s;
        cb->segcap = cap;
    }
    seg = &cb->segs[index];
    memset(seg, 0, sizeof *seg);
    if (cblksty & CBLK_TERMALL)
        seg->maxpasses = 1;
    else if (cblksty & CBLK_LAZY) {
        if (first)
            seg->maxpasses = 10;
        else
            seg->maxpasses = (seg[-1].maxpasses == 1
                              || seg[-1].maxpasses == 10) ? 2 : 1;
    } else
        seg->maxpasses = 109;
    return 0;
}

static uint32_t floorlog2(uint32_t a)
{
    uint32_t l = 0;
    while (a > 1) {
        a >>= 1;
        ++l;
    }
    return l;
}

static uint32_t getnumpasses(bio_t *b)
{
    uint32_t n;
    if (!bio_read(b, 1))
        return 1;
    if (!bio_read(b, 1))
        return 2;
    if ((n = bio_read(b, 2)) != 3)
        return 3 + n;
    if ((n = bio_read(b, 5)) != 31)
        return 6 + n;
    return 37 + bio_read(b, 7);
}

/* a packet: layer, resolution, component, precinct, and its place in
 * its progression's order (the fields of LRCP, RLCP, RPCL, PCRL or CPRL
 * in turn; y, x: the precinct's corner on the reference grid) */
typedef struct {
    uint32_t l, r, c, p;
    uint64_t key[5];
} packet_t;

static void packet_key(packet_t *o, uint32_t prg, uint64_t y, uint64_t x)
{
    uint64_t l = o->l, r = o->r, c = o->c, p = o->p;
    uint64_t keys[5][5] = {{l, r, c, p, 0}, {r, l, c, p, 0},
                           {r, y, x, c, l}, {y, x, c, r, l},
                           {c, y, x, r, l}};
    memcpy(o->key, keys[prg], sizeof o->key);
}

static int packet_cmp(const void *pa, const void *pb)
{
    const packet_t *a = pa, *b = pb;
    int i;
    for (i = 0; i < 5; ++i)
        if (a->key[i] != b->key[i])
            return a->key[i] < b->key[i] ? -1 : 1;
    return 0;
}

typedef struct {
    j2k *d;
    tcp_t *tcp;
    tilec_t *comps;
    uint32_t tx0, ty0, tx1, ty1;
} tile_t;

/* the EPH marker that COD announces must end a packet header (an SOP
 * marker is optional) */
static int eph(j2k *d, const uint8_t **hdr, const uint8_t *end)
{
    if (end - *hdr < 2 || (*hdr)[0] != 0xff || (*hdr)[1] != 0x92)
        return fail(d, J2K_CORRUPT, "Expected EPH marker");
    *hdr += 2;
    return J2K_OK;
}

/* one packet: its header (SOP / EPH as COD says), then its code-block
 * segments; *pos moves past it */
/* where packet headers are read: the packed headers of PPM / PPT */
typedef struct {
    const uint8_t *p;
    size_t len, *pos;
} hsrc_t;

static int read_packet(tile_t *T, const packet_t *pk, const uint8_t *src,
                       size_t max, size_t *pos, const hsrc_t *hs)
{
    j2k *d = T->d;
    tcp_t *tcp = T->tcp;
    tccp_t *tccp = &tcp->tccps[pk->c];
    res_t *res = &T->comps[pk->c].res[pk->r];
    const uint8_t *cur = src + *pos, *end = src + max, *hdr, *hbeg, *hend;
    bio_t b;
    uint32_t bandno, i;

    if (tcp->csty & 2) {  /* SOP: optional, a warning where absent */
        if ((size_t)(end - cur) >= 6 && cur[0] == 0xff && cur[1] == 0x91)
            cur += 6;
    }
    hbeg = hs ? hs->p + *hs->pos : cur;
    hend = hs ? hs->p + hs->len : end;
    bio_init(&b, hbeg, (size_t)(hend - hbeg));
    if (!bio_read(&b, 1)) {
        /* an empty packet */
        if ((b.buf & 0xff) == 0xff)
            bio_bytein(&b);
        hdr = hbeg + (b.bp - b.start);
        if ((tcp->csty & 4) && eph(d, &hdr, hend))
            return d->status;
        if (hs) {
            *hs->pos = (size_t)(hdr - hs->p);
            hdr = cur;
        }
        *pos = (size_t)(hdr - src);
        for (bandno = 0; bandno < res->numbands; ++bandno) {
            band_t *band = &res->bands[bandno];
            prc_t *prc;
            if (band->x1 == band->x0 || band->y1 == band->y0)
                continue;
            prc = &band->prcs[pk->p];
            for (i = 0; i < prc->cw * prc->ch; ++i)
                prc->cblks[i].numnewpasses = 0;
        }
        return J2K_OK;
    }
    for (bandno = 0; bandno < res->numbands; ++bandno) {
        band_t *band = &res->bands[bandno];
        prc_t *prc;
        if (band->x1 == band->x0 || band->y1 == band->y0)
            continue;
        prc = &band->prcs[pk->p];
        for (i = 0; i < prc->cw * prc->ch; ++i) {
            cblk_t *cb = &prc->cblks[i];
            uint32_t included, segno, n;
            if (!cb->numsegs)
                included = tgt_decode(&b, &prc->incl, i, (int32_t)pk->l + 1);
            else
                included = bio_read(&b, 1);
            if (!included) {
                cb->numnewpasses = 0;
                continue;
            }
            if (!cb->numsegs) {
                uint32_t k = 0;
                while (!tgt_decode(&b, &prc->imsb, i, (int32_t)k))
                    ++k;
                cb->numbps = (uint32_t)band->numbps + 1u - k;
                cb->numlenbits = 3;
            }
            cb->numnewpasses = getnumpasses(&b);
            while (bio_read(&b, 1))
                ++cb->numlenbits;
            segno = 0;
            if (!cb->numsegs) {
                if (init_seg(cb, 0, tccp->cblksty, 1))
                    return fail(d, J2K_NOMEM, "out of memory");
            } else {
                segno = cb->numsegs - 1;
                if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses) {
                    ++segno;
                    if (init_seg(cb, segno, tccp->cblksty, 0))
                        return fail(d, J2K_NOMEM, "out of memory");
                }
            }
            n = cb->numnewpasses;
            do {
                seg_t *seg = &cb->segs[segno];
                uint32_t room = seg->maxpasses - seg->numpasses, bits;
                /* HT: the cleanup pass alone in the first segment, every
                 * other pass in the next */
                if (tccp->cblksty & CBLK_HT)
                    seg->numnewpasses = segno ? n : 1;
                else
                    seg->numnewpasses = room < n ? room : n;
                bits = cb->numlenbits + floorlog2(seg->numnewpasses);
                if (bits > 32)
                    return fail(d, J2K_CORRUPT, "a length of %u bits", bits);
                seg->newlen = bio_read(&b, bits);
                n -= seg->numnewpasses;
                if (n > 0) {
                    ++segno;
                    if (init_seg(cb, segno, tccp->cblksty, 0))
                        return fail(d, J2K_NOMEM, "out of memory");
                }
            } while (n > 0);
        }
    }
    if ((b.buf & 0xff) == 0xff)
        bio_bytein(&b);
    hdr = hbeg + (b.bp - b.start);
    if ((tcp->csty & 4) && eph(d, &hdr, hend))
        return d->status;
    if (hs)
        *hs->pos = (size_t)(hdr - hs->p);
    else
        cur = hdr;

    /* the packet body */
    for (bandno = 0; bandno < res->numbands; ++bandno) {
        band_t *band = &res->bands[bandno];
        prc_t *prc;
        if (band->x1 == band->x0 || band->y1 == band->y0)
            continue;
        prc = &band->prcs[pk->p];
        for (i = 0; i < prc->cw * prc->ch; ++i) {
            cblk_t *cb = &prc->cblks[i];
            seg_t *seg;
            if (!cb->numnewpasses)
                continue;
            if (!cb->numsegs) {
                seg = cb->segs;
                cb->numsegs = 1;
            } else {
                seg = &cb->segs[cb->numsegs - 1];
                if (seg->numpasses == seg->maxpasses) {
                    ++seg;
                    ++cb->numsegs;
                }
            }
            do {
                if (seg->newlen > (size_t)(end - cur))
                    return fail(d, J2K_CORRUPT, "a code-block segment runs "
                                "past its tile");
                if (cb->dlen + seg->newlen > cb->dcap) {
                    size_t cap = cb->dcap ? 2 * cb->dcap : 256;
                    uint8_t *p;
                    while (cap < cb->dlen + seg->newlen)
                        cap *= 2;
                    p = realloc(cb->data, cap);
                    if (!p)
                        return fail(d, J2K_NOMEM, "out of memory");
                    cb->data = p;
                    cb->dcap = cap;
                }
                if (seg->newlen)
                    memcpy(cb->data + cb->dlen, cur, seg->newlen);
                if (!cb->nchunks++)
                    cb->align = (uint32_t)(cur - src) & 3;
                cb->dlen += seg->newlen;
                cur += seg->newlen;
                seg->len += seg->newlen;
                seg->numpasses += seg->numnewpasses;
                cb->numnewpasses -= seg->numnewpasses;
                if (cb->numnewpasses > 0) {
                    ++seg;
                    ++cb->numsegs;
                }
            } while (cb->numnewpasses > 0);
        }
    }
    *pos = (size_t)(cur - src);
    return J2K_OK;
}

/* ------------------------------------------------------------------ */
/* tier 1: the MQ decoder (T.800 C.3) and the coding passes (D.3) */

static const uint16_t MQ_QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
static const uint8_t MQ_NMPS[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t MQ_NLPS[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
    18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t MQ_SWITCH[47] = {
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

/* contexts: ZC 0-8, SC 9-13, MR 14-16, AGG 17, UNI 18 */
#define CX_SC 9
#define CX_MR 14
#define CX_AGG 17
#define CX_UNI 18
#define NCX 19

typedef struct {
    const uint8_t *bp;   /* data of the segment followed by 0xFF 0xFF */
    uint32_t a, c, ct;
    uint8_t st[NCX], mps[NCX];
} mqc_t;

static void mq_reset(mqc_t *m)
{
    memset(m->st, 0, sizeof m->st);
    memset(m->mps, 0, sizeof m->mps);
    m->st[CX_UNI] = 46;
    m->st[CX_AGG] = 3;
    m->st[0] = 4;
}

static void mq_bytein(mqc_t *m)
{
    uint32_t next = m->bp[1];
    if (m->bp[0] == 0xff) {
        if (next > 0x8f) {
            m->c += 0xff00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += next << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += next << 8;
        m->ct = 8;
    }
}

static void mq_init(mqc_t *m, const uint8_t *bp, uint32_t len)
{
    m->bp = bp;
    m->c = len ? (uint32_t)bp[0] << 16 : 0xffu << 16;
    mq_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

static void mq_raw_init(mqc_t *m, const uint8_t *bp)
{
    m->bp = bp;
    m->c = 0;
    m->ct = 0;
}

static uint32_t mq_decode(mqc_t *m, int cx)
{
    uint32_t s = m->st[cx], qe = MQ_QE[s], dbit;
    m->a -= qe;
    if ((m->c >> 16) < qe) {
        if (m->a < qe) {
            dbit = m->mps[cx];
            m->st[cx] = MQ_NMPS[s];
        } else {
            dbit = !m->mps[cx];
            if (MQ_SWITCH[s])
                m->mps[cx] = (uint8_t)!m->mps[cx];
            m->st[cx] = MQ_NLPS[s];
        }
        m->a = qe;
    } else {
        m->c -= qe << 16;
        if (m->a & 0x8000)
            return m->mps[cx];
        if (m->a < qe) {
            dbit = !m->mps[cx];
            if (MQ_SWITCH[s])
                m->mps[cx] = (uint8_t)!m->mps[cx];
            m->st[cx] = MQ_NLPS[s];
        } else {
            dbit = m->mps[cx];
            m->st[cx] = MQ_NMPS[s];
        }
    }
    do {
        if (!m->ct)
            mq_bytein(m);
        m->a <<= 1;
        m->c <<= 1;
        m->ct--;
    } while (m->a < 0x8000);
    return dbit;
}

static uint32_t mq_raw_decode(mqc_t *m)
{
    if (!m->ct) {
        if (m->c == 0xff) {
            if (m->bp[0] > 0x8f) {
                m->c = 0xff;
                m->ct = 8;
            } else {
                m->c = m->bp[0];
                m->bp++;
                m->ct = 7;
            }
        } else {
            m->c = m->bp[0];
            m->bp++;
            m->ct = 8;
        }
    }
    m->ct--;
    return (m->c >> m->ct) & 1u;
}

#define F_SIG 1
#define F_NEG 2
#define F_VIS 4
#define F_REF 8

/* ZC contexts (Table D.1) by band orientation, h, v and d */
typedef uint8_t zc_lut_t[4][3][3][5];

static void zc_init(zc_lut_t zc_lut)
{
    int o, h, v, dd;
    for (o = 0; o < 4; ++o)
        for (h = 0; h < 3; ++h)
            for (v = 0; v < 3; ++v)
                for (dd = 0; dd < 5; ++dd) {
                    int hh = h, vv = v, cx;
                    if (o == 1) {
                        hh = v;
                        vv = h;
                    }
                    if (o == 3) {
                        int hv = h + v;
                        if (dd >= 3)
                            cx = 8;
                        else if (dd == 2)
                            cx = hv >= 1 ? 7 : 6;
                        else if (dd == 1)
                            cx = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
                        else
                            cx = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
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
    uint32_t w, h, stride, orient, vsc;
    uint8_t *f;          /* (w + 2) x (h + 2) flags, a zero border */
    int32_t *data;       /* w x h */
    mqc_t mq;
    zc_lut_t zc;
} t1_t;

/* the significance of the eight neighbours of the sample at flag index i
 * in row y: h, v and d counts; below the stripe counts as insignificant
 * in VSC mode on a stripe's last row */
static void t1_nb(const t1_t *t, uint32_t i, uint32_t y, int *h, int *v,
                  int *dd)
{
    const uint8_t *f = t->f;
    uint32_t s = t->stride;
    int below = !(t->vsc && (y & 3) == 3);
    *h = (f[i - 1] & F_SIG) + (f[i + 1] & F_SIG);
    *v = (f[i - s] & F_SIG) + (below ? (f[i + s] & F_SIG) : 0);
    *dd = (f[i - s - 1] & F_SIG) + (f[i - s + 1] & F_SIG)
        + (below ? (f[i + s - 1] & F_SIG) + (f[i + s + 1] & F_SIG) : 0);
}

static int contrib(uint8_t f)
{
    return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0;
}

/* SC context (Table D.3) and the sign prediction */
static int t1_sc(const t1_t *t, uint32_t i, uint32_t y, uint32_t *xr)
{
    const uint8_t *f = t->f;
    uint32_t s = t->stride;
    int below = !(t->vsc && (y & 3) == 3);
    int hc = contrib(f[i - 1]) + contrib(f[i + 1]);
    int vc = contrib(f[i - s]) + (below ? contrib(f[i + s]) : 0);
    hc = hc > 1 ? 1 : hc < -1 ? -1 : hc;
    vc = vc > 1 ? 1 : vc < -1 ? -1 : vc;
    if (hc < 0 || (hc == 0 && vc < 0)) {
        hc = -hc;
        vc = -vc;
        *xr = 1;
    } else
        *xr = 0;
    if (hc == 1)
        return CX_SC + 3 + vc;
    return CX_SC + (vc != 0);
}

static void t1_sign(t1_t *t, uint32_t i, uint32_t x, uint32_t y,
                    int32_t oneplushalf, int raw)
{
    uint32_t s;
    if (raw)
        s = mq_raw_decode(&t->mq);
    else {
        uint32_t xr;
        int cx = t1_sc(t, i, y, &xr);
        s = mq_decode(&t->mq, cx) ^ xr;
    }
    t->data[y * t->w + x] = s ? -oneplushalf : oneplushalf;
    t->f[i] |= (uint8_t)(F_SIG | (s ? F_NEG : 0));
}

static void t1_sigpass(t1_t *t, int bpno, int raw)
{
    int32_t one = (int32_t)1 << bpno, oneplushalf = one | (one >> 1);
    uint32_t k, x, y;
    for (k = 0; k < t->h; k += 4)
        for (x = 0; x < t->w; ++x)
            for (y = k; y < k + 4 && y < t->h; ++y) {
                uint32_t i = (y + 1) * t->stride + x + 1;
                int h, v, dd;
                if (t->f[i] & (F_SIG | F_VIS))
                    continue;
                t1_nb(t, i, y, &h, &v, &dd);
                if (!(h | v | dd))
                    continue;
                if (raw ? mq_raw_decode(&t->mq)
                    : mq_decode(&t->mq, t->zc[t->orient][h][v][dd]))
                    t1_sign(t, i, x, y, oneplushalf, raw);
                t->f[i] |= F_VIS;
            }
}

static void t1_refpass(t1_t *t, int bpno, int raw)
{
    int32_t poshalf = ((int32_t)1 << bpno) >> 1;
    uint32_t k, x, y;
    for (k = 0; k < t->h; k += 4)
        for (x = 0; x < t->w; ++x)
            for (y = k; y < k + 4 && y < t->h; ++y) {
                uint32_t i = (y + 1) * t->stride + x + 1, bit;
                int32_t *dp = &t->data[y * t->w + x];
                if ((t->f[i] & (F_SIG | F_VIS)) != F_SIG)
                    continue;
                if (raw)
                    bit = mq_raw_decode(&t->mq);
                else {
                    int cx;
                    if (t->f[i] & F_REF)
                        cx = CX_MR + 2;
                    else {
                        int h, v, dd;
                        t1_nb(t, i, y, &h, &v, &dd);
                        cx = CX_MR + ((h | v | dd) != 0);
                    }
                    bit = mq_decode(&t->mq, cx);
                }
                *dp += (bit ^ (uint32_t)(*dp < 0)) ? poshalf : -poshalf;
                t->f[i] |= F_REF;
            }
}

static void t1_cln_step(t1_t *t, uint32_t x, uint32_t y, int32_t oneplushalf)
{
    uint32_t i = (y + 1) * t->stride + x + 1;
    int h, v, dd;
    if (t->f[i] & (F_SIG | F_VIS))
        return;
    t1_nb(t, i, y, &h, &v, &dd);
    if (mq_decode(&t->mq, t->zc[t->orient][h][v][dd]))
        t1_sign(t, i, x, y, oneplushalf, 0);
}

static void t1_clnpass(t1_t *t, int bpno, int segsym)
{
    int32_t one = (int32_t)1 << bpno, oneplushalf = one | (one >> 1);
    uint32_t k, x, y;
    for (k = 0; k < t->h; k += 4)
        for (x = 0; x < t->w; ++x) {
            uint32_t start = k;
            if (k + 4 <= t->h) {
                int quiet = 1;
                for (y = k; y < k + 4 && quiet; ++y) {
                    uint32_t i = (y + 1) * t->stride + x + 1;
                    int h, v, dd;
                    t1_nb(t, i, y, &h, &v, &dd);
                    quiet = !(t->f[i] & (F_SIG | F_VIS)) && !(h | v | dd);
                }
                if (quiet) {
                    uint32_t r;
                    if (!mq_decode(&t->mq, CX_AGG))
                        continue;
                    r = mq_decode(&t->mq, CX_UNI) << 1;
                    r |= mq_decode(&t->mq, CX_UNI);
                    y = k + r;
                    t1_sign(t, (y + 1) * t->stride + x + 1, x, y, oneplushalf,
                            0);
                    start = y + 1;
                }
            }
            for (y = start; y < k + 4 && y < t->h; ++y)
                t1_cln_step(t, x, y, oneplushalf);
        }
    for (y = 0; y < t->h; ++y)
        for (x = 0; x < t->w; ++x)
            t->f[(y + 1) * t->stride + x + 1] &= (uint8_t)~F_VIS;
    if (segsym) {
        int b;
        for (b = 0; b < 4; ++b)
            mq_decode(&t->mq, CX_UNI);
    }
}

/* opj_t1_decode_cblk: the code block's segments, pass after pass; data
 * holds the coefficients with one fractional bit (the half step) */
static int t1_decode(j2k *d, const cblk_t *cb, const tccp_t *tccp,
                     uint32_t orient, t1_t *t)
{
    uint32_t w = (uint32_t)(cb->x1 - cb->x0), h = (uint32_t)(cb->y1 - cb->y0);
    int32_t bpno = (int32_t)(tccp->roishift + cb->numbps);
    int passtype = 2;
    uint32_t s;
    size_t at = 0;
    uint8_t *buf = NULL;
    t->w = w;
    t->h = h;
    t->stride = w + 2;
    t->orient = orient;
    t->vsc = (tccp->cblksty & CBLK_VSC) != 0;
    memset(t->f, 0, (size_t)(w + 2) * (h + 2));
    memset(t->data, 0, (size_t)w * h * sizeof(int32_t));
    if (bpno >= 31)
        return fail(d, J2K_CORRUPT, "a code block of %d bit-planes", bpno);
    mq_reset(&t->mq);
    if (cb->numsegs) {
        buf = malloc(cb->dlen + 2);
        if (!buf)
            return fail(d, J2K_NOMEM, "out of memory");
    }
    for (s = 0; s < cb->numsegs; ++s) {
        const seg_t *seg = &cb->segs[s];
        uint32_t pass;
        int raw = bpno <= (int32_t)cb->numbps - 4 && passtype < 2
            && (tccp->cblksty & CBLK_LAZY);
        /* the segment, then the 0xFF 0xFF that stops the byte input */
        if (seg->len)
            memcpy(buf, cb->data + at, seg->len);
        buf[seg->len] = buf[seg->len + 1] = 0xff;
        at += seg->len;
        if (raw)
            mq_raw_init(&t->mq, buf);
        else
            mq_init(&t->mq, buf, seg->len);
        for (pass = 0; pass < seg->numpasses && bpno >= 1; ++pass) {
            if (passtype == 0)
                t1_sigpass(t, bpno, raw);
            else if (passtype == 1)
                t1_refpass(t, bpno, raw);
            else
                t1_clnpass(t, bpno, (tccp->cblksty & CBLK_SEGSYM) != 0);
            if ((tccp->cblksty & CBLK_RESET) && !raw)
                mq_reset(&t->mq);
            if (++passtype == 3) {
                passtype = 0;
                bpno--;
            }
        }
    }
    free(buf);
    return J2K_OK;
}

/* ------------------------------------------------------------------ */
/* HTJ2K code blocks (T.814), as OpenJPEG 2.5's ht_dec.c decodes them:
 * the cleanup pass (MEL and VLC read backward from the segment's end
 * through vlc_tbl0 / vlc_tbl1 of ht_tables.h, UVLC from its definition,
 * MagSgn forward), then SigProp (forward) and MagRef (backward from the
 * refinement segment's end).  Samples are kept as OpenJPEG keeps them:
 * sign in bit 31, the magnitude above its half step, the cleanup's least
 * significant bit at bit p = numbps; at the end they become the signed
 * coefficients with one fractional bit that the EBCOT path leaves. */

/* a forward bit reader (MagSgn, SigProp): bytes least significant bit
 * first; after a 0xFF byte the next gives 7 bits (its top bit overlaps the
 * byte after it); past the end `fill` bytes */
typedef struct {
    const uint8_t *p;
    int64_t left;
    uint64_t acc;
    int nb, unstuff;
    uint8_t fill;
} fwd_t;

static void fwd_init(fwd_t *r, const uint8_t *p, int64_t n, uint8_t fill)
{
    r->p = p;
    r->left = n;
    r->acc = 0;
    r->nb = 0;
    r->unstuff = 0;
    r->fill = fill;
}

static void fwd_fill(fwd_t *r)
{
    while (r->nb <= 48) {
        uint32_t d = r->left-- > 0 ? *r->p++ : r->fill;
        r->acc |= (uint64_t)d << r->nb;
        r->nb += 8 - r->unstuff;
        r->unstuff = d == 0xff;
    }
}

static uint32_t fwd_peek(fwd_t *r)
{
    fwd_fill(r);
    return (uint32_t)r->acc;
}

static void fwd_skip(fwd_t *r, int n)
{
    r->acc >>= n;
    r->nb -= n;
}

/* a backward bit reader (VLC, MagRef): bytes least significant bit first
 * from the end; after a byte above 0x8F, a byte whose low 7 bits are all
 * set gives 7 bits; past the start zeros */
typedef struct {
    const uint8_t *p;
    int64_t left;
    uint64_t acc;
    int nb, unstuff;
} rev_t;

static void rev_fill(rev_t *r)
{
    while (r->nb <= 48) {
        uint32_t d = 0;
        if (r->left > 0) {
            d = *r->p--;
            r->left--;
        }
        r->acc |= (uint64_t)d << r->nb;
        r->nb += 8 - (r->unstuff && (d & 0x7f) == 0x7f);
        r->unstuff = d > 0x8f;
    }
}

static uint32_t rev_peek(rev_t *r)
{
    rev_fill(r);
    return (uint32_t)r->acc;
}

static void rev_skip(rev_t *r, int n)
{
    r->acc >>= n;
    r->nb -= n;
}

/* the MEL decoder: its bytes most significant bit first, a byte after
 * 0xFF giving its low 7 bits, the last byte (shared with the VLC) ORed
 * with 0xF, 0xFF past the end; each symbol a run of events */
typedef struct {
    const uint8_t *p;
    int64_t left;
    int unstuff, k, zeros, one;
    uint64_t acc;
    int nb;
} mel_t;

static int mel_bit(mel_t *m)
{
    int b;
    if (!m->nb) {
        uint32_t d = 0xff;
        if (m->left > 0) {
            d = *m->p++;
            if (m->left == 1)
                d |= 0xf;
            m->left--;
        }
        m->nb = 8 - m->unstuff;
        m->acc = d & ((1u << m->nb) - 1);
        m->unstuff = d == 0xff;
    }
    b = (int)(m->acc >> (m->nb - 1)) & 1;
    m->nb--;
    return b;
}

/* the next MEL event */
static int mel_event(mel_t *m)
{
    if (!m->zeros && !m->one) {
        int e = mel_exp[m->k];
        if (mel_bit(m)) {  /* 2^e zeros */
            m->zeros = 1 << e;
            m->k = m->k + 1 < 12 ? m->k + 1 : 12;
        } else {           /* e bits of zeros, then a one */
            int r = 0;
            while (e--)
                r = r << 1 | mel_bit(m);
            m->zeros = r;
            m->one = 1;
            m->k = m->k > 0 ? m->k - 1 : 0;
        }
    }
    if (m->zeros) {
        m->zeros--;
        return 0;
    }
    m->one = 0;
    return 1;
}

/* a UVLC prefix (T.814 7.3.6): u (1, 2, 3 or 5) and its suffix's bits */
static uint32_t uvlc_prefix(rev_t *r, int *suffix)
{
    uint32_t b = rev_peek(r);
    if (b & 1) {
        rev_skip(r, 1);
        *suffix = 0;
        return 1;
    }
    if (b & 2) {
        rev_skip(r, 2);
        *suffix = 0;
        return 2;
    }
    rev_skip(r, 3);
    *suffix = (b & 4) ? 1 : 5;
    return (b & 4) ? 3 : 5;
}

/* the u of a quad pair (uoff: quad 0 in bit 0, quad 1 in bit 1); mel:
 * the initial line pair's MEL event where both are set, else -1 */
static void uvlc_pair(rev_t *r, int uoff, int mel, uint32_t *u0,
                      uint32_t *u1)
{
    int s0 = 0, s1 = 0;
    *u0 = *u1 = 0;
    if (uoff == 1)
        *u0 = uvlc_prefix(r, &s0);
    else if (uoff == 2)
        *u1 = uvlc_prefix(r, &s1);
    else if (uoff == 3) {
        *u0 = uvlc_prefix(r, &s0);
        if (mel == 0 && *u0 > 2) {
            *u1 = (rev_peek(r) & 1) + 1;
            rev_skip(r, 1);
        } else
            *u1 = uvlc_prefix(r, &s1);
    }
    if (s0) {
        *u0 += rev_peek(r) & ((1u << s0) - 1);
        rev_skip(r, s0);
    }
    if (s1) {
        *u1 += rev_peek(r) & ((1u << s1) - 1);
        rev_skip(r, s1);
    }
    if (mel == 1) {
        *u0 += 2;
        *u1 += 2;
    }
}

/* SigProp and MagRef over the cleanup's significance sigma (a uint16 per
 * 4 x 4 group: a nibble per column, a bit per row, mstr per stripe) */
static void ht_refine(uint32_t *dec, uint32_t w, uint32_t h,
                      const uint16_t *sigma, uint32_t mstr, uint32_t p,
                      int passes, int causal, const uint8_t *seg,
                      uint32_t len1, uint32_t len2)
{
    uint32_t x, y;
    if (passes > 2) {  /* MagRef: the cleanup's significant samples */
        rev_t mr;
        mr.p = seg + len1 + len2 - 1;
        mr.left = len2;
        mr.acc = 0;
        mr.nb = 0;
        mr.unstuff = 1;
        for (y = 0; y < h; y += 4)
            for (x = 0; x < w; x += 4) {
                uint32_t sig = sigma[(y >> 2) * mstr + (x >> 2)], col, j;
                for (col = 0; col < 4; ++col, sig >>= 4)
                    for (j = 0; j < 4; ++j)
                        if (sig & (1u << j)) {
                            uint32_t sym = rev_peek(&mr) & 1;
                            uint32_t *dp = dec + (y + j) * w + x + col;
                            rev_skip(&mr, 1);
                            *dp ^= (1 - sym) << (p - 1);
                            *dp |= 1u << (p - 2);
                        }
            }
    }
    {  /* SigProp */
        fwd_t sp;
        uint16_t prev_row[256 + 8];
        memset(prev_row, 0, sizeof prev_row);
        fwd_init(&sp, seg + len1, len2, 0);
        for (y = 0; y < h; y += 4) {
            uint32_t pattern = h - y >= 4 ? 0xffffu : h - y == 3 ? 0x7777u
                : h - y == 2 ? 0x3333u : 0x1111u, prev = 0;
            const uint16_t *cur = sigma + (y >> 2) * mstr;
            uint32_t g;
            for (x = 0, g = 0; x < w; x += 4, ++g) {
                int32_t s = (int32_t)(x + 4) - (int32_t)w;
                uint32_t ps, ns, u, cs, mbr, t, new_sig;
                s = s > 0 ? s : 0;
                pattern >>= s * 4;
                ps = prev_row[g] | (uint32_t)prev_row[g + 1] << 16;
                ns = cur[mstr + g] | (uint32_t)cur[mstr + g + 1] << 16;
                u = (ps & 0x88888888u) >> 3;
                if (!causal)
                    u |= (ns & 0x11111111u) << 3;
                cs = cur[g] | (uint32_t)cur[g + 1] << 16;
                mbr = cs | (cs & 0x77777777u) << 1 | (cs & 0xeeeeeeeeu) >> 1
                    | u;
                t = mbr;
                mbr |= t << 4 | t >> 4 | prev >> 12;
                mbr &= pattern & ~cs;
                new_sig = mbr;
                if (new_sig) {
                    uint64_t cwd;
                    uint32_t cnt = 0, col_mask = 0xf, inv = ~cs & pattern;
                    int i;
                    static const uint32_t grow[4] = {0x33, 0x76, 0xec, 0xc8};
                    fwd_fill(&sp);
                    cwd = sp.acc;
                    for (i = 0; i < 16; i += 4, col_mask <<= 4) {
                        int j;
                        if (!(col_mask & new_sig))
                            continue;
                        for (j = 0; j < 4; ++j) {
                            uint32_t m = 1u << (i + j);
                            if (new_sig & m) {
                                new_sig &= ~m;
                                if (cwd & 1)
                                    new_sig |= (grow[j] << i) & inv;
                                cwd >>= 1;
                                ++cnt;
                            }
                        }
                    }
                    if (new_sig) {  /* the signs of the new samples */
                        for (i = 0; i < 4; ++i) {
                            int j;
                            for (j = 0; j < 4; ++j)
                                if (new_sig & (1u << (4 * i + j))) {
                                    dec[(y + j) * w + x + i] =
                                        (uint32_t)(cwd & 1) << 31
                                        | 3u << (p - 2);
                                    cwd >>= 1;
                                    ++cnt;
                                }
                        }
                    }
                    fwd_skip(&sp, (int)cnt);
                }
                new_sig |= cs;
                prev_row[g] = (uint16_t)new_sig;
                t = new_sig;
                new_sig |= (t & 0x7777) << 1 | (t & 0xeeee) >> 1;
                prev = (new_sig | u) & 0xf000;
            }
        }
    }
}

/* one HT code block into t->data (mb: the band's Mb).  OpenJPEG checks
 * the first 1-4 bytes of the MEL segment, as many as reach a multiple of
 * 4 in memory: its buffers are aligned, and a block of one segment is
 * read where it lies in the tile's data (cb->align), one of more from a
 * copy. */
static int ht_decode(j2k *d, const cblk_t *cb, const tccp_t *tccp,
                     int32_t mb, t1_t *t)
{
    uint32_t w = (uint32_t)(cb->x1 - cb->x0), h = (uint32_t)(cb->y1 - cb->y0);
    uint32_t passes = 0, len1 = 0, len2 = 0, p, zb, lcup, scup, mmsbp2;
    uint32_t qw = (w + 1) / 2, qh = (h + 1) / 2, qs = qw + 4, mstr;
    uint32_t *dec = (uint32_t *)t->data, x, y, i;
    uint16_t *inf = NULL, *uq = NULL, *sigma = NULL;
    uint32_t *vrow = NULL;
    const uint8_t *seg = cb->data;
    rev_t vlc;
    fwd_t ms;
    mel_t mel;
    int status = J2K_OK;
    memset(t->data, 0, (size_t)w * h * sizeof(int32_t));
    if (!cb->numsegs || !cb->nchunks)
        return J2K_OK;
    passes = cb->segs[0].numpasses;
    len1 = cb->segs[0].len;
    if (cb->numsegs > 1) {
        passes += cb->segs[1].numpasses;
        len2 = passes > 1 ? cb->segs[1].len : 0;
    }
    if (passes > 1 && !len2)
        passes = 1;
    if (passes > 3)
        return fail(d, J2K_CORRUPT, "We do not support more than 3 coding "
                    "passes in an HT codeblock; This codeblocks has %u "
                    "passes.", passes);
    if (tccp->roishift)
        return fail(d, J2K_CORRUPT, "We do not support ROI in decoding HT "
                    "codeblocks");
    if ((uint32_t)mb > 30)  /* OpenJPEG's Mb is unsigned */
        return fail(d, J2K_CORRUPT, "32 bits are not enough to decode this "
                    "codeblock, since the number of bitplane, %d, is larger "
                    "than 30.", mb);
    zb = (uint32_t)mb + 1u - cb->numbps;
    if (zb > (uint32_t)mb)
        return fail(d, J2K_CORRUPT, "Malformed HT codeblock. Decoding this "
                    "codeblock is stopped. There are %u zero bitplanes in "
                    "%d bitplanes.", zb, mb);
    if (zb == (uint32_t)mb && passes > 1)
        passes = 1;
    p = cb->numbps;
    mmsbp2 = zb + 1;
    if (len1 < 2 || len1 > cb->dlen || (uint64_t)len1 + len2 > cb->dlen)
        return fail(d, J2K_CORRUPT, "Malformed HT codeblock. Invalid "
                    "codeblock length values.");
    lcup = len1;
    scup = ((uint32_t)seg[lcup - 1] << 4) + (seg[lcup - 2] & 0xf);
    if (scup < 2 || scup > lcup || scup > 4079)
        return fail(d, J2K_CORRUPT, "Malformed HT codeblock. One of the "
                    "following condition is not met: 2 <= Scup <= min(Lcup, "
                    "4079)");
    {  /* mel_init's check of its first 1-4 bytes */
        uint32_t al = cb->nchunks == 1 ? cb->align : 0;  /* else copied */
        uint32_t pos = lcup - scup, num = 4 - ((al + lcup - scup) & 3);
        int64_t size = (int64_t)scup - 1;
        int unstuff = 0;
        for (i = 0; i < num; ++i) {
            uint32_t v;
            if (unstuff && seg[pos] > 0x8f)
                return fail(d, J2K_CORRUPT, "Malformed HT codeblock. "
                            "Incorrect MEL segment sequence.");
            v = size > 0 ? seg[pos] : 0xff;
            if (size == 1)
                v |= 0xf;
            if (size-- > 0)
                pos++;
            unstuff = (v & 0xff) == 0xff;
        }
    }
    memset(&mel, 0, sizeof mel);
    mel.p = seg + lcup - scup;
    mel.left = (int64_t)scup - 1;
    {  /* the VLC's first byte holds 3 or 4 bits, above Scup's nibble */
        uint32_t d0 = seg[lcup - 2];
        vlc.left = (int64_t)scup - 2;
        vlc.p = vlc.left ? seg + lcup - 3 : seg;
        vlc.acc = d0 >> 4;
        vlc.nb = 4 - ((d0 >> 4 & 7) == 7);
        vlc.unstuff = (d0 | 0xf) > 0x8f;
    }
    fwd_init(&ms, seg, (int64_t)lcup - scup, 0xff);
    inf = calloc((size_t)qs * (qh + 1), sizeof(uint16_t));
    uq = calloc((size_t)qs * (qh + 1), sizeof(uint16_t));
    vrow = calloc((size_t)qw + 4, sizeof(uint32_t));
    mstr = ((w + 3) / 4 + 2 + 7) & ~7u;
    sigma = calloc((size_t)mstr * ((h + 3) / 4 + 1), sizeof(uint16_t));
    if (!inf || !uq || !vrow || !sigma) {
        status = fail(d, J2K_NOMEM, "out of memory");
        goto done;
    }
    /* the VLC, MEL and UVLC of every quad */
    for (y = 0; y < qh; ++y) {
        const uint16_t *tbl = y ? vlc_tbl1 : vlc_tbl0;
        uint16_t *row = inf + (size_t)y * qs, *up = y ? row - qs : row;
        uint32_t q;
        for (q = 0; q < qw; q += 2) {
            uint32_t c, t0, t1 = 0, u0, u1, uoff;
            int melev = -1;
            if (!y)
                c = q ? (row[q - 1] & 0x10) << 3 | (row[q - 1] & 0xe0) << 2
                    : 0;
            else
                c = (q ? (up[q - 1] & 0x80) | (row[q - 1] & 0x40) << 2
                     | (row[q - 1] & 0x80) << 1 : 0)
                    | (up[q] & 0xa0) << 2 | (up[q + 1] & 0x20) << 4;
            t0 = tbl[c + (rev_peek(&vlc) & 0x7f)];
            if (!c && !mel_event(&mel))
                t0 = 0;
            rev_skip(&vlc, (int)(t0 & 7));
            row[q] = (uint16_t)t0;
            if (q + 1 < qw) {
                if (!y)
                    c = (t0 & 0x10) << 3 | (t0 & 0xe0) << 2;
                else
                    c = (t0 & 0x40) << 2 | (t0 & 0x80) << 1 | (up[q] & 0x80)
                        | (up[q + 1] & 0xa0) << 2 | (up[q + 2] & 0x20) << 4;
                t1 = tbl[c + (rev_peek(&vlc) & 0x7f)];
                if (!c && !mel_event(&mel))
                    t1 = 0;
                rev_skip(&vlc, (int)(t1 & 7));
                row[q + 1] = (uint16_t)t1;
            }
            uoff = (t0 >> 3 & 1) | (t1 >> 3 & 1) << 1;
            if (!y && uoff == 3)
                melev = mel_event(&mel);
            /* rho of a sample past the block's right or bottom edge */
            if ((2 * q + 1 >= w && (t0 & 0xc0))
                || (q + 1 < qw && 2 * q + 3 >= w && (t1 & 0xc0))
                || (2 * y + 1 >= h && ((t0 | t1) & 0xa0))) {
                status = fail(d, J2K_CORRUPT, "Malformed HT codeblock. VLC "
                              "code produces significant samples outside "
                              "the codeblock area.");
                goto done;
            }
            uvlc_pair(&vlc, (int)uoff, melev, &u0, &u1);
            /* the initial line pair's kappa is 1 */
            uq[(size_t)y * qs + q] = (uint16_t)(u0 + !y);
            uq[(size_t)y * qs + q + 1] = (uint16_t)(u1 + !y);
        }
    }
    /* MagSgn, quad after quad; vrow: the bottom samples' v ORed in pairs
     * (column 2k - 1 with column 2k), for the next line pair's kappa */
    for (y = 0; y < qh; ++y) {
        const uint16_t *row = inf + (size_t)y * qs;
        uint32_t q, prev_v = 0;
        for (q = 0; q < qw; ++q) {
            uint32_t qi = row[q], U = uq[(size_t)y * qs + q], n;
            uint32_t vb[4] = {0, 0, 0, 0};
            if (y) {
                uint32_t gamma = qi & 0xf0, emax = vrow[q] | vrow[q + 1] | 2;
                int e = 31;
                gamma &= gamma - 0x10;
                while (!(emax >> e))
                    --e;
                U += gamma ? (uint32_t)e : 1u;
            }
            if (U > mmsbp2) {
                status = fail(d, J2K_CORRUPT, "Malformed HT codeblock. "
                              "Decoding this codeblock is stopped. U_q is "
                              "larger than zero bitplanes + 1");
                goto done;
            }
            for (n = 0; n < 4; ++n)  /* rho is 0 outside the block */
                if (qi & (0x10u << n)) {
                    uint32_t m = U - (qi >> (12 + n) & 1), msv = fwd_peek(&ms);
                    uint32_t v = m ? msv & (uint32_t)((1ull << m) - 1) : 0;
                    fwd_skip(&ms, (int)m);
                    v |= (qi >> (8 + n) & 1) << m;
                    v |= 1;
                    vb[n] = v;
                    dec[(2 * y + (n & 1)) * w + 2 * q + (n >> 1)] =
                        msv << 31 | (v + 2) << (p - 1);
                }
            vrow[q] = prev_v | vb[1];
            prev_v = vb[3];
        }
        vrow[qw] = prev_v;
        vrow[qw + 1] = 0;
    }
    if (passes > 1) {
        /* the cleanup's significance, a nibble per column of 4 rows */
        for (y = 0; y < qh; ++y)
            for (x = 0; x < qw; ++x) {
                uint32_t r = inf[(size_t)y * qs + x] >> 4 & 0xf;
                uint32_t col = 2 * x, sh = (2 * y) & 3;
                uint16_t *g = sigma + (size_t)(y >> 1) * mstr + (col >> 2);
                *g |= (uint16_t)(((r & 1) | (r & 2)) << (4 * (col & 3) + sh));
                *g |= (uint16_t)((((r >> 2) & 1) | ((r >> 2) & 2))
                                 << (4 * ((col + 1) & 3) + sh));
            }
        ht_refine(dec, w, h, sigma, mstr, p, (int)passes,
                  (tccp->cblksty & CBLK_VSC) != 0, seg, len1, len2);
    }
    for (i = 0; i < w * h; ++i) {  /* sign and magnitude -> signed */
        uint32_t v = dec[i];
        t->data[i] = (v & 0x80000000u) ? -(int32_t)(v & 0x7fffffffu)
            : (int32_t)v;
    }
done:
    free(inf);
    free(uq);
    free(vrow);
    free(sigma);
    return status;
}

/* ------------------------------------------------------------------ */
/* inverse wavelets (opj_dwt_decode, opj_dwt_decode_real) */

/* the 5/3 lifting of one line: in holds the sn low then dn high
 * coefficients, out gets the samples; cas is the parity of the first */
static void idwt53_line(const int32_t *in, int32_t *out, int32_t sn,
                        int32_t dn, int cas)
{
    int32_t n = sn + dn, i;
    const int32_t *lo = in, *hi = in + sn;
    if (n == 1) {
        out[0] = cas ? in[0] / 2 : in[0];
        return;
    }
    if (!cas) {
        /* even samples X(2i) = s_i - ((d_{i-1} + d_i + 2) >> 2) */
        for (i = 0; i < sn; ++i) {
            int32_t dl = hi[i - 1 < 0 ? 0 : i - 1];
            int32_t dr = hi[i < dn ? i : dn - 1];
            out[2 * i] = (int32_t)((uint32_t)lo[i]
                                   - (uint32_t)(((int64_t)dl + dr + 2) >> 2));
        }
        for (i = 0; i < dn; ++i) {
            int32_t sl = out[2 * i];
            int32_t sr = 2 * i + 2 < n ? out[2 * i + 2] : out[2 * i];
            out[2 * i + 1] = (int32_t)((uint32_t)hi[i]
                                       + (uint32_t)(((int64_t)sl + sr) >> 1));
        }
    } else {
        /* the first sample is a high-pass one: X(2i+1) from s_i */
        for (i = 0; i < sn; ++i) {
            int32_t dl = hi[i];
            int32_t dr = hi[i + 1 < dn ? i + 1 : dn - 1];
            int32_t u = (int32_t)(((int64_t)dl + dr + 2) >> 2);
            out[2 * i + 1] = (int32_t)((uint32_t)lo[i] - (uint32_t)u);
        }
        for (i = 0; i < dn; ++i) {
            int32_t sl = 2 * i - 1 >= 0 ? out[2 * i - 1] : out[2 * i + 1];
            int32_t sr = 2 * i + 1 < n ? out[2 * i + 1] : out[2 * i - 1];
            out[2 * i] = (int32_t)((uint32_t)hi[i]
                                   + (uint32_t)(((int64_t)sl + sr) >> 1));
        }
    }
}

static const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f,
    DWT_GAMMA = 0.882911075f, DWT_DELTA = 0.443506852f,
    DWT_K = 1.230174105f, DWT_TWO_INVK = 1.625732422f;

/* one lifting step of opj_v8dwt_decode_step2 over the interleaved line w
 * of n samples: each sample of parity par gets (left + right) * c, the
 * neighbour past an end mirrored (2c times the one neighbour) */
static void lift97(float *w, int32_t n, int par, float c)
{
    int32_t i;
    for (i = par; i < n; i += 2) {
        if (i - 1 >= 0 && i + 1 < n) {
            float t = w[i - 1] + w[i + 1];
            t = t * c;
            w[i] = w[i] + t;
        } else if (i - 1 >= 0 || i + 1 < n) {
            float c2 = c + c;
            float t = (i - 1 >= 0 ? w[i - 1] : w[i + 1]) * c2;
            w[i] = w[i] + t;
        }
    }
}

static void idwt97_line(const float *in, float *w, int32_t sn, int32_t dn,
                        int cas)
{
    int32_t n = sn + dn, i;
    int a = cas, b = !cas;
    for (i = 0; i < sn; ++i)
        w[2 * i + a] = in[i];
    for (i = 0; i < dn; ++i)
        w[2 * i + b] = in[sn + i];
    if (!cas ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1))
        return;
    for (i = a; i < n; i += 2)
        w[i] = w[i] * DWT_K;
    for (i = b; i < n; i += 2)
        w[i] = w[i] * DWT_TWO_INVK;
    lift97(w, n, a, -DWT_DELTA);
    lift97(w, n, b, -DWT_GAMMA);
    lift97(w, n, a, -DWT_BETA);
    lift97(w, n, b, -DWT_ALPHA);
}

static int idwt(tilec_t *tc, int real)
{
    uint32_t r;
    int32_t stride = tc->x1 - tc->x0;
    size_t longest = 0;
    int32_t *buf, *line;
    for (r = 0; r < tc->numres; ++r) {
        size_t w = (size_t)(tc->res[r].x1 - tc->res[r].x0);
        size_t h = (size_t)(tc->res[r].y1 - tc->res[r].y0);
        if (w > longest)
            longest = w;
        if (h > longest)
            longest = h;
    }
    buf = malloc(2 * (longest + 1) * sizeof(int32_t));
    if (!buf)
        return -1;
    line = buf + longest + 1;
    for (r = 1; r < tc->numres; ++r) {
        res_t *lo = &tc->res[r - 1], *rs = &tc->res[r];
        int32_t rw = rs->x1 - rs->x0, rh = rs->y1 - rs->y0;
        int32_t sw = lo->x1 - lo->x0, sh = lo->y1 - lo->y0;
        int32_t i, j;
        int cash = rs->x0 & 1, casv = rs->y0 & 1;
        for (j = 0; j < rh; ++j) {
            int32_t *row = tc->data + (size_t)j * stride;
            memcpy(line, row, (size_t)rw * sizeof(int32_t));
            if (real)
                idwt97_line((float *)line, (float *)row, sw, rw - sw, cash);
            else if (rw)
                idwt53_line(line, row, sw, rw - sw, cash);
        }
        for (i = 0; i < rw; ++i) {
            for (j = 0; j < rh; ++j)
                line[j] = tc->data[(size_t)j * stride + i];
            if (real)
                idwt97_line((float *)line, (float *)buf, sh, rh - sh, casv);
            else if (rh)
                idwt53_line(line, buf, sh, rh - sh, casv);
            for (j = 0; j < rh; ++j)
                tc->data[(size_t)j * stride + i] = buf[j];
        }
    }
    free(buf);
    return 0;
}

/* ------------------------------------------------------------------ */
/* a tile */

static void tile_free(tile_t *T)
{
    uint32_t c, r, b, p, k;
    if (!T->comps)
        return;
    for (c = 0; c < T->d->ncomp; ++c) {
        tilec_t *tc = &T->comps[c];
        for (r = 0; tc->res && r < tc->numres; ++r)
            for (b = 0; b < tc->res[r].numbands; ++b) {
                band_t *band = &tc->res[r].bands[b];
                for (p = 0; band->prcs && p < tc->res[r].pw * tc->res[r].ph;
                     ++p) {
                    prc_t *prc = &band->prcs[p];
                    for (k = 0; prc->cblks && k < prc->cw * prc->ch; ++k) {
                        free(prc->cblks[k].segs);
                        free(prc->cblks[k].data);
                    }
                    free(prc->cblks);
                    tgt_free(&prc->incl);
                    tgt_free(&prc->imsb);
                }
                free(band->prcs);
            }
        free(tc->res);
        free(tc->data);
    }
    free(T->comps);
    T->comps = NULL;
}

/* opj_tcd_init_tile: resolutions, bands, precincts and code blocks */
static int tile_init(tile_t *T, uint32_t tileno)
{
    j2k *d = T->d;
    uint32_t p = tileno % d->tw, q = tileno / d->tw, c;
    uint64_t v;
    v = (uint64_t)d->tx0 + (uint64_t)p * d->tdx;
    T->tx0 = v > d->x0 ? (uint32_t)v : d->x0;
    v = (uint64_t)d->ty0 + (uint64_t)q * d->tdy;
    T->ty0 = v > d->y0 ? (uint32_t)v : d->y0;
    v = (uint64_t)d->tx0 + (uint64_t)(p + 1) * d->tdx;
    T->tx1 = v < d->x1 ? (uint32_t)v : d->x1;
    v = (uint64_t)d->ty0 + (uint64_t)(q + 1) * d->tdy;
    T->ty1 = v < d->y1 ? (uint32_t)v : d->y1;
    T->comps = calloc(d->ncomp, sizeof(tilec_t));
    if (!T->comps)
        return fail(d, J2K_NOMEM, "out of memory");
    for (c = 0; c < d->ncomp; ++c) {
        tilec_t *tc = &T->comps[c];
        tccp_t *tccp = &T->tcp->tccps[c];
        uint32_t r;
        size_t area;
        tc->x0 = (int32_t)ceildiv(T->tx0, d->cdx[c]);
        tc->y0 = (int32_t)ceildiv(T->ty0, d->cdy[c]);
        tc->x1 = (int32_t)ceildiv(T->tx1, d->cdx[c]);
        tc->y1 = (int32_t)ceildiv(T->ty1, d->cdy[c]);
        tc->numres = tccp->numres;
        area = (size_t)(tc->x1 - tc->x0) * (size_t)(tc->y1 - tc->y0);
        tc->data = calloc(area ? area : 1, sizeof(int32_t));
        tc->res = calloc(tc->numres, sizeof(res_t));
        if (!tc->data || !tc->res)
            return fail(d, J2K_NOMEM, "out of memory");
        for (r = 0; r < tc->numres; ++r) {
            res_t *rs = &tc->res[r];
            uint32_t level = tc->numres - 1 - r, b;
            int32_t px0, py0, px1, py1, cbgx0, cbgy0;
            uint32_t cbgw, cbgh, cbw, cbh;
            rs->x0 = ceildivpow2(tc->x0, (int)level);
            rs->y0 = ceildivpow2(tc->y0, (int)level);
            rs->x1 = ceildivpow2(tc->x1, (int)level);
            rs->y1 = ceildivpow2(tc->y1, (int)level);
            rs->pdx = tccp->prcw[r];
            rs->pdy = tccp->prch[r];
            px0 = floordivpow2(rs->x0, (int)rs->pdx) << rs->pdx;
            py0 = floordivpow2(rs->y0, (int)rs->pdy) << rs->pdy;
            px1 = ceildivpow2(rs->x1, (int)rs->pdx) << rs->pdx;
            py1 = ceildivpow2(rs->y1, (int)rs->pdy) << rs->pdy;
            rs->pw = rs->x0 == rs->x1 ? 0 : (uint32_t)((px1 - px0) >> rs->pdx);
            rs->ph = rs->y0 == rs->y1 ? 0 : (uint32_t)((py1 - py0) >> rs->pdy);
            if ((uint64_t)rs->pw * rs->ph > (1u << 28))
                return fail(d, J2K_CORRUPT, "too many precincts");
            if (r == 0) {
                cbgx0 = px0;
                cbgy0 = py0;
                cbgw = rs->pdx;
                cbgh = rs->pdy;
                rs->numbands = 1;
            } else {
                cbgx0 = ceildivpow2(px0, 1);
                cbgy0 = ceildivpow2(py0, 1);
                cbgw = rs->pdx - 1;
                cbgh = rs->pdy - 1;
                rs->numbands = 3;
            }
            cbw = tccp->cbw < cbgw ? tccp->cbw : cbgw;
            cbh = tccp->cbh < cbgh ? tccp->cbh : cbgh;
            for (b = 0; b < rs->numbands; ++b) {
                band_t *band = &rs->bands[b];
                const stepsize *ss;
                uint32_t k, np = rs->pw * rs->ph;
                double step;
                if (r == 0) {
                    band->bandno = 0;
                    band->x0 = ceildivpow2(tc->x0, (int)level);
                    band->y0 = ceildivpow2(tc->y0, (int)level);
                    band->x1 = ceildivpow2(tc->x1, (int)level);
                    band->y1 = ceildivpow2(tc->y1, (int)level);
                    ss = &tccp->steps[0];
                } else {
                    int64_t xob, yob;
                    band->bandno = b + 1;
                    xob = band->bandno & 1;
                    yob = band->bandno >> 1;
                    band->x0 = ceildivpow2(tc->x0 - (xob << level),
                                           (int)level + 1);
                    band->y0 = ceildivpow2(tc->y0 - (yob << level),
                                           (int)level + 1);
                    band->x1 = ceildivpow2(tc->x1 - (xob << level),
                                           (int)level + 1);
                    band->y1 = ceildivpow2(tc->y1 - (yob << level),
                                           (int)level + 1);
                    ss = &tccp->steps[3 * (r - 1) + b + 1];
                }
                /* the 9/7 path's step: Rb = prec, no band gain (OpenJPEG
                 * scales the bands by 2/K instead); unused on 5/3 */
                step = (1.0 + ss->mant / 2048.0)
                    * pow(2.0, (double)((int)d->prec[c] - ss->expn));
                band->stepsize = (float)step;
                band->numbps = ss->expn + (int)tccp->numgbits - 1;
                band->prcs = calloc(np ? np : 1, sizeof(prc_t));
                if (!band->prcs)
                    return fail(d, J2K_NOMEM, "out of memory");
                for (k = 0; k < np; ++k) {
                    prc_t *prc = &band->prcs[k];
                    int32_t sx = cbgx0 + (int32_t)(k % rs->pw) * (1 << cbgw);
                    int32_t sy = cbgy0 + (int32_t)(k / rs->pw) * (1 << cbgh);
                    int32_t ex = sx + (1 << cbgw), ey = sy + (1 << cbgh);
                    int32_t cx0, cy0, cx1, cy1;
                    uint32_t m, ncb;
                    prc->x0 = sx > band->x0 ? sx : band->x0;
                    prc->y0 = sy > band->y0 ? sy : band->y0;
                    prc->x1 = ex < band->x1 ? ex : band->x1;
                    prc->y1 = ey < band->y1 ? ey : band->y1;
                    cx0 = floordivpow2(prc->x0, (int)cbw) << cbw;
                    cy0 = floordivpow2(prc->y0, (int)cbh) << cbh;
                    cx1 = ceildivpow2(prc->x1, (int)cbw) << cbw;
                    cy1 = ceildivpow2(prc->y1, (int)cbh) << cbh;
                    if (cx1 < cx0 || cy1 < cy0)
                        return fail(d, J2K_CORRUPT, "a precinct outside its "
                                    "band");
                    prc->cw = (uint32_t)((cx1 - cx0) >> cbw);
                    prc->ch = (uint32_t)((cy1 - cy0) >> cbh);
                    if ((uint64_t)prc->cw * prc->ch > (1u << 24))
                        return fail(d, J2K_CORRUPT, "too many code blocks");
                    ncb = prc->cw * prc->ch;
                    prc->cblks = calloc(ncb ? ncb : 1, sizeof(cblk_t));
                    if (!prc->cblks || tgt_init(&prc->incl, prc->cw, prc->ch)
                        || tgt_init(&prc->imsb, prc->cw, prc->ch))
                        return fail(d, J2K_NOMEM, "out of memory");
                    for (m = 0; m < prc->cw * prc->ch; ++m) {
                        cblk_t *cb = &prc->cblks[m];
                        int32_t bx = cx0 + (int32_t)(m % prc->cw) * (1 << cbw);
                        int32_t by = cy0 + (int32_t)(m / prc->cw) * (1 << cbh);
                        cb->x0 = bx > prc->x0 ? bx : prc->x0;
                        cb->y0 = by > prc->y0 ? by : prc->y0;
                        cb->x1 = bx + (1 << cbw) < prc->x1 ? bx + (1 << cbw)
                            : prc->x1;
                        cb->y1 = by + (1 << cbh) < prc->y1 ? by + (1 << cbh)
                            : prc->y1;
                    }
                }
            }
        }
    }
    return J2K_OK;
}

/* the packets of the tile in its progression order: each progression
 * (COD's, or one per POC entry) takes the packets in its ranges that an
 * earlier one has not taken, in its own order */
static int tile_packets(tile_t *T, packet_t **out, size_t *count)
{
    j2k *d = T->d;
    tcp_t *tcp = T->tcp;
    size_t n = 0, k = 0, e;
    uint32_t c, r, p, l, maxres = 0, nprog = tcp->npoc ? tcp->npoc : 1;
    packet_t *pk;
    uint8_t *taken;
    for (c = 0; c < d->ncomp; ++c) {
        if (T->comps[c].numres > maxres)
            maxres = T->comps[c].numres;
        for (r = 0; r < T->comps[c].numres; ++r)
            n += (size_t)T->comps[c].res[r].pw * T->comps[c].res[r].ph;
    }
    n *= tcp->numlayers;
    pk = malloc((n ? n : 1) * sizeof(packet_t));
    taken = calloc(n ? n : 1, 1);
    if (!pk || !taken) {
        free(pk);
        free(taken);
        return fail(d, J2K_NOMEM, "out of memory");
    }
    for (e = 0; e < nprog; ++e) {
        poc_t all = {0, 0, 0, 0, 0, 0}, *q = &all;
        size_t idx = 0, start = k;
        if (tcp->npoc)
            q = &tcp->pocs[e];
        else {
            all.layno1 = tcp->numlayers;
            all.resno1 = maxres;
            all.compno1 = d->ncomp;
            all.prg = tcp->prg;
        }
        if (q->prg > 4)  /* an unknown order: no packet */
            continue;
        for (c = 0; c < d->ncomp; ++c)
            for (r = 0; r < T->comps[c].numres; ++r) {
                res_t *rs = &T->comps[c].res[r];
                uint32_t level = T->comps[c].numres - 1 - r;
                for (p = 0; p < rs->pw * rs->ph; ++p) {
                    /* the precinct's corner on the reference grid, where
                     * the position-driven orders meet it */
                    uint64_t py = ((uint64_t)(floordivpow2(rs->y0,
                                                           (int)rs->pdy)
                                              + (int32_t)(p / rs->pw))
                                   << rs->pdy) << level;
                    uint64_t px = ((uint64_t)(floordivpow2(rs->x0,
                                                           (int)rs->pdx)
                                              + (int32_t)(p % rs->pw))
                                   << rs->pdx) << level;
                    py *= d->cdy[c];
                    px *= d->cdx[c];
                    if (py < T->ty0)
                        py = T->ty0;
                    if (px < T->tx0)
                        px = T->tx0;
                    for (l = 0; l < tcp->numlayers; ++l, ++idx) {
                        packet_t *o;
                        if (taken[idx] || l >= q->layno1 || r < q->resno0
                            || r >= q->resno1 || c < q->compno0
                            || c >= q->compno1)
                            continue;
                        taken[idx] = 1;
                        o = &pk[k++];
                        o->l = l;
                        o->r = r;
                        o->c = c;
                        o->p = p;
                        packet_key(o, q->prg, py, px);
                    }
                }
            }
        qsort(pk + start, k - start, sizeof(packet_t), packet_cmp);
    }
    free(taken);
    *out = pk;
    *count = k;
    return J2K_OK;
}

static int tile_decode(j2k *d, uint32_t tileno)
{
    tile_t T;
    tcp_t *tcp = &d->tcps[tileno];
    packet_t *pk = NULL;
    size_t npk = 0, k, pos = 0, ppt_pos = 0;
    uint32_t c;
    t1_t t1;
    hsrc_t hs, *hsp = NULL;
    uint8_t *ppt = NULL;
    memset(&T, 0, sizeof T);
    memset(&t1, 0, sizeof t1);
    T.d = d;
    T.tcp = tcp;
    if (tile_init(&T, tileno) || tile_packets(&T, &pk, &npk))
        goto done;
    if (d->ppm.any) {
        hs.p = d->ppm_buf;
        hs.len = d->ppm_size;
        hs.pos = &d->ppm_pos;
        hsp = &hs;
    } else if (tcp->ppt) {
        ppt = merge_ppt(tcp->ppt, &hs.len);
        if (!ppt) {
            fail(d, J2K_NOMEM, "out of memory");
            goto done;
        }
        hs.p = ppt;
        hs.pos = &ppt_pos;
        hsp = &hs;
    }
    for (k = 0; k < npk; ++k)
        if (read_packet(&T, &pk[k], tcp->data, tcp->len, &pos, hsp))
            goto done;
    zc_init(t1.zc);
    t1.f = malloc((64 + 2) * (64 + 2) + 4096);
    t1.data = malloc(4096 * sizeof(int32_t));
    if (!t1.f || !t1.data) {
        fail(d, J2K_NOMEM, "out of memory");
        goto done;
    }
    for (c = 0; c < d->ncomp; ++c) {
        tilec_t *tc = &T.comps[c];
        tccp_t *tccp = &tcp->tccps[c];
        int32_t stride = tc->x1 - tc->x0;
        uint32_t r;
        for (r = 0; r < tc->numres; ++r) {
            res_t *rs = &tc->res[r];
            uint32_t b;
            for (b = 0; b < rs->numbands; ++b) {
                band_t *band = &rs->bands[b];
                uint32_t p;
                for (p = 0; p < rs->pw * rs->ph; ++p) {
                    prc_t *prc = &band->prcs[p];
                    uint32_t m;
                    for (m = 0; m < prc->cw * prc->ch; ++m) {
                        cblk_t *cb = &prc->cblks[m];
                        int32_t bw = cb->x1 - cb->x0, bh = cb->y1 - cb->y0;
                        int32_t x0 = cb->x0 - band->x0, y0 = cb->y0 - band->y0;
                        int32_t i, j;
                        if (bw <= 0 || bh <= 0)
                            continue;
                        if (band->bandno & 1)
                            x0 += tc->res[r - 1].x1 - tc->res[r - 1].x0;
                        if (band->bandno & 2)
                            y0 += tc->res[r - 1].y1 - tc->res[r - 1].y0;
                        if ((tccp->cblksty & CBLK_HT)
                            ? ht_decode(d, cb, tccp, band->numbps, &t1)
                            : t1_decode(d, cb, tccp, band->bandno, &t1))
                            goto done;
                        if (tccp->roishift) {
                            int32_t thresh;
                            if (tccp->roishift >= 31) {
                                fail(d, J2K_CORRUPT, "ROI shift %u",
                                     tccp->roishift);
                                goto done;
                            }
                            thresh = (int32_t)1 << tccp->roishift;
                            for (i = 0; i < bw * bh; ++i) {
                                int32_t val = t1.data[i];
                                int32_t mag = val < 0 ? -val : val;
                                if (mag >= thresh) {
                                    mag >>= tccp->roishift;
                                    t1.data[i] = val < 0 ? -mag : mag;
                                }
                            }
                        }
                        for (j = 0; j < bh; ++j) {
                            int32_t *dst = tc->data + (size_t)(y0 + j) * stride
                                + x0;
                            const int32_t *src = t1.data + (size_t)j * bw;
                            if (tccp->qmfbid == 1)
                                for (i = 0; i < bw; ++i)
                                    dst[i] = src[i] / 2;
                            else {
                                float step = 0.5f * band->stepsize;
                                for (i = 0; i < bw; ++i) {
                                    float v = (float)src[i] * step;
                                    memcpy(&dst[i], &v, sizeof v);
                                }
                            }
                        }
                    }
                }
            }
        }
        if (idwt(tc, tccp->qmfbid == 0)) {
            fail(d, J2K_NOMEM, "out of memory");
            goto done;
        }
    }
    /* the multiple component transform */
    if (tcp->mct && d->ncomp >= 3) {
        tilec_t *t0 = &T.comps[0];
        size_t n = (size_t)(t0->x1 - t0->x0) * (size_t)(t0->y1 - t0->y0), i;
        for (c = 1; c < 3; ++c)
            if (T.comps[c].numres != t0->numres
                || (size_t)(T.comps[c].x1 - T.comps[c].x0)
                * (size_t)(T.comps[c].y1 - T.comps[c].y0) != n) {
                fail(d, J2K_CORRUPT, "components of different sizes under "
                     "a multiple component transform");
                goto done;
            }
        if (tcp->tccps[0].qmfbid == 1) {
            int32_t *c0 = t0->data, *c1 = T.comps[1].data,
                *c2 = T.comps[2].data;
            for (i = 0; i < n; ++i) {
                int32_t y = c0[i], u = c1[i], v = c2[i];
                int32_t g = (int32_t)((uint32_t)y
                                      - (uint32_t)(((int64_t)u + v) >> 2));
                int32_t rr = (int32_t)((uint32_t)v + (uint32_t)g);
                int32_t bb = (int32_t)((uint32_t)u + (uint32_t)g);
                c0[i] = rr;
                c1[i] = g;
                c2[i] = bb;
            }
        } else {
            float *c0 = (float *)t0->data, *c1 = (float *)T.comps[1].data,
                *c2 = (float *)T.comps[2].data;
            for (i = 0; i < n; ++i) {
                float y = c0[i], u = c1[i], v = c2[i];
                float rr = y + (v * 1.402f);
                float g = y - (u * 0.34413f);
                float bb = y + (u * 1.772f);
                g = g - (v * 0.71414f);
                c0[i] = rr;
                c1[i] = g;
                c2[i] = bb;
            }
        }
    }
    /* DC level shift, clamp, into the image */
    for (c = 0; c < d->ncomp; ++c) {
        tilec_t *tc = &T.comps[c];
        int32_t w = tc->x1 - tc->x0, h = tc->y1 - tc->y0, i, j;
        int64_t lo, hi, shift;
        uint32_t W = ceildiv(d->x1, d->cdx[c]) - ceildiv(d->x0, d->cdx[c]);
        int32_t ox = tc->x0 - (int32_t)ceildiv(d->x0, d->cdx[c]);
        int32_t oy = tc->y0 - (int32_t)ceildiv(d->y0, d->cdy[c]);
        int32_t *plane = d->out;
        uint32_t k2;
        for (k2 = 0; k2 < c; ++k2)
            plane += (size_t)(ceildiv(d->x1, d->cdx[k2])
                              - ceildiv(d->x0, d->cdx[k2]))
                * (ceildiv(d->y1, d->cdy[k2]) - ceildiv(d->y0, d->cdy[k2]));
        if (d->sgnd[c]) {
            lo = -((int64_t)1 << (d->prec[c] - 1));
            hi = ((int64_t)1 << (d->prec[c] - 1)) - 1;
            shift = 0;
        } else {
            lo = 0;
            hi = ((int64_t)1 << d->prec[c]) - 1;
            shift = (int64_t)1 << (d->prec[c] - 1);
        }
        for (j = 0; j < h; ++j)
            for (i = 0; i < w; ++i) {
                int32_t *src = tc->data + (size_t)j * w + i;
                int64_t v;
                if (tcp->tccps[c].qmfbid == 1)
                    v = (int64_t)(int32_t)((uint32_t)*src + (uint32_t)shift);
                else {
                    float f;
                    memcpy(&f, src, sizeof f);
                    if (f > (float)INT_MAX)
                        v = hi;
                    else if (f < INT_MIN)
                        v = lo;
                    else
                        v = (int64_t)lrintf(f) + shift;
                }
                v = v < lo ? lo : v > hi ? hi : v;
                plane[(size_t)(oy + j) * W + (size_t)(ox + i)] = (int32_t)v;
            }
        d->comp_done[c] = 1;
    }
done:
    free(ppt);
    free(t1.f);
    free(t1.data);
    free(pk);
    tile_free(&T);
    free(tcp->data);
    tcp->data = NULL;
    tcp->len = tcp->cap = 0;
    tcp->pending = 0;
    return d->status;
}

/* ------------------------------------------------------------------ */
/* tile-parts */

static int read_sot(j2k *d, const uint8_t *s, size_t len, uint32_t *psot)
{
    uint32_t tileno, part, nparts;
    tcp_t *tcp;
    if (len != 8)
        return fail(d, J2K_CORRUPT, "Error reading SOT marker");
    tileno = rd16(s);
    *psot = rd32(s + 2);
    part = s[6];
    nparts = s[7];
    if (tileno >= d->tw * d->th)
        return fail(d, J2K_CORRUPT, "Invalid tile number %u", tileno);
    tcp = &d->tcps[tileno];
    if ((int)part != tcp->part + 1)
        return fail(d, J2K_CORRUPT, "tile %u: tile-part %u, expected %d",
                    tileno, part, tcp->part + 1);
    tcp->part = (int)part;
    if (*psot && *psot < 14 && *psot != 12)
        return fail(d, J2K_CORRUPT, "Psot %u", *psot);
    if (!*psot)
        d->last_part = 1;
    if (tcp->nparts && part >= tcp->nparts)
        return fail(d, J2K_CORRUPT, "TPsot %u of %u tile-parts", part,
                    tcp->nparts);
    if (nparts) {
        if (part >= nparts)
            return fail(d, J2K_CORRUPT, "TPsot %u of %u tile-parts", part,
                        nparts);
        tcp->nparts = nparts;
    }
    d->cur_tile = tileno;
    d->state = ST_TPH;
    return J2K_OK;
}

/* the bytes after SOD: this tile-part's share of its tile's data */
static int read_sod(j2k *d, size_t sot_length)
{
    tcp_t *tcp = &d->tcps[d->cur_tile];
    size_t left = d->n - d->pos;
    if (d->last_part) {
        if (left < 2)
            return fail(d, J2K_CORRUPT, "Stream too short");
        sot_length = left - 2;
    } else if (sot_length >= 2)
        sot_length -= 2;
    if (sot_length) {
        if (sot_length > left)
            return fail(d, J2K_CORRUPT, "Tile part length size inconsistent "
                        "with stream length");
        if (tcp->len + sot_length > tcp->cap) {
            size_t cap = tcp->len + sot_length;
            uint8_t *p = realloc(tcp->data, cap);
            if (!p)
                return fail(d, J2K_NOMEM, "out of memory");
            tcp->data = p;
            tcp->cap = cap;
        }
        memcpy(tcp->data + tcp->len, d->p + d->pos, sot_length);
        tcp->len += sot_length;
        d->pos += sot_length;
        tcp->pending = 1;
    }
    d->state = ST_TPHSOT;
    return J2K_OK;
}

static int decode_tiles(j2k *d)
{
    uint32_t ntiles = d->tw * d->th, t, m, decoded = 0, first = 0;
    d->tcps = calloc(ntiles, sizeof(tcp_t));
    if (!d->tcps)
        return fail(d, J2K_NOMEM, "out of memory");
    for (t = 0; t < ntiles; ++t) {
        d->tcps[t].tccps = calloc(d->ncomp, sizeof(tccp_t));
        if (!d->tcps[t].tccps)
            return fail(d, J2K_NOMEM, "out of memory");
        tcp_copy(d, &d->tcps[t], &d->def);
    }
    d->comp_done = calloc(d->ncomp, sizeof(int));
    if (!d->comp_done)
        return fail(d, J2K_NOMEM, "out of memory");
    m = M_SOT;  /* read_main_header stopped past an SOT marker */
    for (;;) {
        uint32_t psot = 0;
        size_t sot_length = 0;
        int can_decode;
        tcp_t *tcp;
        if (m == M_EOC)
            break;
        /* a tile-part header: SOT, marker segments, SOD */
        while (m != M_SOD) {
            size_t len;
            int st;
            if (d->pos == d->n) {
                /* the data ends after a marker: OpenJPEG decodes the first
                 * tile from this one on that has data, and stops */
                for (t = d->cur_tile; t < ntiles; ++t)
                    if (d->tcps[t].pending) {
                        if (tile_decode(d, t))
                            return d->status;
                        break;
                    }
                goto check;
            }
            if (d->pos + 2 > d->n)
                return fail(d, J2K_CORRUPT, "Stream too short");
            len = rd16(d->p + d->pos);
            if (len < 2)
                return fail(d, J2K_CORRUPT, "Inconsistent marker size");
            if (d->state == ST_TPH && sot_length) {
                if (sot_length < len + 2)
                    return fail(d, J2K_CORRUPT, "Sot length is invalid");
                sot_length -= len + 2;
            }
            st = marker_states(m);
            if (st < 0)
                st = ST_MH | ST_TPH;
            if (!(d->state & st))
                return fail(d, J2K_CORRUPT, "marker %04x out of place", m);
            d->pos += 2;
            len -= 2;
            if (len > d->n - d->pos)
                return fail(d, J2K_CORRUPT, "Marker size inconsistent with "
                            "stream length");
            if (m == M_SOT) {
                if (read_sot(d, d->p + d->pos, len, &psot))
                    return d->status;
                sot_length = d->last_part ? 0 : psot - 12;
            } else if (marker_states(m) < 0)
                return fail(d, J2K_CORRUPT, "unknown marker %04x in a "
                            "tile-part header", m);
            else if (read_segment(d, m, d->p + d->pos, len))
                return d->status;
            d->pos += len;
            if (d->pos + 2 > d->n)
                return fail(d, J2K_CORRUPT, "Stream too short");
            m = rd16(d->p + d->pos);
            d->pos += 2;
        }
        if (read_sod(d, sot_length))
            return d->status;
        tcp = &d->tcps[d->cur_tile];
        can_decode = tcp->nparts && (uint32_t)(tcp->part + 1) == tcp->nparts;
        if (can_decode) {
            if (!tcp->pending)
                return fail(d, J2K_CORRUPT, "tile %u holds no data",
                            d->cur_tile);
            if (tile_decode(d, d->cur_tile))
                return d->status;
            ++decoded;
        }
        /* the next marker: SOT or EOC */
        if (d->pos + 2 > d->n) {
            /* OpenJPEG's allowance for files whose last tile-parts have
             * TPsot == TNsot == 0 and whose EOC is missing */
            uint32_t k;
            if (!can_decode && d->cur_tile + 1 == ntiles) {
                for (k = 0; k < ntiles; ++k)
                    if (d->tcps[k].part == 0 && d->tcps[k].nparts == 0)
                        break;
                if (k < ntiles) {
                    first = k;
                    break;
                }
            }
            return fail(d, J2K_CORRUPT, "Stream too short");
        }
        m = rd16(d->p + d->pos);
        d->pos += 2;
        if (m != M_SOT && m != M_EOC) {
            if (can_decode && d->pos == d->n)
                goto check;  /* "Stream does not end with EOC" */
            if (can_decode)
                return fail(d, J2K_CORRUPT, "marker %04x where SOT or EOC "
                            "belongs", m);
        }
        if (decoded == ntiles)
            break;
    }
    /* at EOC: the tiles whose count of tile-parts was not given */
    for (t = first; t < ntiles; ++t)
        if (d->tcps[t].pending && tile_decode(d, t))
            return d->status;
check:
    for (t = 0; t < d->ncomp; ++t)
        if (!d->comp_done[t])
            return fail(d, J2K_CORRUPT, "Failed to decode all used "
                        "components");
    return J2K_OK;
}

static void j2k_free(j2k *d)
{
    uint32_t t;
    if (d->tcps) {
        for (t = 0; t < d->tw * d->th; ++t) {
            free(d->tcps[t].tccps);
            free(d->tcps[t].data);
            free(d->tcps[t].ppt);
        }
        free(d->tcps);
    }
    free(d->def.tccps);
    free(d->prec);
    free(d->sgnd);
    free(d->cdx);
    free(d->cdy);
    free(d->comp_done);
    free(d->ppm_buf);
}

/* info: x0, y0, x1, y1, ncomp, then per component (up to 4 are written)
 * precision, signedness, dx, dy; info[21]: the samples of all component
 * planes */
int j2k_header(const uint8_t *data, int64_t size, int64_t *info, char *err,
               int errlen)
{
    j2k d;
    uint32_t c;
    memset(&d, 0, sizeof d);
    d.p = data;
    d.n = (size_t)size;
    d.err = err;
    d.errlen = errlen;
    err[0] = 0;
    if (!read_main_header(&d)) {
        info[0] = d.x0;
        info[1] = d.y0;
        info[2] = d.x1;
        info[3] = d.y1;
        info[4] = d.ncomp;
        info[21] = 0;
        for (c = 0; c < d.ncomp; ++c) {
            if (c < 4) {
                info[5 + 4 * c] = d.prec[c];
                info[6 + 4 * c] = d.sgnd[c];
                info[7 + 4 * c] = d.cdx[c];
                info[8 + 4 * c] = d.cdy[c];
            }
            info[21] += (int64_t)(ceildiv(d.x1, d.cdx[c])
                                  - ceildiv(d.x0, d.cdx[c]))
                * (ceildiv(d.y1, d.cdy[c]) - ceildiv(d.y0, d.cdy[c]));
        }
    }
    j2k_free(&d);
    return d.status;
}

/* out: the component planes, each ceil(x1 / dx) - ceil(x0 / dx) wide */
int j2k_decode(const uint8_t *data, int64_t size, int32_t *out, char *err,
               int errlen)
{
    j2k d;
    memset(&d, 0, sizeof d);
    d.p = data;
    d.n = (size_t)size;
    d.err = err;
    d.errlen = errlen;
    d.out = out;
    err[0] = 0;
    if (!read_main_header(&d))
        decode_tiles(&d);
    j2k_free(&d);
    return d.status;
}
