/* The AV1 intra tile syntax of lossless frames, shared by the decoder
 * (av1_decode.c) and the fixture writer (av1_encode.c).
 *
 * One implementation of the block syntax serves both: each symbol goes
 * through sym(), which decodes it (libaom's od_ec decoder, 32-bit window)
 * or, in a writer, encodes the value the writer chose (libaom's od_ec
 * encoder); the CDFs adapt alike on both sides.  Reconstruction follows the
 * AV1 specification (section 7.11: every intra predictor, the edge filter
 * and upsampling, CfL, palette; 7.13: the inverse Walsh-Hadamard transform
 * of lossless blocks) over 16-bit planes of MiCols * 4 x MiRows * 4
 * samples.
 *
 * What a lossless key frame can hold and this file does not read raises
 * through av1_fail(ERR_NOTIMPL, ...): intra block copy and segmentation.
 * Errors unwind with longjmp to the entry point, which frees what the
 * frame allocated.
 */
#ifndef AV1_CORE_H
#define AV1_CORE_H

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "av1_tables.h"

enum { ERR_OK = 0, ERR_VALUE = 1, ERR_NOTIMPL = 2, ERR_MEMORY = 3 };

enum {
    DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
    D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
    PAETH_PRED, UV_CFL_PRED
};
enum {
    PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
    PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
    PARTITION_HORZ_4, PARTITION_VERT_4
};
enum { BLOCK_4X4 = 0, BLOCK_8X8 = 3, BLOCK_64X64 = 12, BLOCK_128X128 = 15 };

/* block sizes in the specification's order: width and height in 4 x 4
 * units, log2 */
static const uint8_t bw4_log2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4,
                                     4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
static const uint8_t bh4_log2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3,
                                     4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
static const uint8_t intra_mode_context[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3,
                                               0, 1, 2, 0};
static const uint8_t intra_edge_kernel[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

static int block_size(int wlog2, int hlog2)
{
    for (int b = 0; b < 22; b++)
        if (bw4_log2[b] == wlog2 && bh4_log2[b] == hlog2)
            return b;
    return -1;
}

typedef struct {
    uint16_t partition[20][11];
    uint16_t kf_y_mode[5][5][14];
    uint16_t uv_mode[2][13][15];
    uint16_t angle_delta[8][8];
    uint16_t cfl_sign[9];
    uint16_t cfl_alpha[6][17];
    uint16_t skip[3][3];
    uint16_t intrabc[3];
    uint16_t filter_intra[22][3];
    uint16_t filter_intra_mode[6];
    uint16_t palette_y_mode[7][3][3];
    uint16_t palette_uv_mode[2][3];
    uint16_t palette_y_size[7][8];
    uint16_t palette_uv_size[7][8];
    uint16_t palette_y_color[7][5][9];
    uint16_t palette_uv_color[7][5][9];
    uint16_t txb_skip[5][13][3];
    uint16_t eob_pt16[2][2][6];
    uint16_t eob_extra[5][2][9][3];
    uint16_t dc_sign[2][3][3];
    uint16_t coeff_base_eob[5][2][4][4];
    uint16_t coeff_base[5][2][42][5];
    uint16_t coeff_br[5][2][21][5];
    uint16_t mv[143];
} Cdfs;

static void cdfs_init(Cdfs *c, int qctx)
{
#define CP(dst, src) memcpy(c->dst, src, sizeof(c->dst))
    CP(partition, partition_cdf);
    CP(kf_y_mode, kf_y_mode_cdf);
    CP(uv_mode, uv_mode_cdf);
    CP(angle_delta, angle_delta_cdf);
    CP(cfl_sign, cfl_sign_cdf);
    CP(cfl_alpha, cfl_alpha_cdf);
    CP(skip, skip_cdf);
    CP(intrabc, intrabc_cdf);
    CP(filter_intra, filter_intra_cdf);
    CP(filter_intra_mode, filter_intra_mode_cdf);
    CP(palette_y_mode, palette_y_mode_cdf);
    CP(palette_uv_mode, palette_uv_mode_cdf);
    CP(palette_y_size, palette_y_size_cdf);
    CP(palette_uv_size, palette_uv_size_cdf);
    CP(palette_y_color, palette_y_color_cdf);
    CP(palette_uv_color, palette_uv_color_cdf);
    CP(txb_skip, txb_skip_cdf[qctx]);
    CP(eob_pt16, eob_pt16_cdf[qctx]);
    CP(eob_extra, eob_extra_cdf[qctx]);
    CP(dc_sign, dc_sign_cdf[qctx]);
    CP(coeff_base_eob, coeff_base_eob_cdf[qctx]);
    CP(coeff_base, coeff_base_cdf[qctx]);
    CP(coeff_br, coeff_br_cdf[qctx]);
    CP(mv, mv_cdf);
#undef CP
}

/* -- the entropy coder ---------------------------------------------------- */

typedef struct {
    int writing;
    /* decoder (od_ec_dec) */
    const uint8_t *buf, *bptr, *end;
    uint32_t dif, rng;
    int cnt;
    int64_t shifts; /* od_ec_dec_tell() less one */
    /* encoder (od_ec_enc) */
    uint16_t *pre;
    int64_t offs, cap;
    uint64_t low;
} Ec;

#define EC_WIN 32
#define EC_LOTS 0x4000

static int ilog_nz(uint32_t v)
{
    int n = 0;
    while (v) {
        n++;
        v >>= 1;
    }
    return n;
}

static void ec_refill(Ec *e)
{
    int s = EC_WIN - 9 - (e->cnt + 15);
    for (; s >= 0 && e->bptr < e->end; s -= 8, e->bptr++) {
        e->dif ^= (uint32_t)e->bptr[0] << s;
        e->cnt += 8;
    }
    if (e->bptr >= e->end)
        e->cnt = EC_LOTS;
}

static void ec_dec_init(Ec *e, const uint8_t *buf, int64_t n)
{
    memset(e, 0, sizeof(*e));
    e->buf = e->bptr = buf;
    e->end = buf + n;
    e->dif = ((uint32_t)1 << (EC_WIN - 1)) - 1;
    e->rng = 0x8000;
    e->cnt = -15;
    ec_refill(e);
}

static int ec_dec_normalize(Ec *e, uint32_t dif, uint32_t rng, int ret)
{
    int d = 16 - ilog_nz(rng);
    e->cnt -= d;
    e->shifts += d;
    e->dif = ((dif + 1) << d) - 1;
    e->rng = rng << d;
    if (e->cnt < 0)
        ec_refill(e);
    return ret;
}

/* a symbol of n from the specification-form cdf (icdf = 32768 - cdf) */
static int ec_decode(Ec *e, const uint16_t *cdf, int n)
{
    uint32_t dif = e->dif, r = e->rng, u, v = r;
    uint32_t c = dif >> (EC_WIN - 16);
    int ret = -1;
    do {
        u = v;
        ret++;
        v = ((r >> 8) * (uint32_t)((32768 - cdf[ret]) >> 6) >> 1)
            + 4 * (uint32_t)(n - 1 - ret);
    } while (c < v);
    return ec_dec_normalize(e, dif - (v << (EC_WIN - 16)), u - v, ret);
}

static void ec_enc_init(Ec *e, uint16_t *pre, int64_t cap)
{
    memset(e, 0, sizeof(*e));
    e->writing = 1;
    e->pre = pre;
    e->cap = cap;
    e->rng = 0x8000;
    e->cnt = -9;
}

static int ec_put(Ec *e, uint16_t v)
{
    if (e->offs >= e->cap)
        return 0;
    e->pre[e->offs++] = v;
    return 1;
}

/* od_ec_encode_q15 + od_ec_enc_normalize; returns 0 when the buffer is
 * full */
static int ec_encode(Ec *e, const uint16_t *cdf, int n, int s)
{
    uint64_t l = e->low;
    uint32_t r = e->rng;
    uint32_t fl = s > 0 ? 32768u - cdf[s - 1] : 32768u;
    uint32_t fh = 32768u - cdf[s];
    int N = n - 1;
    if (fl < 32768u) {
        uint32_t u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (uint32_t)(N - (s - 1));
        uint32_t v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (uint32_t)(N - s);
        l += r - u;
        r = u - v;
    } else {
        r -= ((r >> 8) * (fh >> 6) >> 1) + 4 * (uint32_t)(N - s);
    }
    int d = 16 - ilog_nz(r);
    int c = e->cnt;
    int sh = c + d;
    if (sh >= 0) {
        c += 16;
        uint64_t m = ((uint64_t)1 << c) - 1;
        if (sh >= 8) {
            if (!ec_put(e, (uint16_t)(l >> c)))
                return 0;
            l &= m;
            c -= 8;
            m >>= 8;
        }
        if (!ec_put(e, (uint16_t)(l >> c)))
            return 0;
        sh = c + d - 24;
        l &= m;
    }
    e->low = l << d;
    e->rng = r << d;
    e->cnt = sh;
    return 1;
}

/* od_ec_enc_done: the bytes of the tile, carries resolved; returns their
 * number, or -1 when out grows past cap */
static int64_t ec_enc_done(Ec *e, uint8_t *out, int64_t cap)
{
    uint64_t m = 0x3FFF;
    uint64_t l = e->low;
    int c = e->cnt;
    int s = 10 + c;
    uint64_t v = ((l + m) & ~m) | (m + 1);
    if (s > 0) {
        uint64_t n = ((uint64_t)1 << (c + 16)) - 1;
        do {
            if (!ec_put(e, (uint16_t)(v >> (c + 16))))
                return -1;
            v &= n;
            s -= 8;
            c -= 8;
            n >>= 8;
        } while (s > 0);
    }
    if (e->offs > cap)
        return -1;
    uint32_t carry = 0;
    for (int64_t k = e->offs - 1; k >= 0; k--) {
        carry += e->pre[k];
        out[k] = (uint8_t)carry;
        carry >>= 8;
    }
    return e->offs;
}

static void cdf_adapt(uint16_t *cdf, int n, int s)
{
    int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + (n >= 4 ? 2 : 1);
    int tmp = 0;
    for (int i = 0; i < n - 1; i++) {
        if (i == s)
            tmp = 32768;
        if (tmp < cdf[i])
            cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
        else
            cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
    }
    cdf[n] += (cdf[n] < 32);
}

/* -- the frame ------------------------------------------------------------ */

#define MAX_TILES 64

typedef struct Av1 Av1;

/* a writer's choices for one block (av1_encode.c) */
typedef struct {
    int ymode, uvmode, angle_y, angle_uv, filter_intra, filter_mode;
    int cfl_signs, cfl_u, cfl_v, skip;
} Choice;

struct Av1 {
    jmp_buf jb;
    char *err;
    int errlen;
    /* sequence header */
    int profile, still, reduced, bitdepth, mono, ssx, ssy;
    int cp, tc, mc, range, csp, separate_uv_delta_q;
    int use128, filter_intra_en, edge_filter_en, superres_en, cdef_en, lr_en;
    int film_grain_present, sct_force, intmv_force, frame_id_present;
    int frame_id_bits, order_hint_bits, width_bits, height_bits;
    int max_w, max_h, decoder_model_info, equal_picture_interval;
    int presentation_time_bits, removal_time_bits, op_count;
    int op_idc[32], op_model[32];
    int seq_seen;
    /* frame header */
    int W, H, MiCols, MiRows, nplanes;
    int sct, allow_intrabc, disable_cdf_update, reduced_tx_set, base_q;
    int tile_cols, tile_rows, tile_cols_log2, tile_rows_log2;
    int col_starts[MAX_TILES + 1], row_starts[MAX_TILES + 1];
    int tile_size_bytes, context_update_tile_id;
    int temporal_id, spatial_id;
    char unread[64]; /* the first tool of the frame not read, or "" */
    /* planes of MiCols * 4 x MiRows * 4 samples */
    uint16_t *plane[3];
    int stride, rows;
    /* per 4 x 4 (mode info) unit */
    uint8_t *mi_size, *ymodes, *uvmodes, *skips, *pal_sizes[2];
    uint8_t *is_inter, *written;
    uint16_t *pal_colors[2];
    int16_t *mvs; /* intra block copy vectors (row, col), 1/8 sample */
    /* contexts */
    uint8_t *above_level[3], *above_dc[3], *left_level[3], *left_dc[3];
    uint8_t decoded[3][34][34];
    Cdfs cdf, cdf0;
    Ec ec;
    /* the tile */
    int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
    /* the block */
    int mi_row, mi_col, mi_sz, bw4, bh4, has_chroma;
    int avail_u, avail_l;
    int skip, ymode, uvmode, angle_y, angle_uv, use_filter_intra;
    int filter_intra_mode, cfl_u, cfl_v, pal_y, pal_uv, use_intrabc;
    int mv_row, mv_col;
    uint16_t pal_y_colors[8], pal_u_colors[8], pal_v_colors[8];
    uint8_t map_y[64 * 64], map_uv[64 * 64];
    int max_luma_w, max_luma_h;
    int32_t quant[16];
    /* a writer: its source planes, its choice of each block's modes */
    const uint16_t *src[3];
    uint32_t enc_seed;
    Choice enc_choice;
};

static void av1_fail(Av1 *f, int code, const char *fmt, ...)
{
    if (f->err && f->errlen > 0) {
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(f->err, (size_t)f->errlen, fmt, ap);
        va_end(ap);
    }
    longjmp(f->jb, code);
}

static void *av1_alloc(Av1 *f, size_t n)
{
    void *p = calloc(n ? n : 1, 1);
    if (!p)
        av1_fail(f, ERR_MEMORY, "out of memory");
    return p;
}

/* a symbol: decoded, or in a writer the value v encoded; the cdf adapts */
static int sym(Av1 *f, uint16_t *cdf, int n, int v)
{
    if (f->ec.writing) {
        if (v < 0 || v >= n)
            av1_fail(f, ERR_VALUE, "writer: symbol %d of %d", v, n);
        if (!ec_encode(&f->ec, cdf, n, v))
            av1_fail(f, ERR_MEMORY, "writer: output buffer full");
    } else {
        v = ec_decode(&f->ec, cdf, n);
    }
    if (!f->disable_cdf_update)
        cdf_adapt(cdf, n, v);
    return v;
}

/* a symbol of a cdf that does not adapt (read_bool, split_or_horz) */
static int sym_fixed(Av1 *f, const uint16_t *cdf, int n, int v)
{
    if (f->ec.writing) {
        if (!ec_encode(&f->ec, cdf, n, v))
            av1_fail(f, ERR_MEMORY, "writer: output buffer full");
        return v;
    }
    return ec_decode(&f->ec, cdf, n);
}

static int lit(Av1 *f, int bits, int v)
{
    static const uint16_t half[3] = {16384, 32768, 0};
    int x = 0;
    for (int i = bits - 1; i >= 0; i--)
        x = 2 * x + sym_fixed(f, half, 2, (v >> i) & 1);
    return x;
}

/* NS(n) of the tile data */
static int ns_lit(Av1 *f, int n, int v)
{
    int w = 0;
    for (int x = n; x > 1; x >>= 1)
        w++;
    w += 1;
    int m = (1 << w) - n;
    if (f->ec.writing) {
        if (v < m) {
            lit(f, w - 1, v);
        } else {
            int t = v + m;
            lit(f, w - 1, t >> 1);
            lit(f, 1, t & 1);
        }
        return v;
    }
    int x = lit(f, w - 1, 0);
    if (x < m)
        return x;
    return (x << 1) - m + lit(f, 1, 0);
}

#define MI(a, r, c) ((a)[(size_t)(r) * f->MiCols + (c)])
#define PX(p, y, x) (f->plane[p][(size_t)(y) * f->stride + (x)])

static int is_inside(Av1 *f, int r, int c)
{
    return c >= f->mi_col_start && c < f->mi_col_end &&
           r >= f->mi_row_start && r < f->mi_row_end;
}

static int clip1(Av1 *f, int v)
{
    int mx = (1 << f->bitdepth) - 1;
    return v < 0 ? 0 : v > mx ? mx : v;
}

static int round2(int x, int n)
{
    return n ? (x + (1 << (n - 1))) >> n : x;
}

static int round2signed(int x, int n)
{
    return x >= 0 ? round2(x, n) : -round2(-x, n);
}

/* -- intra prediction (specification 7.11.2) ------------------------------ */

static int is_smooth_mode(int m)
{
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
}

static int filter_type(Av1 *f, int plane)
{
    int above = 0, left = 0;
    uint8_t *modes = plane ? f->uvmodes : f->ymodes;
    if (f->avail_u)
        above = is_smooth_mode(MI(modes, f->mi_row - 1, f->mi_col));
    if (f->avail_l)
        left = is_smooth_mode(MI(modes, f->mi_row, f->mi_col - 1));
    return above || left;
}

static int edge_strength(int w, int h, int type, int delta)
{
    int d = delta < 0 ? -delta : delta, wh = w + h, s = 0;
    if (type == 0) {
        if (wh <= 8) {
            if (d >= 56) s = 1;
        } else if (wh <= 16) {
            if (d >= 40) s = 1;
        } else if (wh <= 24) {
            if (d >= 8) s = 1;
            if (d >= 16) s = 2;
            if (d >= 32) s = 3;
        } else if (wh <= 32) {
            if (d >= 1) s = 1;
            if (d >= 4) s = 2;
            if (d >= 32) s = 3;
        } else {
            if (d >= 1) s = 3;
        }
    } else {
        if (wh <= 8) {
            if (d >= 40) s = 1;
            if (d >= 64) s = 2;
        } else if (wh <= 16) {
            if (d >= 20) s = 1;
            if (d >= 48) s = 2;
        } else if (wh <= 24) {
            if (d >= 4) s = 3;
        } else {
            if (d >= 1) s = 3;
        }
    }
    return s;
}

static int use_upsample(int w, int h, int type, int delta)
{
    int d = delta < 0 ? -delta : delta, wh = w + h;
    if (d <= 0 || d >= 40)
        return 0;
    return type ? wh <= 8 : wh <= 16;
}

/* edge[-1 .. sz-2] filtered in place (edge points at element 0) */
static void edge_filter(int *edge, int sz, int strength)
{
    int tmp[300];
    if (!strength)
        return;
    for (int i = 0; i < sz; i++)
        tmp[i] = edge[i - 1];
    for (int i = 1; i < sz; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int k = i - 2 + j;
            k = k < 0 ? 0 : k > sz - 1 ? sz - 1 : k;
            s += intra_edge_kernel[strength - 1][j] * tmp[k];
        }
        edge[i - 1] = (s + 8) >> 4;
    }
}

static void edge_upsample(Av1 *f, int *buf, int num)
{
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < num; i++)
        dup[i + 2] = buf[i];
    dup[num + 2] = buf[num - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        buf[2 * i - 1] = clip1(f, round2(s, 4));
        buf[2 * i] = dup[i + 2];
    }
}

static void predict_intra(Av1 *f, int plane, int x, int y, int have_left,
                          int have_above, int have_ar, int have_bl, int mode,
                          int log2w, int log2h)
{
    int w = 1 << log2w, h = 1 << log2h;
    int abuf[300], lbuf[300];
    int *above = abuf + 16, *left = lbuf + 16;
    int maxx = f->MiCols * 4 - 1, maxy = f->MiRows * 4 - 1;
    int bd = f->bitdepth;
    int n = w + h;
    if (plane) {
        maxx = ((f->MiCols * 4) >> f->ssx) - 1;
        maxy = ((f->MiRows * 4) >> f->ssy) - 1;
    }
    for (int i = 0; i < n; i++) {
        if (!have_above && have_left)
            above[i] = PX(plane, y, x - 1);
        else if (!have_above)
            above[i] = (1 << (bd - 1)) - 1;
        else {
            int lim = x + (have_ar ? 2 * w : w) - 1;
            if (lim > maxx) lim = maxx;
            above[i] = PX(plane, y - 1, x + i < lim ? x + i : lim);
        }
        if (!have_left && have_above)
            left[i] = PX(plane, y - 1, x);
        else if (!have_left)
            left[i] = (1 << (bd - 1)) + 1;
        else {
            int lim = y + (have_bl ? 2 * h : h) - 1;
            if (lim > maxy) lim = maxy;
            left[i] = PX(plane, y + i < lim ? y + i : lim, x - 1);
        }
    }
    if (have_above && have_left)
        above[-1] = PX(plane, y - 1, x - 1);
    else if (have_above)
        above[-1] = PX(plane, y - 1, x);
    else if (have_left)
        above[-1] = PX(plane, y, x - 1);
    else
        above[-1] = 1 << (bd - 1);
    left[-1] = above[-1];
    /* past w + h the edges repeat their last sample (the directional
     * predictors clamp there) */
    for (int i = n; i < 2 * n + 16; i++) {
        above[i] = above[n - 1];
        left[i] = left[n - 1];
    }
    int pred[64][64];
    if (plane == 0 && f->use_filter_intra) {
        int mode_f = f->filter_intra_mode;
        for (int i2 = 0; i2 < (h >> 1); i2++)
            for (int j4 = 0; j4 < (w >> 2); j4++) {
                int p[7];
                for (int i = 0; i < 7; i++) {
                    if (i < 5) {
                        if (i2 == 0)
                            p[i] = above[(j4 << 2) + i - 1];
                        else if (j4 == 0 && i == 0)
                            p[i] = left[(i2 << 1) - 1];
                        else
                            p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                    } else {
                        if (j4 == 0)
                            p[i] = left[(i2 << 1) + i - 5];
                        else
                            p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                    }
                }
                for (int i = 0; i < 8; i++) {
                    int pr = 0;
                    for (int j = 0; j < 7; j++)
                        pr += filter_intra_taps[mode_f][i][j] * p[j];
                    pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] =
                        clip1(f, round2signed(pr, 4));
                }
            }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
        int delta = plane ? f->angle_uv : f->angle_y;
        int pangle = mode_to_angle[mode] + delta * 3;
        int up_above = 0, up_left = 0;
        if (f->edge_filter_en) {
            int type = filter_type(f, plane);
            if (pangle != 90 && pangle != 180) {
                if (pangle > 90 && pangle < 180 && w + h >= 24) {
                    int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5,
                                   4);
                    left[-1] = above[-1] = v;
                }
                if (have_above) {
                    int s = edge_strength(w, h, type, pangle - 90);
                    int num = (w < maxx - x + 1 ? w : maxx - x + 1) +
                              (pangle < 90 ? h : 0) + 1;
                    edge_filter(above, num, s);
                }
                if (have_left) {
                    int s = edge_strength(w, h, type, pangle - 180);
                    int num = (h < maxy - y + 1 ? h : maxy - y + 1) +
                              (pangle > 180 ? w : 0) + 1;
                    edge_filter(left, num, s);
                }
            }
            up_above = use_upsample(w, h, type, pangle - 90);
            if (up_above)
                edge_upsample(f, above, w + (pangle < 90 ? h : 0));
            up_left = use_upsample(w, h, type, pangle - 180);
            if (up_left)
                edge_upsample(f, left, h + (pangle > 180 ? w : 0));
        }
        int dx = 0, dy = 0;
        if (pangle < 90)
            dx = dr_intra_derivative[pangle];
        else if (pangle > 90 && pangle < 180) {
            dx = dr_intra_derivative[180 - pangle];
            dy = dr_intra_derivative[pangle - 90];
        } else if (pangle > 180)
            dy = dr_intra_derivative[270 - pangle];
        int max_x = (w + h - 1) << up_above, max_y = (w + h - 1) << up_left;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int v;
                if (pangle < 90) {
                    int idx = (i + 1) * dx;
                    int base = (idx >> (6 - up_above)) + (j << up_above);
                    int shift = ((idx << up_above) >> 1) & 0x1F;
                    if (base < max_x)
                        v = round2(above[base] * (32 - shift) +
                                   above[base + 1] * shift, 5);
                    else
                        v = above[max_x];
                } else if (pangle > 90 && pangle < 180) {
                    int idx = (j << 6) - (i + 1) * dx;
                    int base = idx >> (6 - up_above);
                    if (base >= -(1 << up_above)) {
                        int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
                        v = round2(above[base] * (32 - shift) +
                                   above[base + 1] * shift, 5);
                    } else {
                        idx = (i << 6) - (j + 1) * dy;
                        base = idx >> (6 - up_left);
                        int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
                        v = round2(left[base] * (32 - shift) +
                                   left[base + 1] * shift, 5);
                    }
                } else if (pangle > 180) {
                    int idx = (j + 1) * dy;
                    int base = (idx >> (6 - up_left)) + (i << up_left);
                    int shift = ((idx << up_left) >> 1) & 0x1F;
                    if (base < max_y)
                        v = round2(left[base] * (32 - shift) +
                                   left[base + 1] * shift, 5);
                    else
                        v = left[max_y];
                } else if (pangle == 90) {
                    v = above[j];
                } else {
                    v = left[i];
                }
                pred[i][j] = v;
            }
    } else if (mode == SMOOTH_PRED) {
        const uint8_t *wx = sm_weights + w - 4, *wy = sm_weights + h - 4;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                pred[i][j] = round2(wy[i] * above[j] +
                                    (256 - wy[i]) * left[h - 1] +
                                    wx[j] * left[i] +
                                    (256 - wx[j]) * above[w - 1], 9);
    } else if (mode == SMOOTH_V_PRED) {
        const uint8_t *wy = sm_weights + h - 4;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                pred[i][j] = round2(wy[i] * above[j] +
                                    (256 - wy[i]) * left[h - 1], 8);
    } else if (mode == SMOOTH_H_PRED) {
        const uint8_t *wx = sm_weights + w - 4;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                pred[i][j] = round2(wx[j] * left[i] +
                                    (256 - wx[j]) * above[w - 1], 8);
    } else if (mode == DC_PRED) {
        int avg, sum = 0;
        if (have_left && have_above) {
            for (int k = 0; k < h; k++) sum += left[k];
            for (int k = 0; k < w; k++) sum += above[k];
            sum += (w + h) >> 1;
            avg = sum / (w + h);
        } else if (have_left) {
            for (int k = 0; k < h; k++) sum += left[k];
            avg = (sum + (h >> 1)) >> log2h;
        } else if (have_above) {
            for (int k = 0; k < w; k++) sum += above[k];
            avg = (sum + (w >> 1)) >> log2w;
        } else {
            avg = 1 << (bd - 1);
        }
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                pred[i][j] = avg;
    } else { /* PAETH_PRED */
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int base = above[j] + left[i] - above[-1];
                int pl = abs(base - left[i]), pt = abs(base - above[j]);
                int ptl = abs(base - above[-1]);
                pred[i][j] = (pl <= pt && pl <= ptl) ? left[i]
                             : (pt <= ptl) ? above[j] : above[-1];
            }
    }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
            PX(plane, y + i, x + j) = (uint16_t)pred[i][j];
}

static void predict_cfl(Av1 *f, int plane, int x, int y, int log2w, int log2h)
{
    int w = 1 << log2w, h = 1 << log2h;
    int alpha = plane == 1 ? f->cfl_u : f->cfl_v;
    int l[64][64], avg = 0;
    for (int i = 0; i < h; i++) {
        int ly = (y + i) << f->ssy;
        if (ly > f->max_luma_h - (1 << f->ssy))
            ly = f->max_luma_h - (1 << f->ssy);
        for (int j = 0; j < w; j++) {
            int lx = (x + j) << f->ssx;
            if (lx > f->max_luma_w - (1 << f->ssx))
                lx = f->max_luma_w - (1 << f->ssx);
            int t = 0;
            for (int dy = 0; dy <= f->ssy; dy++)
                for (int dx = 0; dx <= f->ssx; dx++)
                    t += PX(0, ly + dy, lx + dx);
            l[i][j] = t << (3 - f->ssx - f->ssy);
            avg += l[i][j];
        }
    }
    avg = round2(avg, log2w + log2h);
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int dc = PX(plane, y + i, x + j);
            int scaled = round2signed(alpha * (l[i][j] - avg), 6);
            PX(plane, y + i, x + j) = (uint16_t)clip1(f, dc + scaled);
        }
}

/* -- coefficients of a 4 x 4 block (specification 5.11.39) ---------------- */

static int coeff_base_ctx(const int32_t *q, int pos)
{
    static const int8_t off[5][2] = {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}};
    int row = pos >> 2, col = pos & 3, mag = 0;
    for (int k = 0; k < 5; k++) {
        int r = row + off[k][0], c = col + off[k][1];
        if (r < 4 && c < 4) {
            int a = abs(q[r * 4 + c]);
            mag += a < 3 ? a : 3;
        }
    }
    int ctx = (mag + 1) >> 1;
    if (ctx > 4) ctx = 4;
    if (pos == 0)
        return 0;
    return ctx + nz_map_ctx_offset_4x4[pos];
}

static int coeff_br_ctx(const int32_t *q, int pos)
{
    static const int8_t off[3][2] = {{0, 1}, {1, 0}, {1, 1}};
    int row = pos >> 2, col = pos & 3, mag = 0;
    for (int k = 0; k < 3; k++) {
        int r = row + off[k][0], c = col + off[k][1];
        if (r < 4 && c < 4) {
            int a = q[r * 4 + c];
            mag += a < 15 ? a : 15;
        }
    }
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (pos == 0)
        return mag;
    return (row < 2 && col < 2) ? mag + 7 : mag + 14;
}

/* the coefficients of the 4 x 4 block at (x4, y4) of a plane: read into
 * f->quant (signed, row-major), or in a writer written from it; returns
 * the end of block */
static int coeffs(Av1 *f, int plane, int x4, int y4)
{
    Cdfs *c = &f->cdf;
    int ptype = plane > 0;
    int maxx4 = f->MiCols, maxy4 = f->MiRows;
    int32_t *q = f->quant;
    int32_t want[16];
    if (plane) {
        maxx4 >>= f->ssx;
        maxy4 >>= f->ssy;
    }
    memcpy(want, q, sizeof(want));
    memset(q, 0, sizeof(int32_t) * 16);
    int ctx;
    if (plane == 0) {
        int top = x4 < maxx4 ? f->above_level[0][x4] : 0;
        int left = y4 < maxy4 ? f->left_level[0][y4] : 0;
        int bsz = f->mi_sz;
        if (bsz == BLOCK_4X4)
            ctx = 0;
        else if (top == 0 && left == 0)
            ctx = 1;
        else if (top == 0 || left == 0)
            ctx = 2 + ((top > left ? top : left) > 3);
        else if ((top > left ? top : left) <= 3)
            ctx = 4;
        else if ((top < left ? top : left) <= 3)
            ctx = 5;
        else
            ctx = 6;
    } else {
        int above = 0, left = 0;
        if (x4 < maxx4)
            above = f->above_level[plane][x4] | f->above_dc[plane][x4];
        if (y4 < maxy4)
            left = f->left_level[plane][y4] | f->left_dc[plane][y4];
        ctx = 7 + (above != 0) + (left != 0);
        /* the plane's block is larger than 4 x 4 */
        int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
        if ((bw >> f->ssx) * (bh >> f->ssy) > 16)
            ctx += 3;
    }
    int eob = 0, want_eob = 0;
    if (f->ec.writing)
        for (int k = 0; k < 16; k++)
            if (want[default_scan_4x4[k]])
                want_eob = k + 1;
    int all_zero = sym(f, c->txb_skip[0][ctx], 2, want_eob == 0);
    int cul = 0, dc_cat = 0;
    if (!all_zero) {
        /* eob: class (eob_pt_16), then its extra bits */
        static const int pt_of[17] = {0, 1, 2, 3, 3, 4, 4, 4, 4,
                                      5, 5, 5, 5, 5, 5, 5, 5};
        int want_pt = f->ec.writing ? pt_of[want_eob] : 0;
        int eob_pt = sym(f, c->eob_pt16[ptype][0], 5, want_pt - 1) + 1;
        eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
        int shift = eob_pt - 3;
        if (shift >= 0) {
            int rest = want_eob - eob;
            int bit = sym(f, c->eob_extra[0][ptype][eob_pt - 3], 2,
                          (rest >> shift) & 1);
            if (bit)
                eob += 1 << shift;
            for (int i = 1; i < eob_pt - 2; i++) {
                shift = eob_pt - 2 - 1 - i;
                if (lit(f, 1, (rest >> shift) & 1))
                    eob += 1 << shift;
            }
        }
        for (int k = eob - 1; k >= 0; k--) {
            int pos = default_scan_4x4[k];
            int wl = abs(want[pos]);
            int level;
            if (k == eob - 1) {
                int cx = k == 0 ? 0 : k <= 2 ? 1 : k <= 4 ? 2 : 3;
                level = sym(f, c->coeff_base_eob[0][ptype][cx], 3,
                            (wl > 3 ? 3 : wl) - 1) + 1;
            } else {
                level = sym(f, c->coeff_base[0][ptype][coeff_base_ctx(q, pos)],
                            4, wl > 3 ? 3 : wl);
            }
            if (level > 2) {
                int bctx = coeff_br_ctx(q, pos);
                for (int idx = 0; idx < 4; idx++) {
                    int br_want = wl - level;
                    int br = sym(f, c->coeff_br[0][ptype][bctx], 4,
                                 br_want > 3 ? 3 : br_want);
                    level += br;
                    if (br < 3)
                        break;
                }
            }
            q[pos] = level;
        }
        for (int k = 0; k < eob; k++) {
            int pos = default_scan_4x4[k];
            int sign = 0;
            if (q[pos]) {
                int ws = want[pos] < 0;
                if (k == 0) {
                    int ds = 0;
                    if (x4 < maxx4)
                        ds += f->above_dc[plane][x4] == 1 ? -1 :
                              f->above_dc[plane][x4] == 2 ? 1 : 0;
                    if (y4 < maxy4)
                        ds += f->left_dc[plane][y4] == 1 ? -1 :
                              f->left_dc[plane][y4] == 2 ? 1 : 0;
                    int sctx = ds < 0 ? 1 : ds > 0 ? 2 : 0;
                    sign = sym(f, c->dc_sign[ptype][sctx], 2, ws);
                } else {
                    sign = lit(f, 1, ws);
                }
            }
            if (q[pos] > 14) {
                /* Golomb: the value less 15, plus one */
                uint32_t gx = f->ec.writing ? (uint32_t)abs(want[pos]) - 14 : 0;
                int length = 0, glen = 0;
                if (f->ec.writing)
                    for (uint32_t t = gx; t; t >>= 1)
                        glen++;
                int bit;
                do {
                    length++;
                    bit = lit(f, 1, length == glen);
                    if (length > 20)
                        av1_fail(f, ERR_VALUE, "AV1: a Golomb code longer "
                                 "than 20 bits");
                } while (!bit);
                uint32_t x = 1;
                for (int i = length - 2; i >= 0; i--)
                    x = (x << 1) | (uint32_t)lit(f, 1, (gx >> i) & 1);
                q[pos] = (int32_t)(x + 14);
            }
            if (pos == 0 && q[pos] > 0)
                dc_cat = sign ? 1 : 2;
            q[pos] &= 0xFFFFF;
            cul += q[pos];
            if (sign)
                q[pos] = -q[pos];
        }
        if (cul > 63)
            cul = 63;
    }
    f->above_level[plane][x4] = (uint8_t)cul;
    f->above_dc[plane][x4] = (uint8_t)dc_cat;
    f->left_level[plane][y4] = (uint8_t)cul;
    f->left_dc[plane][y4] = (uint8_t)dc_cat;
    return eob;
}

static void iwht_1d(int32_t *t, int shift)
{
    int32_t a = t[0] >> shift, c = t[1] >> shift, d = t[2] >> shift;
    int32_t b = t[3] >> shift, e;
    a += c;
    d -= b;
    e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    t[0] = a;
    t[1] = b;
    t[2] = c;
    t[3] = d;
}

/* dequantize (qindex 0: 4 for DC and AC at every bit depth), inverse WHT
 * (rows with shift 2, then columns) and add to the prediction */
static void reconstruct(Av1 *f, int plane, int x, int y)
{
    int32_t r[4][4];
    int32_t lim = (int32_t)1 << (7 + f->bitdepth);
    const int16_t *dcq = f->bitdepth == 8 ? dc_qlookup : f->bitdepth == 10
                         ? dc_qlookup_10 : dc_qlookup_12;
    const int16_t *acq = f->bitdepth == 8 ? ac_qlookup : f->bitdepth == 10
                         ? ac_qlookup_10 : ac_qlookup_12;
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) {
            int32_t v = f->quant[i * 4 + j];
            int32_t qv = (i | j) ? acq[0] : dcq[0];
            int32_t dq = (int32_t)(((int64_t)abs(v) * qv) & 0xFFFFFF);
            if (v < 0) dq = -dq;
            r[i][j] = dq < -lim ? -lim : dq > lim - 1 ? lim - 1 : dq;
        }
    for (int i = 0; i < 4; i++)
        iwht_1d(r[i], 2);
    for (int j = 0; j < 4; j++) {
        int32_t t[4] = {r[0][j], r[1][j], r[2][j], r[3][j]};
        iwht_1d(t, 0);
        for (int i = 0; i < 4; i++)
            r[i][j] = t[i];
    }
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
            PX(plane, y + i, x + j) =
                (uint16_t)clip1(f, PX(plane, y + i, x + j) + r[i][j]);
}

/* a writer: the coefficients of the residual of a 4 x 4 block (forward
 * WHT, the inverse of reconstruct()) */
static void forward_wht(Av1 *f, int plane, int x, int y);

/* -- blocks --------------------------------------------------------------- */

static void transform_block(Av1 *f, int plane, int base_x, int base_y, int tx,
                            int ty)
{
    int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
    int sx = base_x + 4 * tx, sy = base_y + 4 * ty;
    int row = (sy << ssy) >> 2, col = (sx << ssx) >> 2;
    int mask = f->use128 ? 31 : 15;
    int sbr = (row & mask) >> ssy, sbc = (col & mask) >> ssx;
    int maxx = f->MiCols * 4 - 1, maxy = f->MiRows * 4 - 1;
    if (sx >= (maxx >> ssx) + 1 || sy >= (maxy >> ssy) + 1)
        return;
    if (f->use_intrabc) {
        /* predicted with the block (intrabc_predict) */
    } else if ((plane == 0 && f->pal_y) || (plane && f->pal_uv)) {
        const uint16_t *pal = plane == 0 ? f->pal_y_colors : plane == 1
                              ? f->pal_u_colors : f->pal_v_colors;
        const uint8_t *map = plane ? f->map_uv : f->map_y;
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++)
                PX(plane, sy + i, sx + j) =
                    pal[map[(ty * 4 + i) * 64 + tx * 4 + j]];
    } else {
        int cfl = plane > 0 && f->uvmode == UV_CFL_PRED;
        int mode = plane == 0 ? f->ymode : cfl ? DC_PRED : f->uvmode;
        predict_intra(f, plane, sx, sy, f->avail_l || tx > 0,
                      f->avail_u || ty > 0,
                      f->decoded[plane][sbr - 1 + 1][sbc + 1 + 1],
                      f->decoded[plane][sbr + 1 + 1][sbc - 1 + 1], mode, 2, 2);
        if (cfl)
            predict_cfl(f, plane, sx, sy, 2, 2);
    }
    if (plane == 0 && !f->use_intrabc) {
        f->max_luma_w = sx + 4;
        f->max_luma_h = sy + 4;
    }
    if (!f->skip) {
        if (f->ec.writing)
            forward_wht(f, plane, sx, sy);
        if (coeffs(f, plane, sx >> 2, sy >> 2) > 0)
            reconstruct(f, plane, sx, sy);
    }
    f->decoded[plane][sbr + 1][sbc + 1] = 1;
}

static void residual(Av1 *f)
{
    int wchunks = f->bw4 >> 4 > 1 ? f->bw4 >> 4 : 1;
    int hchunks = f->bh4 >> 4 > 1 ? f->bh4 >> 4 : 1;
    for (int cy = 0; cy < hchunks; cy++)
        for (int cx = 0; cx < wchunks; cx++)
            for (int plane = 0; plane < 1 + 2 * f->has_chroma; plane++) {
                int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
                int n4w = f->bw4 >> ssx, n4h = f->bh4 >> ssy;
                if (n4w < 1) n4w = 1;
                if (n4h < 1) n4h = 1;
                int bx = (f->mi_col >> ssx) * 4, by = (f->mi_row >> ssy) * 4;
                int lh = n4h < (16 >> ssy) ? n4h : 16 >> ssy;
                int lw = n4w < (16 >> ssx) ? n4w : 16 >> ssx;
                for (int y = 0; y < lh; y++)
                    for (int x = 0; x < lw; x++)
                        transform_block(f, plane, bx, by,
                                        x + ((cx << 4) >> ssx),
                                        y + ((cy << 4) >> ssy));
            }
}

static int palette_cache(Av1 *f, int plane, uint16_t *cache)
{
    int an = 0, ln = 0, ai = 0, li = 0, n = 0;
    const uint16_t *ac = NULL, *lc = NULL;
    if (((f->mi_row * 4) % 64) && f->avail_u) {
        an = MI(f->pal_sizes[plane], f->mi_row - 1, f->mi_col);
        ac = f->pal_colors[plane] +
             ((size_t)(f->mi_row - 1) * f->MiCols + f->mi_col) * 8;
    }
    if (f->avail_l) {
        ln = MI(f->pal_sizes[plane], f->mi_row, f->mi_col - 1);
        lc = f->pal_colors[plane] +
             ((size_t)f->mi_row * f->MiCols + f->mi_col - 1) * 8;
    }
    while (ai < an && li < ln) {
        int a = ac[ai], l = lc[li];
        if (l < a) {
            if (n == 0 || l != cache[n - 1])
                cache[n++] = (uint16_t)l;
            li++;
        } else {
            if (n == 0 || a != cache[n - 1])
                cache[n++] = (uint16_t)a;
            ai++;
            if (l == a)
                li++;
        }
    }
    for (; ai < an; ai++)
        if (n == 0 || ac[ai] != cache[n - 1])
            cache[n++] = ac[ai];
    for (; li < ln; li++)
        if (n == 0 || lc[li] != cache[n - 1])
            cache[n++] = lc[li];
    return n;
}

static int ceil_log2(int x)
{
    int i = 1, p = 2;
    if (x < 2)
        return 0;
    while (p < x) {
        i++;
        p <<= 1;
    }
    return i;
}

static void sort_colors(uint16_t *c, int n)
{
    for (int i = 1; i < n; i++)
        for (int j = i; j > 0 && c[j - 1] > c[j]; j--) {
            uint16_t t = c[j];
            c[j] = c[j - 1];
            c[j - 1] = t;
        }
}

/* palette colours of plane 0 or 1 (y, u): from the cache, a literal, then
 * ascending deltas (the writer writes no palette) */
static void palette_colors(Av1 *f, int plane, int n, uint16_t *out)
{
    uint16_t cache[16];
    int cn = palette_cache(f, plane, cache), idx = 0, bd = f->bitdepth;
    for (int i = 0; i < cn && idx < n; i++)
        if (lit(f, 1, 0))
            out[idx++] = cache[i];
    if (idx < n)
        out[idx++] = (uint16_t)lit(f, bd, 0);
    int bits = idx < n ? bd - 3 + lit(f, 2, 0) : 0;
    while (idx < n) {
        int dlt = lit(f, bits, 0);
        if (plane == 0)
            dlt++;
        out[idx] = (uint16_t)clip1(f, out[idx - 1] + dlt);
        int range = (1 << bd) - out[idx] - (plane == 0);
        int cl = ceil_log2(range);
        if (cl < bits)
            bits = cl;
        idx++;
    }
    sort_colors(out, n);
}

static void palette_mode_info(Av1 *f)
{
    Cdfs *c = &f->cdf;
    int bctx = bw4_log2[f->mi_sz] + bh4_log2[f->mi_sz] - 2;
    int bd = f->bitdepth;
    if (f->ymode == DC_PRED) {
        int ctx = 0;
        if (f->avail_u && MI(f->pal_sizes[0], f->mi_row - 1, f->mi_col))
            ctx++;
        if (f->avail_l && MI(f->pal_sizes[0], f->mi_row, f->mi_col - 1))
            ctx++;
        if (sym(f, c->palette_y_mode[bctx][ctx], 2, 0)) {
            f->pal_y = sym(f, c->palette_y_size[bctx], 7, 0) + 2;
            palette_colors(f, 0, f->pal_y, f->pal_y_colors);
        }
    }
    if (f->has_chroma && f->uvmode == DC_PRED) {
        if (sym(f, c->palette_uv_mode[f->pal_y > 0], 2, 0)) {
            f->pal_uv = sym(f, c->palette_uv_size[bctx], 7, 0) + 2;
            palette_colors(f, 1, f->pal_uv, f->pal_u_colors);
            if (lit(f, 1, 0)) { /* delta_encode_palette_colors_v */
                int max = 1 << bd;
                int bits = bd - 4 + lit(f, 2, 0);
                f->pal_v_colors[0] = (uint16_t)lit(f, bd, 0);
                for (int i = 1; i < f->pal_uv; i++) {
                    int d = lit(f, bits, 0);
                    if (d && lit(f, 1, 0))
                        d = -d;
                    int v = f->pal_v_colors[i - 1] + d;
                    if (v < 0) v += max;
                    if (v >= max) v -= max;
                    f->pal_v_colors[i] = (uint16_t)clip1(f, v);
                }
            } else {
                for (int i = 0; i < f->pal_uv; i++)
                    f->pal_v_colors[i] = (uint16_t)lit(f, bd, 0);
            }
        }
    }
}

static void color_context(const uint8_t *map, int r, int col, int n,
                          int *order, int *ctx)
{
    int scores[8] = {0};
    for (int i = 0; i < 8; i++)
        order[i] = i;
    if (col > 0)
        scores[map[r * 64 + col - 1]] += 2;
    if (r > 0 && col > 0)
        scores[map[(r - 1) * 64 + col - 1]] += 1;
    if (r > 0)
        scores[map[(r - 1) * 64 + col]] += 2;
    for (int i = 0; i < 3; i++) {
        int mx = scores[i], mi = i;
        for (int j = i + 1; j < n; j++)
            if (scores[j] > mx) {
                mx = scores[j];
                mi = j;
            }
        if (mi != i) {
            int mo = order[mi];
            for (int k = mi; k > i; k--) {
                scores[k] = scores[k - 1];
                order[k] = order[k - 1];
            }
            scores[i] = mx;
            order[i] = mo;
        }
    }
    *ctx = palette_color_context[scores[0] + 2 * scores[1] + 2 * scores[2]];
}

static void color_map(Av1 *f, uint8_t *map, int n, int bw, int bh, int onw,
                      int onh, uint16_t (*cdfs)[9])
{
    map[0] = (uint8_t)ns_lit(f, n, 0);
    for (int i = 1; i < onh + onw - 1; i++)
        for (int j = (i < onw - 1 ? i : onw - 1);
             j >= (i - onh + 1 > 0 ? i - onh + 1 : 0); j--) {
            int order[8], ctx;
            color_context(map, i - j, j, n, order, &ctx);
            if (ctx < 0)
                ctx = 0;
            map[(i - j) * 64 + j] = (uint8_t)order[sym(f, cdfs[ctx], n, 0)];
        }
    for (int i = 0; i < onh; i++)
        for (int j = onw; j < bw; j++)
            map[i * 64 + j] = map[i * 64 + onw - 1];
    for (int i = onh; i < bh; i++)
        for (int j = 0; j < bw; j++)
            map[i * 64 + j] = map[(onh - 1) * 64 + j];
}

static void palette_tokens(Av1 *f)
{
    int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
    int onh = (f->MiRows - f->mi_row) * 4, onw = (f->MiCols - f->mi_col) * 4;
    if (onh > bh) onh = bh;
    if (onw > bw) onw = bw;
    if (f->pal_y)
        color_map(f, f->map_y, f->pal_y, bw, bh, onw, onh,
                  f->cdf.palette_y_color[f->pal_y - 2]);
    if (f->pal_uv) {
        bw >>= f->ssx;
        bh >>= f->ssy;
        onw >>= f->ssx;
        onh >>= f->ssy;
        if (bw < 4) {
            bw += 2;
            onw += 2;
        }
        if (bh < 4) {
            bh += 2;
            onh += 2;
        }
        color_map(f, f->map_uv, f->pal_uv, bw, bh, onw, onh,
                  f->cdf.palette_uv_color[f->pal_uv - 2]);
    }
}

static Choice *enc_choice(Av1 *f);
static int enc_partition(Av1 *f, int r, int c, int bsize);

/* -- intra block copy (specification 7.10.2, 5.11.26, 7.11.3) ----------- */

typedef struct {
    int n, row[8], col[8], weight[8], found;
} MvStack;

static void add_candidate(Av1 *f, MvStack *st, int r, int c, int weight)
{
    size_t k = (size_t)r * f->MiCols + c;
    if (!f->is_inter[k])
        return;
    /* the candidate's vector, at integer precision (force_integer_mv) */
    int v[2] = {f->mvs[2 * k], f->mvs[2 * k + 1]};
    for (int i = 0; i < 2; i++) {
        int a = (abs(v[i]) + 3) >> 3;
        v[i] = v[i] > 0 ? a << 3 : -(a << 3);
    }
    st->found = 1;
    for (int i = 0; i < st->n; i++)
        if (st->row[i] == v[0] && st->col[i] == v[1]) {
            st->weight[i] += weight;
            return;
        }
    if (st->n < 8) {
        st->row[st->n] = v[0];
        st->col[st->n] = v[1];
        st->weight[st->n] = weight;
        st->n++;
    }
}

static void scan_row(Av1 *f, MvStack *st, int delta_row)
{
    int bw4 = f->bw4, end4 = bw4 < f->MiCols - f->mi_col ? bw4
                                 : f->MiCols - f->mi_col;
    int delta_col = 0, step16 = bw4 >= 16;
    if (end4 > 16) end4 = 16;
    if (abs(delta_row) > 1) {
        delta_row += f->mi_row & 1;
        delta_col = 1 - (f->mi_col & 1);
    }
    for (int i = 0; i < end4;) {
        int r = f->mi_row + delta_row, c = f->mi_col + delta_col + i;
        if (!is_inside(f, r, c))
            break;
        int len = 1 << bw4_log2[MI(f->mi_size, r, c)];
        if (len > bw4) len = bw4;
        if (abs(delta_row) > 1 && len < 2) len = 2;
        if (step16 && len < 4) len = 4;
        add_candidate(f, st, r, c, len * 2);
        i += len;
    }
}

static void scan_col(Av1 *f, MvStack *st, int delta_col)
{
    int bh4 = f->bh4, end4 = bh4 < f->MiRows - f->mi_row ? bh4
                                 : f->MiRows - f->mi_row;
    int delta_row = 0, step16 = bh4 >= 16;
    if (end4 > 16) end4 = 16;
    if (abs(delta_col) > 1) {
        delta_row = 1 - (f->mi_row & 1);
        delta_col += f->mi_col & 1;
    }
    for (int i = 0; i < end4;) {
        int r = f->mi_row + delta_row + i, c = f->mi_col + delta_col;
        if (!is_inside(f, r, c))
            break;
        int len = 1 << bh4_log2[MI(f->mi_size, r, c)];
        if (len > bh4) len = bh4;
        if (abs(delta_col) > 1 && len < 2) len = 2;
        if (step16 && len < 4) len = 4;
        add_candidate(f, st, r, c, len * 2);
        i += len;
    }
}

static void scan_point(Av1 *f, MvStack *st, int delta_row, int delta_col)
{
    int r = f->mi_row + delta_row, c = f->mi_col + delta_col;
    if (is_inside(f, r, c) && MI(f->written, r, c))
        add_candidate(f, st, r, c, 4);
}

static void sort_stack(MvStack *st, int start, int end)
{
    while (end > start) {
        int new_end = start;
        for (int i = start + 1; i < end; i++)
            if (st->weight[i - 1] < st->weight[i]) {
                int t;
                t = st->weight[i]; st->weight[i] = st->weight[i - 1];
                st->weight[i - 1] = t;
                t = st->row[i]; st->row[i] = st->row[i - 1]; st->row[i - 1] = t;
                t = st->col[i]; st->col[i] = st->col[i - 1]; st->col[i - 1] = t;
                new_end = i;
            }
        end = new_end;
    }
}

static int mv_component(Av1 *f, const int base)
{
    uint16_t *m = f->cdf.mv + base;
    int sign = sym(f, m + 27, 2, 0);
    int cls = sym(f, m, 11, 0), mag;
    if (cls == 0) {
        mag = sym(f, m + 36, 2, 0) << 3;
    } else {
        int d = 0;
        for (int i = 0; i < cls; i++)
            d |= sym(f, m + 39 + 3 * i, 2, 0) << i;
        mag = (2 << (cls + 2)) + (d << 3);
    }
    mag += (3 << 1) + 1 + 1; /* fr = 3, hp = 1 */
    return sign ? -mag : mag;
}

/* av1_is_dv_valid: inside the tile, in superblocks decoded at least
 * INTRABC_DELAY_SB64 (4) 64-wide columns before, above the wavefront */
static int dv_valid(Av1 *f, int dr, int dc)
{
    int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
    if ((dr & 7) || (dc & 7))
        return 0;
    int top = f->mi_row * 32 + dr, left = f->mi_col * 32 + dc;
    int bottom = (f->mi_row * 4 + bh) * 8 + dr;
    int right = (f->mi_col * 4 + bw) * 8 + dc;
    if (top < f->mi_row_start * 32 || left < f->mi_col_start * 32 ||
        bottom > f->mi_row_end * 32 || right > f->mi_col_end * 32)
        return 0;
    if (f->nplanes > 1 && f->has_chroma) {
        if (bw < 8 && f->ssx && left < f->mi_col_start * 32 + 32)
            return 0;
        if (bh < 8 && f->ssy && top < f->mi_row_start * 32 + 32)
            return 0;
    }
    int log2 = f->use128 ? 5 : 4, sb = (1 << log2) * 4;
    int active_row = f->mi_row >> log2;
    int active_col64 = (f->mi_col * 4) >> 6;
    int src_row = ((bottom >> 3) - 1) / sb;
    int src_col64 = ((right >> 3) - 1) >> 6;
    int per_row = ((f->mi_col_end - f->mi_col_start - 1) >> 4) + 1;
    if (src_row * per_row + src_col64 >= active_row * per_row +
        active_col64 - 4)
        return 0;
    int wf = (1 + 4 + (sb > 64)) * (active_row - src_row);
    if (src_row > active_row || src_col64 >= active_col64 - 4 + wf)
        return 0;
    return 1;
}

static void intrabc_vector(Av1 *f)
{
    MvStack st = {0};
    int bw4 = f->bw4, bh4 = f->bh4;
    scan_row(f, &st, -1);
    int found_above = st.found;
    st.found = 0;
    scan_col(f, &st, -1);
    st.found = 0;
    if ((bw4 > bh4 ? bw4 : bh4) <= 16)
        scan_point(f, &st, -1, bw4);
    int nearest = st.n;
    for (int i = 0; i < nearest; i++)
        st.weight[i] += 640;
    scan_point(f, &st, -1, -1);
    scan_row(f, &st, -3);
    scan_col(f, &st, -3);
    if (bh4 > 1)
        scan_row(f, &st, -5);
    if (bw4 > 1)
        scan_col(f, &st, -5);
    (void)found_above;
    sort_stack(&st, 0, nearest);
    sort_stack(&st, nearest, st.n);
    /* no extra candidates: intra frames have no inter references */
    int top = -(f->mi_row * 32), bot = (f->MiRows - bh4 - f->mi_row) * 32;
    int lef = -(f->mi_col * 32), rig = (f->MiCols - bw4 - f->mi_col) * 32;
    for (int i = 0; i < st.n; i++) {
        int br = 128 + bh4 * 32, bc = 128 + bw4 * 32;
        st.row[i] = st.row[i] < top - br ? top - br : st.row[i] > bot + br
                    ? bot + br : st.row[i];
        st.col[i] = st.col[i] < lef - bc ? lef - bc : st.col[i] > rig + bc
                    ? rig + bc : st.col[i];
    }
    for (int i = st.n; i < 2; i++)
        st.row[i] = st.col[i] = 0;
    int pr = st.row[0], pc = st.col[0];
    if (pr == 0 && pc == 0) {
        pr = st.row[1];
        pc = st.col[1];
    }
    if (pr == 0 && pc == 0) {
        int sb4 = f->use128 ? 32 : 16;
        if (f->mi_row - sb4 < f->mi_row_start) {
            pr = 0;
            pc = -(sb4 * 4 + 256) * 8;
        } else {
            pr = -(sb4 * 4 * 8);
            pc = 0;
        }
    }
    uint16_t *m = f->cdf.mv;
    int joint = sym(f, m, 4, 0);
    int dr = 0, dc = 0;
    if (joint == 2 || joint == 3)
        dr = mv_component(f, 5);
    if (joint == 1 || joint == 3)
        dc = mv_component(f, 74);
    f->mv_row = pr + dr;
    f->mv_col = pc + dc;
    if (!dv_valid(f, f->mv_row, f->mv_col))
        av1_fail(f, ERR_VALUE, "AV1: an invalid intra block copy vector");
}

/* the block copied from the frame decoded so far, clamped to the frame */
static void intrabc_predict(Av1 *f)
{
    int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
    for (int plane = 0; plane < 1 + 2 * f->has_chroma; plane++) {
        int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
        int x0 = (f->mi_col >> ssx) * 4, y0 = (f->mi_row >> ssy) * 4;
        int w = bw >> ssx, h = bh >> ssy;
        int lastx = ((f->W + ssx) >> ssx) - 1, lasty = ((f->H + ssy) >> ssy)
                    - 1;
        int dy = (f->mv_row >> 3) >> ssy, dx = (f->mv_col >> 3) >> ssx;
        uint16_t tmp[128 * 128];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int sy = y0 + i + dy, sx = x0 + j + dx;
                sy = sy < 0 ? 0 : sy > lasty ? lasty : sy;
                sx = sx < 0 ? 0 : sx > lastx ? lastx : sx;
                tmp[i * 128 + j] = PX(plane, sy, sx);
            }
        for (int i = 0; i < h && y0 + i < f->rows; i++)
            for (int j = 0; j < w && x0 + j < f->stride; j++)
                PX(plane, y0 + i, x0 + j) = tmp[i * 128 + j];
    }
}

static void intra_frame_mode_info(Av1 *f)
{
    Cdfs *c = &f->cdf;
    Choice none = {0}, *ch = f->ec.writing ? enc_choice(f) : &none;
    int ctx = 0;
    if (f->avail_u)
        ctx += MI(f->skips, f->mi_row - 1, f->mi_col);
    if (f->avail_l)
        ctx += MI(f->skips, f->mi_row, f->mi_col - 1);
    f->skip = sym(f, c->skip[ctx], 2, ch->skip);
    f->use_intrabc = 0;
    if (f->allow_intrabc) {
        f->use_intrabc = sym(f, c->intrabc, 2, 0);
        if (f->use_intrabc) {
            f->ymode = f->uvmode = DC_PRED;
            f->angle_y = f->angle_uv = f->cfl_u = f->cfl_v = 0;
            f->pal_y = f->pal_uv = f->use_filter_intra = 0;
            intrabc_vector(f);
            return;
        }
    }
    int above = f->avail_u ? MI(f->ymodes, f->mi_row - 1, f->mi_col)
                           : DC_PRED;
    int left = f->avail_l ? MI(f->ymodes, f->mi_row, f->mi_col - 1)
                          : DC_PRED;
    f->ymode = sym(f, c->kf_y_mode[intra_mode_context[above]]
                   [intra_mode_context[left]], 13, ch->ymode);
    f->angle_y = 0;
    if (f->mi_sz >= BLOCK_8X8 && f->ymode >= V_PRED && f->ymode <= D67_PRED)
        f->angle_y = sym(f, c->angle_delta[f->ymode - V_PRED], 7,
                         ch->angle_y + 3) - 3;
    f->uvmode = DC_PRED;
    f->angle_uv = 0;
    f->cfl_u = f->cfl_v = 0;
    if (f->has_chroma) {
        /* lossless: CfL only where the chroma block is 4 x 4 */
        int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
        int cfl_ok = (bw >> f->ssx) <= 4 && (bh >> f->ssy) <= 4;
        f->uvmode = sym(f, c->uv_mode[cfl_ok][f->ymode], 13 + cfl_ok,
                        ch->uvmode);
        if (f->uvmode == UV_CFL_PRED) {
            int signs = sym(f, c->cfl_sign, 8, ch->cfl_signs);
            int su = (signs + 1) / 3, sv = (signs + 1) % 3;
            if (su) {
                int a = sym(f, c->cfl_alpha[(su - 1) * 3 + sv], 16,
                            abs(ch->cfl_u) - 1) + 1;
                f->cfl_u = su == 1 ? -a : a;
            }
            if (sv) {
                int a = sym(f, c->cfl_alpha[(sv - 1) * 3 + su], 16,
                            abs(ch->cfl_v) - 1) + 1;
                f->cfl_v = sv == 1 ? -a : a;
            }
        }
        if (f->mi_sz >= BLOCK_8X8 && f->uvmode >= V_PRED &&
            f->uvmode <= D67_PRED)
            f->angle_uv = sym(f, c->angle_delta[f->uvmode - V_PRED], 7,
                              ch->angle_uv + 3) - 3;
    }
    f->pal_y = f->pal_uv = 0;
    int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
    if (f->mi_sz >= BLOCK_8X8 && bw <= 64 && bh <= 64 && f->sct)
        palette_mode_info(f);
    f->use_filter_intra = 0;
    if (f->filter_intra_en && f->ymode == DC_PRED && f->pal_y == 0 &&
        (bw > bh ? bw : bh) <= 32) {
        f->use_filter_intra = sym(f, c->filter_intra[f->mi_sz], 2,
                                  ch->filter_intra);
        if (f->use_filter_intra)
            f->filter_intra_mode = sym(f, c->filter_intra_mode, 5,
                                       ch->filter_mode);
    }
}

static void decode_block(Av1 *f, int r, int c, int bsize)
{
    f->mi_row = r;
    f->mi_col = c;
    f->mi_sz = bsize;
    f->bw4 = 1 << bw4_log2[bsize];
    f->bh4 = 1 << bh4_log2[bsize];
    if (f->bh4 == 1 && f->ssy && (r & 1) == 0)
        f->has_chroma = 0;
    else if (f->bw4 == 1 && f->ssx && (c & 1) == 0)
        f->has_chroma = 0;
    else
        f->has_chroma = f->nplanes > 1;
    f->avail_u = is_inside(f, r - 1, c);
    f->avail_l = is_inside(f, r, c - 1);
    intra_frame_mode_info(f);
    palette_tokens(f);
    if (f->skip)
        for (int plane = 0; plane < 1 + 2 * f->has_chroma; plane++) {
            int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
            for (int i = c >> ssx; i < ((c + f->bw4 - 1) >> ssx) + 1; i++)
                f->above_level[plane][i] = f->above_dc[plane][i] = 0;
            for (int i = r >> ssy; i < ((r + f->bh4 - 1) >> ssy) + 1; i++)
                f->left_level[plane][i] = f->left_dc[plane][i] = 0;
        }
    for (int y = 0; y < f->bh4 && r + y < f->MiRows; y++)
        for (int x = 0; x < f->bw4 && c + x < f->MiCols; x++) {
            size_t k = (size_t)(r + y) * f->MiCols + c + x;
            f->ymodes[k] = (uint8_t)f->ymode;
            f->uvmodes[k] = (uint8_t)f->uvmode;
            f->skips[k] = (uint8_t)f->skip;
            f->mi_size[k] = (uint8_t)bsize;
            f->pal_sizes[0][k] = (uint8_t)f->pal_y;
            f->pal_sizes[1][k] = (uint8_t)f->pal_uv;
            memcpy(f->pal_colors[0] + k * 8, f->pal_y_colors, 16);
            memcpy(f->pal_colors[1] + k * 8, f->pal_u_colors, 16);
            f->is_inter[k] = (uint8_t)f->use_intrabc;
            f->written[k] = 1;
            f->mvs[2 * k] = (int16_t)f->mv_row;
            f->mvs[2 * k + 1] = (int16_t)f->mv_col;
        }
    if (f->use_intrabc)
        intrabc_predict(f);
    residual(f);
}

static const uint16_t *partition_probs(Av1 *f, int r, int c, int bsize,
                                       int *nsym)
{
    int bsl = bw4_log2[bsize];
    int above = f->avail_u &&
                bw4_log2[MI(f->mi_size, r - 1, c)] < bsl;
    int left = f->avail_l &&
               bh4_log2[MI(f->mi_size, r, c - 1)] < bsl;
    *nsym = bsize == BLOCK_8X8 ? 4 : bsize == BLOCK_128X128 ? 8 : 10;
    return f->cdf.partition[(bsl - 1) * 4 + left * 2 + above];
}

static void decode_partition(Av1 *f, int r, int c, int bsize)
{
    if (r >= f->MiRows || c >= f->MiCols)
        return;
    f->avail_u = is_inside(f, r - 1, c);
    f->avail_l = is_inside(f, r, c - 1);
    int n4 = 1 << bw4_log2[bsize], half = n4 >> 1, quarter = half >> 1;
    int has_rows = r + half < f->MiRows, has_cols = c + half < f->MiCols;
    int partition, nsym;
    int want = f->ec.writing ? enc_partition(f, r, c, bsize) : 0;
    if (bsize < BLOCK_8X8) {
        partition = PARTITION_NONE;
    } else if (has_rows && has_cols) {
        uint16_t *cdf = (uint16_t *)partition_probs(f, r, c, bsize, &nsym);
        partition = sym(f, cdf, nsym, want);
    } else if (has_cols || has_rows) {
        const uint16_t *p = partition_probs(f, r, c, bsize, &nsym);
#define PROB(k) ((k) ? p[k] - p[(k) - 1] : p[0])
        int psum;
        if (has_cols) /* split_or_horz */
            psum = PROB(PARTITION_VERT) + PROB(PARTITION_SPLIT) +
                   PROB(PARTITION_HORZ_A) + PROB(PARTITION_VERT_A) +
                   PROB(PARTITION_VERT_B) +
                   (bsize != BLOCK_128X128 ? PROB(PARTITION_VERT_4) : 0);
        else /* split_or_vert */
            psum = PROB(PARTITION_HORZ) + PROB(PARTITION_SPLIT) +
                   PROB(PARTITION_HORZ_A) + PROB(PARTITION_HORZ_B) +
                   PROB(PARTITION_VERT_A) +
                   (bsize != BLOCK_128X128 ? PROB(PARTITION_HORZ_4) : 0);
#undef PROB
        uint16_t tmp[3] = {(uint16_t)(32768 - psum), 32768, 0};
        int split = sym_fixed(f, tmp, 2, want == PARTITION_SPLIT);
        partition = split ? PARTITION_SPLIT
                          : has_cols ? PARTITION_HORZ : PARTITION_VERT;
    } else {
        partition = PARTITION_SPLIT;
    }
    int wl = bw4_log2[bsize], hl = bh4_log2[bsize];
    int sub, split = block_size(wl - 1, hl - 1);
    switch (partition) {
    case PARTITION_NONE: sub = bsize; break;
    case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B:
        sub = block_size(wl, hl - 1); break;
    case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B:
        sub = block_size(wl - 1, hl); break;
    case PARTITION_SPLIT: sub = split; break;
    case PARTITION_HORZ_4: sub = block_size(wl, hl - 2); break;
    default: sub = block_size(wl - 2, hl); break;
    }
    switch (partition) {
    case PARTITION_NONE:
        decode_block(f, r, c, sub);
        break;
    case PARTITION_HORZ:
        decode_block(f, r, c, sub);
        if (has_rows)
            decode_block(f, r + half, c, sub);
        break;
    case PARTITION_VERT:
        decode_block(f, r, c, sub);
        if (has_cols)
            decode_block(f, r, c + half, sub);
        break;
    case PARTITION_SPLIT:
        decode_partition(f, r, c, sub);
        decode_partition(f, r, c + half, sub);
        decode_partition(f, r + half, c, sub);
        decode_partition(f, r + half, c + half, sub);
        break;
    case PARTITION_HORZ_A:
        decode_block(f, r, c, split);
        decode_block(f, r, c + half, split);
        decode_block(f, r + half, c, sub);
        break;
    case PARTITION_HORZ_B:
        decode_block(f, r, c, sub);
        decode_block(f, r + half, c, split);
        decode_block(f, r + half, c + half, split);
        break;
    case PARTITION_VERT_A:
        decode_block(f, r, c, split);
        decode_block(f, r + half, c, split);
        decode_block(f, r, c + half, sub);
        break;
    case PARTITION_VERT_B:
        decode_block(f, r, c, sub);
        decode_block(f, r, c + half, split);
        decode_block(f, r + half, c + half, split);
        break;
    case PARTITION_HORZ_4:
        for (int k = 0; k < 4; k++)
            if (k < 3 || r + quarter * 3 < f->MiRows)
                decode_block(f, r + quarter * k, c, sub);
        break;
    default:
        for (int k = 0; k < 4; k++)
            if (k < 3 || c + quarter * 3 < f->MiCols)
                decode_block(f, r, c + quarter * k, sub);
        break;
    }
}

static void clear_block_decoded(Av1 *f, int r, int c, int sb4)
{
    for (int plane = 0; plane < f->nplanes; plane++) {
        int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
        int w4 = (f->mi_col_end - c) >> ssx, h4 = (f->mi_row_end - r) >> ssy;
        for (int y = -1; y <= (sb4 >> ssy); y++)
            for (int x = -1; x <= (sb4 >> ssx); x++) {
                int v = (y < 0 && x < w4) || (x < 0 && y < h4);
                f->decoded[plane][y + 1][x + 1] = (uint8_t)v;
            }
        f->decoded[plane][(sb4 >> ssy) + 1][0] = 0;
    }
}

/* one tile's superblocks, read or written; the tile's symbol coder is set
 * up by the caller */
static void code_tile(Av1 *f, int tile_row, int tile_col,
                      void (*superblock)(Av1 *, int, int))
{
    f->mi_row_start = f->row_starts[tile_row];
    f->mi_row_end = f->row_starts[tile_row + 1];
    f->mi_col_start = f->col_starts[tile_col];
    f->mi_col_end = f->col_starts[tile_col + 1];
    int sb4 = f->use128 ? 32 : 16;
    memcpy(&f->cdf, &f->cdf0, sizeof(Cdfs));
    for (int p = 0; p < f->nplanes; p++) {
        int ssx = p ? f->ssx : 0;
        memset(f->above_level[p] + (f->mi_col_start >> ssx), 0,
               (size_t)((f->mi_col_end - f->mi_col_start) >> ssx) + 34);
        memset(f->above_dc[p] + (f->mi_col_start >> ssx), 0,
               (size_t)((f->mi_col_end - f->mi_col_start) >> ssx) + 34);
    }
    for (int r = f->mi_row_start; r < f->mi_row_end; r += sb4) {
        for (int p = 0; p < f->nplanes; p++) {
            memset(f->left_level[p], 0, (size_t)f->MiRows + 34);
            memset(f->left_dc[p], 0, (size_t)f->MiRows + 34);
        }
        for (int c = f->mi_col_start; c < f->mi_col_end; c += sb4) {
            clear_block_decoded(f, r, c, sb4);
            superblock(f, r, c);
        }
    }
}

static void frame_alloc(Av1 *f)
{
    size_t n = (size_t)f->MiRows * f->MiCols;
    f->stride = f->MiCols * 4;
    f->rows = f->MiRows * 4;
    for (int p = 0; p < f->nplanes; p++) {
        f->plane[p] = av1_alloc(f, (size_t)f->stride * f->rows * 2);
        f->above_level[p] = av1_alloc(f, (size_t)f->MiCols + 68);
        f->above_dc[p] = av1_alloc(f, (size_t)f->MiCols + 68);
        f->left_level[p] = av1_alloc(f, (size_t)f->MiRows + 68);
        f->left_dc[p] = av1_alloc(f, (size_t)f->MiRows + 68);
    }
    f->mi_size = av1_alloc(f, n);
    f->is_inter = av1_alloc(f, n);
    f->written = av1_alloc(f, n);
    f->mvs = av1_alloc(f, n * 4);
    f->ymodes = av1_alloc(f, n);
    f->uvmodes = av1_alloc(f, n);
    f->skips = av1_alloc(f, n);
    for (int k = 0; k < 2; k++) {
        f->pal_sizes[k] = av1_alloc(f, n);
        f->pal_colors[k] = av1_alloc(f, n * 16);
    }
}

static void frame_free(Av1 *f)
{
    for (int p = 0; p < 3; p++) {
        free(f->plane[p]);
        free(f->above_level[p]);
        free(f->above_dc[p]);
        free(f->left_level[p]);
        free(f->left_dc[p]);
    }
    free(f->mi_size);
    free(f->is_inter);
    free(f->written);
    free(f->mvs);
    free(f->ymodes);
    free(f->uvmodes);
    free(f->skips);
    for (int k = 0; k < 2; k++) {
        free(f->pal_sizes[k]);
        free(f->pal_colors[k]);
        f->pal_sizes[k] = NULL;
        f->pal_colors[k] = NULL;
    }
    for (int p = 0; p < 3; p++)
        f->plane[p] = NULL, f->above_level[p] = f->above_dc[p] = NULL,
        f->left_level[p] = f->left_dc[p] = NULL;
    f->mi_size = f->is_inter = f->written = NULL;
    f->ymodes = f->uvmodes = f->skips = NULL;
    f->mvs = NULL;
}

#endif
