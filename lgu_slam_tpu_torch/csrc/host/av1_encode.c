/* An AV1 still-image writer, for the fixtures of the port's AVIF reader
 * (data/avif.py encode_av1 / encode_avif) on machines without an AVIF
 * encoder.
 *
 * It writes a sequence header (reduced still picture header, or a full
 * one, 64 x 64 or 128 x 128 superblocks, filter intra and the intra edge
 * filter on; profile 0 for gray and 4:2:0, 1 for 4:4:4 colour, 2 at 12
 * bits and for 4:2:2; the colour description given) and one frame OBU.
 * Its tiles go through the same block syntax as the decoder (av1_core.h)
 * with the symbol coder writing.
 *
 * Lossless frames (base_q_idx 0): each superblock is split down to 32 x
 * 32, then a partition and intra modes are picked for each node from a
 * hash of the seed and the position (every partition of 16 x 16 and 8 x 8
 * nodes, the thirteen y modes with angle deltas, uv modes with CfL,
 * filter intra), the residual of each 4 x 4 block is transformed by the
 * exact inverse of the decoder's Walsh-Hadamard lifting and coded with
 * the decoder's contexts.  Colour is 4:4:4 (under the identity matrix by
 * default), 4:2:0 or 4:2:2 (no partition a 4:2:2 chroma block cannot
 * follow).
 *
 * Lossy frames: 4:4:4, 4:2:0 or 4:2:2 colour (or gray), blocks of one size
 * (8, 16 or 32; smaller at the frame's edges) with TX_MODE_LARGEST, so
 * one DCT_DCT transform per block and plane; y modes and filter intra
 * from the hash, uv modes DC, D45 or CfL (whose chroma transform is
 * DCT_DCT); the residual's DCT quantised by the caller's base_q_idx and
 * quantiser matrix level; deblocking levels and sharpness, CDEF damping
 * and strengths (the index of each 64 x 64 unit from the hash) as given;
 * loop restoration of a given type per plane, unit size and lr_uv_shift,
 * each unit's Wiener taps or self-guided set and projection taken in
 * turn from the caller's list (lr[]).  The writer reconstructs with the
 * decoder's own inverse transforms and in-loop filters, and returns that
 * reconstruction.
 *
 * Film grain: the sequence header allows it and the frame carries the
 * grain given (any of libaom's test vectors, or one changed: lags 0-3,
 * chroma scaling from luma, overlap, the clip), which a decoder adds to
 * the shown frame (the reconstruction returned is without it).
 *
 * Segmentation: each segment's features as given (alt q, the four loop
 * filter levels, skip), each block's segment from the hash up to the
 * last segment with a feature; a lossless segment takes the 4 x 4 WHT.
 * Superres: the frame coded at 8 / SuperresDenom of its width (at least
 * 16 samples), its columns sampled from the source's, upscaled by the
 * shared filters; uniform tile columns.  Full headers (not the reduced
 * still picture header): a key or intra-only frame, shown or not,
 * showable, its refresh_frame_flags, a size below the sequence's largest
 * (frame_size_override), screen content tools on; items of several
 * frames are these frames' OBUs in a row (data/avif.py frames_av1).
 * Intra block copy (screen content tools on, no in-loop filter): two
 * blocks in three copy from the first valid of eight vectors up and left
 * (odd ones give half chroma samples); a lossy frame then selects
 * transform sizes (tx_depth 0, no split of the variable partition) and
 * writes DCT_DCT of the inter sets.
 *
 * Entry points (ctypes):
 *   av1_encode(planes, nplanes, H, W, depth, seed, opts, lr, grain, out,
 *              cap, size, recon, err, errlen): planes Y [H][W] then U, V
 *     at their subsampled size, uint16; opts NULL (lossless 4:4:4) or
 *     int32 [OPT_COUNT] (below); lr NULL (no restoration) or int32: the
 *     number of units of Y, U and V, then theirs, LR_FIELDS each; grain
 *     NULL (none) or int32 [162] in aom_film_grain_t's order; writes the
 *     OBUs to out, their length to *size, and, where recon is not NULL,
 *     the reconstruction in the planes' layout;
 *   av1_grain_vector(k, v[162]): libaom's film grain test vector k.
 */
#include <math.h>

#include "av1_core.h"

typedef struct {
    uint8_t *p;
    int64_t cap, pos; /* bits */
    Av1 *f;
} Put;

static void put(Put *w, uint32_t v, int n)
{
    for (int i = n - 1; i >= 0; i--) {
        if ((w->pos >> 3) >= w->cap)
            av1_fail(w->f, ERR_MEMORY, "writer: output buffer full");
        uint8_t *b = w->p + (w->pos >> 3);
        if ((w->pos & 7) == 0)
            *b = 0;
        *b |= (uint8_t)(((v >> i) & 1) << (7 - (w->pos & 7)));
        w->pos++;
    }
}

static void trailing(Put *w)
{
    put(w, 1, 1);
    while (w->pos & 7)
        put(w, 0, 1);
}

static uint32_t hash(uint32_t a, uint32_t b, uint32_t c, uint32_t d)
{
    uint32_t h = a * 0x9E3779B1u ^ (b + 0x7F4A7C15u) * 0x85EBCA77u;
    h ^= (c + 0x165667B1u) * 0xC2B2AE3Du;
    h ^= (d + 0x27D4EB2Fu) * 0x27D4EB2Du;
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    return h;
}

/* the writer's options (opts[]) */
enum {
    OPT_SUBSAMPLED, /* 0: 4:4:4, 1: 4:2:0, 2: 4:2:2 */
    OPT_BASE_Q,     /* base_q_idx, 0 lossless */
    OPT_QM,         /* quantiser matrix level, 15 none */
    OPT_BLOCK_LOG2, /* lossy blocks and transforms: 3, 4 or 5 */
    OPT_LF0, OPT_LF1, OPT_LF2, OPT_LF3, OPT_SHARPNESS,
    OPT_CDEF_DAMPING, /* 3 .. 6 */
    OPT_CDEF_COUNT,   /* 0 (CDEF off), 1, 2, 4 or 8 strengths */
    OPT_CDEF,         /* 8 x (y pri, y sec, uv pri, uv sec) */
    OPT_CP = OPT_CDEF + 32, OPT_TC, OPT_MC, /* the colour description */
    OPT_FULL_RANGE,
    OPT_SB128,        /* 128 x 128 superblocks */
    OPT_LR,           /* FrameRestorationType of Y, U and V */
    OPT_LR_UNIT_SHIFT = OPT_LR + 3, OPT_LR_UV_SHIFT,
    OPT_SEG,          /* segmentation_enabled */
    OPT_SEG_FEATURES, /* 8 segments x 8 features x (enabled, value) */
    OPT_FULL = OPT_SEG_FEATURES + 128, /* full headers (not reduced) */
    OPT_MAX_W, OPT_MAX_H, /* the sequence's largest frame; 0: this one */
    OPT_FRAME_TYPE,   /* 0 key, 2 intra-only (full headers) */
    OPT_SHOW_FRAME, OPT_SHOWABLE, OPT_REFRESH, /* (full headers) */
    OPT_SUPERRES,     /* SuperresDenom 9-16, 0 none */
    OPT_TILE_COLS_LOG2, /* 0: one tile column */
    OPT_SCT,          /* allow_screen_content_tools (full headers) */
    OPT_INTRABC,      /* allow_intrabc (screen content tools on) */
    OPT_COUNT
};

/* the fields of one restoration unit in lr[] (after the three counts):
 * restoration_type, the Wiener taps 0-2 of the vertical then the
 * horizontal pass, the self-guided set, its xqd[2] */
#define LR_FIELDS 10

/* unit k (raster order) of a plane takes the plane's (k mod count)-th
 * unit of lr[] */
static const LrUnit *enc_lr_unit(Av1 *f, int plane, int row, int col)
{
    const int32_t *lr = f->enc_lr;
    int start = 3;
    for (int p = 0; p < plane; p++)
        start += lr[p] * LR_FIELDS;
    const int32_t *e = lr + start + ((row * f->lr_cols[plane] + col) %
                                     lr[plane]) * LR_FIELDS;
    LrUnit *u = &f->enc_unit;
    int type = f->lr_type[plane];
    if (e[0] < 0 || e[0] > 2 || (type != RESTORE_SWITCHABLE && e[0] &&
                                 e[0] != type) || e[7] < 0 || e[7] > 15)
        av1_fail(f, ERR_VALUE, "writer: a restoration unit of type %d in "
                 "a plane of type %d, or set %d", e[0], type, e[7]);
    u->type = e[0];
    for (int pass = 0; pass < 2; pass++)
        for (int i = 0; i < 3; i++)
            u->wiener[pass][i] = e[1 + 3 * pass + i];
    u->sgr_set = e[7];
    u->xqd[0] = e[8];
    u->xqd[1] = e[9];
    return u;
}

/* a block's segment: from the hash, up to LastActiveSegId */
static int enc_segment(Av1 *f)
{
    return (int)(hash(f->enc_seed, (uint32_t)f->mi_row, (uint32_t)f->mi_col,
                      91u) % (uint32_t)(f->seg_last + 1));
}

static int enc_cdef(Av1 *f, int r, int c)
{
    return (int)(hash(f->enc_seed, (uint32_t)r, (uint32_t)c, 77u) %
                 (1u << f->cdef_bits));
}

static int enc_partition(Av1 *f, int r, int c, int bsize)
{
    int n4 = 1 << bw4_log2[bsize], half = n4 >> 1;
    int has_rows = r + half < f->MiRows, has_cols = c + half < f->MiCols;
    uint32_t h = hash(f->enc_seed, (uint32_t)r, (uint32_t)c, (uint32_t)bsize);
    if (!f->lossless) /* one block size, smaller at the edges */
        return bw4_log2[bsize] + 2 > f->enc_block_log2 || !has_rows ||
               !has_cols ? PARTITION_SPLIT : PARTITION_NONE;
    if (bsize > 9) /* 64 x 64: split */
        return PARTITION_SPLIT;
    /* 4:2:2 has no chroma block for a block taller than wide */
    int narrow = f->ssx && !f->ssy;
    if (!has_rows || !has_cols)
        return h & 1 || (narrow && !has_cols) ? PARTITION_SPLIT
               : has_cols ? PARTITION_HORZ : PARTITION_VERT;
    if (bsize == 9) /* 32 x 32 */
        return h % 4 ? PARTITION_SPLIT : PARTITION_NONE;
    int p = bsize == BLOCK_8X8 ? (int)(h % 4) : (int)(h % 10);
    if (narrow && (p == PARTITION_VERT || p == PARTITION_VERT_A ||
                   p == PARTITION_VERT_B || p == PARTITION_VERT_4))
        p = PARTITION_SPLIT;
    return p;
}

static Choice *enc_choice(Av1 *f)
{
    Choice *ch = &f->enc_choice;
    uint32_t h = hash(f->enc_seed ^ 0x5bd1e995u, (uint32_t)f->mi_row,
                      (uint32_t)f->mi_col, (uint32_t)f->mi_sz);
    uint32_t h2 = hash(h, 1, 2, 3);
    int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
    memset(ch, 0, sizeof(*ch));
    ch->ymode = (int)(h % 13);
    ch->angle_y = (int)((h >> 8) % 7) - 3;
    if (ch->ymode == DC_PRED && (bw > bh ? bw : bh) <= 32 &&
        f->filter_intra_en && (h >> 12) & 1) {
        ch->filter_intra = 1;
        ch->filter_mode = (int)((h >> 13) % 5);
    }
    int cfl_ok = f->blk_lossless ? plane_bsize(f->mi_sz, f->ssx, f->ssy) ==
                 BLOCK_4X4 : bw <= 32 && bh <= 32;
    ch->uvmode = (int)(h2 % (13u + (uint32_t)cfl_ok));
    if (!f->lossless) { /* modes whose chroma transform is DCT_DCT */
        static const uint8_t dct_modes[3] = {DC_PRED, D45_PRED, UV_CFL_PRED};
        ch->uvmode = dct_modes[h2 % (2u + (uint32_t)cfl_ok)];
    }
    ch->angle_uv = (int)((h2 >> 8) % 7) - 3;
    ch->cfl_signs = (int)((h2 >> 12) % 8);
    int su = (ch->cfl_signs + 1) / 3, sv = (ch->cfl_signs + 1) % 3;
    int au = 1 + (int)((h2 >> 16) % 16), av = 1 + (int)((h2 >> 20) % 16);
    ch->cfl_u = su ? (su == 1 ? -au : au) : 0;
    ch->cfl_v = sv ? (sv == 1 ? -av : av) : 0;
    /* intra block copy in two blocks of three, from the first valid of
     * vectors (in samples) at least 2 superblock rows up or 4 columns
     * left, as libaom's delay wants; odd ones give half chroma samples */
    static const int16_t dvs[8][2] = {{-128, 0}, {-128, -5}, {-131, 3},
                                      {-192, 7}, {0, -256}, {-3, -261},
                                      {-64, -320}, {-197, -1}};
    for (int k = 0; f->allow_intrabc && h2 % 3 && k < 8; k++) {
        int j = (k + (int)(h2 >> 24)) & 7;
        if (dv_valid(f, dvs[j][0] * 8, dvs[j][1] * 8)) {
            ch->intrabc = 1;
            ch->dv_row = dvs[j][0] * 8;
            ch->dv_col = dvs[j][1] * 8;
            break;
        }
    }
    return ch;
}

static void fwht_1d(int32_t *t)
{
    /* the inverse of iwht_1d (shift 0): [a, b, c, d] -> its input */
    int32_t A = t[0], B = t[1], C = t[2], D = t[3];
    int32_t d1 = D - C, a1 = A + B, e = (a1 - d1) >> 1;
    int32_t c0 = e - C, b0 = e - B;
    t[0] = a1 - c0;
    t[1] = c0;
    t[2] = d1 + b0;
    t[3] = b0;
}

/* the source sample of a plane at (x, y), the edge's past the frame's
 * edge (as good as any) */
static int32_t source(Av1 *f, int plane, int x, int y)
{
    int w = plane ? (f->W + f->ssx) >> f->ssx : f->W;
    int uw = plane ? (f->up_w + f->ssx) >> f->ssx : f->up_w;
    int h = plane ? (f->H + f->ssy) >> f->ssy : f->H;
    x = x < w ? x : w - 1;
    /* under superres the coded frame samples the source's columns */
    x = (int)((int64_t)x * uw / w);
    return f->src[plane][(size_t)(y < h ? y : h - 1) * uw + x];
}

static void forward_wht(Av1 *f, int plane, int x, int y)
{
    int32_t r[4][4];
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
            r[i][j] = source(f, plane, x + j, y + i) -
                      PX(plane, y + i, x + j);
    for (int j = 0; j < 4; j++) {
        int32_t t[4] = {r[0][j], r[1][j], r[2][j], r[3][j]};
        fwht_1d(t);
        for (int i = 0; i < 4; i++)
            r[i][j] = t[i];
    }
    for (int i = 0; i < 4; i++) {
        fwht_1d(r[i]);
        for (int j = 0; j < 4; j++)
            f->quant[i * 4 + j] = r[i][j];
    }
}

/* the residual's orthonormal DCT scaled to the decoder's coefficients
 * (2^(row shift + 4) * 2 / sqrt(W H), times sqrt(2) for 2:1 shapes),
 * quantised to the dequantisers of DCT_DCT */
static void forward_tx(Av1 *f, int plane, int x, int y, int t)
{
    if (f->blk_lossless) {
        forward_wht(f, plane, x, y);
        return;
    }
    double res[32][32], tmp[32][32];
    int32_t qv[32 * 32];
    int wl = tx_wl[t], hl = tx_hl[t], W = 1 << wl, H = 1 << hl;
    for (int i = 0; i < H; i++)
        for (int j = 0; j < W; j++)
            res[i][j] = source(f, plane, x + j, y + i) -
                        PX(plane, y + i, x + j);
    for (int i = 0; i < H; i++)
        for (int k = 0; k < W; k++) {
            double v = 0;
            for (int j = 0; j < W; j++)
                v += res[i][j] * cos(3.14159265358979323846 * (2 * j + 1) *
                                     k / (2.0 * W));
            tmp[i][k] = v * sqrt((k ? 2.0 : 1.0) / W);
        }
    double scale = (double)(1 << (row_shift[t] + 4)) * 2.0 / sqrt(W * H);
    if (wl - hl == 1 || hl - wl == 1)
        scale *= sqrt(2.0);
    int pels = W * H, shift = (pels > 256) + (pels > 1024);
    dequantisers(f, plane, t, DCT_DCT, qv);
    for (int k = 0; k < H; k++)
        for (int l = 0; l < W; l++) {
            double v = 0;
            for (int i = 0; i < H; i++)
                v += tmp[i][l] * cos(3.14159265358979323846 * (2 * i + 1) *
                                     k / (2.0 * H));
            v *= sqrt((k ? 2.0 : 1.0) / H) * scale * (1 << shift) /
                 qv[k * W + l];
            long level = lround(v);
            level = level > 16383 ? 16383 : level < -16383 ? -16383 : level;
            f->quant[k * W + l] = (int32_t)level;
        }
}

static void encode_superblock(Av1 *f, int r, int c)
{
    decode_partition(f, r, c, f->use128 ? BLOCK_128X128 : BLOCK_64X64);
}

static void obu(Put *w, int type, const uint8_t *payload, int64_t n)
{
    put(w, (uint32_t)(type << 3 | 2), 8);
    uint64_t v = (uint64_t)n;
    do {
        uint32_t byte = v & 0x7F;
        v >>= 7;
        put(w, byte | (v ? 0x80u : 0), 8);
    } while (v);
    for (int64_t k = 0; k < n; k++)
        put(w, payload[k], 8);
}

/* a field of at most n bits, or the writer refuses the grain */
static void put_field(Put *w, int v, int n)
{
    if (v < 0 || v >= 1 << n)
        av1_fail(w->f, ERR_VALUE, "writer: a film grain field of %d bits "
                 "holds %d", n, v);
    put(w, (uint32_t)v, n);
}

/* film_grain_params with apply_grain set, of a grain in the ints of
 * libaom's aom_film_grain_t (av1_tables.h film_grain_test_vectors; its
 * bit depth is ignored): the fields the frame's format reads, as given
 * (a grain a decoder refuses too: more points than it allows, points
 * that do not increase) */
static void put_grain(Put *h, const int32_t *v, int mono, int sub420)
{
    int ny = v[30], ncb = v[51], ncr = v[72], lag = v[74];
    int from_luma = mono ? 0 : v[159];
    if (ny > 15 || ncb > 15 || ncr > 15)
        av1_fail(h->f, ERR_VALUE, "writer: more than 15 film grain points");
    put(h, 1, 1); /* apply_grain */
    put_field(h, v[161], 16);
    put_field(h, ny, 4);
    for (int i = 0; i < 2 * ny; i++)
        put_field(h, v[2 + i], 8);
    if (!mono)
        put_field(h, from_luma, 1);
    if (mono || from_luma || (sub420 && !ny)) {
        ncb = ncr = 0;
    } else {
        put_field(h, ncb, 4);
        for (int i = 0; i < 2 * ncb; i++)
            put_field(h, v[31 + i], 8);
        put_field(h, ncr, 4);
        for (int i = 0; i < 2 * ncr; i++)
            put_field(h, v[52 + i], 8);
    }
    put_field(h, v[73] - 8, 2); /* grain_scaling_minus_8 */
    put_field(h, lag, 2);
    int luma = 2 * lag * (lag + 1), chroma = luma + (ny > 0);
    for (int i = 0; ny && i < luma; i++)
        put_field(h, v[75 + i] + 128, 8);
    for (int i = 0; (ncb || from_luma) && i < chroma; i++)
        put_field(h, v[99 + i] + 128, 8);
    for (int i = 0; (ncr || from_luma) && i < chroma; i++)
        put_field(h, v[124 + i] + 128, 8);
    put_field(h, v[149] - 6, 2); /* ar_coeff_shift_minus_6 */
    put_field(h, v[160], 2);     /* grain_scale_shift */
    for (int k = 0; k < 2; k++)
        if (k ? ncr : ncb) {
            put_field(h, v[150 + 3 * k], 8);
            put_field(h, v[151 + 3 * k], 8);
            put_field(h, v[152 + 3 * k], 9);
        }
    put_field(h, v[156], 1); /* overlap_flag */
    put_field(h, v[157], 1); /* clip_to_restricted_range */
}

/* libaom's film grain test vector k (1-16) in aom_film_grain_t's ints */
int av1_grain_vector(int k, int32_t *v)
{
    if (k < 1 || k > 16)
        return ERR_VALUE;
    memcpy(v, film_grain_test_vectors[k - 1], 162 * sizeof(int32_t));
    return ERR_OK;
}

int av1_encode(const uint16_t *planes, int nplanes, int64_t H, int64_t W,
               int depth, int seed, const int32_t *opts, const int32_t *lr,
               const int32_t *grain, uint8_t *out, int64_t cap,
               int64_t *size, uint16_t *recon, char *err, int errlen)
{
    Av1 *f = calloc(1, sizeof(Av1));
    uint8_t *hdr = malloc(512);
    uint8_t *volatile tile = NULL; /* kept across longjmp */
    uint16_t *volatile pre = NULL;
    if (!f || !hdr) {
        free(f);
        free(hdr);
        return ERR_MEMORY;
    }
    f->err = err;
    f->errlen = errlen;
    int code = setjmp(f->jb);
    if (code == 0) {
        int32_t none[OPT_COUNT] = {0};
        none[OPT_QM] = 15;
        none[OPT_CP] = none[OPT_TC] = 2;
        none[OPT_FULL_RANGE] = 1;
        const int32_t *o = opts ? opts : none;
        static const int32_t no_units[3] = {0, 0, 0};
        int sub = o[OPT_SUBSAMPLED], bq = o[OPT_BASE_Q];
        static const int seg_max[8] = {255, 63, 63, 63, 63, 7, 0, 0};
        if (bq < 0 || bq > 255)
            av1_fail(f, ERR_VALUE, "writer: base_q_idx 0-255");
        f->base_q = bq;
        f->seg_enabled = o[OPT_SEG] != 0;
        for (int i = 0; f->seg_enabled && i < 64; i++) {
            int on = o[OPT_SEG_FEATURES + 2 * i];
            int v = o[OPT_SEG_FEATURES + 2 * i + 1], j = i & 7;
            if (on && (v < (j < 5 ? -seg_max[j] : 0) || v > seg_max[j] ||
                       j == SEG_LVL_REF_FRAME || j == 7))
                av1_fail(f, ERR_VALUE, "writer: segment feature %d of %d",
                         j, v);
            f->seg_mask[i >> 3] |= (on != 0) << j;
            f->seg_data[i >> 3][j] = on ? v : 0;
        }
        seg_setup(f, 0);
        int lossy = !f->lossless;
        int ncdef = lossy ? o[OPT_CDEF_COUNT] : 0;
        if (W < 1 || H < 1 || W > 4096 || ((W + 63) / 64) * ((H + 63) / 64)
            > 2304 || (nplanes != 1 && nplanes != 3) ||
            (depth != 8 && depth != 10 && depth != 12) || sub < 0 ||
            sub > 2)
            av1_fail(f, ERR_VALUE, "writer: 1 or 3 planes of at most 4096 "
                     "samples a row and 2304 superblocks, 8, 10 or 12 "
                     "bits, 4:4:4, 4:2:0 or 4:2:2");
        if (o[OPT_QM] < 0 || o[OPT_QM] > 15 ||
            (lossy && (o[OPT_BLOCK_LOG2] < 3 ||
            o[OPT_BLOCK_LOG2] > 5)) || o[OPT_CDEF_DAMPING] < 0 ||
            o[OPT_CDEF_DAMPING] > 6 || (ncdef && o[OPT_CDEF_DAMPING] < 3) ||
            (ncdef != 0 && ncdef != 1 && ncdef != 2 && ncdef != 4 &&
             ncdef != 8) || o[OPT_SHARPNESS] < 0 || o[OPT_SHARPNESS] > 7)
            av1_fail(f, ERR_VALUE, "writer: options out of range (lossy "
                     "blocks of 8, 16 or 32)");
        for (int i = 0; i < 4; i++)
            if (o[OPT_LF0 + i] < 0 || o[OPT_LF0 + i] > 63)
                av1_fail(f, ERR_VALUE, "writer: a loop filter level past 63");
        for (int i = 0; i < 4 * ncdef; i++) {
            int v = o[OPT_CDEF + i];
            if (v < 0 || v > ((i & 1) ? 4 : 15) || ((i & 1) && v == 3))
                av1_fail(f, ERR_VALUE, "writer: CDEF strengths are 0-15, "
                         "secondary 0, 1, 2 or 4");
        }
        int mono = nplanes == 1, use128 = o[OPT_SB128] != 0;
        int cp = o[OPT_CP], tc = o[OPT_TC], mc = o[OPT_MC];
        /* BT.709 primaries, sRGB transfer and the identity matrix: the
         * sequence header then holds no range or subsampling (full range,
         * 4:4:4) */
        int srgb = cp == 1 && tc == 13 && mc == 0;
        int profile = depth == 12 || sub == 2 ? 2 : mono || sub ? 0 : 1;
        if (cp < 0 || cp > 255 || tc < 0 || tc > 255 || mc < 0 ||
            mc > 255 || (mc == 0 && sub) || (srgb && (mono || !o[
            OPT_FULL_RANGE])))
            av1_fail(f, ERR_VALUE, "writer: a colour description AV1 does "
                     "not allow (identity is 4:4:4)");
        /* superres: the coded width (av1_decode.c's frame header) */
        int denom = o[OPT_SUPERRES], coded = (int)W, full = o[OPT_FULL];
        if (denom && (denom < 9 || denom > 16))
            av1_fail(f, ERR_VALUE, "writer: SuperresDenom 9-16");
        if (denom) {
            coded = ((int)W * 8 + denom / 2) / denom;
            coded = coded < (W < 16 ? W : 16) ? (int)(W < 16 ? W : 16)
                                              : coded;
        }
        int all_lossless = f->lossless && coded == W;
        int max_w = o[OPT_MAX_W] ? o[OPT_MAX_W] : (int)W;
        int max_h = o[OPT_MAX_H] ? o[OPT_MAX_H] : (int)H;
        int ftype = full ? o[OPT_FRAME_TYPE] : 0;
        int show = full ? o[OPT_SHOW_FRAME] : 1, intrabc = o[OPT_INTRABC];
        int sct = (full && o[OPT_SCT]) || intrabc;
        int refresh = ftype == 0 && show ? 0xFF : o[OPT_REFRESH];
        if (max_w < W || max_h < H || max_w > 65536 || max_h > 65536 ||
            (!full && (max_w != W || max_h != H)) || (ftype != 0 &&
            ftype != 2) || refresh < 0 || refresh > 255 ||
            (ftype == 2 && refresh == 0xFF) || (intrabc && (coded != W ||
            ncdef || o[OPT_LR] || o[OPT_LR + 1] || o[OPT_LR + 2] ||
            o[OPT_LF0] || o[OPT_LF0 + 1])))
            av1_fail(f, ERR_VALUE, "writer: a frame inside the sequence's "
                     "largest, a key or intra-only frame (full headers), "
                     "refresh_frame_flags of 8 bits (not all intra-only), "
                     "intra block copy without superres or in-loop filters");
        int lr_used = 0, lr_chroma = 0;
        for (int p = 0; p < 3; p++) {
            int t = o[OPT_LR + p];
            if (t < 0 || t > 3 || (t && (all_lossless || p >= nplanes)))
                av1_fail(f, ERR_VALUE, "writer: restoration types are 0-3, "
                         "in a frame that is not all lossless");
            lr_used |= t != 0;
            lr_chroma |= p && t;
            f->lr_type[p] = t;
        }
        if (lr_used && (o[OPT_LR_UNIT_SHIFT] < use128 ||
                        o[OPT_LR_UNIT_SHIFT] > 2 || o[OPT_LR_UV_SHIFT] < 0 ||
                        o[OPT_LR_UV_SHIFT] > (sub == 1 && lr_chroma)))
            av1_fail(f, ERR_VALUE, "writer: lr_unit_shift 0-2 (1-2 with 128 "
                     "x 128 superblocks), lr_uv_shift 0-1 (restored 4:2:0 "
                     "chroma)");
        for (int p = 0; p < 3; p++)
            if (f->lr_type[p] && (!lr || lr[p] < 1))
                av1_fail(f, ERR_VALUE, "writer: a restored plane without "
                         "its units");
        f->enc_lr = lr ? lr : no_units;
        Put w = {out, cap, 0, f};
        /* the sequence header: reduced, or with one operating point, no
         * timing, frame ids or order hints; screen content tools off, or
         * on (integer vectors) with sct */
        Put s = {hdr, 512, 0, f};
        put(&s, (uint32_t)profile, 3);
        put(&s, !full, 1); /* still_picture */
        put(&s, !full, 1); /* reduced_still_picture_header */
        if (full) {
            put(&s, 0, 1); /* timing_info_present_flag */
            put(&s, 0, 1); /* initial_display_delay_present_flag */
            put(&s, 0, 5); /* operating_points_cnt_minus_1 */
            put(&s, 0, 12); /* operating_point_idc[0] */
        }
        put(&s, 31, 5); /* seq_level_idx: no level */
        if (full)
            put(&s, 0, 1); /* seq_tier */
        put(&s, 15, 4);
        put(&s, 15, 4);
        put(&s, (uint32_t)(max_w - 1), 16);
        put(&s, (uint32_t)(max_h - 1), 16);
        if (full)
            put(&s, 0, 1); /* frame_id_numbers_present_flag */
        put(&s, (uint32_t)use128, 1); /* use_128x128_superblock */
        put(&s, 1, 1); /* enable_filter_intra */
        put(&s, 1, 1); /* enable_intra_edge_filter */
        if (full) {
            put(&s, 0, 4); /* inter tools */
            put(&s, 0, 1); /* enable_order_hint */
            put(&s, 0, 1); /* seq_choose_screen_content_tools */
            put(&s, (uint32_t)sct, 1); /* seq_force_screen_content_tools */
            if (sct) {
                put(&s, 0, 1); /* seq_choose_integer_mv */
                put(&s, 1, 1); /* seq_force_integer_mv */
            }
        }
        put(&s, denom != 0, 1); /* enable_superres */
        put(&s, ncdef > 0, 1); /* enable_cdef */
        put(&s, (uint32_t)lr_used, 1); /* enable_restoration */
        put(&s, depth > 8, 1);
        if (profile == 2 && depth > 8)
            put(&s, depth == 12, 1);
        if (profile != 1)
            put(&s, (uint32_t)mono, 1);
        put(&s, 1, 1); /* color_description_present_flag */
        put(&s, (uint32_t)cp, 8);
        put(&s, (uint32_t)tc, 8);
        put(&s, (uint32_t)mc, 8);
        if (!srgb)
            put(&s, o[OPT_FULL_RANGE] != 0, 1); /* color_range */
        if (!mono && !srgb) {
            if (profile == 2 && depth == 12) {
                put(&s, sub != 0, 1); /* subsampling_x */
                if (sub)
                    put(&s, sub == 1, 1); /* subsampling_y */
            }
            if (sub == 1)
                put(&s, 0, 2); /* chroma_sample_position */
        }
        if (!mono)
            put(&s, 0, 1); /* separate_uv_delta_q */
        put(&s, grain != NULL, 1); /* film_grain_params_present */
        trailing(&s);
        obu(&w, 1, hdr, s.pos >> 3);
        /* the frame */
        f->W = coded;
        f->up_w = (int)W;
        f->superres_denom = denom ? denom : 8;
        f->H = (int)H;
        f->MiCols = 2 * ((coded + 7) >> 3);
        f->MiRows = 2 * (((int)H + 7) >> 3);
        f->nplanes = nplanes;
        f->bitdepth = depth;
        f->ssx = mono || sub;
        f->ssy = mono || sub == 1;
        f->use128 = use128;
        f->sct = sct;
        f->allow_intrabc = intrabc != 0;
        /* intra block copy's variable transform partition is read where
         * the frame selects transform sizes */
        f->tx_mode_select = intrabc && lossy;
        if (lr_used) {
            f->lr_unit_shift = o[OPT_LR_UNIT_SHIFT];
            f->lr_uv_shift = o[OPT_LR_UV_SHIFT];
            f->lr_size[0] = 256 >> (2 - f->lr_unit_shift);
            f->lr_size[1] = f->lr_size[2] = f->lr_size[0] >> f->lr_uv_shift;
        }
        f->filter_intra_en = f->edge_filter_en = 1;
        /* uniform tile columns (av1_decode.c's tile_info), one tile row */
        int sb_shift = use128 ? 5 : 4;
        int sbc = (f->MiCols + (1 << sb_shift) - 1) >> sb_shift;
        int sbr = (f->MiRows + (1 << sb_shift) - 1) >> sb_shift;
        int maxc = 0, maxr = 0, cols_log2 = o[OPT_TILE_COLS_LOG2];
        while ((1 << maxc) < (sbc < 64 ? sbc : 64))
            maxc++;
        while ((1 << maxr) < (sbr < 64 ? sbr : 64))
            maxr++;
        if (cols_log2 < 0 || cols_log2 > maxc || sbc > 4096 >> (sb_shift + 2))
            av1_fail(f, ERR_VALUE, "writer: tile_cols_log2 %d of at most %d "
                     "(and one tile row)", cols_log2, maxc);
        int tw = (sbc + (1 << cols_log2) - 1) >> cols_log2, ntiles = 0;
        for (int c = 0; c < sbc; c += tw)
            f->col_starts[ntiles++] = c << sb_shift;
        f->col_starts[ntiles] = f->MiCols;
        f->tile_cols = ntiles;
        f->tile_rows = 1;
        f->row_starts[1] = f->MiRows;
        f->enc_block_log2 = o[OPT_BLOCK_LOG2];
        f->qm_level[0] = f->qm_level[1] = f->qm_level[2] =
            lossy ? o[OPT_QM] : 15;
        if (lossy) {
            for (int i = 0; i < 4; i++)
                f->lf_level[i] = o[OPT_LF0 + i];
            if (mono || (!f->lf_level[0] && !f->lf_level[1]))
                f->lf_level[2] = f->lf_level[3] = 0;
            f->lf_sharpness = o[OPT_SHARPNESS];
            f->cdef_en = ncdef > 0;
            f->cdef_damping = o[OPT_CDEF_DAMPING];
            f->cdef_bits = ncdef == 8 ? 3 : ncdef == 4 ? 2 : ncdef == 2;
            for (int i = 0; i < ncdef; i++) {
                f->cdef_pri[0][i] = o[OPT_CDEF + 4 * i];
                f->cdef_sec[0][i] = o[OPT_CDEF + 4 * i + 1];
                f->cdef_pri[1][i] = o[OPT_CDEF + 4 * i + 2];
                f->cdef_sec[1][i] = o[OPT_CDEF + 4 * i + 3];
            }
        }
        size_t hw = (size_t)H * W;
        size_t cw = (size_t)((H + f->ssy) >> f->ssy) * ((W + f->ssx) >> f->ssx);
        for (int p = 0; p < nplanes; p++)
            f->src[p] = planes + (p ? hw + (p - 1) * cw : 0);
        frame_alloc(f);
        cdfs_init(&f->cdf0, bq <= 20 ? 0 : bq <= 60 ? 1 : bq <= 120 ? 2 : 3);
        /* each tile's symbols, then its bytes after the last one's */
        int64_t tcap = 8 * nplanes * H * W + 1024, tn = 0;
        pre = malloc((size_t)tcap * 2);
        tile = malloc((size_t)tcap);
        if (!pre || !tile)
            av1_fail(f, ERR_MEMORY, "out of memory");
        f->enc_seed = (uint32_t)seed;
        for (int t = 0; t < ntiles; t++) {
            int64_t at = tn + (t < ntiles - 1 ? 4 : 0);
            ec_enc_init(&f->ec, pre, tcap);
            code_tile(f, 0, t, encode_superblock);
            int64_t k = ec_enc_done(&f->ec, tile + at, tcap - at);
            if (k < 0)
                av1_fail(f, ERR_MEMORY, "writer: tile buffer full");
            for (int i = 0; i < 4 && t < ntiles - 1; i++)
                tile[tn + i] = (uint8_t)((k - 1) >> (8 * i));
            tn = at + k;
        }
        postfilter(f);
        Put h = {hdr, 512, 0, f};
        if (full) {
            put(&h, 0, 1); /* show_existing_frame */
            put(&h, (uint32_t)ftype, 2);
            put(&h, (uint32_t)show, 1);
            if (!show)
                put(&h, o[OPT_SHOWABLE] != 0, 1); /* showable_frame */
            if (!(ftype == 0 && show))
                put(&h, 0, 1); /* error_resilient_mode */
        }
        put(&h, 0, 1); /* disable_cdf_update */
        if (full) {
            put(&h, max_w != W || max_h != H, 1); /* frame_size_override */
            if (!(ftype == 0 && show))
                put(&h, (uint32_t)refresh, 8); /* refresh_frame_flags */
            if (max_w != W || max_h != H) {
                put(&h, (uint32_t)(W - 1), 16);
                put(&h, (uint32_t)(H - 1), 16);
            }
        } else {
            put(&h, (uint32_t)sct, 1); /* allow_screen_content_tools */
            if (sct)
                put(&h, 1, 1); /* force_integer_mv */
        }
        if (denom) {
            put(&h, 1, 1); /* use_superres */
            put(&h, (uint32_t)(denom - 9), 3);
        }
        put(&h, 0, 1); /* render_and_frame_size_different */
        if (sct && coded == W)
            put(&h, (uint32_t)f->allow_intrabc, 1); /* allow_intrabc */
        if (full)
            put(&h, 1, 1); /* disable_frame_end_update_cdf */
        put(&h, 1, 1); /* uniform_tile_spacing_flag */
        for (int i = 0; i < cols_log2; i++)
            put(&h, 1, 1); /* increment_tile_cols_log2 */
        if (cols_log2 < maxc)
            put(&h, 0, 1);
        if (maxr > 0)
            put(&h, 0, 1); /* increment_tile_rows_log2 */
        if (cols_log2) {
            put(&h, 0, (int)cols_log2); /* context_update_tile_id */
            put(&h, 3, 2); /* tile_size_bytes_minus_1 */
        }
        put(&h, (uint32_t)bq, 8); /* base_q_idx */
        put(&h, 0, 1); /* DeltaQYDc */
        if (!mono) {
            put(&h, 0, 1); /* DeltaQUDc */
            put(&h, 0, 1); /* DeltaQUAc */
        }
        put(&h, lossy && o[OPT_QM] < 15, 1); /* using_qmatrix */
        if (lossy && o[OPT_QM] < 15) {
            put(&h, (uint32_t)o[OPT_QM], 4); /* qm_y */
            put(&h, (uint32_t)o[OPT_QM], 4); /* qm_u */
        }
        put(&h, (uint32_t)f->seg_enabled, 1); /* segmentation_enabled */
        for (int i = 0; f->seg_enabled && i < 8; i++)
            for (int j = 0; j < 8; j++) {
                static const int bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
                int on = f->seg_mask[i] >> j & 1, v = f->seg_data[i][j];
                put(&h, (uint32_t)on, 1);
                if (on && j < 5)
                    put(&h, (uint32_t)v & ((2u << bits[j]) - 1),
                        1 + bits[j]);
                else if (on)
                    put(&h, (uint32_t)v, bits[j]);
            }
        if (bq)
            put(&h, 0, 1); /* delta_q_present */
        if (lossy && !intrabc) {
            put(&h, (uint32_t)f->lf_level[0], 6);
            put(&h, (uint32_t)f->lf_level[1], 6);
            if (!mono && (f->lf_level[0] || f->lf_level[1])) {
                put(&h, (uint32_t)f->lf_level[2], 6);
                put(&h, (uint32_t)f->lf_level[3], 6);
            }
            put(&h, (uint32_t)f->lf_sharpness, 3);
            put(&h, 0, 1); /* loop_filter_delta_enabled */
            if (ncdef) {
                put(&h, (uint32_t)(f->cdef_damping - 3), 2);
                put(&h, (uint32_t)f->cdef_bits, 2);
                for (int i = 0; i < ncdef; i++)
                    for (int p = 0; p < (mono ? 1 : 2); p++) {
                        put(&h, (uint32_t)f->cdef_pri[p][i], 4);
                        put(&h, (uint32_t)(f->cdef_sec[p][i] == 4 ? 3
                                           : f->cdef_sec[p][i]), 2);
                    }
            }
        }
        if (lr_used && !intrabc) { /* lr_params: lr_type of Remap_Lr_Type */
            static const int coded_type[4] = {0, 2, 3, 1};
            for (int p = 0; p < nplanes; p++)
                put(&h, (uint32_t)coded_type[f->lr_type[p]], 2);
            if (use128) {
                put(&h, (uint32_t)(f->lr_unit_shift - 1), 1);
            } else {
                put(&h, f->lr_unit_shift > 0, 1);
                if (f->lr_unit_shift)
                    put(&h, f->lr_unit_shift > 1, 1);
            }
            if (sub == 1 && lr_chroma)
                put(&h, (uint32_t)f->lr_uv_shift, 1);
        }
        if (lossy)
            put(&h, (uint32_t)f->tx_mode_select, 1); /* tx_mode_select */
        put(&h, 0, 1); /* reduced_tx_set */
        if (grain && (show || o[OPT_SHOWABLE]))
            put_grain(&h, grain, mono, sub == 1);
        else if (grain)
            av1_fail(f, ERR_VALUE, "writer: film grain on a frame that is "
                     "neither shown nor showable");
        while (h.pos & 7)
            put(&h, 0, 1);
        if (ntiles > 1) /* the tile group: tile_start_and_end_present_flag */
            put(&h, 0, 8);
        int64_t hn = h.pos >> 3;
        uint8_t *frame = malloc((size_t)(hn + tn));
        if (!frame)
            av1_fail(f, ERR_MEMORY, "out of memory");
        memcpy(frame, hdr, (size_t)hn);
        memcpy(frame + hn, (uint8_t *)tile, (size_t)tn);
        free(tile);
        tile = frame;
        obu(&w, 6, frame, hn + tn);
        *size = w.pos >> 3;
        if (recon)
            for (int p = 0; p < nplanes; p++) {
                int pw = p ? (f->W + f->ssx) >> f->ssx : f->W;
                int ph = p ? (f->H + f->ssy) >> f->ssy : f->H;
                uint16_t *dst = recon + (p ? hw + (p - 1) * cw : 0);
                for (int y = 0; y < ph; y++)
                    memcpy(dst + (size_t)y * pw,
                           f->plane[p] + (size_t)y * f->stride,
                           (size_t)pw * 2);
            }
    }
    frame_free(f);
    free(f);
    free(hdr);
    free(tile);
    free(pre);
    return code;
}
