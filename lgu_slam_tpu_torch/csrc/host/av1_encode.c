/* A lossless AV1 still-image writer, for the fixtures of the port's AVIF
 * reader (data/avif.py encode_av1 / encode_avif) on machines without an
 * AVIF encoder.
 *
 * It writes a sequence header (reduced still picture header, 64 x 64
 * superblocks, filter intra and the intra edge filter on, no CDEF,
 * restoration or superres; profile 0 for gray, 1 for 4:4:4 colour, 2 at 12
 * bits) and one frame OBU: base_q_idx 0 (coded lossless), one tile.  The
 * tile goes through the same block syntax as the decoder (av1_core.h) with
 * the symbol coder writing: each superblock is split down to 32 x 32, then
 * a partition and intra modes are picked for each node from a hash of the
 * seed and the position (every partition of 16 x 16 and 8 x 8 nodes, the
 * thirteen y modes with angle deltas, uv modes with CfL, filter intra),
 * the residual of each 4 x 4 block is transformed by the exact inverse of
 * the decoder's Walsh-Hadamard lifting and coded with the decoder's
 * contexts.
 *
 * Entry point (ctypes):
 *   av1_encode(planes, nplanes, H, W, depth, seed, out, cap, size, err,
 *              errlen): planes [nplanes][H][W] uint16 (Y or Y, U, V);
 *     writes the OBUs to out, their length to *size.
 */
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

static int enc_partition(Av1 *f, int r, int c, int bsize)
{
    int n4 = 1 << bw4_log2[bsize], half = n4 >> 1;
    int has_rows = r + half < f->MiRows, has_cols = c + half < f->MiCols;
    uint32_t h = hash(f->enc_seed, (uint32_t)r, (uint32_t)c, (uint32_t)bsize);
    if (bsize > 9) /* 64 x 64: split */
        return PARTITION_SPLIT;
    if (!has_rows || !has_cols)
        return h & 1 ? PARTITION_SPLIT : has_cols ? PARTITION_HORZ
                                                  : PARTITION_VERT;
    if (bsize == 9) /* 32 x 32 */
        return h % 4 ? PARTITION_SPLIT : PARTITION_NONE;
    if (bsize == BLOCK_8X8)
        return (int)(h % 4);
    return (int)(h % 10);
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
    int cfl_ok = (bw >> f->ssx) <= 4 && (bh >> f->ssy) <= 4;
    ch->uvmode = (int)(h2 % (13u + (uint32_t)cfl_ok));
    ch->angle_uv = (int)((h2 >> 8) % 7) - 3;
    ch->cfl_signs = (int)((h2 >> 12) % 8);
    int su = (ch->cfl_signs + 1) / 3, sv = (ch->cfl_signs + 1) % 3;
    int au = 1 + (int)((h2 >> 16) % 16), av = 1 + (int)((h2 >> 20) % 16);
    ch->cfl_u = su ? (su == 1 ? -au : au) : 0;
    ch->cfl_v = sv ? (sv == 1 ? -av : av) : 0;
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

static void forward_wht(Av1 *f, int plane, int x, int y)
{
    int32_t r[4][4];
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) {
            int sy = y + i < f->H ? y + i : f->H - 1;
            int sx = x + j < f->W ? x + j : f->W - 1;
            /* past the frame's edge: the edge sample, as good as any */
            r[i][j] = (int32_t)f->src[plane][(size_t)sy * f->W + sx] -
                      PX(plane, y + i, x + j);
        }
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

static void encode_superblock(Av1 *f, int r, int c)
{
    decode_partition(f, r, c, BLOCK_64X64);
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

int av1_encode(const uint16_t *planes, int nplanes, int64_t H, int64_t W,
               int depth, int seed, uint8_t *out, int64_t cap, int64_t *size,
               char *err, int errlen)
{
    Av1 *f = calloc(1, sizeof(Av1));
    uint8_t *hdr = malloc(64);
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
        if (W < 1 || H < 1 || W > 4096 || ((W + 63) / 64) * ((H + 63) / 64)
            > 2304 || (nplanes != 1 && nplanes != 3) ||
            (depth != 8 && depth != 10 && depth != 12))
            av1_fail(f, ERR_VALUE, "writer: 1 or 3 planes of at most 4096 "
                     "samples a row and 2304 superblocks, 8, 10 or 12 bits");
        int mono = nplanes == 1;
        int profile = depth == 12 ? 2 : mono ? 0 : 1;
        Put w = {out, cap, 0, f};
        /* the sequence header */
        Put s = {hdr, 64, 0, f};
        put(&s, (uint32_t)profile, 3);
        put(&s, 1, 1); /* still_picture */
        put(&s, 1, 1); /* reduced_still_picture_header */
        put(&s, 31, 5); /* seq_level_idx: no level */
        put(&s, 15, 4);
        put(&s, 15, 4);
        put(&s, (uint32_t)(W - 1), 16);
        put(&s, (uint32_t)(H - 1), 16);
        put(&s, 0, 1); /* use_128x128_superblock */
        put(&s, 1, 1); /* enable_filter_intra */
        put(&s, 1, 1); /* enable_intra_edge_filter */
        put(&s, 0, 1); /* enable_superres */
        put(&s, 0, 1); /* enable_cdef */
        put(&s, 0, 1); /* enable_restoration */
        put(&s, depth > 8, 1);
        if (profile == 2)
            put(&s, depth == 12, 1);
        if (profile != 1)
            put(&s, (uint32_t)mono, 1);
        put(&s, 1, 1); /* color_description_present_flag */
        put(&s, 2, 8);
        put(&s, 2, 8);
        put(&s, mono ? 2 : 0, 8); /* identity for colour */
        put(&s, 1, 1); /* color_range: full */
        if (!mono) {
            if (profile == 2)
                put(&s, 0, 1); /* subsampling_x */
            put(&s, 0, 1); /* separate_uv_delta_q */
        }
        put(&s, 0, 1); /* film_grain_params_present */
        trailing(&s);
        obu(&w, 1, hdr, s.pos >> 3);
        /* the frame */
        f->W = (int)W;
        f->H = (int)H;
        f->MiCols = 2 * (((int)W + 7) >> 3);
        f->MiRows = 2 * (((int)H + 7) >> 3);
        f->nplanes = nplanes;
        f->bitdepth = depth;
        f->ssx = f->ssy = mono;
        f->filter_intra_en = f->edge_filter_en = 1;
        f->tile_cols = f->tile_rows = 1;
        f->col_starts[1] = f->MiCols;
        f->row_starts[1] = f->MiRows;
        for (int p = 0; p < nplanes; p++)
            f->src[p] = planes + (size_t)p * H * W;
        frame_alloc(f);
        cdfs_init(&f->cdf0, 0);
        int64_t tcap = 8 * nplanes * H * W + 1024;
        pre = malloc((size_t)tcap * 2);
        tile = malloc((size_t)tcap);
        if (!pre || !tile)
            av1_fail(f, ERR_MEMORY, "out of memory");
        ec_enc_init(&f->ec, pre, tcap);
        f->enc_seed = (uint32_t)seed;
        code_tile(f, 0, 0, encode_superblock);
        int64_t tn = ec_enc_done(&f->ec, tile, tcap);
        if (tn < 0)
            av1_fail(f, ERR_MEMORY, "writer: tile buffer full");
        Put h = {hdr, 64, 0, f};
        put(&h, 0, 1); /* disable_cdf_update */
        put(&h, 0, 1); /* allow_screen_content_tools */
        put(&h, 0, 1); /* render_and_frame_size_different */
        put(&h, 1, 1); /* uniform_tile_spacing_flag */
        int sbc = (f->MiCols + 15) >> 4, sbr = (f->MiRows + 15) >> 4;
        int maxc = 0, maxr = 0;
        while ((1 << maxc) < (sbc < 64 ? sbc : 64))
            maxc++;
        while ((1 << maxr) < (sbr < 64 ? sbr : 64))
            maxr++;
        if (maxc > 0)
            put(&h, 0, 1); /* increment_tile_cols_log2 */
        if (maxr > 0)
            put(&h, 0, 1); /* increment_tile_rows_log2 */
        put(&h, 0, 8); /* base_q_idx */
        put(&h, 0, 1); /* DeltaQYDc */
        if (!mono) {
            put(&h, 0, 1); /* DeltaQUDc */
            put(&h, 0, 1); /* DeltaQUAc */
        }
        put(&h, 0, 1); /* using_qmatrix */
        put(&h, 0, 1); /* segmentation_enabled */
        put(&h, 0, 1); /* reduced_tx_set */
        while (h.pos & 7)
            put(&h, 0, 1);
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
    }
    frame_free(f);
    free(f);
    free(hdr);
    free(tile);
    free(pre);
    return code;
}
