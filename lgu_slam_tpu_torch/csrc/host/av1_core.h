/* The AV1 tile syntax, shared by the decoder (av1_decode.c) and the
 * fixture writer (av1_encode.c), and the in-loop filters and superres of a
 * frame; the inter blocks of inter frames are av1_inter.h's, which this
 * file includes.
 *
 * One implementation of the block syntax serves both: each symbol goes
 * through sym(), which decodes it (libaom's od_ec decoder, 32-bit window)
 * or, in a writer, encodes the value the writer chose (libaom's od_ec
 * encoder); the CDFs adapt alike on both sides.  Reconstruction follows the
 * AV1 specification (section 7.11: every intra predictor, the edge filter
 * and upsampling, CfL, palette, intra block copy with libaom's bilinear
 * chroma; 5.11.9 and 7.12.2: segment ids and each segment's qindex,
 * lossless flag and loop filter levels; 7.12-7.13: dequantisation with
 * quantiser matrices and delta q, the inverse Walsh-Hadamard transform of
 * lossless blocks and every DCT / ADST / identity size of lossy ones,
 * clamped where libaom clamps, the intra and inter (intra block copy)
 * transform sets and an intra block copy block's variable transform
 * partition; 7.14-7.15: deblocking and CDEF; 7.16: superres, as libaom's
 * av1_upscale_normative_rows; 7.17: loop restoration, the units'
 * coefficients read with each superblock (5.11.57-58), the Wiener and
 * self-guided filters as libaom's restoration.c computes them) over
 * 16-bit planes of MiCols * 4 x MiRows * 4 samples (and room for
 * transform blocks that reach past them), chroma at 4:4:4, 4:2:2 or
 * 4:2:0.
 *
 * An intra frame holds nothing this file does not read (film grain is
 * added to the shown frame by av1_grain.h); an inter frame's blocks go to
 * av1_inter.h, and deblocking takes their reference and mode deltas and
 * skips the inner edges of skipped inter blocks.  Errors unwind with
 * longjmp to the entry point, which frees what the frame allocated.
 */
#ifndef AV1_CORE_H
#define AV1_CORE_H

#include <setjmp.h>
#include <stddef.h>
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
/* Size_Group: the y mode context of an inter frame's intra blocks */
static const uint8_t size_group[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                                       3, 3, 3, 3, 0, 0, 1, 1, 2, 2};
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
    uint16_t eob_pt32[2][2][7];
    uint16_t eob_pt64[2][2][8];
    uint16_t eob_pt128[2][2][9];
    uint16_t eob_pt256[2][2][10];
    uint16_t eob_pt512[2][2][11];
    uint16_t eob_pt1024[2][2][12];
    uint16_t intra_ext_tx[3][4][13][17];
    uint16_t inter_ext_tx[4][4][17];
    uint16_t txfm_partition[21][3];
    uint16_t spatial_pred_seg[3][9];
    uint16_t tx_8x8[3][3];
    uint16_t tx[3][3][4];
    uint16_t delta_q[5];
    uint16_t delta_lf[5];
    uint16_t delta_lf_multi[4][5];
    uint16_t mv[143];
    uint16_t switchable_restore[4];
    uint16_t wiener_restore[3];
    uint16_t sgrproj_restore[3];
    /* inter frames (mv_inter: the vectors of inter blocks, mv's layout) */
    uint16_t y_mode[4][14];
    uint16_t intra_inter[4][3];
    uint16_t comp_inter[5][3];
    uint16_t single_ref[3][6][3];
    uint16_t skip_mode[3][3];
    uint16_t newmv[6][3], zeromv[2][3], refmv[6][3], drl[3][3];
    uint16_t interintra[4][3], interintra_mode[4][5];
    uint16_t wedge_interintra[22][3], wedge_idx[22][17];
    uint16_t motion_mode[22][4], obmc[22][3];
    uint16_t interp[16][4];
    uint16_t seg_pred[3][3];
    uint16_t mv_inter[143];
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
    CP(eob_pt32, eob_pt32_cdf[qctx]);
    CP(eob_pt64, eob_pt64_cdf[qctx]);
    CP(eob_pt128, eob_pt128_cdf[qctx]);
    CP(eob_pt256, eob_pt256_cdf[qctx]);
    CP(eob_pt512, eob_pt512_cdf[qctx]);
    CP(eob_pt1024, eob_pt1024_cdf[qctx]);
    CP(intra_ext_tx, intra_ext_tx_cdf);
    CP(inter_ext_tx, inter_ext_tx_cdf);
    CP(txfm_partition, txfm_partition_cdf);
    CP(spatial_pred_seg, spatial_pred_seg_cdf);
    CP(tx_8x8, tx_8x8_cdf);
    CP(tx, tx_cdf);
    CP(delta_q, delta_q_cdf);
    CP(delta_lf, delta_lf_cdf);
    CP(delta_lf_multi, delta_lf_multi_cdf);
    CP(mv, mv_cdf);
    CP(switchable_restore, switchable_restore_cdf);
    CP(wiener_restore, wiener_restore_cdf);
    CP(sgrproj_restore, sgrproj_restore_cdf);
    CP(y_mode, y_mode_cdf);
    CP(intra_inter, intra_inter_cdf);
    CP(comp_inter, comp_inter_cdf);
    CP(single_ref, single_ref_cdf);
    CP(skip_mode, skip_mode_cdf);
    CP(newmv, newmv_cdf);
    CP(zeromv, zeromv_cdf);
    CP(refmv, refmv_cdf);
    CP(drl, drl_cdf);
    CP(interintra, interintra_cdf);
    CP(interintra_mode, interintra_mode_cdf);
    CP(wedge_interintra, wedge_interintra_cdf);
    CP(wedge_idx, wedge_idx_cdf);
    CP(motion_mode, motion_mode_cdf);
    CP(obmc, obmc_cdf);
    CP(interp, switchable_interp_cdf);
    CP(seg_pred, seg_pred_cdf);
    CP(mv_inter, mv_cdf);
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

/* every CDF's adaptation counter cleared (libaom's
 * av1_reset_cdf_symbol_counters): a row holds its cumulative counts below
 * 32768, then 32768, then its counter, then 32768s up to its width */
static void cdfs_clear_counts(void *cdfs, size_t bytes)
{
    uint16_t *p = cdfs;
    size_t n = bytes / 2;
    int in_row = 1;
    for (size_t i = 0; i < n; i++) {
        if (p[i] == 32768) {
            if (in_row && i + 1 < n)
                p[++i] = 0;
            in_row = 0;
        } else {
            in_row = 1;
        }
    }
}

/* -- the frame ------------------------------------------------------------ */

#define MAX_TILES 64

typedef struct Av1 Av1;
struct Frame; /* a decoded frame a reference slot holds (av1_decode.c) */

/* film_grain_params of a frame (5.9.30): the scaling points (x, y) of
 * each plane, the auto-regressive coefficients less 128, the shifts with
 * their offsets added (scaling 8-11, AR 6-9) */
typedef struct {
    int apply, seed, ny, ncb, ncr, from_luma;
    int pts_y[14][2], pts_cb[10][2], pts_cr[10][2];
    int scaling_shift, lag, ar_y[24], ar_cb[25], ar_cr[25], ar_shift;
    int grain_scale_shift, cb_mult, cb_luma_mult, cb_offset;
    int cr_mult, cr_luma_mult, cr_offset, overlap, clip;
} Grain;

/* a writer's choices for one block (av1_encode.c) */
typedef struct {
    int ymode, uvmode, angle_y, angle_uv, filter_intra, filter_mode;
    int cfl_signs, cfl_u, cfl_v, skip;
    int intrabc, dv_row, dv_col; /* an intra block copy vector, 1/8 sample */
} Choice;

/* a reference frame of an inter frame (the slot ref_frame_idx names):
 * its planes, UpscaledWidth and FrameHeight, MiRows / MiCols, whether it
 * is an intra frame, its OrderHint and the OrderHints of its own
 * references, its motion field (7.19: per 8 x 8 unit, the reference
 * frame, -1 none, and the vector); the scale factors of the current
 * frame's prediction from it (REF_SCALE_SHIFT 14), 0 where invalid */
typedef struct {
    const uint16_t *plane[3];
    int stride, up_w, h, mi_rows, mi_cols, intra, order_hint;
    int saved_hints[8];
    const int8_t *mf_ref;
    const int16_t *mf_mv;
    int xs, ys;
} RefView;

/* FrameRestorationType and a unit's restoration_type */
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

/* one loop restoration unit: its type, the Wiener taps 0-2 of each pass
 * (0 vertical, 1 horizontal; tap 0 is 0 for chroma), the self-guided set
 * and its projection xqd */
typedef struct {
    int type, wiener[2][3], sgr_set, xqd[2];
} LrUnit;

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
    int seq_seen, frame_id_delta;
    /* the reference slots, the frame to output; frame ids; a sequence
     * header that changed (the next frame must be a key frame) */
    struct Frame *slot[8], *shown;
    int ref_id[8], ref_valid[8], frame_id, first_frame, seq_changed;
    const uint8_t *seq;
    int64_t seq_size;
    /* frame header; W is the coded width until superres upscales the
     * frame to up_w (UpscaledWidth), SuperresDenom (8: none) */
    int W, H, MiCols, MiRows, nplanes, up_w, superres_denom;
    int sct, allow_intrabc, disable_cdf_update, reduced_tx_set, base_q;
    int frame_type, show_frame, showable, refresh, show_existing, existing;
    int lossless, tx_mode_select, qm_level[3], dq_dc[3], dq_ac[3];
    /* segmentation: each segment's features (a mask of SEG_LVL_*) and
     * their values, SegIdPreSkip, LastActiveSegId; each segment's qindex
     * (base_q_idx and its feature, without delta q) and whether it is
     * lossless */
    int seg_enabled, seg_mask[8], seg_data[8][8], seg_preskip, seg_last;
    int seg_qindex[8], seg_lossless[8];
    int delta_q_present, delta_q_res, delta_lf_present, delta_lf_res;
    int delta_lf_multi;
    int lf_level[4], lf_sharpness, lf_delta_enabled;
    int cdef_damping, cdef_bits, cdef_pri[2][8], cdef_sec[2][8];
    /* loop restoration: FrameRestorationType, LoopRestorationSize and the
     * unit grid of each plane */
    int lr_type[3], lr_unit_shift, lr_uv_shift, lr_size[3];
    int lr_rows[3], lr_cols[3];
    int tile_cols, tile_rows, tile_cols_log2, tile_rows_log2;
    int col_starts[MAX_TILES + 1], row_starts[MAX_TILES + 1];
    int tile_size_bytes, context_update_tile_id;
    int temporal_id, spatial_id;
    /* the operating point (libavif's a1op) and the spatial layer to
     * output (lsel; -1: the last frame shown) */
    int op_point, want_layer;
    /* inter frames: the sequence's inter tools; the frame's header
     * (FrameIsIntra's negation, OrderHint, primary_ref_frame,
     * ref_frame_idx and OrderHints by reference frame 1-7,
     * RefFrameSignBias, ...), the loop filter's reference and mode deltas,
     * global motion (gm: the warp parameters of each reference frame,
     * prev_gm: PrevGmParams; gm_valid: its shear is valid), the
     * segmentation map's update flags, the references and the previous
     * segment ids (NULL: none) */
    int enable_order_hint, enable_dual_filter, enable_ref_frame_mvs;
    int enable_warped, enable_interintra;
    int inter_frame, order_hint, primary_ref, ref_idx[8], order_hints[8];
    int sign_bias[8], ref_side[8];
    int force_intmv, allow_hp, interp_filter, switchable_motion;
    int use_ref_mvs, ref_select, skip_mode_present, allow_warp;
    int disable_end_update;
    int lf_ref[8], lf_mode[2];
    int32_t gm[8][6], prev_gm[8][6];
    int gm_type[8], gm_valid[8];
    int seg_update_map, seg_temporal;
    RefView ref[8];
    const uint8_t *prev_seg;
    /* the motion field of use_ref_frame_mvs (per 8 x 8 unit: the
     * projected vector, -32768 none, and its reference's offset), the
     * frame's own field to save (per 8 x 8 unit) */
    int16_t *tpl_mv;
    int8_t *tpl_off, *save_ref;
    int16_t *save_mv;
    int mf_rows, mf_cols;
    /* the CDFs at the end of the tile context_update_tile_id names */
    Cdfs cdf_end;
    /* inter prediction's intermediate rows and its block */
    int32_t *pred_tmp;
    uint16_t *pred_blk;
    /* the time spent in inter prediction, where the includer sets
     * LR_CLOCK */
    double inter_ms;
    /* the inter frames' blocks by tool (av1_decode_ms): inter, intra,
     * NEWMV, GLOBALMV, OBMC, local warp, global warp, inter-intra, wedge
     * inter-intra, predictions from a scaled reference, chroma predicted
     * from several luma blocks, two interpolation filters; motion field
     * units projected; temporal candidates added to a vector stack */
    int32_t tools[14];
    /* the first tool read that no layered item here exercises (NULL:
     * none), refused once the decode has ended (av1_refuse) */
    const char *refused;
    Grain grain;
    /* film grain's templates and noise stripes while it runs; its time
     * (where the includer sets LR_CLOCK) */
    int16_t *grain_buf[9];
    double grain_ms;
    /* the planes output: the shown frame's, or a copy with its grain */
    uint16_t *out[3], *grained[3];
    /* planes of MiCols * 4 x MiRows * 4 samples, and room for transform
     * blocks that reach past them */
    uint16_t *plane[3];
    int stride, rows;
    /* per 4 x 4 (mode info) unit */
    uint8_t *mi_size, *ymodes, *uvmodes, *skips, *pal_sizes[2];
    uint8_t *is_inter, *written, *txsizes;
    /* per unit of inter frames: the reference frames (2; -1 none), the
     * interpolation filters (y, x), seg_id_predicted */
    int8_t *ref_frames;
    uint8_t *filters, *seg_preds;
    /* per 4 x 4 luma unit: the transform size of an intra block copy
     * block's variable partition, the luma transform type (chroma's of an
     * intra block copy block) */
    uint8_t *vtx, *tx_types;
    uint8_t *seg_ids; /* segment_id */
    int8_t *delta_lfs; /* 4 per unit */
    /* per 4 x 4 unit of each plane: the loop filter's transform size */
    uint8_t *lf_tx[3];
    /* per 64 x 64 unit: the CDEF strength index, -1 unread */
    int8_t *cdef_idx;
    int cdef_cols;
    /* per restoration unit of each plane; the references of the tile */
    LrUnit *lr_units[3];
    int ref_wiener[3][2][3], ref_xqd[3][2];
    /* the deblocked planes before CDEF (restoration reads them at stripe
     * edges), and restoration's stripe buffer */
    uint16_t *pre_cdef[3];
    int32_t *lr_buf;
    double lr_ms; /* time in lr_frame, where the includer sets LR_CLOCK */
    double superres_ms; /* time in superres_upscale, likewise */
    uint16_t *pal_colors[2];
    /* the vectors of each unit's two reference lists (row, col), 1/8
     * sample (an intra block copy vector in the first) */
    int16_t *mvs;
    /* contexts */
    uint8_t *above_level[3], *above_dc[3], *left_level[3], *left_dc[3];
    /* the transform width above and height left of each 4 x 4 unit in
     * samples (libaom's txfm contexts) */
    uint8_t *above_txfm, *left_txfm;
    uint8_t decoded[3][34][34];
    Cdfs cdf, cdf0;
    Ec ec;
    /* the tile */
    int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
    /* the block */
    int mi_row, mi_col, mi_sz, bw4, bh4, has_chroma;
    int avail_u, avail_l, avail_u_uv, avail_l_uv, txsz;
    int qindex, read_deltas, delta_lf[4], blk_lossless, segment_id, blk_q;
    int skip, ymode, uvmode, angle_y, angle_uv, use_filter_intra;
    int filter_intra_mode, cfl_u, cfl_v, pal_y, pal_uv, use_intrabc;
    int mv_row, mv_col;
    /* an inter block (inter: an inter block or intra block copy, to the
     * transform syntax): its reference frames, vectors, filters (y, x),
     * motion mode, inter-intra, the neighbours' reference frames, the
     * local warp and its validity */
    int inter, blk_inter, ref_frame[2], mv[2][2], filt[2], motion_mode;
    int interintra, ii_mode, wedge_ii, wedge_idx;
    int above_ref[2], left_ref[2];
    int32_t lw[6];
    int lw_valid;
    uint16_t pal_y_colors[8], pal_u_colors[8], pal_v_colors[8];
    uint8_t map_y[64 * 64], map_uv[64 * 64];
    int max_luma_w, max_luma_h;
    int32_t quant[32 * 32]; /* row-major, at most 32 x 32 */
    int plane_tx_type;
    /* a writer: its source planes, its choice of each block's modes */
    const uint16_t *src[3];
    uint32_t enc_seed;
    int enc_block_log2;
    Choice enc_choice;
    const int32_t *enc_lr; /* per plane: the count, then the units */
    LrUnit enc_unit;
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

/* a tool no layered item here exercises, where it is read: the decode
 * goes on, so that a damaged stream still fails where libaom fails, and
 * a full decode that ends ends in ERR_NOTIMPL naming the first such tool
 * (decode_obus) */
static void av1_refuse(Av1 *f, const char *what)
{
    if (!f->refused)
        f->refused = what;
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

/* get_filter_type: the above or left block is smooth; for chroma, the
 * blocks that hold the chroma above and left */
static int filter_type(Av1 *f, int plane)
{
    int above = 0, left = 0;
    uint8_t *modes = plane ? f->uvmodes : f->ymodes;
    if (plane ? f->avail_u_uv : f->avail_u) {
        int r = f->mi_row - 1, c = f->mi_col;
        if (plane && f->ssx && !(f->mi_col & 1))
            c++;
        if (plane && f->ssy && (f->mi_row & 1))
            r--;
        above = is_smooth_mode(MI(modes, r, c));
    }
    if (plane ? f->avail_l_uv : f->avail_l) {
        int r = f->mi_row, c = f->mi_col - 1;
        if (plane && f->ssx && (f->mi_col & 1))
            c--;
        if (plane && f->ssy && !(f->mi_row & 1))
            r++;
        left = is_smooth_mode(MI(modes, r, c));
    }
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

/* -- transform sizes and types (specification 5.11.15-16, 6.10.19) ------ */

enum {
    TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16,
    TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4,
    TX_8X32, TX_32X8, TX_16X64, TX_64X16
};
enum {
    DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
    V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
enum { T_DCT, T_ADST, T_FLIPADST, T_IDTX };

static const uint8_t tx_wl[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2,
                                  4, 3, 5, 4, 6};
static const uint8_t tx_hl[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4,
                                  2, 5, 3, 6, 4};
/* each transform type's vertical (column) and horizontal (row) kernel */
static const uint8_t tx_vtype[16] = {
    T_DCT, T_ADST, T_DCT, T_ADST, T_FLIPADST, T_DCT, T_FLIPADST, T_ADST,
    T_FLIPADST, T_IDTX, T_DCT, T_IDTX, T_ADST, T_IDTX, T_FLIPADST, T_IDTX};
static const uint8_t tx_htype[16] = {
    T_DCT, T_DCT, T_ADST, T_ADST, T_DCT, T_FLIPADST, T_FLIPADST, T_FLIPADST,
    T_ADST, T_IDTX, T_IDTX, T_DCT, T_IDTX, T_ADST, T_IDTX, T_FLIPADST};
static const uint8_t filter_intra_dir[5] = {DC_PRED, V_PRED, H_PRED,
                                            D157_PRED, DC_PRED};

static int tx_of(int wl, int hl)
{
    for (int t = 0; t < 19; t++)
        if (tx_wl[t] == wl && tx_hl[t] == hl)
            return t;
    return -1;
}

/* the largest transform of a block, at most 64 x 64 */
static int max_tx_rect(int bsize)
{
    int wl = bw4_log2[bsize] + 2, hl = bh4_log2[bsize] + 2;
    return tx_of(wl > 6 ? 6 : wl, hl > 6 ? 6 : hl);
}

static int split_tx(int t)
{
    int wl = tx_wl[t], hl = tx_hl[t];
    if (wl == hl)
        return wl == 2 ? t : tx_of(wl - 1, hl - 1);
    if (wl - hl == 1 || hl - wl == 1)
        return wl < hl ? tx_of(wl, wl) : tx_of(hl, hl);
    return wl > hl ? tx_of(wl - 1, hl) : tx_of(wl, hl - 1);
}

/* a block's size in a plane subsampled by (ssx, ssy) (Subsampled_Size),
 * -1 where AV1 has none (a tall block at 4:2:2) */
static int plane_bsize(int bsize, int ssx, int ssy)
{
    int wl = bw4_log2[bsize], hl = bh4_log2[bsize];
    if ((ssx && !ssy && hl > wl) || (!ssx && ssy && wl > hl))
        return -1;
    wl -= ssx;
    hl -= ssy;
    return block_size(wl < 0 ? 0 : wl, hl < 0 ? 0 : hl);
}

/* the transform size of a plane of the block (get_tx_size) */
static int plane_tx(Av1 *f, int plane, int bsize, int txsz)
{
    if (plane == 0)
        return txsz;
    if (f->blk_lossless)
        return TX_4X4;
    int t = max_tx_rect(plane_bsize(bsize, f->ssx, f->ssy));
    if (tx_wl[t] == 6 || tx_hl[t] == 6)
        return tx_wl[t] == 4 ? TX_16X32 : tx_hl[t] == 4 ? TX_32X16
                                                        : TX_32X32;
    return t;
}

/* libaom's TxSetType of a transform of an intra block or of an inter one
 * (intra block copy; av1_get_ext_tx_set_type): 0 DCT only, 1 DCT and
 * identity, 2 DTT4_IDTX, 3 DTT4_IDTX_1DDCT, 4 DTT9_IDTX_1DDCT, 5 ALL16 */
static int tx_set_type(Av1 *f, int t, int inter)
{
    int up = tx_wl[t] > tx_hl[t] ? tx_wl[t] : tx_hl[t];
    int sq = tx_wl[t] < tx_hl[t] ? tx_wl[t] : tx_hl[t];
    if (up > 5)
        return 0;
    if (up == 5)
        return inter ? 1 : 0;
    if (f->reduced_tx_set)
        return inter ? 1 : 2;
    if (inter)
        return sq == 4 ? 4 : 5;
    return sq == 4 ? 2 : 3;
}

/* the chroma transform type of the transform at (sx, sy) of a chroma plane
 * (av1_get_tx_type): an intra block's from its uv mode, an intra block
 * copy block's the luma type at the same place in the block */
static int uv_tx_type(Av1 *f, int t, int sx, int sy)
{
    int up = tx_wl[t] > tx_hl[t] ? tx_wl[t] : tx_hl[t];
    if (f->blk_lossless || up > 5)
        return DCT_DCT;
    int type;
    if (f->inter) {
        int r = f->mi_row + (((sy >> 2) - (f->mi_row >> f->ssy)) << f->ssy);
        int c = f->mi_col + (((sx >> 2) - (f->mi_col >> f->ssx)) << f->ssx);
        type = MI(f->tx_types, r, c);
    } else {
        type = mode_to_txfm[f->uvmode == UV_CFL_PRED ? DC_PRED : f->uvmode];
    }
    return ext_tx_used[tx_set_type(f, t, f->inter)][type] ? type
                                                               : DCT_DCT;
}

static int tx_class(int type)
{
    if (type == V_DCT || type == V_ADST || type == V_FLIPADST)
        return 2; /* TX_CLASS_VERT */
    if (type == H_DCT || type == H_ADST || type == H_FLIPADST)
        return 1; /* TX_CLASS_HORIZ */
    return 0;
}

/* where the scans (and quantiser matrices) of a size at most 32 x 32
 * start in their tables */
static int scan_offset(int wl, int hl)
{
    static const int8_t sizes[14][2] = {
        {2, 2}, {3, 3}, {4, 4}, {5, 5}, {2, 3}, {3, 2}, {3, 4}, {4, 3},
        {4, 5}, {5, 4}, {2, 4}, {4, 2}, {3, 5}, {5, 3}};
    int off = 0;
    for (int k = 0; k < 14; k++) {
        if (sizes[k][0] == wl && sizes[k][1] == hl)
            return off;
        off += 1 << (sizes[k][0] + sizes[k][1]);
    }
    return 0;
}

static const int16_t *get_scan(int t, int type)
{
    int wl = tx_wl[t], hl = tx_hl[t];
    int big = wl == 6 || hl == 6;
    const int16_t *base = default_scan;
    if (!big && type != IDTX) {
        int cls = tx_class(type);
        base = cls == 2 ? mrow_scan : cls == 1 ? mcol_scan : default_scan;
    }
    return base + scan_offset(wl > 5 ? 5 : wl, hl > 5 ? 5 : hl);
}

/* -- coefficients (specification 5.11.39) --------------------------------- */

/* wide: the transform is wider (1) or taller (-1) than high, before a
 * 64-point side is cut to 32 (libaom's av1_nz_map_ctx_offset_64x32) */
static int coeff_base_ctx(const int32_t *q, int wl, int hl, int wide,
                          int cls, int pos)
{
    static const int8_t off[3][5][2] = {
        {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
        {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
        {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
    int W = 1 << wl, H = 1 << hl;
    int row = pos >> wl, col = pos & (W - 1), mag = 0;
    for (int k = 0; k < 5; k++) {
        int r = row + off[cls][k][0], c = col + off[cls][k][1];
        if (r < H && c < W) {
            int a = abs(q[(r << wl) + c]);
            mag += a < 3 ? a : 3;
        }
    }
    int ctx = (mag + 1) >> 1;
    if (ctx > 4)
        ctx = 4;
    if (cls == 0) {
        if (pos == 0)
            return 0;
        if (wide < 0 && row < 2)
            return ctx + 11;
        if (wide > 0 && col < 2)
            return ctx + 16;
        return ctx + (row + col < 2 ? 1 : row + col < 4 ? 6 : 21);
    }
    int idx = cls == 2 ? row : col;
    return ctx + 26 + 5 * (idx < 2 ? idx : 2);
}

static int coeff_br_ctx(const int32_t *q, int wl, int hl, int cls, int pos)
{
    static const int8_t off[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}},
                                        {{0, 1}, {1, 0}, {0, 2}},
                                        {{0, 1}, {1, 0}, {2, 0}}};
    int W = 1 << wl, H = 1 << hl;
    int row = pos >> wl, col = pos & (W - 1), mag = 0;
    for (int k = 0; k < 3; k++) {
        int r = row + off[cls][k][0], c = col + off[cls][k][1];
        if (r < H && c < W) {
            int a = q[(r << wl) + c];
            mag += a < 15 ? a : 15;
        }
    }
    mag = (mag + 1) >> 1;
    if (mag > 6)
        mag = 6;
    if (pos == 0)
        return mag;
    if ((cls == 0 && row < 2 && col < 2) || (cls == 1 && col == 0) ||
        (cls == 2 && row == 0))
        return mag + 7;
    return mag + 14;
}

/* the luma transform type (transform_type), of the intra sets or, in an
 * intra block copy block, the inter sets; none where the segment's
 * qindex (without delta q) is 0; a writer writes DCT_DCT */
static int read_tx_type(Av1 *f, int t)
{
    static const int8_t eset[2][6] = {{0, -1, 2, 1, -1, -1},
                                      {0, 3, -1, -1, 2, 1}};
    static const int8_t nsym[6] = {1, 2, 5, 7, 12, 16};
    int inter = f->inter, st = tx_set_type(f, t, inter);
    if (st == 0 || f->seg_qindex[f->segment_id] == 0)
        return DCT_DCT;
    int set = eset[inter][st], n = nsym[st], want = 0;
    for (int k = 0; k < n; k++)
        if (ext_tx_inv[st][k] == DCT_DCT)
            want = k;
    int mode = f->use_filter_intra ? filter_intra_dir[f->filter_intra_mode]
                                   : f->ymode;
    int sq = (tx_wl[t] < tx_hl[t] ? tx_wl[t] : tx_hl[t]) - 2;
    uint16_t *cdf = inter ? f->cdf.inter_ext_tx[set][sq]
                          : f->cdf.intra_ext_tx[set][sq][mode];
    return ext_tx_inv[st][sym(f, cdf, n, want)];
}

/* the coefficients of the transform block of size t at (x4, y4) of a
 * plane: read into f->quant (signed, row-major over at most 32 x 32), or
 * in a writer written from it; sets f->plane_tx_type, returns the end of
 * block */
static int coeffs(Av1 *f, int plane, int x4, int y4, int t)
{
    Cdfs *c = &f->cdf;
    int ptype = plane > 0;
    int maxx4 = f->MiCols, maxy4 = f->MiRows;
    int wl = tx_wl[t] > 5 ? 5 : tx_wl[t], hl = tx_hl[t] > 5 ? 5 : tx_hl[t];
    int n = 1 << (wl + hl);
    int w4 = 1 << (tx_wl[t] - 2), h4 = 1 << (tx_hl[t] - 2);
    int sq = (tx_wl[t] < tx_hl[t] ? tx_wl[t] : tx_hl[t]) - 2;
    int up = (tx_wl[t] > tx_hl[t] ? tx_wl[t] : tx_hl[t]) - 2;
    int txctx = (sq + up + 1) >> 1;
    int32_t *q = f->quant;
    int32_t want[32 * 32];
    if (plane) {
        maxx4 >>= f->ssx;
        maxy4 >>= f->ssy;
    }
    if (f->ec.writing)
        memcpy(want, q, sizeof(int32_t) * (size_t)n);
    memset(q, 0, sizeof(int32_t) * (size_t)n);
    int ctx;
    if (plane == 0) {
        int top = 0, left = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < maxx4 && f->above_level[0][x4 + k] > top)
                top = f->above_level[0][x4 + k];
        for (int k = 0; k < h4; k++)
            if (y4 + k < maxy4 && f->left_level[0][y4 + k] > left)
                left = f->left_level[0][y4 + k];
        int mx = top > left ? top : left, mn = top < left ? top : left;
        if (bw4_log2[f->mi_sz] + 2 == tx_wl[t] &&
            bh4_log2[f->mi_sz] + 2 == tx_hl[t])
            ctx = 0;
        else if (top == 0 && left == 0)
            ctx = 1;
        else if (top == 0 || left == 0)
            ctx = 2 + (mx > 3);
        else if (mx <= 3)
            ctx = 4;
        else if (mn <= 3)
            ctx = 5;
        else
            ctx = 6;
    } else {
        int above = 0, left = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < maxx4)
                above |= f->above_level[plane][x4 + k] |
                         f->above_dc[plane][x4 + k];
        for (int k = 0; k < h4; k++)
            if (y4 + k < maxy4)
                left |= f->left_level[plane][y4 + k] |
                        f->left_dc[plane][y4 + k];
        ctx = 7 + (above != 0) + (left != 0);
        int pb = plane_bsize(f->mi_sz, f->ssx, f->ssy);
        if (bw4_log2[pb] + bh4_log2[pb] + 4 > tx_wl[t] + tx_hl[t])
            ctx += 3;
    }
    int type = DCT_DCT;
    const int16_t *scan = get_scan(t, type);
    int eob = 0, want_eob = 0;
    if (f->ec.writing) {
        scan = get_scan(t, plane ? uv_tx_type(f, t, x4 * 4, y4 * 4)
                                 : DCT_DCT);
        for (int k = 0; k < n; k++)
            if (want[scan[k]])
                want_eob = k + 1;
    }
    int all_zero = sym(f, c->txb_skip[txctx][ctx], 2, want_eob == 0);
    int cul = 0, dc_cat = 0;
    if (!all_zero) {
        type = plane ? uv_tx_type(f, t, x4 * 4, y4 * 4)
                     : f->blk_lossless ? DCT_DCT : read_tx_type(f, t);
        scan = get_scan(t, type);
        int cls = tx_class(type);
        /* eob: its class, then the class's extra bits */
        int eob_pt, ectx = cls != 0, m = wl + hl - 4;
        int want_pt = want_eob <= 2 ? want_eob : 2;
        for (int e = want_eob - 1; want_eob > 2 && e > 1; e >>= 1)
            want_pt++;
        uint16_t *pt_cdf = m == 0 ? c->eob_pt16[ptype][ectx]
                           : m == 1 ? c->eob_pt32[ptype][ectx]
                           : m == 2 ? c->eob_pt64[ptype][ectx]
                           : m == 3 ? c->eob_pt128[ptype][ectx]
                           : m == 4 ? c->eob_pt256[ptype][ectx]
                           : m == 5 ? c->eob_pt512[ptype][0]
                                    : c->eob_pt1024[ptype][0];
        eob_pt = sym(f, pt_cdf, 5 + m, want_pt - 1) + 1;
        eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
        int shift = eob_pt - 3;
        if (shift >= 0) {
            int rest = want_eob - eob;
            int bit = sym(f, c->eob_extra[txctx][ptype][eob_pt - 3], 2,
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
            int pos = scan[k];
            int wv = abs(want[pos]);
            int level;
            if (k == eob - 1) {
                int cx = k == 0 ? 0 : k <= n / 8 ? 1 : k <= n / 4 ? 2 : 3;
                level = sym(f, c->coeff_base_eob[txctx][ptype][cx], 3,
                            (wv > 3 ? 3 : wv) - 1) + 1;
            } else {
                level = sym(f, c->coeff_base[txctx][ptype]
                            [coeff_base_ctx(q, wl, hl, (tx_wl[t] > tx_hl[t]) -
                             (tx_wl[t] < tx_hl[t]), cls, pos)], 4,
                            wv > 3 ? 3 : wv);
            }
            if (level > 2) {
                int bctx = coeff_br_ctx(q, wl, hl, cls, pos);
                for (int idx = 0; idx < 4; idx++) {
                    int br_want = wv - level;
                    int br = sym(f, c->coeff_br[txctx < 3 ? txctx : 3][ptype]
                                 [bctx], 4, br_want > 3 ? 3 : br_want);
                    level += br;
                    if (br < 3)
                        break;
                }
            }
            q[pos] = level;
        }
        for (int k = 0; k < eob; k++) {
            int pos = scan[k];
            int sign = 0;
            if (q[pos]) {
                int ws = want[pos] < 0;
                if (k == 0) {
                    int ds = 0;
                    for (int i = 0; i < w4; i++)
                        if (x4 + i < maxx4)
                            ds += f->above_dc[plane][x4 + i] == 1 ? -1 :
                                  f->above_dc[plane][x4 + i] == 2 ? 1 : 0;
                    for (int i = 0; i < h4; i++)
                        if (y4 + i < maxy4)
                            ds += f->left_dc[plane][y4 + i] == 1 ? -1 :
                                  f->left_dc[plane][y4 + i] == 2 ? 1 : 0;
                    int sctx = ds < 0 ? 1 : ds > 0 ? 2 : 0;
                    sign = sym(f, c->dc_sign[ptype][sctx], 2, ws);
                } else {
                    sign = lit(f, 1, ws);
                }
            }
            if (q[pos] > 14) {
                /* Golomb: the value less 15, plus one */
                uint32_t gx = f->ec.writing ? (uint32_t)abs(want[pos]) - 14
                                            : 0;
                int length = 0, glen = 0;
                if (f->ec.writing)
                    for (uint32_t g = gx; g; g >>= 1)
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
    f->plane_tx_type = type;
    if (plane == 0)
        for (int i = 0; i < h4 && y4 + i < maxy4; i++)
            for (int j = 0; j < w4 && x4 + j < maxx4; j++)
                MI(f->tx_types, y4 + i, x4 + j) = (uint8_t)type;
    for (int i = 0; i < w4; i++) {
        f->above_level[plane][x4 + i] = (uint8_t)cul;
        f->above_dc[plane][x4 + i] = (uint8_t)dc_cat;
    }
    for (int i = 0; i < h4; i++) {
        f->left_level[plane][y4 + i] = (uint8_t)cul;
        f->left_dc[plane][y4 + i] = (uint8_t)dc_cat;
    }
    return eob;
}

/* -- inverse transforms (specification 7.13, as libaom clamps them) ------- */

static int32_t clampv(int64_t v, int bits)
{
    int64_t hi = ((int64_t)1 << (bits - 1)) - 1;
    return (int32_t)(v < -hi - 1 ? -hi - 1 : v > hi ? hi : v);
}

/* libaom's half_btf: the products wrap at 32 bits, as its C computes
 * them */
static int32_t hbtf(int32_t w0, int32_t x0, int32_t w1, int32_t x1)
{
    int32_t a = (int32_t)((uint32_t)w0 * (uint32_t)x0);
    int32_t b = (int32_t)((uint32_t)w1 * (uint32_t)x1);
    return (int32_t)(((int64_t)a + b + 2048) >> 12);
}

static int32_t cos128(int a)
{
    a &= 255;
    const int32_t *c = cospi_arr[2];
#define C64(i) ((i) == 64 ? 0 : c[i])
    if (a <= 64)
        return C64(a);
    if (a <= 128)
        return -C64(128 - a);
    if (a <= 192)
        return -C64(a - 128);
    return C64(256 - a);
#undef C64
}

static int32_t sin128(int a)
{
    return cos128(a - 64);
}

static void bfly(int32_t *T, int a, int b, int angle, int flip)
{
    int32_t x = hbtf(cos128(angle), T[a], -sin128(angle), T[b]);
    int32_t y = hbtf(sin128(angle), T[a], cos128(angle), T[b]);
    T[a] = flip ? y : x;
    T[b] = flip ? x : y;
}

static void hada(int32_t *T, int a, int b, int f, int r)
{
    if (f) {
        int t = a;
        a = b;
        b = t;
    }
    int32_t x = T[a], y = T[b];
    T[a] = clampv((int64_t)x + y, r);
    T[b] = clampv((int64_t)x - y, r);
}

static int brev(int bits, int x)
{
    int r = 0;
    for (int i = 0; i < bits; i++)
        r |= ((x >> i) & 1) << (bits - 1 - i);
    return r;
}

/* the inverse DCT of 2^n samples (7.13.2.3) */
static void idct(int32_t *T, int n, int r)
{
    int32_t cp[64];
    int n0 = 1 << n;
    memcpy(cp, T, sizeof(int32_t) * (size_t)n0);
    for (int i = 0; i < n0; i++)
        T[i] = cp[brev(n, i)];
    if (n == 6)
        for (int i = 0; i < 16; i++)
            bfly(T, 32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
    if (n >= 5)
        for (int i = 0; i < 8; i++)
            bfly(T, 16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
    if (n == 6)
        for (int i = 0; i < 16; i++)
            hada(T, 32 + i * 2, 33 + i * 2, i & 1, r);
    if (n >= 4)
        for (int i = 0; i < 4; i++)
            bfly(T, 8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
    if (n >= 5)
        for (int i = 0; i < 8; i++)
            hada(T, 16 + 2 * i, 17 + 2 * i, i & 1, r);
    if (n == 6)
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 2; j++)
                bfly(T, 62 - i * 4 - j, 33 + i * 4 + j,
                     60 - 16 * brev(2, i) + 64 * j, 1);
    if (n >= 3)
        for (int i = 0; i < 2; i++)
            bfly(T, 4 + i, 7 - i, 56 - 32 * i, 0);
    if (n >= 4)
        for (int i = 0; i < 4; i++)
            hada(T, 8 + 2 * i, 9 + 2 * i, i & 1, r);
    if (n >= 5)
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 2; j++)
                bfly(T, 30 - 4 * i - j, 17 + 4 * i + j,
                     24 + (j << 6) + ((1 - i) << 5), 1);
    if (n == 6)
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 2; j++)
                hada(T, 32 + i * 4 + j, 35 + i * 4 - j, i & 1, r);
    for (int i = 0; i < 2; i++)
        bfly(T, 2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i);
    if (n >= 3)
        for (int i = 0; i < 2; i++)
            hada(T, 4 + 2 * i, 5 + 2 * i, i, r);
    if (n >= 4)
        for (int i = 0; i < 2; i++)
            bfly(T, 14 - i, 9 + i, 48 + 64 * i, 1);
    if (n >= 5)
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 2; j++)
                hada(T, 16 + 4 * i + j, 19 + 4 * i - j, i & 1, r);
    if (n == 6)
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 4; j++)
                bfly(T, 61 - i * 8 - j, 34 + i * 8 + j,
                     56 - i * 32 + (j >> 1) * 64, 1);
    for (int i = 0; i < 2; i++)
        hada(T, i, 3 - i, 0, r);
    if (n >= 3)
        bfly(T, 6, 5, 32, 1);
    if (n >= 4)
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 2; j++)
                hada(T, 8 + 4 * i + j, 11 + 4 * i - j, i, r);
    if (n >= 5)
        for (int i = 0; i < 4; i++)
            bfly(T, 29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
    if (n == 6)
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++)
                hada(T, 32 + 8 * i + j, 39 + 8 * i - j, i & 1, r);
    if (n >= 3)
        for (int i = 0; i < 4; i++)
            hada(T, i, 7 - i, 0, r);
    if (n >= 4)
        for (int i = 0; i < 2; i++)
            bfly(T, 13 - i, 10 + i, 32, 1);
    if (n >= 5)
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 4; j++)
                hada(T, 16 + i * 8 + j, 23 + i * 8 - j, i, r);
    if (n == 6)
        for (int i = 0; i < 8; i++)
            bfly(T, 59 - i, 36 + i, i < 4 ? 48 : 112, 1);
    if (n >= 4)
        for (int i = 0; i < 8; i++)
            hada(T, i, 15 - i, 0, r);
    if (n >= 5)
        for (int i = 0; i < 4; i++)
            bfly(T, 27 - i, 20 + i, 32, 1);
    if (n == 6) {
        for (int i = 0; i < 8; i++) {
            hada(T, 32 + i, 47 - i, 0, r);
            hada(T, 48 + i, 63 - i, 1, r);
        }
    }
    if (n >= 5)
        for (int i = 0; i < 16; i++)
            hada(T, i, 31 - i, 0, r);
    if (n == 6)
        for (int i = 0; i < 8; i++)
            bfly(T, 55 - i, 40 + i, 32, 1);
    if (n == 6)
        for (int i = 0; i < 32; i++)
            hada(T, i, 63 - i, 0, r);
}

static void iadst4(int32_t *T)
{
    const int32_t *s = sinpi_arr[2];
    int32_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
    if (!(x0 | x1 | x2 | x3))
        return;
#define M(a, b) ((int32_t)((uint32_t)(a) * (uint32_t)(b)))
    int32_t s0 = M(s[1], x0), s1 = M(s[2], x0), s2 = M(s[3], x1);
    int32_t s3 = M(s[4], x2), s4 = M(s[1], x2), s5 = M(s[2], x3);
    int32_t s6 = M(s[4], x3);
    int32_t s7 = (int32_t)((uint32_t)x0 - (uint32_t)x2 + (uint32_t)x3);
    s0 = (int32_t)((uint32_t)s0 + (uint32_t)s3);
    s1 = (int32_t)((uint32_t)s1 - (uint32_t)s4);
    s3 = s2;
    s2 = M(s[3], s7);
    s0 = (int32_t)((uint32_t)s0 + (uint32_t)s5);
    s1 = (int32_t)((uint32_t)s1 - (uint32_t)s6);
    int64_t y0 = (int64_t)s0 + s3, y1 = (int64_t)s1 + s3, y2 = s2;
    int64_t y3 = (int64_t)s0 + s1 - s3;
#undef M
    T[0] = (int32_t)((y0 + 2048) >> 12);
    T[1] = (int32_t)((y1 + 2048) >> 12);
    T[2] = (int32_t)((y2 + 2048) >> 12);
    T[3] = (int32_t)((y3 + 2048) >> 12);
}

/* libaom's av1_iadst8 and av1_iadst16 (their stages, clamped as they
 * clamp) */
static void iadst8(int32_t *T, int r)
{
    const int32_t *c = cospi_arr[2];
    int32_t b[8], o[8];
    static const int8_t in[8] = {7, 0, 5, 2, 3, 4, 1, 6};
    for (int i = 0; i < 8; i++)
        b[i] = T[in[i]];
    for (int i = 0; i < 4; i++) {
        int a = 4 + 16 * i;
        o[2 * i] = hbtf(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
        o[2 * i + 1] = hbtf(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 4; i++) {
        b[i] = clampv((int64_t)o[i] + o[i + 4], r);
        b[i + 4] = clampv((int64_t)o[i] - o[i + 4], r);
    }
    o[0] = b[0], o[1] = b[1], o[2] = b[2], o[3] = b[3];
    o[4] = hbtf(c[16], b[4], c[48], b[5]);
    o[5] = hbtf(c[48], b[4], -c[16], b[5]);
    o[6] = hbtf(-c[48], b[6], c[16], b[7]);
    o[7] = hbtf(c[16], b[6], c[48], b[7]);
    for (int k = 0; k < 8; k += 4) {
        b[k] = clampv((int64_t)o[k] + o[k + 2], r);
        b[k + 1] = clampv((int64_t)o[k + 1] + o[k + 3], r);
        b[k + 2] = clampv((int64_t)o[k] - o[k + 2], r);
        b[k + 3] = clampv((int64_t)o[k + 1] - o[k + 3], r);
    }
    for (int k = 2; k < 8; k += 4) {
        int32_t x = b[k], y = b[k + 1];
        b[k] = hbtf(c[32], x, c[32], y);
        b[k + 1] = hbtf(c[32], x, -c[32], y);
    }
    T[0] = b[0], T[1] = -b[4], T[2] = b[6], T[3] = -b[2];
    T[4] = b[3], T[5] = -b[7], T[6] = b[5], T[7] = -b[1];
}

static void iadst16(int32_t *T, int r)
{
    const int32_t *c = cospi_arr[2];
    int32_t b[16], o[16];
    for (int i = 0; i < 16; i++)
        b[i] = T[(i & 1) ? i - 1 : 15 - i];
    for (int i = 0; i < 8; i++) {
        int a = 2 + 8 * i;
        o[2 * i] = hbtf(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
        o[2 * i + 1] = hbtf(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 8; i++) {
        b[i] = clampv((int64_t)o[i] + o[i + 8], r);
        b[i + 8] = clampv((int64_t)o[i] - o[i + 8], r);
    }
    for (int i = 0; i < 8; i++)
        o[i] = b[i];
    o[8] = hbtf(c[8], b[8], c[56], b[9]);
    o[9] = hbtf(c[56], b[8], -c[8], b[9]);
    o[10] = hbtf(c[40], b[10], c[24], b[11]);
    o[11] = hbtf(c[24], b[10], -c[40], b[11]);
    o[12] = hbtf(-c[56], b[12], c[8], b[13]);
    o[13] = hbtf(c[8], b[12], c[56], b[13]);
    o[14] = hbtf(-c[24], b[14], c[40], b[15]);
    o[15] = hbtf(c[40], b[14], c[24], b[15]);
    for (int k = 0; k < 16; k += 8)
        for (int i = 0; i < 4; i++) {
            b[k + i] = clampv((int64_t)o[k + i] + o[k + i + 4], r);
            b[k + i + 4] = clampv((int64_t)o[k + i] - o[k + i + 4], r);
        }
    for (int i = 0; i < 16; i++)
        o[i] = b[i];
    for (int k = 4; k < 16; k += 8) {
        o[k] = hbtf(c[16], b[k], c[48], b[k + 1]);
        o[k + 1] = hbtf(c[48], b[k], -c[16], b[k + 1]);
        o[k + 2] = hbtf(-c[48], b[k + 2], c[16], b[k + 3]);
        o[k + 3] = hbtf(c[16], b[k + 2], c[48], b[k + 3]);
    }
    for (int k = 0; k < 16; k += 4) {
        b[k] = clampv((int64_t)o[k] + o[k + 2], r);
        b[k + 1] = clampv((int64_t)o[k + 1] + o[k + 3], r);
        b[k + 2] = clampv((int64_t)o[k] - o[k + 2], r);
        b[k + 3] = clampv((int64_t)o[k + 1] - o[k + 3], r);
    }
    for (int k = 2; k < 16; k += 4) {
        int32_t x = b[k], y = b[k + 1];
        b[k] = hbtf(c[32], x, c[32], y);
        b[k + 1] = hbtf(c[32], x, -c[32], y);
    }
    static const int8_t out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7,
                                   5, 13, 9, 1};
    for (int i = 0; i < 16; i++)
        T[i] = (i & 1) ? -b[out[i]] : b[out[i]];
}

static void itx_1d(int32_t *T, int kind, int n, int r)
{
    int N = 1 << n;
    if (kind == T_IDTX) {
        for (int i = 0; i < N; i++) {
            int64_t v = T[i];
            T[i] = n == 2 ? (int32_t)((v * 5793 + 2048) >> 12)
                   : n == 3 ? (int32_t)(v * 2)
                   : n == 4 ? (int32_t)((v * 11586 + 2048) >> 12)
                            : (int32_t)(v * 4);
        }
    } else if (kind == T_DCT) {
        idct(T, n, r);
    } else if (n == 2) {
        iadst4(T);
    } else if (n == 3) {
        iadst8(T, r);
    } else {
        iadst16(T, r);
    }
}

static const uint8_t row_shift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1,
                                      1, 1, 2, 2, 2, 2};

/* the residual of dequantised coefficients dq (row-major, at most 32 x
 * 32) of a transform of size t and type type, added to the plane at
 * (x, y) */
static void inverse_transform(Av1 *f, int plane, int x, int y, int t,
                              int type, const int32_t *dq)
{
    int32_t buf[64 * 64];
    int wl = tx_wl[t], hl = tx_hl[t], W = 1 << wl, H = 1 << hl;
    int cw = W < 32 ? W : 32;
    int bd = f->bitdepth, rr = bd + 8, cr = bd + 6 > 16 ? bd + 6 : 16;
    int vt = tx_vtype[type], ht = tx_htype[type], sh = row_shift[t];
    int32_t T[64];
    for (int i = 0; i < H; i++) {
        for (int j = 0; j < W; j++) {
            int64_t v = (i < 32 && j < 32) ? dq[i * cw + j] : 0;
            if (wl - hl == 1 || hl - wl == 1)
                v = (v * 2896 + 2048) >> 12;
            T[j] = clampv(v, rr);
        }
        itx_1d(T, ht, wl, rr);
        for (int j = 0; j < W; j++)
            buf[i * W + j] = sh ? (int32_t)(((int64_t)T[j] + (1 << (sh - 1)))
                                            >> sh) : T[j];
    }
    for (int j = 0; j < W; j++) {
        int src = ht == T_FLIPADST ? W - 1 - j : j;
        for (int i = 0; i < H; i++)
            T[i] = clampv(buf[i * W + src], cr);
        itx_1d(T, vt, hl, cr);
        for (int i = 0; i < H; i++) {
            int32_t v = T[vt == T_FLIPADST ? H - 1 - i : i];
            v = (int32_t)(((int64_t)v + 8) >> 4);
            uint16_t *p = &PX(plane, y + i, x + j);
            *p = (uint16_t)clip1(f, *p + v);
        }
    }
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
static void reconstruct_lossless(Av1 *f, int plane, int x, int y)
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

/* a quantiser of the block's qindex (dc_q / ac_q) */
static int qlookup(Av1 *f, int dc, int delta)
{
    int q = f->blk_q + delta;
    q = q < 0 ? 0 : q > 255 ? 255 : q;
    const int16_t *t = dc ? (f->bitdepth == 8 ? dc_qlookup : f->bitdepth ==
                             10 ? dc_qlookup_10 : dc_qlookup_12)
                          : (f->bitdepth == 8 ? ac_qlookup : f->bitdepth ==
                             10 ? ac_qlookup_10 : ac_qlookup_12);
    return t[q];
}

/* the dequantiser of each coefficient position (row-major over the
 * coded part, at most 32 x 32): dc_q / ac_q, weighted by the quantiser
 * matrix of 2-D types (libaom's get_dqv) */
static void dequantisers(Av1 *f, int plane, int t, int type, int32_t *out)
{
    int wl = tx_wl[t] > 5 ? 5 : tx_wl[t], hl = tx_hl[t] > 5 ? 5 : tx_hl[t];
    int W = 1 << wl, H = 1 << hl;
    int dcq = qlookup(f, 1, f->dq_dc[plane]);
    int acq = qlookup(f, 0, f->dq_ac[plane]);
    int lvl = f->blk_lossless ? 15 : f->qm_level[plane];
    const uint8_t *qm = NULL;
    if (lvl < 15 && type < IDTX)
        qm = qm_iwt[lvl][plane > 0] + scan_offset(wl, hl);
    for (int r = 0; r < H; r++)
        for (int c = 0; c < W; c++) {
            int q = (r | c) ? acq : dcq;
            if (qm)
                q = (qm[c * H + r] * q + 16) >> 5;
            out[r * W + c] = q;
        }
}

/* dequantize f->quant, inverse transform, add to the prediction */
static void reconstruct(Av1 *f, int plane, int x, int y, int t)
{
    if (f->blk_lossless) {
        reconstruct_lossless(f, plane, x, y);
        return;
    }
    int32_t dq[32 * 32], qv[32 * 32];
    int wl = tx_wl[t] > 5 ? 5 : tx_wl[t], hl = tx_hl[t] > 5 ? 5 : tx_hl[t];
    int n = 1 << (wl + hl), pels = 1 << (tx_wl[t] + tx_hl[t]);
    int shift = (pels > 256) + (pels > 1024);
    int32_t lim = (int32_t)1 << (7 + f->bitdepth);
    dequantisers(f, plane, t, f->plane_tx_type, qv);
    for (int k = 0; k < n; k++) {
        int32_t v = f->quant[k];
        int32_t d = 0;
        if (v) {
            d = (int32_t)(((int64_t)abs(v) * qv[k]) & 0xFFFFFF) >> shift;
            if (v < 0)
                d = -d;
            d = d < -lim ? -lim : d > lim - 1 ? lim - 1 : d;
        }
        dq[k] = d;
    }
    inverse_transform(f, plane, x, y, t, f->plane_tx_type, dq);
}

/* a writer: the coefficients of the residual of a transform block
 * (forward WHT of lossless frames, else a quantised DCT) */
static void forward_tx(Av1 *f, int plane, int x, int y, int t);

/* -- blocks --------------------------------------------------------------- */

static void transform_block(Av1 *f, int plane, int base_x, int base_y, int t,
                            int tx, int ty)
{
    int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
    int sx = base_x + 4 * tx, sy = base_y + 4 * ty;
    int row = (sy << ssy) >> 2, col = (sx << ssx) >> 2;
    int mask = f->use128 ? 31 : 15;
    int sbr = (row & mask) >> ssy, sbc = (col & mask) >> ssx;
    int maxx = f->MiCols * 4 - 1, maxy = f->MiRows * 4 - 1;
    int stepx = 1 << (tx_wl[t] - 2), stepy = 1 << (tx_hl[t] - 2);
    int w = 1 << tx_wl[t], h = 1 << tx_hl[t];
    if (sx >= (maxx >> ssx) + 1 || sy >= (maxy >> ssy) + 1)
        return;
    if (f->inter) {
        /* predicted with the block (intrabc_predict, predict_inter) */
    } else if ((plane == 0 && f->pal_y) || (plane && f->pal_uv)) {
        const uint16_t *pal = plane == 0 ? f->pal_y_colors : plane == 1
                              ? f->pal_u_colors : f->pal_v_colors;
        const uint8_t *map = plane ? f->map_uv : f->map_y;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                PX(plane, sy + i, sx + j) =
                    pal[map[(ty * 4 + i) * 64 + tx * 4 + j]];
    } else {
        int cfl = plane > 0 && f->uvmode == UV_CFL_PRED;
        int mode = plane == 0 ? f->ymode : cfl ? DC_PRED : f->uvmode;
        predict_intra(f, plane, sx, sy,
                      (plane ? f->avail_l_uv : f->avail_l) || tx > 0,
                      (plane ? f->avail_u_uv : f->avail_u) || ty > 0,
                      f->decoded[plane][sbr - 1 + 1][sbc + stepx + 1],
                      f->decoded[plane][sbr + stepy + 1][sbc - 1 + 1], mode,
                      tx_wl[t], tx_hl[t]);
        if (cfl)
            predict_cfl(f, plane, sx, sy, tx_wl[t], tx_hl[t]);
    }
    if (plane == 0 && !f->inter) {
        f->max_luma_w = sx + w;
        f->max_luma_h = sy + h;
    }
    if (!f->skip) {
        if (f->ec.writing)
            forward_tx(f, plane, sx, sy, t);
        if (coeffs(f, plane, sx >> 2, sy >> 2, t) > 0)
            reconstruct(f, plane, sx, sy, t);
    }
    for (int i = 0; i < stepy; i++)
        for (int j = 0; j < stepx; j++) {
            f->decoded[plane][sbr + i + 1][sbc + j + 1] = 1;
            int py = (sy >> 2) + i, px = (sx >> 2) + j;
            if (py < f->MiRows && px < f->MiCols)
                f->lf_tx[plane][(size_t)py * f->MiCols + px] = (uint8_t)t;
        }
}

/* the luma transform blocks of an intra block copy block below the
 * transform t at (x4, y4) of the block, in the order of libaom's
 * decode_reconstruct_tx */
static void vartx_blocks(Av1 *f, int t, int x4, int y4)
{
    if (f->mi_row + y4 >= f->MiRows || f->mi_col + x4 >= f->MiCols)
        return;
    if (t == TX_4X4 || MI(f->vtx, f->mi_row + y4, f->mi_col + x4) == t) {
        transform_block(f, 0, f->mi_col * 4, f->mi_row * 4, t, x4, y4);
        return;
    }
    int sub = split_tx(t);
    for (int i = 0; i < 1 << (tx_hl[t] - 2); i += 1 << (tx_hl[sub] - 2))
        for (int j = 0; j < 1 << (tx_wl[t] - 2); j += 1 << (tx_wl[sub] - 2))
            vartx_blocks(f, sub, x4 + j, y4 + i);
}

static void residual(Av1 *f)
{
    int wchunks = f->bw4 >> 4 > 1 ? f->bw4 >> 4 : 1;
    int hchunks = f->bh4 >> 4 > 1 ? f->bh4 >> 4 : 1;
    for (int cy = 0; cy < hchunks; cy++)
        for (int cx = 0; cx < wchunks; cx++)
            for (int plane = 0; plane < 1 + 2 * f->has_chroma; plane++) {
                int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
                int t = plane_tx(f, plane, f->mi_sz, f->txsz);
                int stepx = 1 << (tx_wl[t] - 2), stepy = 1 << (tx_hl[t] - 2);
                int pb = plane ? plane_bsize(f->mi_sz, ssx, ssy) : f->mi_sz;
                int n4w = 1 << bw4_log2[pb], n4h = 1 << bh4_log2[pb];
                int bx = (f->mi_col >> ssx) * 4, by = (f->mi_row >> ssy) * 4;
                int lh = n4h < (16 >> ssy) ? n4h : 16 >> ssy;
                int lw = n4w < (16 >> ssx) ? n4w : 16 >> ssx;
                if (plane == 0 && f->inter && !f->blk_lossless) {
                    int m = max_tx_rect(f->mi_sz);
                    for (int y = 0; y < lh; y += 1 << (tx_hl[m] - 2))
                        for (int x = 0; x < lw; x += 1 << (tx_wl[m] - 2))
                            vartx_blocks(f, m, x + (cx << 4), y + (cy << 4));
                    continue;
                }
                for (int y = 0; y < lh; y += stepy)
                    for (int x = 0; x < lw; x += stepx)
                        transform_block(f, plane, bx, by, t,
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
static int enc_cdef(Av1 *f, int r, int c);
static const LrUnit *enc_lr_unit(Av1 *f, int plane, int row, int col);

/* -- intra block copy (specification 7.10.2, 5.11.26, 7.11.3) ----------- */

typedef struct {
    int n, row[8], col[8], weight[8], found, new_count;
    int global[2]; /* GlobalMvs[0] of an inter block */
} MvStack;

static void inter_candidate(Av1 *f, MvStack *st, int r, int c, int weight);

static void add_candidate(Av1 *f, MvStack *st, int r, int c, int weight)
{
    size_t k = (size_t)r * f->MiCols + c;
    if (f->inter_frame) {
        inter_candidate(f, st, r, c, weight);
        return;
    }
    if (!f->is_inter[k])
        return;
    /* the candidate's vector, at integer precision (force_integer_mv) */
    int v[2] = {f->mvs[4 * k], f->mvs[4 * k + 1]};
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

/* a vector component of integer precision (1/8 samples); in a writer v,
 * a nonzero multiple of 8: |v| / 8 = 1 or 2 (class 0), else 2^c + d + 1 */
static int mv_component(Av1 *f, const int base, int v)
{
    uint16_t *m = f->cdf.mv + base;
    int a = abs(v) / 8, wc = 0, wd = a - 1;
    if (f->ec.writing && (v % 8 || !a || a > 2048))
        av1_fail(f, ERR_VALUE, "writer: a vector component of %d", v);
    if (a > 2)
        while (2 << wc <= a - 1)
            wc++;
    if (wc)
        wd = a - 1 - (1 << wc);
    int sign = sym(f, m + 27, 2, v < 0);
    int cls = sym(f, m, 11, wc), mag;
    if (cls == 0) {
        mag = sym(f, m + 36, 2, wd) << 3;
    } else {
        int d = 0;
        for (int i = 0; i < cls; i++)
            d |= sym(f, m + 39 + 3 * i, 2, (wd >> i) & 1) << i;
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
    /* a writer: its vector against the prediction */
    int wr = f->enc_choice.dv_row - pr, wc = f->enc_choice.dv_col - pc;
    int joint = sym(f, m, 4, (wr != 0) * 2 + (wc != 0));
    int dr = 0, dc = 0;
    if (joint == 2 || joint == 3)
        dr = mv_component(f, 5, wr);
    if (joint == 1 || joint == 3)
        dc = mv_component(f, 74, wc);
    f->mv_row = pr + dr;
    f->mv_col = pc + dc;
    if (!dv_valid(f, f->mv_row, f->mv_col))
        av1_fail(f, ERR_VALUE, "AV1: an invalid intra block copy vector");
}

/* the block copied from the frame decoded so far (libaom's
 * build_inter_predictors_8x8_and_bigger: intra block copy never takes the
 * sub-8x8 path, so a chroma block of a block 4 samples wide or high is 4
 * samples and takes this block's vector).  Under subsampling an odd luma
 * vector is a half chroma sample: libaom's intra block copy bilinear
 * filter, the rounded mean of 2 (or 2 x 2) samples. */
static void intrabc_predict(Av1 *f)
{
    int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
    for (int plane = 0; plane < 1 + 2 * f->has_chroma; plane++) {
        int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
        int x0 = (f->mi_col >> ssx) * 4, y0 = (f->mi_row >> ssy) * 4;
        int w = bw >> ssx, h = bh >> ssy;
        w = w < 4 ? 4 : w;
        h = h < 4 ? 4 : h;
        /* the vector in 1/16 samples of the plane (mv_q4) */
        int qy = f->mv_row * (1 << (1 - ssy));
        int qx = f->mv_col * (1 << (1 - ssx));
        int dy = qy >> 4, dx = qx >> 4, fy = qy & 15, fx = qx & 15;
        uint16_t tmp[128 * 128];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int sy = y0 + i + dy, sx = x0 + j + dx;
                int a[4];
                for (int k = 0; k < 4; k++) {
                    int yy = sy + ((k >> 1) && fy), xx = sx + ((k & 1) && fx);
                    yy = yy < 0 ? 0 : yy >= f->rows ? f->rows - 1 : yy;
                    xx = xx < 0 ? 0 : xx >= f->stride ? f->stride - 1 : xx;
                    a[k] = PX(plane, yy, xx);
                }
                tmp[i * 128 + j] = (uint16_t)(fx && fy ?
                    (a[0] + a[1] + a[2] + a[3] + 2) >> 2 : fx || fy ?
                    (a[0] + a[fx ? 1 : 2] + 1) >> 1 : a[0]);
            }
        for (int i = 0; i < h && y0 + i < f->rows; i++)
            for (int j = 0; j < w && x0 + j < f->stride; j++)
                PX(plane, y0 + i, x0 + j) = tmp[i * 128 + j];
    }
}

/* -- segmentation (specification 5.9.14, 5.11.9, 7.12.2) ---------------- */

enum { SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V, SEG_LVL_REF_FRAME = 5,
       SEG_LVL_SKIP };

static int seg_active(Av1 *f, int id, int feature)
{
    return f->seg_enabled && (f->seg_mask[id] >> feature & 1);
}

/* the qindex of segment id over qindex q (get_qindex) */
static int seg_q(Av1 *f, int id, int q)
{
    if (!seg_active(f, id, SEG_LVL_ALT_Q))
        return q;
    q += f->seg_data[id][SEG_LVL_ALT_Q];
    return q < 0 ? 0 : q > 255 ? 255 : q;
}

/* av1_neg_deinterleave */
static int neg_deinterleave(int diff, int ref, int max)
{
    if (!ref)
        return diff;
    if (ref >= max - 1)
        return max - diff - 1;
    if (2 * ref < max) {
        if (diff <= 2 * ref)
            return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
        return diff;
    }
    if (diff <= 2 * (max - ref - 1))
        return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return max - (diff + 1);
}

static int enc_segment(Av1 *f);

/* from the segments' features: SegIdPreSkip, LastActiveSegId, each
 * segment's qindex and lossless flag (dq: a delta q of the chroma or of
 * luma DC), and the frame's CodedLossless */
static void seg_setup(Av1 *f, int dq)
{
    f->seg_preskip = f->seg_last = 0;
    for (int i = 0; f->seg_enabled && i < 8; i++)
        for (int j = 0; j < 8; j++)
            if (f->seg_mask[i] >> j & 1) {
                f->seg_preskip |= j >= SEG_LVL_REF_FRAME;
                f->seg_last = i;
            }
    f->lossless = 1;
    for (int i = 0; i < 8; i++) {
        f->seg_qindex[i] = seg_q(f, i, f->base_q);
        f->seg_lossless[i] = f->seg_qindex[i] == 0 && !dq;
        if (i < (f->seg_enabled ? 8 : 1))
            f->lossless &= f->seg_lossless[i];
    }
}

/* intra_segment_id: predicted from the segments above, left and above
 * left (av1_get_spatial_seg_pred), taken as it is in a skipped block
 * (read after skip), else coded against it; then the block's map */
static void read_segment_id(Av1 *f, int skip)
{
    int ul = -1, u = -1, l = -1, ctx, pred, id;
    if (f->avail_u && f->avail_l)
        ul = MI(f->seg_ids, f->mi_row - 1, f->mi_col - 1);
    if (f->avail_u)
        u = MI(f->seg_ids, f->mi_row - 1, f->mi_col);
    if (f->avail_l)
        l = MI(f->seg_ids, f->mi_row, f->mi_col - 1);
    if (ul < 0)
        ctx = 0;
    else if (ul == u && ul == l)
        ctx = 2;
    else
        ctx = ul == u || ul == l || u == l;
    pred = u < 0 ? (l < 0 ? 0 : l) : l < 0 ? u : ul == u ? u : l;
    if (skip) {
        id = pred;
    } else {
        int want = 0, n = f->seg_last + 1;
        if (f->ec.writing) {
            int v = enc_segment(f);
            for (int d = 0; d < 8; d++)
                if (neg_deinterleave(d, pred, n) == v)
                    want = d;
        }
        id = neg_deinterleave(sym(f, f->cdf.spatial_pred_seg[ctx], 8, want),
                              pred, n);
        if (id < 0 || id > f->seg_last)
            av1_fail(f, ERR_VALUE, "AV1: segment_id %d past the last active "
                     "segment", id);
    }
    for (int y = 0; y < f->bh4 && f->mi_row + y < f->MiRows; y++)
        for (int x = 0; x < f->bw4 && f->mi_col + x < f->MiCols; x++)
            MI(f->seg_ids, f->mi_row + y, f->mi_col + x) = (uint8_t)id;
    f->segment_id = id;
    f->blk_lossless = f->seg_lossless[id];
}

/* cdef_idx of the block's 64 x 64 unit, at its first block that is not
 * skipped (read_cdef) */
static void read_cdef(Av1 *f)
{
    if (f->skip || f->lossless || !f->cdef_en || f->allow_intrabc)
        return;
    int r = f->mi_row & ~15, c = f->mi_col & ~15;
    int8_t *idx = &f->cdef_idx[(r >> 4) * f->cdef_cols + (c >> 4)];
    if (*idx != -1)
        return;
    int v = lit(f, f->cdef_bits, f->ec.writing ? enc_cdef(f, r, c) : 0);
    for (int y = r; y < r + f->bh4; y += 16)
        for (int x = c; x < c + f->bw4; x += 16)
            f->cdef_idx[(y >> 4) * f->cdef_cols + (x >> 4)] = (int8_t)v;
}

static int delta_abs(Av1 *f, uint16_t *cdf)
{
    int a = sym(f, cdf, 4, 0);
    if (a == 3) {
        int n = lit(f, 3, 0) + 1;
        a = lit(f, n, 0) + (1 << n) + 1;
    }
    return a;
}

static void read_delta_qindex(Av1 *f)
{
    int sb = f->use128 ? BLOCK_128X128 : BLOCK_64X64;
    if ((f->mi_sz == sb && f->skip) || !f->read_deltas)
        return;
    int a = delta_abs(f, f->cdf.delta_q);
    if (a) {
        int d = lit(f, 1, 0) ? -a : a;
        int q = f->qindex + d * (1 << f->delta_q_res);
        f->qindex = q < 1 ? 1 : q > 255 ? 255 : q;
    }
}

static void read_delta_lf(Av1 *f)
{
    int sb = f->use128 ? BLOCK_128X128 : BLOCK_64X64;
    if ((f->mi_sz == sb && f->skip) || !f->read_deltas ||
        !f->delta_lf_present)
        return;
    int n = f->delta_lf_multi ? (f->nplanes > 1 ? 4 : 2) : 1;
    for (int i = 0; i < n; i++) {
        int a = delta_abs(f, f->delta_lf_multi ? f->cdf.delta_lf_multi[i]
                                               : f->cdf.delta_lf);
        if (a) {
            int d = lit(f, 1, 0) ? -a : a;
            int v = f->delta_lf[i] + d * (1 << f->delta_lf_res);
            f->delta_lf[i] = v < -63 ? -63 : v > 63 ? 63 : v;
        }
    }
}

/* the transform widths above and heights left of w4 x h4 units at (r, c)
 * (libaom's set_txfm_ctx, txfm_partition_update) */
static void set_txfm_ctx(Av1 *f, int r, int c, int w4, int h4, int tw,
                         int th)
{
    memset(f->above_txfm + c, tw, (size_t)w4);
    memset(f->left_txfm + r, th, (size_t)h4);
}

/* the transform size t over its units from (r4, c4) of the block */
static void set_vtx(Av1 *f, int r4, int c4, int t, int v)
{
    for (int i = 0; i < 1 << (tx_hl[t] - 2); i++)
        for (int j = 0; j < 1 << (tx_wl[t] - 2); j++)
            if (f->mi_row + r4 + i < f->MiRows &&
                f->mi_col + c4 + j < f->MiCols)
                MI(f->vtx, f->mi_row + r4 + i, f->mi_col + c4 + j) =
                    (uint8_t)v;
}

/* an intra block copy block's variable transform partition below the
 * transform t at (r4, c4) of the block (read_tx_size_vartx: at most two
 * splits); a writer splits nothing */
static void read_vartx(Av1 *f, int t, int depth, int r4, int c4)
{
    int r = f->mi_row + r4, c = f->mi_col + c4;
    if (r >= f->MiRows || c >= f->MiCols)
        return;
    int tw = 1 << tx_wl[t], th = 1 << tx_hl[t], split = 0;
    if (depth < 2) {
        int bl = bw4_log2[f->mi_sz] > bh4_log2[f->mi_sz] ? bw4_log2[f->mi_sz]
                                                         : bh4_log2[f->mi_sz];
        int maxl = bl + 2 > 6 ? 6 : bl + 2;
        int upl = tx_wl[t] > tx_hl[t] ? tx_wl[t] : tx_hl[t];
        int cat = (upl != maxl && maxl > 3) + (6 - maxl) * 2;
        int ctx = cat * 3 + (f->above_txfm[c] < tw) + (f->left_txfm[r] < th);
        split = sym(f, f->cdf.txfm_partition[ctx], 2, 0);
    }
    if (!split) {
        set_vtx(f, r4, c4, t, t);
        set_txfm_ctx(f, r, c, tw >> 2, th >> 2, tw, th);
        return;
    }
    int sub = split_tx(t);
    if (sub == TX_4X4) {
        set_vtx(f, r4, c4, t, TX_4X4);
        set_txfm_ctx(f, r, c, tw >> 2, th >> 2, 4, 4);
        return;
    }
    for (int i = 0; i < th >> 2; i += 1 << (tx_hl[sub] - 2))
        for (int j = 0; j < tw >> 2; j += 1 << (tx_wl[sub] - 2))
            read_vartx(f, sub, depth + 1, r4 + i, c4 + j);
}

/* the block's transform size (read_tx_size): of an intra block, its
 * tx_depth; of an intra block copy block (an inter block to the transform
 * syntax), its variable partition where the frame selects transform sizes
 * and the block is not skipped, else the largest rectangular size; then
 * the transform contexts (a skipped intra block copy block's are its
 * size) */
static void read_tx_size(Av1 *f)
{
    int t = max_tx_rect(f->mi_sz);
    if (f->inter) {
        if (f->tx_mode_select && f->mi_sz > BLOCK_4X4 && !f->skip &&
            !f->blk_lossless) {
            for (int i = 0; i < f->bh4; i += 1 << (tx_hl[t] - 2))
                for (int j = 0; j < f->bw4; j += 1 << (tx_wl[t] - 2))
                    read_vartx(f, t, 0, i, j);
            f->txsz = t;
            return;
        }
        f->txsz = f->blk_lossless ? TX_4X4 : t;
        for (int i = 0; i < f->bh4 && f->mi_row + i < f->MiRows; i++)
            for (int j = 0; j < f->bw4 && f->mi_col + j < f->MiCols; j++)
                MI(f->vtx, f->mi_row + i, f->mi_col + j) = (uint8_t)f->txsz;
        if (f->skip)
            set_txfm_ctx(f, f->mi_row, f->mi_col, f->bw4, f->bh4,
                         f->bw4 * 4, f->bh4 * 4);
        else
            set_txfm_ctx(f, f->mi_row, f->mi_col, f->bw4, f->bh4,
                         1 << tx_wl[f->txsz], 1 << tx_hl[f->txsz]);
        return;
    }
    if (f->blk_lossless) {
        f->txsz = TX_4X4;
        set_txfm_ctx(f, f->mi_row, f->mi_col, f->bw4, f->bh4, 4, 4);
        return;
    }
    if (f->mi_sz > BLOCK_4X4 && f->tx_mode_select) {
        int splits = 0;
        for (int u = t; u != TX_4X4; u = split_tx(u))
            splits++;
        int maxw = 1 << tx_wl[t], maxh = 1 << tx_hl[t];
        int above = 0, left = 0;
        if (f->avail_u) {
            size_t k = (size_t)(f->mi_row - 1) * f->MiCols + f->mi_col;
            above = (f->is_inter[k] ? 4 << bw4_log2[f->mi_size[k]]
                                    : 1 << tx_wl[f->txsizes[k]]) >= maxw;
        }
        if (f->avail_l) {
            size_t k = (size_t)f->mi_row * f->MiCols + f->mi_col - 1;
            left = (f->is_inter[k] ? 4 << bh4_log2[f->mi_size[k]]
                                   : 1 << tx_hl[f->txsizes[k]]) >= maxh;
        }
        int ctx = above + left;
        uint16_t *cdf = splits == 1 ? f->cdf.tx_8x8[ctx]
                                    : f->cdf.tx[splits - 2][ctx];
        int depth = sym(f, cdf, (splits < 2 ? splits : 2) + 1, 0);
        for (int i = 0; i < depth; i++)
            t = split_tx(t);
    }
    f->txsz = t;
    set_txfm_ctx(f, f->mi_row, f->mi_col, f->bw4, f->bh4, 1 << tx_wl[t],
                 1 << tx_hl[t]);
}

static void intra_modes(Av1 *f, Choice *ch);

static void intra_frame_mode_info(Av1 *f)
{
    Cdfs *c = &f->cdf;
    Choice none = {0}, *ch;
    int ctx = 0;
    if (f->seg_enabled && f->seg_preskip)
        read_segment_id(f, 0);
    ch = f->ec.writing ? enc_choice(f) : &none;
    if (f->avail_u)
        ctx += MI(f->skips, f->mi_row - 1, f->mi_col);
    if (f->avail_l)
        ctx += MI(f->skips, f->mi_row, f->mi_col - 1);
    if (seg_active(f, f->segment_id, SEG_LVL_SKIP))
        f->skip = 1;
    else
        f->skip = sym(f, c->skip[ctx], 2, ch->skip);
    if (f->seg_enabled && !f->seg_preskip) {
        read_segment_id(f, f->skip);
        if (f->ec.writing)
            ch = enc_choice(f);
    }
    read_cdef(f);
    read_delta_qindex(f);
    read_delta_lf(f);
    f->blk_q = seg_q(f, f->segment_id, f->qindex);
    f->read_deltas = 0;
    f->use_intrabc = 0;
    if (f->allow_intrabc) {
        f->use_intrabc = sym(f, c->intrabc, 2, ch->intrabc);
        if (f->use_intrabc) {
            f->ymode = f->uvmode = DC_PRED;
            f->angle_y = f->angle_uv = f->cfl_u = f->cfl_v = 0;
            f->pal_y = f->pal_uv = f->use_filter_intra = 0;
            intrabc_vector(f);
            return;
        }
    }
    intra_modes(f, ch);
}

/* an intra block's modes (intra_frame_y_mode or, in an inter frame, y_mode
 * by Size_Group; uv_mode, CfL, angle deltas, palettes, filter intra) */
static void intra_modes(Av1 *f, Choice *ch)
{
    Cdfs *c = &f->cdf;
    uint16_t *ycdf = c->y_mode[size_group[f->mi_sz]];
    if (!f->inter_frame) {
        int above = f->avail_u ? MI(f->ymodes, f->mi_row - 1, f->mi_col)
                               : DC_PRED;
        int left = f->avail_l ? MI(f->ymodes, f->mi_row, f->mi_col - 1)
                              : DC_PRED;
        ycdf = c->kf_y_mode[intra_mode_context[above]]
                           [intra_mode_context[left]];
    }
    f->ymode = sym(f, ycdf, 13, ch->ymode);
    f->angle_y = 0;
    if (f->mi_sz >= BLOCK_8X8 && f->ymode >= V_PRED && f->ymode <= D67_PRED)
        f->angle_y = sym(f, c->angle_delta[f->ymode - V_PRED], 7,
                         ch->angle_y + 3) - 3;
    f->uvmode = DC_PRED;
    f->angle_uv = 0;
    f->cfl_u = f->cfl_v = 0;
    if (f->has_chroma) {
        /* CfL: lossless where the chroma block is 4 x 4, else in blocks
         * of at most 32 x 32 */
        int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
        int cfl_ok = f->blk_lossless ? plane_bsize(f->mi_sz, f->ssx, f->ssy) ==
                     BLOCK_4X4 : bw <= 32 && bh <= 32;
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

#include "av1_inter.h"

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
    f->segment_id = 0;
    f->blk_lossless = f->seg_lossless[0];
    if (!f->seg_enabled)
        for (int y = 0; y < f->bh4 && r + y < f->MiRows; y++)
            memset(&MI(f->seg_ids, r + y, c), 0,
                   (size_t)(f->bw4 < f->MiCols - c ? f->bw4 : f->MiCols - c));
    f->avail_u_uv = f->avail_u;
    f->avail_l_uv = f->avail_l;
    if (f->has_chroma && f->ssy && f->bh4 == 1)
        f->avail_u_uv = is_inside(f, r - 2, c);
    if (f->has_chroma && f->ssx && f->bw4 == 1)
        f->avail_l_uv = is_inside(f, r, c - 2);
    f->blk_inter = f->use_intrabc = f->motion_mode = f->interintra = 0;
    f->ref_frame[0] = INTRA_FRAME;
    f->ref_frame[1] = -1;
    memset(f->mv, 0, sizeof(f->mv));
    f->filt[0] = f->filt[1] = 0;
    if (f->inter_frame)
        inter_frame_mode_info(f);
    else
        intra_frame_mode_info(f);
    f->inter = f->use_intrabc || f->blk_inter;
    palette_tokens(f);
    read_tx_size(f);
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
            f->is_inter[k] = (uint8_t)f->inter;
            f->written[k] = 1;
            f->txsizes[k] = (uint8_t)f->txsz;
            for (int i = 0; i < 4; i++)
                f->delta_lfs[k * 4 + i] = (int8_t)f->delta_lf[i];
            f->ref_frames[2 * k] = (int8_t)f->ref_frame[0];
            f->ref_frames[2 * k + 1] = (int8_t)f->ref_frame[1];
            f->filters[2 * k] = (uint8_t)f->filt[0];
            f->filters[2 * k + 1] = (uint8_t)f->filt[1];
            if (f->use_intrabc) {
                f->mvs[4 * k] = (int16_t)f->mv_row;
                f->mvs[4 * k + 1] = (int16_t)f->mv_col;
                f->mvs[4 * k + 2] = f->mvs[4 * k + 3] = 0;
            } else {
                for (int i = 0; i < 4; i++)
                    f->mvs[4 * k + i] = (int16_t)f->mv[i >> 1][i & 1];
            }
        }
    if (f->save_ref)
        save_frame_mvs(f);
    if (f->use_intrabc)
        intrabc_predict(f);
    else if (f->blk_inter)
        predict_inter(f);
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
    if (plane_bsize(sub, f->ssx, f->ssy) < 0)
        av1_fail(f, ERR_VALUE, "AV1: a block size the chroma subsampling "
                 "does not allow");
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

/* -- loop restoration coefficients (specification 5.11.57-58) ------------ */

/* count_units_in_frame */
static int lr_count(int unit, int size)
{
    int n = (size + (unit >> 1)) / unit;
    return n > 1 ? n : 1;
}

/* decode_subexp_bool of numSyms symbols; in a writer the value v */
static int subexp_bool(Av1 *f, int num, int k, int v)
{
    int i = 0, mk = 0;
    for (;;) {
        int b2 = i ? k + i - 1 : k, a = 1 << b2;
        if (num <= mk + 3 * a)
            return ns_lit(f, num - mk, v - mk) + mk;
        if (!lit(f, 1, v >= mk + a))
            return lit(f, b2, v - mk) + mk;
        i++;
        mk += a;
    }
}

static int inverse_recenter(int r, int v)
{
    return v > 2 * r ? v : v & 1 ? r - ((v + 1) >> 1) : r + (v >> 1);
}

/* the writer's v of inverse_recenter(r, v) = x */
static int recenter(int r, int x)
{
    return x > 2 * r ? x : x >= r ? (x - r) << 1 : ((r - x) << 1) - 1;
}

/* decode_signed_subexp_with_ref_bool: a value of [low, high) coded
 * against the reference r; in a writer the value x */
static int subexp_ref(Av1 *f, int low, int high, int k, int r, int x)
{
    int mx = high - low, near = ((r - low) << 1) <= mx, v = 0;
    r -= low;
    if (f->ec.writing) {
        if (x < low || x >= high)
            av1_fail(f, ERR_VALUE, "writer: a restoration coefficient "
                     "%d outside [%d, %d)", x, low, high);
        x -= low;
        v = near ? recenter(r, x) : recenter(mx - 1 - r, mx - 1 - x);
    }
    v = subexp_bool(f, mx, k, v);
    return (near ? inverse_recenter(r, v)
                 : mx - 1 - inverse_recenter(mx - 1 - r, v)) + low;
}

static void read_lr_unit(Av1 *f, int plane, int row, int col)
{
    LrUnit *u = &f->lr_units[plane][(size_t)row * f->lr_cols[plane] + col];
    LrUnit none = {0};
    const LrUnit *w = f->ec.writing ? enc_lr_unit(f, plane, row, col)
                                    : &none;
    int type = f->lr_type[plane];
    if (type == RESTORE_SWITCHABLE)
        type = sym(f, f->cdf.switchable_restore, 3, w->type);
    else if (!sym(f, type == RESTORE_WIENER ? f->cdf.wiener_restore
                                            : f->cdf.sgrproj_restore, 2,
                  w->type == type))
        type = RESTORE_NONE;
    memset(u, 0, sizeof(*u));
    u->type = type;
    if (type == RESTORE_WIENER) {
        for (int pass = 0; pass < 2; pass++)
            for (int j = plane ? 1 : 0; j < 3; j++) {
                int v = subexp_ref(f, wiener_taps_min[j],
                                   wiener_taps_max[j] + 1, wiener_taps_k[j],
                                   f->ref_wiener[plane][pass][j],
                                   w->wiener[pass][j]);
                u->wiener[pass][j] = f->ref_wiener[plane][pass][j] = v;
            }
    } else if (type == RESTORE_SGRPROJ) {
        int set = lit(f, 4, w->sgr_set);
        u->sgr_set = set;
        for (int i = 0; i < 2; i++) {
            int mn = sgrproj_xqd_min[i], mx = sgrproj_xqd_max[i], v = 0;
            if (sgr_params[set][i]) { /* the radius of pass i */
                v = subexp_ref(f, mn, mx + 1, 4, f->ref_xqd[plane][i],
                               w->xqd[i]);
            } else if (i == 1) {
                v = 128 - f->ref_xqd[plane][0];
                v = v < mn ? mn : v > mx ? mx : v;
            }
            u->xqd[i] = f->ref_xqd[plane][i] = v;
        }
    }
}

/* read_lr: the coefficients of the units whose top left corner lies in
 * the superblock at (r, c) */
static void read_lr(Av1 *f, int r, int c, int sb4)
{
    if (f->allow_intrabc)
        return;
    for (int p = 0; p < f->nplanes; p++) {
        if (f->lr_type[p] == RESTORE_NONE)
            continue;
        int ssx = p ? f->ssx : 0, ssy = p ? f->ssy : 0, us = f->lr_size[p];
        /* columns of the upscaled frame under superres */
        int num = (4 >> ssx) * f->superres_denom, den = us * 8;
        int r0 = (r * (4 >> ssy) + us - 1) / us;
        int r1 = ((r + sb4) * (4 >> ssy) + us - 1) / us;
        int c0 = (c * num + den - 1) / den;
        int c1 = ((c + sb4) * num + den - 1) / den;
        r1 = r1 < f->lr_rows[p] ? r1 : f->lr_rows[p];
        c1 = c1 < f->lr_cols[p] ? c1 : f->lr_cols[p];
        for (int y = r0; y < r1; y++)
            for (int x = c0; x < c1; x++)
                read_lr_unit(f, p, y, x);
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
    f->qindex = f->base_q;
    memset(f->delta_lf, 0, sizeof(f->delta_lf));
    for (int p = 0; p < 3; p++)
        for (int pass = 0; pass < 2; pass++) {
            f->ref_xqd[p][pass] = sgrproj_xqd_mid[pass];
            for (int i = 0; i < 3; i++)
                f->ref_wiener[p][pass][i] = wiener_taps_mid[i];
        }
    for (int p = 0; p < f->nplanes; p++) {
        int ssx = p ? f->ssx : 0;
        memset(f->above_level[p] + (f->mi_col_start >> ssx), 0,
               (size_t)((f->mi_col_end - f->mi_col_start) >> ssx) + 34);
        memset(f->above_dc[p] + (f->mi_col_start >> ssx), 0,
               (size_t)((f->mi_col_end - f->mi_col_start) >> ssx) + 34);
    }
    memset(f->above_txfm + f->mi_col_start, 64,
           (size_t)(f->mi_col_end - f->mi_col_start) + 32);
    for (int r = f->mi_row_start; r < f->mi_row_end; r += sb4) {
        memset(f->left_txfm, 64, (size_t)f->MiRows + 64);
        for (int p = 0; p < f->nplanes; p++) {
            memset(f->left_level[p], 0, (size_t)f->MiRows + 34);
            memset(f->left_dc[p], 0, (size_t)f->MiRows + 34);
        }
        for (int c = f->mi_col_start; c < f->mi_col_end; c += sb4) {
            f->read_deltas = f->delta_q_present;
            for (int y = r; y < r + sb4; y += 16)
                for (int x = c; x < c + sb4; x += 16)
                    f->cdef_idx[(y >> 4) * f->cdef_cols + (x >> 4)] = -1;
            clear_block_decoded(f, r, c, sb4);
            read_lr(f, r, c, sb4);
            superblock(f, r, c);
        }
    }
}

/* -- the loop filter (specification 7.14; libaom's filters) --------------- */

static int lf_level(Av1 *f, int row, int col, int plane, int pass)
{
    size_t k = (size_t)row * f->MiCols + col;
    int i = plane == 0 ? pass : plane + 1;
    int lvl = f->lf_level[i], id = f->seg_ids[k];
    if (f->delta_lf_present) {
        lvl += f->delta_lfs[k * 4 + (f->delta_lf_multi ? i : 0)];
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
    }
    if (seg_active(f, id, SEG_LVL_ALT_LF_Y_V + i)) {
        lvl += f->seg_data[id][SEG_LVL_ALT_LF_Y_V + i];
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
    }
    if (f->lf_delta_enabled) {
        /* loop_filter_ref_deltas by the block's first reference frame,
         * and an inter block's mode delta (1 but for GLOBALMV) */
        int ref = f->ref_frames ? f->ref_frames[2 * k] : 0, sc = 1 << (lvl >> 5);
        ref = ref < 0 ? 0 : ref;
        lvl += f->lf_ref[ref] * sc;
        if (ref > 0)
            lvl += f->lf_mode[f->ymodes[k] != GLOBALMV] * sc;
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
    }
    return lvl;
}

static int sclamp(int v, int bd)
{
    int m = 128 << (bd - 8);
    return v < -m ? -m : v > m - 1 ? m - 1 : v;
}

/* one sample position of an edge; s at q0, st the step across the edge */
static void sample_filter(Av1 *f, uint16_t *s, ptrdiff_t st, int size,
                          int plane, int lvl)
{
    int bd = f->bitdepth, sh = bd - 8;
    int shp = f->lf_sharpness;
    int limit = lvl >> ((shp > 0) + (shp > 4));
    if (shp > 0 && limit > 9 - shp)
        limit = 9 - shp;
    if (limit < 1)
        limit = 1;
    int blimit = 2 * (lvl + 2) + limit, thresh = lvl >> 4;
    int lim = limit << sh, blim = blimit << sh, thr = thresh << sh;
    int one = 1 << sh;
    int taps = size == 4 ? 2 : plane ? 3 : size == 8 ? 4 : 7;
    int v[14]; /* p6 .. p0 at 0 .. 6, q0 .. q6 at 7 .. 13 */
    for (int i = 0; i < taps; i++) {
        v[6 - i] = s[-(i + 1) * st];
        v[7 + i] = s[i * st];
    }
#define P(i) v[6 - (i)]
#define Q(i) v[7 + (i)]
    if (abs(P(1) - P(0)) > lim || abs(Q(1) - Q(0)) > lim ||
        abs(P(0) - Q(0)) * 2 + abs(P(1) - Q(1)) / 2 > blim)
        return;
    if (taps >= 3 && (abs(P(2) - P(1)) > lim || abs(Q(2) - Q(1)) > lim))
        return;
    if (taps >= 4 && (abs(P(3) - P(2)) > lim || abs(Q(3) - Q(2)) > lim))
        return;
    int flat = 0, flat2 = 0;
    if (taps >= 3) {
        flat = abs(P(1) - P(0)) <= one && abs(Q(1) - Q(0)) <= one &&
               abs(P(2) - P(0)) <= one && abs(Q(2) - Q(0)) <= one;
        if (taps >= 4)
            flat = flat && abs(P(3) - P(0)) <= one &&
                   abs(Q(3) - Q(0)) <= one;
    }
    if (taps == 7)
        flat2 = abs(P(4) - P(0)) <= one && abs(Q(4) - Q(0)) <= one &&
                abs(P(5) - P(0)) <= one && abs(Q(5) - Q(0)) <= one &&
                abs(P(6) - P(0)) <= one && abs(Q(6) - Q(0)) <= one;
    if (flat) {
        /* the wide filters: n samples each side, 2^log2 in all */
        int n = flat2 ? 6 : taps == 3 ? 2 : 3, log2 = flat2 ? 4 : 3;
        int n2 = (log2 == 3 && plane == 0) ? 0 : 1;
        int out[12];
        for (int i = -n; i < n; i++) {
            int t = 0;
            for (int j = -n; j <= n; j++) {
                int p = i + j;
                p = p < -(n + 1) ? -(n + 1) : p > n ? n : p;
                t += v[7 + p] * (abs(j) <= n2 ? 2 : 1);
            }
            out[i + n] = (t + (1 << (log2 - 1))) >> log2;
        }
        for (int i = -n; i < n; i++)
            s[i * st] = (uint16_t)out[i + n];
        return;
    }
    int hev = abs(P(1) - P(0)) > thr || abs(Q(1) - Q(0)) > thr;
    int off = 0x80 << sh;
    int ps1 = P(1) - off, ps0 = P(0) - off, qs0 = Q(0) - off;
    int qs1 = Q(1) - off;
    int filt = hev ? sclamp(ps1 - qs1, bd) : 0;
    filt = sclamp(filt + 3 * (qs0 - ps0), bd);
    int f1 = sclamp(filt + 4, bd) >> 3, f2 = sclamp(filt + 3, bd) >> 3;
    s[0] = (uint16_t)(sclamp(qs0 - f1, bd) + off);
    s[-st] = (uint16_t)(sclamp(ps0 + f2, bd) + off);
    if (!hev) {
        filt = (f1 + 1) >> 1;
        s[st] = (uint16_t)(sclamp(qs1 - filt, bd) + off);
        s[-2 * st] = (uint16_t)(sclamp(ps1 + filt, bd) + off);
    }
#undef P
#undef Q
}

static void edge_filter_4x4(Av1 *f, int plane, int pass, int row, int col)
{
    int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
    int x = col * 4, y = row * 4;
    if (x >= f->W || y >= f->H || (pass == 0 && x == 0) ||
        (pass == 1 && y == 0))
        return;
    int xp = x >> ssx, yp = y >> ssy;
    row |= ssy;
    col |= ssx;
    int prow = row - (pass ? 1 << ssy : 0), pcol = col - (pass ? 0 : 1 << ssx);
    int t = f->lf_tx[plane][(size_t)(row >> ssy) * f->MiCols + (col >> ssx)];
    int pt = f->lf_tx[plane][(size_t)(prow >> ssy) * f->MiCols +
                             (pcol >> ssx)];
    /* transform edges only; between two skipped inter blocks (or intra
     * block copy ones), prediction block edges only */
    if (pass == 0 ? xp & ((1 << tx_wl[t]) - 1) : yp & ((1 << tx_hl[t]) - 1))
        return;
    size_t k = (size_t)row * f->MiCols + col;
    size_t pk = (size_t)prow * f->MiCols + pcol;
    if (f->skips[k] && f->is_inter[k] && f->skips[pk] && f->is_inter[pk]) {
        int pb = plane_bsize(f->mi_size[k], ssx, ssy);
        if (pass == 0 ? xp & ((4 << bw4_log2[pb]) - 1)
                      : yp & ((4 << bh4_log2[pb]) - 1))
            return;
    }
    int base = pass == 0 ? (tx_wl[t] < tx_wl[pt] ? tx_wl[t] : tx_wl[pt])
                         : (tx_hl[t] < tx_hl[pt] ? tx_hl[t] : tx_hl[pt]);
    int size = 1 << base;
    if (size > (plane ? 8 : 16))
        size = plane ? 8 : 16;
    int lvl = lf_level(f, row, col, plane, pass);
    if (!lvl)
        lvl = lf_level(f, prow, pcol, plane, pass);
    if (!lvl)
        return;
    for (int i = 0; i < 4; i++) {
        uint16_t *s = pass == 0 ? &PX(plane, yp + i, xp)
                                : &PX(plane, yp, xp + i);
        sample_filter(f, s, pass == 0 ? 1 : f->stride, size, plane, lvl);
    }
}

static void loop_filter(Av1 *f)
{
    if (!f->lf_level[0] && !f->lf_level[1])
        return;
    for (int plane = 0; plane < f->nplanes; plane++) {
        if (plane && !f->lf_level[plane + 1])
            continue;
        int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
        for (int pass = 0; pass < 2; pass++)
            for (int row = 0; row < f->MiRows; row += 1 << ssy)
                for (int col = 0; col < f->MiCols; col += 1 << ssx)
                    edge_filter_4x4(f, plane, pass, row, col);
    }
}

/* -- CDEF (specification 7.15) -------------------------------------------- */

static int cdef_direction(Av1 *f, const uint16_t *src, int r, int c,
                          int *var)
{
    static const int div[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
    int cost[8] = {0}, partial[8][15];
    memset(partial, 0, sizeof(partial));
    int x0 = c * 4, y0 = r * 4, sh = f->bitdepth - 8;
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            int x = (src[(size_t)(y0 + i) * f->stride + x0 + j] >> sh) - 128;
            partial[0][i + j] += x;
            partial[1][i + j / 2] += x;
            partial[2][i] += x;
            partial[3][3 + i - j / 2] += x;
            partial[4][7 + i - j] += x;
            partial[5][3 - i / 2 + j] += x;
            partial[6][j] += x;
            partial[7][i / 2 + j] += x;
        }
    for (int i = 0; i < 8; i++) {
        cost[2] += partial[2][i] * partial[2][i];
        cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= div[8];
    cost[6] *= div[8];
    for (int i = 0; i < 7; i++) {
        cost[0] += (partial[0][i] * partial[0][i] +
                    partial[0][14 - i] * partial[0][14 - i]) * div[i + 1];
        cost[4] += (partial[4][i] * partial[4][i] +
                    partial[4][14 - i] * partial[4][14 - i]) * div[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * div[8];
    cost[4] += partial[4][7] * partial[4][7] * div[8];
    for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; j++)
            cost[i] += partial[i][3 + j] * partial[i][3 + j];
        cost[i] *= div[8];
        for (int j = 0; j < 3; j++)
            cost[i] += (partial[i][j] * partial[i][j] +
                        partial[i][10 - j] * partial[i][10 - j]) *
                       div[2 * j + 2];
    }
    int best = 0, dir = 0;
    for (int i = 0; i < 8; i++)
        if (cost[i] > best) {
            best = cost[i];
            dir = i;
        }
    *var = (best - cost[(dir + 4) & 7]) >> 10;
    return dir;
}

static int floor_log2(int x)
{
    int n = -1;
    while (x) {
        n++;
        x >>= 1;
    }
    return n;
}

/* constrain() of the specification for a threshold above 0, its damping
 * adjustment (Max(0, damping - FloorLog2(threshold))) given */
static int constrain(int diff, int thr, int adj)
{
    int a = abs(diff), m = thr - (a >> adj);
    int v = m < 0 ? 0 : a < m ? a : m;
    return diff < 0 ? -v : v;
}

static void cdef_filter(Av1 *f, const uint16_t *src, int plane, int r, int c,
                        int pri, int sec, int damping, int dir)
{
    int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
    int x0 = (c * 4) >> ssx, y0 = (r * 4) >> ssy;
    int w = 8 >> ssx, h = 8 >> ssy, sh = f->bitdepth - 8;
    int xlim = (f->MiCols * 4) >> ssx, ylim = (f->MiRows * 4) >> ssy;
    /* every tap (at most 2 samples away) inside the frame */
    int inside = x0 >= 2 && y0 >= 2 && x0 + w + 2 <= xlim &&
                 y0 + h + 2 <= ylim;
    const int *pt = cdef_pri_taps[(pri >> sh) & 1];
    int padj = 0, sadj = 0;
    if (!pri && !sec)
        return; /* the output is the input */
    if (pri) {
        padj = damping - floor_log2(pri);
        padj = padj < 0 ? 0 : padj;
    }
    if (sec) {
        sadj = damping - floor_log2(sec);
        sadj = sadj < 0 ? 0 : sadj;
    }
    int dirs[3] = {dir, (dir + 6) & 7, (dir + 2) & 7};
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int x = src[(size_t)(y0 + i) * f->stride + x0 + j];
            int sum = 0, mx = x, mn = x;
            for (int k = 0; k < 2; k++)
                for (int sg = -1; sg <= 1; sg += 2)
                    for (int d = 0; d < 3; d++) {
                        /* the primary tap, then the two secondary ones */
                        if (d == 0 ? !pri : !sec)
                            continue;
                        int yy = y0 + i + sg * cdef_directions[dirs[d]][k][0];
                        int xx = x0 + j + sg * cdef_directions[dirs[d]][k][1];
                        if (!inside && (yy < 0 || xx < 0 || yy >= ylim ||
                                        xx >= xlim))
                            continue;
                        int p = src[(size_t)yy * f->stride + xx];
                        sum += d == 0 ? pt[k] * constrain(p - x, pri, padj)
                                      : cdef_sec_taps[k] *
                                        constrain(p - x, sec, sadj);
                        mx = p > mx ? p : mx;
                        mn = p < mn ? p : mn;
                    }
            int y = x + ((8 + sum - (sum < 0)) >> 4);
            PX(plane, y0 + i, x0 + j) = (uint16_t)(y < mn ? mn : y > mx ? mx
                                                                      : y);
        }
}

/* the deblocked planes, kept in pre_cdef: CDEF's input, and the rows
 * loop restoration reads past a stripe's edges */
static void keep_deblocked(Av1 *f)
{
    size_t size = (size_t)f->stride * f->rows;
    for (int p = 0; p < f->nplanes; p++) {
        if (!f->pre_cdef[p])
            f->pre_cdef[p] = av1_alloc(f, size * 2);
        memcpy(f->pre_cdef[p], f->plane[p], size * 2);
    }
}

static void cdef_frame(Av1 *f)
{
    if (!f->cdef_en || f->lossless || f->allow_intrabc)
        return;
    static const uint8_t uv_dir[2][2][8] = {
        {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
        {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
    uint16_t *const *src = f->pre_cdef;
    int sh = f->bitdepth - 8;
    for (int r = 0; r < f->MiRows; r += 2)
        for (int c = 0; c < f->MiCols; c += 2) {
            int idx = f->cdef_idx[(r >> 4) * f->cdef_cols + (c >> 4)];
            size_t k = (size_t)r * f->MiCols + c;
            if (idx < 0 || (f->skips[k] && f->skips[k + 1] &&
                            f->skips[k + f->MiCols] &&
                            f->skips[k + f->MiCols + 1]))
                continue;
            int var, ydir = cdef_direction(f, src[0], r, c, &var);
            int pri = f->cdef_pri[0][idx] << sh, sec = f->cdef_sec[0][idx] << sh;
            int dir = pri ? ydir : 0;
            int vs = (var >> 6) ? floor_log2(var >> 6) : 0;
            if (vs > 12)
                vs = 12;
            int adj = var ? (pri * (4 + vs) + 8) >> 4 : 0;
            cdef_filter(f, src[0], 0, r, c, adj, sec,
                        f->cdef_damping + sh, dir);
            if (f->nplanes == 1)
                continue;
            pri = f->cdef_pri[1][idx] << sh;
            sec = f->cdef_sec[1][idx] << sh;
            dir = pri ? uv_dir[f->ssx][f->ssy][ydir] : 0;
            for (int p = 1; p < 3; p++)
                cdef_filter(f, src[p], p, r, c, pri, sec,
                            f->cdef_damping + sh - 1, dir);
        }
}

/* -- loop restoration (specification 7.17; libaom's restoration.c) ------- */

/* the Wiener filter of rows [0, h) and columns [x0, x1) of a stripe
 * buffer (b: row -3, column -3 of the plane at b[0], stride bs) into out
 * (the plane's first row of the stripe) */
static void lr_wiener(Av1 *f, const LrUnit *u, const int32_t *b, int bs,
                      int h, int x0, int x1, uint16_t *out)
{
    int bd = f->bitdepth, r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
    int off = 1 << (bd + 6 - r0), lim = (1 << (bd + 8 - r0)) - 1;
    int hf[7], vf[7];
    for (int pass = 0; pass < 2; pass++) {
        int *t = pass ? hf : vf;
        const int *c = u->wiener[pass];
        t[3] = 128 - 2 * (c[0] + c[1] + c[2]);
        for (int i = 0; i < 3; i++)
            t[i] = t[6 - i] = c[i];
    }
    int w = x1 - x0;
    int32_t *tmp = f->lr_buf + (size_t)bs * (h + 6);
    for (int r = 0; r < h + 6; r++)
        for (int c = 0; c < w; c++) {
            const int32_t *s = b + (size_t)r * bs + x0 + c;
            int sum = 0;
            for (int t = 0; t < 7; t++)
                sum += hf[t] * s[t];
            int v = round2(sum, r0);
            tmp[r * w + c] = v < -off ? -off : v > lim - off ? lim - off : v;
        }
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int sum = 0;
            for (int t = 0; t < 7; t++)
                sum += vf[t] * tmp[(r + t) * w + c];
            out[(size_t)r * f->stride + x0 + c] =
                (uint16_t)clip1(f, round2(sum, r1));
        }
}

/* box_filter_process of one pass of a self-guided set (radius 2 on every
 * other row, libaom's fast filter; radius 1 on every row): flt[h][w] */
static void lr_box(Av1 *f, int set, int pass, const int32_t *b, int bs,
                   int h, int x0, int x1, int32_t *flt)
{
    int r = sgr_params[set][pass], n = (2 * r + 1) * (2 * r + 1);
    uint32_t s = (uint32_t)sgr_params[set][2 + pass];
    int bd = f->bitdepth, w = x1 - x0, aw = w + 2;
    int32_t *A = flt + (size_t)h * w, *B = A + (size_t)aw * (h + 2);
    for (int i = -1; i <= h; i++) {
        if (pass == 0 && !(i & 1))
            continue; /* only the odd rows (stripes start on even rows) */
        for (int j = -1; j <= w; j++) {
            uint32_t sq = 0, sum = 0;
            for (int dy = -r; dy <= r; dy++) {
                const int32_t *row = b + (size_t)(i + 3 + dy) * bs + x0 + 3 +
                                     j;
                for (int dx = -r; dx <= r; dx++) {
                    uint32_t c = (uint32_t)row[dx];
                    sq += c * c;
                    sum += c;
                }
            }
            uint32_t a = (uint32_t)round2((int)sq, 2 * (bd - 8));
            uint32_t d = (uint32_t)round2((int)sum, bd - 8);
            uint32_t p = a * n < d * d ? 0 : a * n - d * d;
            uint32_t z = (p * s + (1u << 19)) >> 20;
            uint32_t a2 = (uint32_t)x_by_xplus1[z < 255 ? z : 255];
            size_t k = (size_t)(i + 1) * aw + j + 1;
            A[k] = (int32_t)a2;
            B[k] = (int32_t)(((256 - a2) * sum * (uint32_t)one_by_x[n - 1] +
                              (1u << 11)) >> 12);
        }
    }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            size_t k = (size_t)(i + 1) * aw + j + 1;
            int32_t a, bb, nb = 5;
            if (pass == 0 && !(i & 1)) {
                a = (A[k - aw] + A[k + aw]) * 6 + (A[k - 1 - aw] +
                    A[k - 1 + aw] + A[k + 1 - aw] + A[k + 1 + aw]) * 5;
                bb = (B[k - aw] + B[k + aw]) * 6 + (B[k - 1 - aw] +
                     B[k - 1 + aw] + B[k + 1 - aw] + B[k + 1 + aw]) * 5;
            } else if (pass == 0) {
                a = A[k] * 6 + (A[k - 1] + A[k + 1]) * 5;
                bb = B[k] * 6 + (B[k - 1] + B[k + 1]) * 5;
                nb = 4;
            } else {
                a = (A[k] + A[k - 1] + A[k + 1] + A[k - aw] + A[k + aw]) * 4
                    + (A[k - 1 - aw] + A[k - 1 + aw] + A[k + 1 - aw] +
                       A[k + 1 + aw]) * 3;
                bb = (B[k] + B[k - 1] + B[k + 1] + B[k - aw] + B[k + aw]) * 4
                     + (B[k - 1 - aw] + B[k - 1 + aw] + B[k + 1 - aw] +
                        B[k + 1 + aw]) * 3;
            }
            int32_t v = a * b[(size_t)(i + 3) * bs + x0 + 3 + j] + bb;
            flt[(size_t)i * w + j] = round2(v, 8 + nb - 4);
        }
}

/* the self-guided filter of a stripe's unit: both passes, projected */
static void lr_sgrproj(Av1 *f, const LrUnit *u, const int32_t *b, int bs,
                       int h, int x0, int x1, uint16_t *out)
{
    int w = x1 - x0, set = u->sgr_set;
    size_t part = (size_t)h * w + 2 * (size_t)(w + 2) * (h + 2);
    int32_t *flt0 = f->lr_buf + (size_t)bs * (h + 6), *flt1 = flt0 + part;
    int xq0 = 0, xq1 = 0;
    if (sgr_params[set][0]) {
        lr_box(f, set, 0, b, bs, h, x0, x1, flt0);
        xq0 = u->xqd[0];
    }
    if (sgr_params[set][1]) {
        lr_box(f, set, 1, b, bs, h, x0, x1, flt1);
        xq1 = 128 - xq0 - u->xqd[1];
    }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int32_t uu = b[(size_t)(i + 3) * bs + x0 + 3 + j] << 4;
            int32_t v = uu << 7;
            if (sgr_params[set][0])
                v += xq0 * (flt0[(size_t)i * w + j] - uu);
            if (sgr_params[set][1])
                v += xq1 * (flt1[(size_t)i * w + j] - uu);
            out[(size_t)i * f->stride + x0 + j] =
                (uint16_t)clip1(f, (int16_t)round2(v, 11));
        }
}

/* lr_frame_process: each plane stripe by stripe (64 luma rows, the first
 * 8 shorter), each stripe unit by unit.  The stripe's samples are taken
 * once into a buffer with 3 rows and columns around it, as
 * get_source_sample takes them: columns clamped to the plane, rows to the
 * plane, then rows above or below the stripe from the deblocked frame
 * before CDEF, at most 2 away (the frame's own top and bottom rows come
 * from the CDEF output). */
static void lr_frame(Av1 *f)
{
    for (int p = 0; p < f->nplanes; p++) {
        if (f->lr_type[p] == RESTORE_NONE)
            continue;
        int ssx = p ? f->ssx : 0, ssy = p ? f->ssy : 0, us = f->lr_size[p];
        int pw = (f->W + ssx) >> ssx, ph = (f->H + ssy) >> ssy;
        int bs = pw + 6;
        for (int st = 0;; st++) {
            int top = (64 * st - 8) >> ssy, end = top + (64 >> ssy) - 1;
            int y0 = top > 0 ? top : 0, y1 = end < ph - 1 ? end + 1 : ph;
            if (y0 >= ph)
                break;
            int h = y1 - y0;
            int32_t *b = f->lr_buf;
            for (int k = 0; k < h + 6; k++) {
                int y = y0 - 3 + k;
                y = y < 0 ? 0 : y > ph - 1 ? ph - 1 : y;
                const uint16_t *src = f->plane[p];
                if (y < top) {
                    y = y > top - 2 ? y : top - 2;
                    src = f->pre_cdef[p];
                } else if (y > end) {
                    y = y < end + 2 ? y : end + 2;
                    src = f->pre_cdef[p];
                }
                const uint16_t *row = src + (size_t)y * f->stride;
                for (int j = 0; j < bs; j++) {
                    int x = j - 3;
                    b[(size_t)k * bs + j] = row[x < 0 ? 0 : x > pw - 1 ? pw - 1
                                                                         : x];
                }
            }
            int ur = ((y0 << ssy) + 8) >> ssy;
            ur = ur / us < f->lr_rows[p] - 1 ? ur / us : f->lr_rows[p] - 1;
            uint16_t *out = f->plane[p] + (size_t)y0 * f->stride;
            for (int uc = 0; uc < f->lr_cols[p]; uc++) {
                const LrUnit *u =
                    &f->lr_units[p][(size_t)ur * f->lr_cols[p] + uc];
                int x0 = uc * us;
                int x1 = uc == f->lr_cols[p] - 1 ? pw : x0 + us;
                if (u->type == RESTORE_WIENER)
                    lr_wiener(f, u, b, bs, h, x0, x1, out);
                else if (u->type == RESTORE_SGRPROJ)
                    lr_sgrproj(f, u, b, bs, h, x0, x1, out);
            }
        }
    }
}

/* -- superres (specification 7.16; libaom's av1_upscale_normative_rows) -- */

/* one plane's rows [0, rows) of width w (samples up to the decoded width
 * dw read, the edges repeated) upscaled to uw samples into dst: libaom's
 * 8-tap normative filter at its x0 and step, continuous across tile
 * columns */
static void upscale_rows(Av1 *f, const uint16_t *src, uint16_t *dst,
                         int stride, int dstride, int rows, int w, int dw,
                         int uw)
{
    int32_t step = ((w << 14) + uw / 2) / uw;
    int32_t err = uw * step - (w << 14);
    int32_t x0 = (-((uw - w) << 13) + uw / 2) / uw + 128 - err / 2;
    x0 &= (1 << 14) - 1;
    for (int y = 0; y < rows; y++) {
        const uint16_t *s = src + (size_t)y * stride;
        uint16_t *d = dst + (size_t)y * dstride;
        int32_t xq = x0;
        for (int x = 0; x < uw; x++, xq += step) {
            const int16_t *k = resize_filter[(xq & ((1 << 14) - 1)) >> 8];
            int sum = 0;
            for (int t = 0; t < 8; t++) {
                int sx = (xq >> 14) + t - 4;
                sum += s[sx < 0 ? 0 : sx > dw - 1 ? dw - 1 : sx] * k[t];
            }
            d[x] = (uint16_t)clip1(f, round2(sum, 7));
        }
    }
}

/* the frame (and the deblocked planes that loop restoration reads)
 * widened from the coded width to UpscaledWidth */
static void superres_upscale(Av1 *f)
{
    int stride = ((f->up_w + 7) & ~7) + 64, lr = 0;
    for (int p = 0; p < f->nplanes; p++)
        lr |= f->lr_type[p] != RESTORE_NONE;
    for (int p = 0; p < f->nplanes; p++) {
        int ssx = p ? f->ssx : 0, ssy = p ? f->ssy : 0;
        int w = (f->W + ssx) >> ssx, uw = (f->up_w + ssx) >> ssx;
        int dw = (f->MiCols * 4) >> ssx, rows = (f->H + ssy) >> ssy;
        for (int k = 0; k < 2; k++) {
            uint16_t **pl = k ? &f->pre_cdef[p] : &f->plane[p];
            if (!*pl || (k && !lr))
                continue;
            uint16_t *up = av1_alloc(f, (size_t)stride * f->rows * 2);
            upscale_rows(f, *pl, up, f->stride, stride, rows, w, dw, uw);
            free(*pl);
            *pl = up;
        }
    }
    f->stride = stride;
    f->W = f->up_w;
}

/* the in-loop filters of a decoded (or written) frame: deblocking, CDEF,
 * superres, loop restoration */
static void postfilter(Av1 *f)
{
    if (f->allow_intrabc)
        return;
    if (!f->lossless)
        loop_filter(f);
    int lr = 0;
    for (int p = 0; p < f->nplanes; p++)
        lr |= f->lr_type[p] != RESTORE_NONE;
    if (lr || (f->cdef_en && !f->lossless))
        keep_deblocked(f);
    cdef_frame(f);
    if (f->up_w != f->W) {
#ifdef LR_CLOCK
        double t0 = LR_CLOCK();
#endif
        superres_upscale(f);
#ifdef LR_CLOCK
        f->superres_ms += LR_CLOCK() - t0;
#endif
    }
    if (lr) {
#ifdef LR_CLOCK
        double t0 = LR_CLOCK();
#endif
        lr_frame(f);
#ifdef LR_CLOCK
        f->lr_ms += LR_CLOCK() - t0;
#endif
    }
}

/* the restoration unit grid of each plane, and the buffers of the filter */
static void lr_alloc(Av1 *f)
{
    int lr = 0;
    for (int p = 0; p < f->nplanes; p++) {
        f->lr_rows[p] = f->lr_cols[p] = 0;
        if (f->lr_type[p] == RESTORE_NONE)
            continue;
        int ssx = p ? f->ssx : 0, ssy = p ? f->ssy : 0;
        f->lr_rows[p] = lr_count(f->lr_size[p], (f->H + ssy) >> ssy);
        f->lr_cols[p] = lr_count(f->lr_size[p], (f->up_w + ssx) >> ssx);
        f->lr_units[p] = av1_alloc(f, sizeof(LrUnit) * (size_t)f->lr_rows[p]
                                   * f->lr_cols[p]);
        lr = 1;
    }
    if (lr) {
        /* the stripe (70 rows), then the Wiener rows or the two passes of
         * the self-guided filter over a unit (at most 64 x 384 + 4:4:4's
         * 70 x 390 for A and B, per pass) */
        size_t bs = (size_t)f->up_w + 6, unit = 70 * 390 * 3;
        f->lr_buf = av1_alloc(f, (bs * 70 + 2 * unit) * sizeof(int32_t));
    }
}

static void frame_alloc(Av1 *f)
{
    size_t n = (size_t)f->MiRows * f->MiCols;
    f->stride = f->MiCols * 4 + 64;
    f->rows = f->MiRows * 4 + 64;
    f->cdef_cols = (f->MiCols + 31) >> 4;
    f->cdef_idx = av1_alloc(f, (size_t)f->cdef_cols * ((f->MiRows + 31) >> 4));
    f->txsizes = av1_alloc(f, n);
    f->delta_lfs = av1_alloc(f, n * 4);
    for (int p = 0; p < f->nplanes; p++) {
        f->lf_tx[p] = av1_alloc(f, n);
        f->plane[p] = av1_alloc(f, (size_t)f->stride * f->rows * 2);
        f->above_level[p] = av1_alloc(f, (size_t)f->MiCols + 68);
        f->above_dc[p] = av1_alloc(f, (size_t)f->MiCols + 68);
        f->left_level[p] = av1_alloc(f, (size_t)f->MiRows + 68);
        f->left_dc[p] = av1_alloc(f, (size_t)f->MiRows + 68);
    }
    f->mi_size = av1_alloc(f, n);
    f->vtx = av1_alloc(f, n);
    f->seg_ids = av1_alloc(f, n);
    f->tx_types = av1_alloc(f, n);
    f->above_txfm = av1_alloc(f, (size_t)f->MiCols + 68);
    f->left_txfm = av1_alloc(f, (size_t)f->MiRows + 68);
    f->is_inter = av1_alloc(f, n);
    f->written = av1_alloc(f, n);
    f->mvs = av1_alloc(f, n * 8);
    f->ref_frames = av1_alloc(f, n * 2);
    f->filters = av1_alloc(f, n * 2);
    f->seg_preds = av1_alloc(f, n);
    f->ymodes = av1_alloc(f, n);
    f->uvmodes = av1_alloc(f, n);
    f->skips = av1_alloc(f, n);
    for (int k = 0; k < 2; k++) {
        f->pal_sizes[k] = av1_alloc(f, n);
        f->pal_colors[k] = av1_alloc(f, n * 16);
    }
    lr_alloc(f);
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
    for (int p = 0; p < 3; p++) {
        free(f->lf_tx[p]);
        f->lf_tx[p] = NULL;
    }
    for (int p = 0; p < 3; p++) {
        free(f->lr_units[p]);
        free(f->pre_cdef[p]);
        f->lr_units[p] = NULL;
        f->pre_cdef[p] = NULL;
    }
    free(f->lr_buf);
    f->lr_buf = NULL;
    for (int k = 0; k < 9; k++) {
        free(f->grain_buf[k]);
        f->grain_buf[k] = NULL;
    }
    free(f->cdef_idx);
    free(f->txsizes);
    free(f->delta_lfs);
    f->cdef_idx = NULL;
    f->txsizes = NULL;
    f->delta_lfs = NULL;
    free(f->mi_size);
    free(f->vtx);
    free(f->seg_ids);
    f->seg_ids = NULL;
    free(f->tx_types);
    free(f->above_txfm);
    free(f->left_txfm);
    f->vtx = f->tx_types = f->above_txfm = f->left_txfm = NULL;
    free(f->is_inter);
    free(f->written);
    free(f->mvs);
    free(f->ref_frames);
    free(f->filters);
    free(f->seg_preds);
    free(f->tpl_mv);
    free(f->tpl_off);
    free(f->save_ref);
    free(f->save_mv);
    free(f->pred_tmp);
    free(f->pred_blk);
    f->ref_frames = NULL;
    f->filters = f->seg_preds = NULL;
    f->tpl_mv = f->save_mv = NULL;
    f->tpl_off = f->save_ref = NULL;
    f->pred_tmp = NULL;
    f->pred_blk = NULL;
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
