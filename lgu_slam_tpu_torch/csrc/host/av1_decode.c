/* An AV1 decoder for the port's AVIF reader (data/avif.py): the OBUs of
 * one AVIF item (sequence headers, frames or frame headers and tile
 * groups) decoded to 16-bit planes as libaom 3.14 decodes them.
 *
 * Read: profiles 0-2, 8 / 10 / 12 bits, mono_chrome, 4:4:4, 4:2:2 and
 * 4:2:0 chroma, the reduced still picture header and full sequence and
 * frame headers, tiles (uniform or not), 64 or 128 superblocks, every
 * partition, the mode info of key and intra-only frames (segment ids,
 * skip, CDEF index, delta q and delta lf, y and uv modes, angle deltas,
 * CfL, palettes with their colour cache, filter intra, tx_depth, intra
 * block copy in lossless and lossy frames with its variable transform
 * partition), segmentation (every feature: a segment's qindex, lossless
 * segments, loop filter levels, skip), the loop restoration units'
 * coefficients and the coefficients of every transform size and type,
 * lossless or lossy; then deblocking, CDEF, superres (libaom's normative
 * upscale) and loop restoration.  Inter frames (av1_inter.h): their
 * header (references, frame_size_with_refs, global motion, the CDFs, loop
 * filter deltas and segmentation features of the primary reference
 * frame), single-reference inter blocks with OBMC, local warp and
 * inter-intra, from references of the same or another size, chroma
 * blocks over several luma blocks, with the temporal vector candidates of
 * the projected motion field, as the layers
 * of a layered (progressive) AVIF item carry them; each frame's CDFs,
 * deltas, segment ids and motion field are kept in its slot for the
 * frames that reference it.  An item may hold several frames: each is
 * decoded, the reference slots keep them for show_existing_frame and
 * inter prediction, and the last frame shown (or the first of the spatial
 * layer libavif's lsel selects) is output with its film grain
 * (av1_grain.h), as libaom outputs it; a changed sequence header starts a
 * new sequence at its key frame.  The tile syntax, reconstruction and
 * filters are in av1_core.h.  The OBUs are checked as libaom's
 * aom_decode_frame_from_obus checks them (sizes, trailing bits and zero
 * padding, reserved types, the operating point, tile group order, zero
 * bytes between frames, frame ids, showable frames, tile columns under
 * superres, references of another format or of a size libaom cannot
 * scale).  A tool no layered item here uses returns ERR_NOTIMPL naming it:
 * at once where nothing decodes it (compound prediction, skip mode, switch
 * frames, frame_refs_short_signaling, a reference replaced by its order
 * hint), else at the end of a decode that libaom's checks pass, the code
 * that reads it run but not held against libaom by any file (a frame
 * size taken from a reference, segmentation of an inter frame, film
 * grain of a reference frame, a reference frame other than LAST, a block
 * predicted from a reference with global motion, dual interpolation
 * filters, a vector candidate of the extra search, a wedge inter-intra
 * block with 4:2:2 chroma); a
 * stream libaom refuses (a cut header, a tile that reads past its bytes, a
 * Golomb code longer than 20 bits, a block size the chroma subsampling
 * does not allow, an inter frame first, a vector out of range, no frame
 * shown, ...) ERR_VALUE.
 *
 * Entry points (ctypes, data/avif.py):
 *   av1_info(data, n, op, layer, info[20], err, errlen): of operating
 *     point op (libavif's a1op; libaom takes 0 where the sequence has no
 *     such point) and, with layer >= 0 (lsel), of the first frame shown of
 *     that spatial layer, else of the last frame shown: its width, height,
 *     bit depth, mono_chrome, subsampling x / y, matrix coefficients,
 *     colour range, colour primaries, transfer characteristics, profile,
 *     still_picture, base_q_idx, tx_mode_select, cdef_bits, then
 *     FrameRestorationType of Y, U and V (0 none, 1 Wiener, 2
 *     self-guided, 3 switchable), the luma restoration unit size and
 *     lr_uv_shift;
 *   av1_decode(data, n, op, layer, out, planes, H, W, err, errlen): that
 *     frame's planes, uint16, Y (H x W) then U and V at their subsampled
 *     size;
 *   av1_lr_stats(data, n, counts[9], ms, err, errlen): the frame decoded,
 *     its restoration units of each plane counted by type (none, Wiener,
 *     self-guided) and the milliseconds spent in the restoration filter;
 *   av1_grain_params(data, n, v[162], err, errlen): the frame's film
 *     grain in libaom's aom_film_grain_t order;
 *   av1_decode_ms(data, n, ms[4], counts, err, errlen): milliseconds of
 *     the decode, of its film grain, of its superres upscaling and of its
 *     inter prediction; where counts is not NULL, counts[14] the inter
 *     frames' blocks by tool (Av1's tools).
 * av1_info and av1_grain_params read the headers alone and report the
 * frame that is output; av1_lr_stats counts the last frame decoded.
 */
#define _POSIX_C_SOURCE 199309L
#include <time.h>

/* the clock of the restoration, upscaling and grain times */
static double clock_ms(void)
{
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec * 1e3 + (double)t.tv_nsec / 1e6;
}
#define LR_CLOCK clock_ms

#include "av1_core.h"
#include "av1_grain.h"

static Choice *enc_choice(Av1 *f)
{
    (void)f;
    return NULL;
}

static int enc_partition(Av1 *f, int r, int c, int bsize)
{
    (void)f;
    (void)r;
    (void)c;
    (void)bsize;
    return 0;
}

static int enc_segment(Av1 *f)
{
    (void)f;
    return 0;
}

static int enc_cdef(Av1 *f, int r, int c)
{
    (void)f;
    (void)r;
    (void)c;
    return 0;
}

static const LrUnit *enc_lr_unit(Av1 *f, int plane, int row, int col)
{
    (void)f;
    (void)plane;
    (void)row;
    (void)col;
    return NULL;
}

static void forward_tx(Av1 *f, int plane, int x, int y, int t)
{
    (void)f;
    (void)plane;
    (void)x;
    (void)y;
    (void)t;
}

/* a decoded frame: what a reference slot holds and what is output (the
 * last frame shown), with av1_info's fields (its size and format first)
 * and its grain; planes NULL where only the headers were read.  What a
 * later inter frame loads from it (7.20): whether it is intra, its
 * OrderHint and its references' (by reference frame), MiRows and MiCols,
 * the loop filter deltas, segmentation features, global motion, its CDFs
 * (NULL where only the headers were read), segment ids and motion field
 * (per 8 x 8 unit; NULL where the sequence has no ref frame mvs) */
struct Frame {
    int refs, showable, key, stride;
    int32_t info[20];
    Grain grain;
    uint16_t *plane[3];
    int intra, order_hint, saved_hints[8], mi_rows, mi_cols;
    int lf_ref[8], lf_mode[2], seg_mask[8], seg_data[8][8];
    int32_t gm[8][6];
    Cdfs *cdf;
    uint8_t *seg_map;
    int8_t *mf_ref;
    int16_t *mf_mv;
};

/* -- header bits ---------------------------------------------------------- */

typedef struct {
    Av1 *f;
    const uint8_t *p;
    int64_t n, pos; /* bits */
} Bits;

static uint32_t fb(Bits *b, int n)
{
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
        if (b->pos >= b->n * 8)
            av1_fail(b->f, ERR_VALUE, "AV1: a header ends early");
        v = (v << 1) | ((b->p[b->pos >> 3] >> (7 - (b->pos & 7))) & 1);
        b->pos++;
    }
    return v;
}

static int su(Bits *b, int n)
{
    int v = (int)fb(b, n), m = 1 << (n - 1);
    return (v & m) ? v - 2 * m : v;
}

static uint32_t ns(Bits *b, uint32_t n)
{
    int w = 0;
    for (uint32_t x = n; x > 1; x >>= 1)
        w++;
    w++;
    uint32_t m = (1u << w) - n, v = fb(b, w - 1);
    return v < m ? v : (v << 1) - m + fb(b, 1);
}

static uint32_t uvlc(Bits *b)
{
    int lz = 0;
    while (!fb(b, 1))
        if (++lz >= 32)
            return 0xFFFFFFFFu;
    return lz ? fb(b, lz) + ((1u << lz) - 1) : 0;
}

/* libaom's av1_check_trailing_bits, then its check that the rest of the
 * OBU's payload is zero */
static void trailing_bits(Av1 *f, Bits *b, const char *what)
{
    int n = 8 - (int)(b->pos & 7);
    if (fb(b, n) != 1u << (n - 1))
        av1_fail(f, ERR_VALUE, "AV1: the %s's trailing bits", what);
    for (int64_t k = b->pos >> 3; k < b->n; k++)
        if (b->p[k])
            av1_fail(f, ERR_VALUE, "AV1: nonzero padding after the %s",
                     what);
}

/* libaom's byte_alignment: zero bits up to the next byte */
static void byte_alignment(Av1 *f, Bits *b)
{
    while (b->pos & 7)
        if (fb(b, 1))
            av1_fail(f, ERR_VALUE, "AV1: byte_alignment() is not all 0 "
                     "bits");
}

/* libaom's is_valid_seq_level_idx: the levels AV1 defines, and 31 */
static int valid_level(int level)
{
    return level == 31 || (level < 20 && ((level & 3) < 2 || level >= 12));
}

static int tile_log2(int blk, int target)
{
    int k = 0;
    while ((blk << k) < target)
        k++;
    return k;
}

/* -- sequence header (5.5) ------------------------------------------------ */

static void sequence_header(Av1 *f, Bits *b)
{
    f->profile = (int)fb(b, 3);
    if (f->profile > 2)
        av1_fail(f, ERR_VALUE, "AV1: profile %d", f->profile);
    f->still = (int)fb(b, 1);
    f->reduced = (int)fb(b, 1);
    int delay_bits = 0;
    f->decoder_model_info = 0;
    f->equal_picture_interval = 0;
    if (f->reduced && !f->still)
        av1_fail(f, ERR_VALUE, "AV1: a reduced header of a non-still "
                 "picture");
    if (f->reduced) {
        f->op_count = 1;
        f->op_idc[0] = 0;
        int level = (int)fb(b, 5);
        if (!valid_level(level))
            av1_fail(f, ERR_VALUE, "AV1: seq_level_idx %d", level);
        f->op_model[0] = 0;
    } else {
        if (fb(b, 1)) { /* timing_info_present_flag */
            if (!fb(b, 32) || !fb(b, 32))
                av1_fail(f, ERR_VALUE, "AV1: a timing tick or scale of 0");
            f->equal_picture_interval = (int)fb(b, 1);
            if (f->equal_picture_interval && uvlc(b) == 0xFFFFFFFFu)
                av1_fail(f, ERR_VALUE, "AV1: num_ticks_per_picture");
            f->decoder_model_info = (int)fb(b, 1);
            if (f->decoder_model_info) {
                delay_bits = (int)fb(b, 5) + 1;
                fb(b, 32);
                f->removal_time_bits = (int)fb(b, 5) + 1;
                f->presentation_time_bits = (int)fb(b, 5) + 1;
            }
        }
        int initial_display = (int)fb(b, 1);
        f->op_count = (int)fb(b, 5) + 1;
        for (int i = 0; i < f->op_count; i++) {
            f->op_idc[i] = (int)fb(b, 12);
            int level = (int)fb(b, 5);
            if (!valid_level(level))
                av1_fail(f, ERR_VALUE, "AV1: seq_level_idx %d", level);
            if (level > 7)
                fb(b, 1);
            f->op_model[i] = 0;
            if (f->decoder_model_info) {
                f->op_model[i] = (int)fb(b, 1);
                if (f->op_model[i]) {
                    fb(b, delay_bits);
                    fb(b, delay_bits);
                    fb(b, 1);
                }
            }
            if (initial_display && fb(b, 1) && fb(b, 4) + 1 > 10)
                av1_fail(f, ERR_VALUE, "AV1: an initial display delay "
                         "past 10 frames");
        }
    }
    f->width_bits = (int)fb(b, 4) + 1;
    f->height_bits = (int)fb(b, 4) + 1;
    f->max_w = (int)fb(b, f->width_bits) + 1;
    f->max_h = (int)fb(b, f->height_bits) + 1;
    f->frame_id_present = f->reduced ? 0 : (int)fb(b, 1);
    if (f->frame_id_present) {
        int delta = (int)fb(b, 4) + 2;
        f->frame_id_delta = delta;
        f->frame_id_bits = (int)fb(b, 3) + delta + 1;
        if (f->frame_id_bits > 16)
            av1_fail(f, ERR_VALUE, "AV1: frame_id_length %d",
                     f->frame_id_bits);
    }
    f->use128 = (int)fb(b, 1);
    f->filter_intra_en = (int)fb(b, 1);
    f->edge_filter_en = (int)fb(b, 1);
    f->order_hint_bits = 0;
    f->enable_interintra = f->enable_warped = f->enable_dual_filter = 0;
    f->enable_ref_frame_mvs = 0;
    if (f->reduced) {
        f->sct_force = 2;
        f->intmv_force = 2;
    } else {
        f->enable_interintra = (int)fb(b, 1);
        fb(b, 1); /* masked compound */
        f->enable_warped = (int)fb(b, 1);
        f->enable_dual_filter = (int)fb(b, 1);
        int order_hint = (int)fb(b, 1);
        f->enable_ref_frame_mvs = 0;
        if (order_hint) {
            fb(b, 1); /* jnt comp */
            f->enable_ref_frame_mvs = (int)fb(b, 1);
        }
        if (fb(b, 1)) /* seq_choose_screen_content_tools */
            f->sct_force = 2;
        else
            f->sct_force = (int)fb(b, 1);
        if (f->sct_force > 0) {
            if (fb(b, 1))
                f->intmv_force = 2;
            else
                f->intmv_force = (int)fb(b, 1);
        } else {
            f->intmv_force = 2;
        }
        if (order_hint)
            f->order_hint_bits = (int)fb(b, 3) + 1;
    }
    f->enable_order_hint = f->order_hint_bits > 0;
    f->superres_en = (int)fb(b, 1);
    f->cdef_en = (int)fb(b, 1);
    f->lr_en = (int)fb(b, 1);
    /* color_config */
    int high = (int)fb(b, 1);
    if (f->profile == 2 && high)
        f->bitdepth = fb(b, 1) ? 12 : 10;
    else
        f->bitdepth = high ? 10 : 8;
    f->mono = f->profile == 1 ? 0 : (int)fb(b, 1);
    f->cp = f->tc = f->mc = 2;
    if (fb(b, 1)) {
        f->cp = (int)fb(b, 8);
        f->tc = (int)fb(b, 8);
        f->mc = (int)fb(b, 8);
    }
    f->separate_uv_delta_q = 0;
    f->csp = 0;
    if (f->mono) {
        f->range = (int)fb(b, 1);
        f->ssx = f->ssy = 1;
    } else if (f->cp == 1 && f->tc == 13 && f->mc == 0) {
        f->range = 1;
        f->ssx = f->ssy = 0;
        if (!(f->profile == 1 || (f->profile == 2 && f->bitdepth == 12)))
            av1_fail(f, ERR_VALUE, "AV1: sRGB in profile %d", f->profile);
    } else {
        f->range = (int)fb(b, 1);
        if (f->profile == 0) {
            f->ssx = f->ssy = 1;
        } else if (f->profile == 1) {
            f->ssx = f->ssy = 0;
        } else if (f->bitdepth == 12) {
            f->ssx = (int)fb(b, 1);
            f->ssy = f->ssx ? (int)fb(b, 1) : 0;
        } else {
            f->ssx = 1;
            f->ssy = 0;
        }
        if (f->mc == 0 && (f->ssx || f->ssy))
            av1_fail(f, ERR_VALUE, "AV1: the identity matrix on subsampled "
                     "chroma");
        if (f->ssx && f->ssy)
            f->csp = (int)fb(b, 2);
    }
    if (!f->mono)
        f->separate_uv_delta_q = (int)fb(b, 1);
    f->film_grain_present = (int)fb(b, 1);
    f->nplanes = f->mono ? 1 : 3;
    f->seq_seen = 1;
}

/* -- frame header (5.9) --------------------------------------------------- */

static int read_delta_q(Bits *b)
{
    return fb(b, 1) ? su(b, 7) : 0;
}

static void tile_info(Av1 *f, Bits *b)
{
    int sb_cols = f->use128 ? (f->MiCols + 31) >> 5 : (f->MiCols + 15) >> 4;
    int sb_rows = f->use128 ? (f->MiRows + 31) >> 5 : (f->MiRows + 15) >> 4;
    int sb_shift = f->use128 ? 5 : 4, sb_size = sb_shift + 2;
    int max_w_sb = 4096 >> sb_size;
    int max_area_sb = (4096 * 2304) >> (2 * sb_size);
    int min_log2_cols = tile_log2(max_w_sb, sb_cols);
    int max_log2_cols = tile_log2(1, sb_cols < 64 ? sb_cols : 64);
    int max_log2_rows = tile_log2(1, sb_rows < 64 ? sb_rows : 64);
    int min_log2_tiles = tile_log2(max_area_sb, sb_rows * sb_cols);
    if (min_log2_tiles < min_log2_cols)
        min_log2_tiles = min_log2_cols;
    int i;
    if (fb(b, 1)) { /* uniform_tile_spacing_flag */
        f->tile_cols_log2 = min_log2_cols;
        while (f->tile_cols_log2 < max_log2_cols && fb(b, 1))
            f->tile_cols_log2++;
        int w = (sb_cols + (1 << f->tile_cols_log2) - 1) >> f->tile_cols_log2;
        i = 0;
        for (int s = 0; s < sb_cols; s += w)
            f->col_starts[i++] = s << sb_shift;
        f->col_starts[i] = f->MiCols;
        f->tile_cols = i;
        int min_log2_rows = min_log2_tiles - f->tile_cols_log2;
        f->tile_rows_log2 = min_log2_rows > 0 ? min_log2_rows : 0;
        while (f->tile_rows_log2 < max_log2_rows && fb(b, 1))
            f->tile_rows_log2++;
        int h = (sb_rows + (1 << f->tile_rows_log2) - 1) >> f->tile_rows_log2;
        i = 0;
        for (int s = 0; s < sb_rows; s += h)
            f->row_starts[i++] = s << sb_shift;
        f->row_starts[i] = f->MiRows;
        f->tile_rows = i;
    } else {
        int widest = 0, s = 0;
        for (i = 0; s < sb_cols; i++) {
            if (i >= MAX_TILES)
                av1_fail(f, ERR_VALUE, "AV1: more than 64 tile columns");
            f->col_starts[i] = s << sb_shift;
            int mw = sb_cols - s < max_w_sb ? sb_cols - s : max_w_sb;
            int size = (int)ns(b, (uint32_t)mw) + 1;
            if (size > widest)
                widest = size;
            s += size;
        }
        f->col_starts[i] = f->MiCols;
        f->tile_cols = i;
        f->tile_cols_log2 = tile_log2(1, f->tile_cols);
        int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >>
                   (min_log2_tiles + 1) : sb_rows * sb_cols;
        int max_h_sb = area / widest > 1 ? area / widest : 1;
        s = 0;
        for (i = 0; s < sb_rows; i++) {
            if (i >= MAX_TILES)
                av1_fail(f, ERR_VALUE, "AV1: more than 64 tile rows");
            f->row_starts[i] = s << sb_shift;
            int mh = sb_rows - s < max_h_sb ? sb_rows - s : max_h_sb;
            s += (int)ns(b, (uint32_t)mh) + 1;
        }
        f->row_starts[i] = f->MiRows;
        f->tile_rows = i;
        f->tile_rows_log2 = tile_log2(1, f->tile_rows);
    }
    /* libaom's is_min_tile_width_satisfied: under superres, tile columns
     * but the last of at least 128 samples */
    for (i = 0; f->W != f->up_w && i < f->tile_cols - 1; i++)
        if ((f->col_starts[i + 1] - f->col_starts[i]) * 4 < 128)
            av1_fail(f, ERR_VALUE, "AV1: a tile column narrower than 128 "
                     "samples under superres");
    f->context_update_tile_id = 0;
    f->tile_size_bytes = 4;
    if (f->tile_cols_log2 > 0 || f->tile_rows_log2 > 0) {
        f->context_update_tile_id =
            (int)fb(b, f->tile_rows_log2 + f->tile_cols_log2);
        if (f->context_update_tile_id >= f->tile_cols * f->tile_rows)
            av1_fail(f, ERR_VALUE, "AV1: context_update_tile_id %d",
                     f->context_update_tile_id);
        f->tile_size_bytes = (int)fb(b, 2) + 1;
    }
}

static void loop_filter_params(Av1 *f, Bits *b)
{
    f->lf_level[0] = (int)fb(b, 6);
    f->lf_level[1] = (int)fb(b, 6);
    if (f->nplanes > 1 && (f->lf_level[0] || f->lf_level[1])) {
        f->lf_level[2] = (int)fb(b, 6);
        f->lf_level[3] = (int)fb(b, 6);
    }
    f->lf_sharpness = (int)fb(b, 3);
    f->lf_delta_enabled = (int)fb(b, 1);
    if (f->lf_delta_enabled && fb(b, 1)) /* loop_filter_delta_update */
        for (int i = 0; i < 10; i++)
            if (fb(b, 1)) {
                int v = su(b, 7);
                if (i < 8)
                    f->lf_ref[i] = v;
                else
                    f->lf_mode[i - 8] = v;
            }
}

static void cdef_params(Av1 *f, Bits *b)
{
    f->cdef_damping = (int)fb(b, 2) + 3;
    f->cdef_bits = (int)fb(b, 2);
    for (int i = 0; i < 1 << f->cdef_bits; i++)
        for (int p = 0; p < (f->nplanes > 1 ? 2 : 1); p++) {
            f->cdef_pri[p][i] = (int)fb(b, 4);
            f->cdef_sec[p][i] = (int)fb(b, 2);
            if (f->cdef_sec[p][i] == 3)
                f->cdef_sec[p][i] = 4;
        }
}

/* lr_params: FrameRestorationType (Remap_Lr_Type of lr_type) and
 * LoopRestorationSize of each plane */
static void lr_params(Av1 *f, Bits *b)
{
    static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE,
                                 RESTORE_WIENER, RESTORE_SGRPROJ};
    int uses = 0, chroma = 0;
    for (int i = 0; i < f->nplanes; i++) {
        f->lr_type[i] = remap[fb(b, 2)];
        if (f->lr_type[i] != RESTORE_NONE) {
            uses = 1;
            chroma |= i > 0;
        }
    }
    if (!uses)
        return;
    if (f->use128) {
        f->lr_unit_shift = (int)fb(b, 1) + 1;
    } else {
        f->lr_unit_shift = (int)fb(b, 1);
        if (f->lr_unit_shift)
            f->lr_unit_shift += (int)fb(b, 1);
    }
    f->lr_size[0] = 256 >> (2 - f->lr_unit_shift);
    f->lr_uv_shift = f->ssx && f->ssy && chroma ? (int)fb(b, 1) : 0;
    f->lr_size[1] = f->lr_size[2] = f->lr_size[0] >> f->lr_uv_shift;
}

/* the scaling points of one plane (libaom: at most max, increasing) */
static int grain_points(Av1 *f, Bits *b, int max, int (*pts)[2])
{
    int n = (int)fb(b, 4);
    if (n > max)
        av1_fail(f, ERR_VALUE, "AV1: %d film grain points", n);
    for (int i = 0; i < n; i++) {
        pts[i][0] = (int)fb(b, 8);
        if (i && pts[i][0] <= pts[i - 1][0])
            av1_fail(f, ERR_VALUE, "AV1: film grain points that do not "
                     "increase");
        pts[i][1] = (int)fb(b, 8);
    }
    return n;
}

/* film_grain_params of a frame with apply_grain set (libaom's
 * read_film_grain_params): an inter frame may take a reference's grain
 * (update_grain 0) with its own seed */
static void film_grain_params(Av1 *f, Bits *b)
{
    Grain *g = &f->grain;
    memset(g, 0, sizeof(*g));
    g->apply = 1;
    g->seed = (int)fb(b, 16);
    if (f->inter_frame && !fb(b, 1)) {
        av1_refuse(f, "an AV1 film grain of a reference frame");
        int idx = (int)fb(b, 3), seed = g->seed, found = 0;
        for (int i = LAST_FRAME; i <= ALTREF_FRAME; i++)
            found |= f->ref_idx[i] == idx;
        if (!found || !f->slot[idx])
            av1_fail(f, ERR_VALUE, "AV1: film grain of a frame that is not "
                     "a reference");
        *g = f->slot[idx]->grain;
        g->seed = seed;
        return;
    }
    g->ny = grain_points(f, b, 14, g->pts_y);
    g->from_luma = f->mono ? 0 : (int)fb(b, 1);
    if (!(f->mono || g->from_luma || (f->ssx && f->ssy && !g->ny))) {
        g->ncb = grain_points(f, b, 10, g->pts_cb);
        g->ncr = grain_points(f, b, 10, g->pts_cr);
        if (f->ssx && f->ssy && !g->ncb != !g->ncr)
            av1_fail(f, ERR_VALUE, "AV1: film grain on one chroma plane "
                     "of 4:2:0");
    }
    g->scaling_shift = (int)fb(b, 2) + 8;
    g->lag = (int)fb(b, 2);
    int luma = 2 * g->lag * (g->lag + 1), chroma = luma + (g->ny > 0);
    if (g->ny)
        for (int i = 0; i < luma; i++)
            g->ar_y[i] = (int)fb(b, 8) - 128;
    if (g->ncb || g->from_luma)
        for (int i = 0; i < chroma; i++)
            g->ar_cb[i] = (int)fb(b, 8) - 128;
    if (g->ncr || g->from_luma)
        for (int i = 0; i < chroma; i++)
            g->ar_cr[i] = (int)fb(b, 8) - 128;
    g->ar_shift = (int)fb(b, 2) + 6;
    g->grain_scale_shift = (int)fb(b, 2);
    if (g->ncb) {
        g->cb_mult = (int)fb(b, 8);
        g->cb_luma_mult = (int)fb(b, 8);
        g->cb_offset = (int)fb(b, 9);
    }
    if (g->ncr) {
        g->cr_mult = (int)fb(b, 8);
        g->cr_luma_mult = (int)fb(b, 8);
        g->cr_offset = (int)fb(b, 9);
    }
    g->overlap = (int)fb(b, 1);
    g->clip = (int)fb(b, 1);
}

static void release_frame(struct Frame *fr);

/* the references of an inter frame (ref_frame_idx): OrderHints,
 * RefFrameSignBias, and each one's view and scale factors; libaom refuses a
 * reference of another format or of a size it cannot scale from */
static void setup_refs(Av1 *f)
{
    for (int i = LAST_FRAME; i <= ALTREF_FRAME; i++) {
        const struct Frame *r = f->slot[f->ref_idx[i]];
        RefView *v = &f->ref[i];
        int rw = r->info[0], rh = r->info[1];
        if (r->info[2] != f->bitdepth || r->info[4] != f->ssx ||
            r->info[5] != f->ssy || r->info[3] != f->mono)
            av1_fail(f, ERR_VALUE, "AV1: a reference frame of another "
                     "format");
        if (2 * f->W < rw || 2 * f->H < rh || f->W > 16 * rw ||
            f->H > 16 * rh)
            av1_fail(f, ERR_VALUE, "AV1: a reference frame of invalid "
                     "dimensions");
        f->order_hints[i] = r->order_hint;
        f->sign_bias[i] = rel_dist(f, r->order_hint, f->order_hint) > 0;
        memset(v, 0, sizeof(*v));
        for (int p = 0; p < 3; p++)
            v->plane[p] = r->plane[p];
        v->stride = r->stride;
        v->up_w = rw;
        v->h = rh;
        v->mi_rows = r->mi_rows;
        v->mi_cols = r->mi_cols;
        v->intra = r->intra;
        v->order_hint = r->order_hint;
        memcpy(v->saved_hints, r->saved_hints, sizeof(v->saved_hints));
        v->mf_ref = r->mf_ref;
        v->mf_mv = r->mf_mv;
        v->xs = ((rw << 14) + f->W / 2) / f->W;
        v->ys = ((rh << 14) + f->H / 2) / f->H;
    }
}

/* setup_past_independence, or load_previous of the primary reference
 * frame: the loop filter deltas, the segmentation features, PrevGmParams
 * and the previous segment ids (where its size is the frame's) */
static void load_previous(Av1 *f)
{
    static const int deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    f->prev_seg = NULL;
    if (f->primary_ref == 7) {
        memcpy(f->lf_ref, deltas, sizeof(deltas));
        f->lf_mode[0] = f->lf_mode[1] = 0;
        memset(f->seg_mask, 0, sizeof(f->seg_mask));
        memset(f->seg_data, 0, sizeof(f->seg_data));
        memset(f->prev_gm, 0, sizeof(f->prev_gm));
        for (int i = 0; i < 8; i++)
            f->prev_gm[i][2] = f->prev_gm[i][5] = 1 << 16;
        return;
    }
    const struct Frame *r = f->slot[f->ref_idx[f->primary_ref + 1]];
    memcpy(f->lf_ref, r->lf_ref, sizeof(f->lf_ref));
    memcpy(f->lf_mode, r->lf_mode, sizeof(f->lf_mode));
    memcpy(f->seg_mask, r->seg_mask, sizeof(f->seg_mask));
    memcpy(f->seg_data, r->seg_data, sizeof(f->seg_data));
    memcpy(f->prev_gm, r->gm, sizeof(f->prev_gm));
    if (r->mi_rows == f->MiRows && r->mi_cols == f->MiCols)
        f->prev_seg = r->seg_map;
}

/* skipModeAllowed of skip_mode_params */
static int skip_mode_allowed(Av1 *f)
{
    if (!f->inter_frame || !f->ref_select || !f->enable_order_hint)
        return 0;
    int fwd = -1, bwd = -1, fh = 0, bh = 0;
    for (int i = LAST_FRAME; i <= ALTREF_FRAME; i++) {
        int h = f->order_hints[i];
        if (rel_dist(f, h, f->order_hint) < 0) {
            if (fwd < 0 || rel_dist(f, h, fh) > 0)
                fwd = i, fh = h;
        } else if (rel_dist(f, h, f->order_hint) > 0) {
            if (bwd < 0 || rel_dist(f, h, bh) < 0)
                bwd = i, bh = h;
        }
    }
    if (fwd < 0)
        return 0;
    if (bwd >= 0)
        return 1;
    for (int i = LAST_FRAME; i <= ALTREF_FRAME; i++)
        if (rel_dist(f, f->order_hints[i], fh) < 0)
            return 1;
    return 0;
}

/* decode_subexp (k 3) and decode_signed_subexp_with_ref of the frame
 * header */
static int decode_subexp(Bits *b, int num)
{
    int i = 0, mk = 0;
    for (;;) {
        int b2 = i ? 3 + i - 1 : 3, a = 1 << b2;
        if (num <= mk + 3 * a)
            return (int)ns(b, (uint32_t)(num - mk)) + mk;
        if (!fb(b, 1))
            return (int)fb(b, b2) + mk;
        i++;
        mk += a;
    }
}

static int signed_subexp_ref(Bits *b, int low, int high, int r)
{
    int mx = high - low, v = decode_subexp(b, mx);
    r -= low;
    int x = (r << 1) <= mx ? inverse_recenter(r, v)
                          : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return x + low;
}

/* global_motion_params: each reference frame's warp against the previous
 * frame's (PrevGmParams), and whether its shear is valid */
static void global_motion_params(Av1 *f, Bits *b)
{
    for (int ref = 0; ref < 8; ref++) {
        memset(f->gm[ref], 0, sizeof(f->gm[ref]));
        f->gm[ref][2] = f->gm[ref][5] = 1 << 16;
        f->gm_type[ref] = GM_IDENTITY;
    }
    for (int ref = LAST_FRAME; ref <= ALTREF_FRAME && f->inter_frame; ref++) {
        int type = GM_IDENTITY;
        if (fb(b, 1))
            type = fb(b, 1) ? GM_ROTZOOM : fb(b, 1) ? GM_TRANSLATION
                                                    : GM_AFFINE;
        f->gm_type[ref] = type;
        static const int order[6] = {2, 3, 4, 5, 0, 1};
        for (int k = 0; k < 6; k++) {
            int idx = order[k];
            if (idx < 2 ? type < GM_TRANSLATION : idx < 4
                ? type < GM_ROTZOOM : type < GM_AFFINE)
                continue;
            int abs_bits = 12, prec_bits = 15;
            if (idx < 2) {
                abs_bits = type == GM_TRANSLATION ? 9 - !f->allow_hp : 12;
                prec_bits = type == GM_TRANSLATION ? 3 - !f->allow_hp : 6;
            }
            int diff = 16 - prec_bits, round = idx % 3 == 2 ? 1 << 16 : 0;
            int sub = idx % 3 == 2 ? 1 << prec_bits : 0, mx = 1 << abs_bits;
            int r = (f->prev_gm[ref][idx] >> diff) - sub;
            f->gm[ref][idx] = (int32_t)(signed_subexp_ref(b, -mx, mx + 1, r)
                                        * (1 << diff)) + round;
        }
        if (type == GM_ROTZOOM) {
            f->gm[ref][4] = -f->gm[ref][3];
            f->gm[ref][5] = f->gm[ref][2];
        }
    }
    for (int ref = 0; ref < 8; ref++) {
        int sh[4];
        f->gm_valid[ref] = shear_params(f->gm[ref], sh);
    }
}

/* every reference slot emptied (libaom's reset_frame_buffers) */
static void reset_slots(Av1 *f)
{
    for (int i = 0; i < 8; i++) {
        release_frame(f->slot[i]);
        f->slot[i] = NULL;
    }
}

/* current_frame_id, checked against the previous frame's, and the slots
 * too old for it marked (libaom's read_uncompressed_header) */
static void frame_id(Av1 *f, Bits *b, int key_shown)
{
    int n = f->frame_id_bits, prev = f->frame_id;
    int have_prev = !f->first_frame && !key_shown;
    f->frame_id = (int)fb(b, n);
    if (have_prev) {
        int diff = f->frame_id > prev ? f->frame_id - prev
                                      : (1 << n) + f->frame_id - prev;
        if (prev == f->frame_id || diff >= 1 << (n - 1))
            av1_fail(f, ERR_VALUE, "AV1: an invalid current_frame_id");
    }
    int id = f->frame_id, d = 1 << f->frame_id_delta;
    for (int i = 0; i < 8; i++)
        if (id - d > 0 ? f->ref_id[i] > id || f->ref_id[i] < id - d
                       : f->ref_id[i] > id && f->ref_id[i] < (1 << n) + id - d)
            f->ref_valid[i] = 0;
}

/* an intra frame's uncompressed header (5.9), or show_existing_frame of
 * a frame a slot holds; first: no frame decoded yet, where libaom
 * refuses a frame that needs one */
static void frame_header(Av1 *f, Bits *b, int first)
{
    int frame_type = 0, show_frame = 1, showable = 0, error_resilient = 1;
    f->show_existing = 0;
    if (!f->seq_seen)
        av1_fail(f, ERR_VALUE, "AV1: a frame before the sequence header");
    if (!f->reduced) {
        if (fb(b, 1)) { /* show_existing_frame */
            int idx = (int)fb(b, 3);
            if (f->seq_changed)
                av1_fail(f, ERR_VALUE, "AV1: a new sequence header starts "
                         "with show_existing_frame");
            if (!f->slot[idx])
                av1_fail(f, ERR_VALUE, "AV1: show_existing_frame of an "
                         "empty slot");
            if (f->decoder_model_info && !f->equal_picture_interval)
                fb(b, f->presentation_time_bits);
            if (f->frame_id_present && ((int)fb(b, f->frame_id_bits) !=
                                        f->ref_id[idx] || !f->ref_valid[idx]))
                av1_fail(f, ERR_VALUE, "AV1: a display_frame_id that is not "
                         "the slot's");
            if (!f->slot[idx]->showable)
                av1_fail(f, ERR_VALUE, "AV1: show_existing_frame of a frame "
                         "that is not showable");
            f->show_existing = 1;
            f->existing = idx;
            return;
        }
        frame_type = (int)fb(b, 2);
        if (f->seq_changed) {
            if (frame_type != 0)
                av1_fail(f, ERR_VALUE, "AV1: a new sequence header without "
                         "a key frame");
            f->seq_changed = 0;
            f->first_frame = 1;
            reset_slots(f);
        }
        show_frame = (int)fb(b, 1);
        if (frame_type != 0 && frame_type != 2 && first)
            av1_fail(f, ERR_VALUE, "AV1: an inter frame first");
        if (frame_type == 3)
            av1_fail(f, ERR_NOTIMPL, "AVIF: an AV1 switch frame");
        if (frame_type == 0 && show_frame)
            for (int i = 0; i < 8; i++)
                f->ref_valid[i] = 0;
        if (show_frame && f->decoder_model_info && !f->equal_picture_interval)
            fb(b, f->presentation_time_bits);
        showable = show_frame ? frame_type != 0 : (int)fb(b, 1);
        if (frame_type == 0 && show_frame)
            error_resilient = 1;
        else
            error_resilient = (int)fb(b, 1);
    }
    int intra = frame_type == 0 || frame_type == 2;
    f->frame_type = frame_type;
    f->inter_frame = !intra;
    f->show_frame = show_frame;
    f->showable = showable;
    f->disable_cdf_update = (int)fb(b, 1);
    f->sct = f->sct_force == 2 ? (int)fb(b, 1) : f->sct_force;
    f->force_intmv = 0;
    if (f->sct)
        f->force_intmv = f->intmv_force == 2 ? (int)fb(b, 1) : f->intmv_force;
    if (intra)
        f->force_intmv = 1;
    if (f->frame_id_present)
        frame_id(f, b, frame_type == 0 && show_frame);
    int size_override = f->reduced ? 0 : (int)fb(b, 1);
    f->order_hint = (int)fb(b, f->order_hint_bits);
    f->primary_ref = intra || error_resilient ? 7 : (int)fb(b, 3);
    if (f->decoder_model_info && fb(b, 1)) { /* buffer_removal_time_present */
        for (int op = 0; op < f->op_count; op++)
            if (f->op_model[op]) {
                int idc = f->op_idc[op];
                int in_t = (idc >> f->temporal_id) & 1;
                int in_s = (idc >> (f->spatial_id + 8)) & 1;
                if (idc == 0 || (in_t && in_s))
                    fb(b, f->removal_time_bits);
            }
    }
    int refresh = 0xFF;
    if (!(frame_type == 0 && show_frame))
        refresh = (int)fb(b, 8);
    if (frame_type == 2 && refresh == 0xFF)
        av1_fail(f, ERR_VALUE, "AV1: an intra-only frame refreshing every "
                 "reference");
    f->refresh = refresh;
    if ((!intra || refresh != 0xFF) && error_resilient && f->order_hint_bits)
        for (int i = 0; i < 8; i++)
            /* libaom replaces a slot of another order hint by a grey
             * frame; an intra frame predicts from none */
            if ((int)fb(b, f->order_hint_bits) !=
                (f->slot[i] ? f->slot[i]->order_hint : -1) && !intra)
                av1_fail(f, ERR_NOTIMPL, "AVIF: an AV1 reference frame "
                         "replaced by its order hint");
    int found_ref = 0;
    if (!intra) {
        if (f->enable_order_hint && fb(b, 1))
            av1_fail(f, ERR_NOTIMPL, "AVIF: AV1 frame_refs_short_signaling");
        for (int i = LAST_FRAME; i <= ALTREF_FRAME; i++) {
            int idx = (int)fb(b, 3);
            f->ref_idx[i] = idx;
            if (!f->slot[idx])
                av1_fail(f, ERR_VALUE, "AV1: an inter frame references an "
                         "empty slot");
            if (f->frame_id_present) {
                int n = f->frame_id_bits;
                int delta = (int)fb(b, f->frame_id_delta) + 1;
                int want = (f->frame_id + (1 << n) - delta) % (1 << n);
                if (want != f->ref_id[idx] || !f->ref_valid[idx])
                    av1_fail(f, ERR_VALUE, "AV1: a reference's frame id "
                             "mismatches");
            }
        }
        if (size_override && !error_resilient)
            for (int i = LAST_FRAME; i <= ALTREF_FRAME && !found_ref; i++)
                if (fb(b, 1)) { /* found_ref */
                    av1_refuse(f, "an AV1 frame size taken from a "
                               "reference");
                    const struct Frame *r = f->slot[f->ref_idx[i]];
                    f->W = r->info[0];
                    f->H = r->info[1];
                    found_ref = 1;
                }
    }
    /* frame_size (or the size of frame_size_with_refs), superres_params,
     * render_size */
    if (!found_ref) {
        if (size_override) {
            f->W = (int)fb(b, f->width_bits) + 1;
            f->H = (int)fb(b, f->height_bits) + 1;
            if (f->W > f->max_w || f->H > f->max_h)
                av1_fail(f, ERR_VALUE, "AV1: a frame larger than the "
                         "sequence's maximum");
        } else {
            f->W = f->max_w;
            f->H = f->max_h;
        }
    }
    /* superres_params: the coded width (libaom's
     * av1_calculate_scaled_superres_size, at least 16 samples or the
     * frame's width) */
    f->up_w = f->W;
    f->superres_denom = 8;
    if (f->superres_en && fb(b, 1)) {
        int denom = (int)fb(b, 3) + 9, least = f->W < 16 ? f->W : 16;
        f->superres_denom = denom;
        f->W = (f->W * 8 + denom / 2) / denom;
        f->W = f->W < least ? least : f->W;
    }
    f->MiCols = 2 * ((f->W + 7) >> 3);
    f->MiRows = 2 * ((f->H + 7) >> 3);
    if (!found_ref && fb(b, 1)) { /* render_and_frame_size_different */
        fb(b, 16);
        fb(b, 16);
    }
    f->allow_intrabc = 0;
    if (intra)
        f->allow_intrabc = f->sct && f->W == f->up_w ? (int)fb(b, 1) : 0;
    f->allow_hp = f->use_ref_mvs = f->switchable_motion = 0;
    f->interp_filter = 0;
    if (!intra) {
        f->allow_hp = f->force_intmv ? 0 : (int)fb(b, 1);
        f->interp_filter = fb(b, 1) ? 4 : (int)fb(b, 2);
        f->switchable_motion = (int)fb(b, 1);
        if (!error_resilient && f->enable_ref_frame_mvs)
            f->use_ref_mvs = (int)fb(b, 1);
        setup_refs(f);
    }
    f->disable_end_update = 1;
    if (!(f->reduced || f->disable_cdf_update))
        f->disable_end_update = (int)fb(b, 1);
    load_previous(f);
    tile_info(f, b);
    /* quantization_params */
    f->base_q = (int)fb(b, 8);
    memset(f->dq_dc, 0, sizeof(f->dq_dc));
    memset(f->dq_ac, 0, sizeof(f->dq_ac));
    f->dq_dc[0] = read_delta_q(b);
    if (f->nplanes > 1) {
        int diff_uv = f->separate_uv_delta_q ? (int)fb(b, 1) : 0;
        f->dq_dc[1] = read_delta_q(b);
        f->dq_ac[1] = read_delta_q(b);
        f->dq_dc[2] = f->dq_dc[1];
        f->dq_ac[2] = f->dq_ac[1];
        if (diff_uv) {
            f->dq_dc[2] = read_delta_q(b);
            f->dq_ac[2] = read_delta_q(b);
        }
    }
    int dq = f->dq_dc[0] || f->dq_dc[1] || f->dq_ac[1] || f->dq_dc[2] ||
             f->dq_ac[2];
    f->qm_level[0] = f->qm_level[1] = f->qm_level[2] = 15;
    if (fb(b, 1)) { /* using_qmatrix */
        f->qm_level[0] = (int)fb(b, 4);
        f->qm_level[1] = f->qm_level[2] = (int)fb(b, 4);
        if (f->separate_uv_delta_q)
            f->qm_level[2] = (int)fb(b, 4);
    }
    /* segmentation_params: without a primary reference frame the map and
     * the data are updated; else the data not updated are the primary
     * reference's (load_previous); SegIdPreSkip, LastActiveSegId */
    static const int seg_bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
    static const int seg_max[8] = {255, 63, 63, 63, 63, 7, 0, 0};
    f->seg_enabled = (int)fb(b, 1);
    if (f->seg_enabled && f->inter_frame)
        av1_refuse(f, "an AV1 segmentation of an inter frame");
    f->seg_update_map = 1;
    f->seg_temporal = 0;
    int update_data = 1;
    if (f->seg_enabled && f->primary_ref != 7) {
        f->seg_update_map = (int)fb(b, 1);
        if (f->seg_update_map)
            f->seg_temporal = (int)fb(b, 1);
        update_data = (int)fb(b, 1);
    }
    if (!f->seg_enabled || update_data) {
        memset(f->seg_mask, 0, sizeof(f->seg_mask));
        memset(f->seg_data, 0, sizeof(f->seg_data));
    }
    for (int i = 0; f->seg_enabled && update_data && i < 8; i++)
        for (int j = 0; j < 8; j++)
            if (fb(b, 1)) {
                int v = j < 5 ? su(b, 1 + seg_bits[j]) : (int)fb(b,
                                                                seg_bits[j]);
                f->seg_mask[i] |= 1 << j;
                f->seg_data[i][j] = v < -seg_max[j] ? -seg_max[j]
                                    : v > seg_max[j] ? seg_max[j] : v;
            }
    /* delta_q_params, delta_lf_params */
    f->delta_q_present = f->delta_q_res = 0;
    f->delta_lf_present = f->delta_lf_res = f->delta_lf_multi = 0;
    if (f->base_q > 0 && fb(b, 1)) {
        f->delta_q_present = 1;
        f->delta_q_res = (int)fb(b, 2);
        if (!f->allow_intrabc && fb(b, 1)) {
            f->delta_lf_present = 1;
            f->delta_lf_res = (int)fb(b, 2);
            f->delta_lf_multi = (int)fb(b, 1);
        }
    }
    seg_setup(f, dq);
    int lossless = f->lossless;
    memset(f->lf_level, 0, sizeof(f->lf_level));
    f->lf_sharpness = 0;
    f->lf_delta_enabled = 0;
    f->cdef_damping = 3;
    f->cdef_bits = 0;
    memset(f->cdef_pri, 0, sizeof(f->cdef_pri));
    memset(f->cdef_sec, 0, sizeof(f->cdef_sec));
    memset(f->lr_type, 0, sizeof(f->lr_type));
    f->lr_unit_shift = f->lr_uv_shift = 0;
    if (!lossless && !f->allow_intrabc) {
        loop_filter_params(f, b);
    } else {
        static const int deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
        memcpy(f->lf_ref, deltas, sizeof(deltas));
        f->lf_mode[0] = f->lf_mode[1] = 0;
    }
    if (!lossless && !f->allow_intrabc && f->cdef_en)
        cdef_params(f, b);
    if (!(lossless && f->W == f->up_w) && !f->allow_intrabc && f->lr_en)
        lr_params(f, b);
    f->tx_mode_select = 0;
    if (!lossless)
        f->tx_mode_select = (int)fb(b, 1);
    f->ref_select = intra ? 0 : (int)fb(b, 1);
    f->skip_mode_present = 0;
    if (skip_mode_allowed(f))
        f->skip_mode_present = (int)fb(b, 1);
    f->allow_warp = 0;
    if (!intra && !error_resilient && f->enable_warped)
        f->allow_warp = (int)fb(b, 1);
    f->reduced_tx_set = (int)fb(b, 1);
    global_motion_params(f, b);
    f->grain.apply = 0;
    if (f->film_grain_present && (show_frame || showable) && fb(b, 1))
        film_grain_params(f, b);
}

/* -- tiles ---------------------------------------------------------------- */

static void decode_superblock(Av1 *f, int r, int c)
{
    decode_partition(f, r, c, f->use128 ? BLOCK_128X128 : BLOCK_64X64);
    /* libaom: a tile whose reader went past its bytes is corrupt */
    int64_t tell = f->ec.shifts + 1;
    if ((tell + 7) >> 3 > (int64_t)(f->ec.end - f->ec.buf))
        av1_fail(f, ERR_VALUE, "AV1: tile data ends early");
}

/* libaom's check_trailing_bits_after_symbol_coder: the bit after the
 * last one the symbol decoder used is 1, the rest of its byte and the
 * tile's later bytes 0 */
static void check_trailing_bits(Av1 *f, const uint8_t *p, int64_t size)
{
    int64_t tell = f->ec.shifts + 1, nbytes = (tell + 7) >> 3;
    int pattern = 128 >> ((tell - 1) & 7);
    if (nbytes > size || (p[nbytes - 1] & (2 * pattern - 1)) != pattern)
        av1_fail(f, ERR_VALUE, "AV1: corrupt tile data (trailing bits)");
    for (int64_t k = nbytes; k < size; k++)
        if (p[k])
            av1_fail(f, ERR_VALUE, "AV1: corrupt tile data (padding)");
}

static void release_frame(struct Frame *fr)
{
    if (!fr || --fr->refs > 0)
        return;
    for (int p = 0; p < 3; p++)
        free(fr->plane[p]);
    free(fr->cdf);
    free(fr->seg_map);
    free(fr->mf_ref);
    free(fr->mf_mv);
    free(fr);
}

/* whether a frame shown is the one output: the last one, or with a layer
 * selected (libavif's lsel: libaom outputs every layer) the first of that
 * spatial layer */
static int show_layer(Av1 *f)
{
    return f->want_layer < 0 || (!f->shown && f->spatial_id == f->want_layer);
}

static void hold(struct Frame **dst, struct Frame *fr)
{
    fr->refs++;
    release_frame(*dst);
    *dst = fr;
}

/* the frame just decoded (or whose headers were read) into the slots
 * refresh_frame_flags names, and output where it is shown */
static void frame_done(Av1 *f, int decoded)
{
    struct Frame *fr = calloc(1, sizeof(struct Frame));
    if (!fr)
        av1_fail(f, ERR_MEMORY, "out of memory");
    int32_t v[20] = {f->up_w, f->H, f->bitdepth, f->mono, f->ssx, f->ssy,
                     f->mc, f->range, f->cp, f->tc, f->profile, f->still,
                     f->base_q, f->tx_mode_select, f->cdef_bits,
                     f->lr_type[0], f->lr_type[1], f->lr_type[2],
                     f->lr_size[0], f->lr_uv_shift};
    memcpy(fr->info, v, sizeof(v));
    fr->showable = f->showable;
    fr->key = f->frame_type == 0;
    fr->grain = f->grain;
    fr->stride = f->stride;
    fr->intra = !f->inter_frame;
    fr->order_hint = f->order_hint;
    memcpy(fr->saved_hints, f->order_hints, sizeof(fr->saved_hints));
    fr->mi_rows = f->MiRows;
    fr->mi_cols = f->MiCols;
    memcpy(fr->lf_ref, f->lf_ref, sizeof(fr->lf_ref));
    memcpy(fr->lf_mode, f->lf_mode, sizeof(fr->lf_mode));
    memcpy(fr->seg_mask, f->seg_mask, sizeof(fr->seg_mask));
    memcpy(fr->seg_data, f->seg_data, sizeof(fr->seg_data));
    memcpy(fr->gm, f->gm, sizeof(fr->gm));
    if (decoded) {
        for (int p = 0; p < f->nplanes; p++) {
            fr->plane[p] = f->plane[p];
            f->plane[p] = NULL;
        }
        /* the CDFs at the frame's end (of the tile context_update_tile_id
         * names, unless disable_frame_end_update_cdf), counts cleared */
        fr->cdf = malloc(sizeof(Cdfs));
        if (!fr->cdf) {
            free(fr);
            av1_fail(f, ERR_MEMORY, "out of memory");
        }
        memcpy(fr->cdf, f->disable_end_update ? &f->cdf0 : &f->cdf_end,
               sizeof(Cdfs));
        cdfs_clear_counts(fr->cdf, sizeof(Cdfs));
        fr->seg_map = f->seg_ids;
        fr->mf_ref = f->save_ref;
        fr->mf_mv = f->save_mv;
        f->seg_ids = NULL;
        f->save_ref = NULL;
        f->save_mv = NULL;
    }
    fr->refs = 1;
    for (int i = 0; i < 8; i++)
        if (f->refresh >> i & 1) {
            hold(&f->slot[i], fr);
            f->ref_id[i] = f->frame_id;
            f->ref_valid[i] = 1;
        }
    if (f->show_frame && show_layer(f))
        hold(&f->shown, fr);
    release_frame(fr);
    f->first_frame = 0;
}

/* show_existing_frame: the slot's frame is output; a key frame shown so
 * refreshes every slot and cannot be shown again */
static void show_existing(Av1 *f)
{
    struct Frame *fr = f->slot[f->existing];
    if (show_layer(f))
        hold(&f->shown, fr);
    if (fr->key) {
        fr->showable = 0;
        f->frame_id = f->ref_id[f->existing];
        for (int i = 0; i < 8; i++) {
            if (f->slot[i] != fr)
                hold(&f->slot[i], fr);
            f->ref_id[i] = f->frame_id;
            f->ref_valid[i] = 1;
        }
    }
    f->first_frame = 0;
}

/* one tile group; *next: the tile it must start at (libaom's
 * next_start_tile), 0 again once the frame's last tile is read; with
 * headers, its tiles are not decoded */
static void tile_group(Av1 *f, const uint8_t *p, int64_t sz, int frame_obu,
                       int *next, int *done, int headers)
{
    Bits b = {f, p, sz, 0};
    int num = f->tile_cols * f->tile_rows, start = 0, end = num - 1;
    if (num > 1 && fb(&b, 1)) {
        if (frame_obu)
            av1_fail(f, ERR_VALUE, "AV1: tile_start_and_end_present_flag "
                     "in a frame OBU");
        int bits = f->tile_cols_log2 + f->tile_rows_log2;
        start = (int)fb(&b, bits);
        end = (int)fb(&b, bits);
    }
    if (start != *next || end < start || end >= num)
        av1_fail(f, ERR_VALUE, "AV1: tile group %d..%d of %d tiles", start,
                 end, num);
    *next = end == num - 1 ? 0 : end + 1;
    int64_t pos = (b.pos + 7) >> 3;
    for (int t = start; t <= end && !headers; t++) {
        int64_t size;
        if (t == end) {
            size = sz - pos;
        } else {
            if (sz - pos < f->tile_size_bytes)
                av1_fail(f, ERR_VALUE, "AV1: a tile size ends early");
            size = 0;
            for (int k = 0; k < f->tile_size_bytes; k++)
                size |= (int64_t)p[pos + k] << (8 * k);
            size += 1;
            pos += f->tile_size_bytes;
            if (size > sz - pos)
                av1_fail(f, ERR_VALUE, "AV1: a tile runs past its group");
        }
        if (size <= 0)
            av1_fail(f, ERR_VALUE, "AV1: an empty tile");
        ec_dec_init(&f->ec, p + pos, size);
        code_tile(f, t / f->tile_cols, t % f->tile_cols, decode_superblock);
        check_trailing_bits(f, p + pos, size);
        if (t == f->context_update_tile_id)
            memcpy(&f->cdf_end, &f->cdf, sizeof(Cdfs));
        pos += size;
    }
    if (end == num - 1) {
        if (!headers)
            postfilter(f);
        frame_done(f, !headers);
        *done = 1;
    }
}

static int leb128(const uint8_t *p, int64_t n, int64_t *pos, uint64_t *v)
{
    *v = 0;
    for (int i = 0; i < 8; i++) {
        if (*pos >= n)
            return 0;
        uint8_t byte = p[(*pos)++];
        *v |= (uint64_t)(byte & 0x7F) << (7 * i);
        if (!(byte & 0x80))
            return 1;
    }
    return 0;
}

/* the last nonzero byte of p[0, n), 0 if none (libaom's
 * get_last_nonzero_byte) */
static int last_nonzero(const uint8_t *p, int64_t n)
{
    while (n > 0 && !p[n - 1])
        n--;
    return n ? p[n - 1] : 0;
}

/* an OBU after the header's checks, as libaom's aom_decode_frame_from_obus
 * takes it */
typedef struct {
    int in_frame, frames, next_tile, have_header;
    const uint8_t *fh; /* the frame header's bytes, for redundant copies */
    int64_t fh_size;
} Obus;

static void frame_obu(Av1 *f, Obus *o, int type, const uint8_t *p,
                      int64_t size, int headers)
{
    Bits b = {f, p, size, 0};
    if (type == 7) { /* a redundant frame header: a copy of the frame's */
        /* libaom 3.14 refuses one outside a frame (measured) */
        if (!o->in_frame)
            av1_fail(f, ERR_VALUE, "AV1: a redundant frame header outside "
                     "a frame");
        if (o->fh_size > size || memcmp(p, o->fh, (size_t)o->fh_size))
            av1_fail(f, ERR_VALUE, "AV1: a redundant frame header that "
                     "differs");
        for (int64_t k = o->fh_size; k < size; k++)
            if (p[k])
                av1_fail(f, ERR_VALUE, "AV1: nonzero padding after a "
                         "redundant frame header");
        return;
    }
    if (o->in_frame)
        av1_fail(f, ERR_VALUE, "AV1: a frame header inside a frame");
    frame_header(f, &b, !o->frames);
    if (type == 3)
        trailing_bits(f, &b, "frame header");
    else
        byte_alignment(f, &b);
    o->have_header = 1;
    if (f->show_existing) {
        if (type == 6)
            av1_fail(f, ERR_VALUE, "AV1: show_existing_frame in a frame OBU");
        show_existing(f);
        o->frames++;
        return;
    }
    o->fh = p;
    o->fh_size = b.pos >> 3;
    o->in_frame = 1;
    o->next_tile = 0;
    if (!headers) {
        frame_free(f);
        frame_alloc(f);
        if (f->primary_ref == 7) {
            cdfs_init(&f->cdf0, f->base_q <= 20 ? 0 : f->base_q <= 60 ? 1
                                : f->base_q <= 120 ? 2 : 3);
        } else {
            const struct Frame *r = f->slot[f->ref_idx[f->primary_ref + 1]];
            if (!r->cdf)
                av1_fail(f, ERR_VALUE, "AV1: a primary reference frame "
                         "without CDFs");
            memcpy(&f->cdf0, r->cdf, sizeof(Cdfs));
        }
        if (!f->seg_enabled)
            f->prev_seg = NULL;
        /* the saved motion field (per 8 x 8 unit), the projected one */
        f->mf_rows = f->MiRows >> 1;
        f->mf_cols = f->MiCols >> 1;
        size_t n8 = (size_t)f->mf_rows * f->mf_cols;
        if (f->enable_ref_frame_mvs) {
            f->save_ref = av1_alloc(f, n8);
            f->save_mv = av1_alloc(f, n8 * 4);
        }
        if (f->inter_frame) {
            f->tpl_mv = av1_alloc(f, n8 * 4);
            f->tpl_off = av1_alloc(f, n8);
            motion_field(f);
        }
    }
    if (type == 6) {
        int done = 0;
        tile_group(f, p + o->fh_size, size - o->fh_size, 1, &o->next_tile,
                   &done, headers);
        if (done)
            o->in_frame = 0, o->frames++;
    }
}

/* libaom's read_metadata, for what a still image's stream may carry:
 * the type, then the payload's trailing bits */
static void metadata(Av1 *f, const uint8_t *p, int64_t size)
{
    int64_t pos = 0;
    uint64_t kind;
    if (!leb128(p, size, &pos, &kind))
        av1_fail(f, ERR_VALUE, "AV1: a metadata type that ends early");
    int last = last_nonzero(p + pos, size - pos);
    if (kind == 0 || kind >= 6 ? last == 0 : last != 0x80)
        av1_fail(f, ERR_VALUE, "AV1: metadata without its trailing bits");
}

/* every OBU of the data, as libaom decodes an item: each frame decoded
 * (with headers, only their headers read), the last frame shown output
 * (f->shown); zero bytes may follow a frame */
static void decode_obus(Av1 *f, const uint8_t *data, int64_t n, int headers)
{
    int64_t pos = 0;
    Obus o = {0};
    f->first_frame = 1;
    while (pos < n) {
        if (o.frames && !o.in_frame) {
            while (pos < n && !data[pos])
                pos++;
            if (pos == n)
                break;
        }
        uint8_t h = data[pos++];
        int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
        if (h & 0x80)
            av1_fail(f, ERR_VALUE, "AV1: the OBU forbidden bit is set");
        if (!has_size)
            av1_fail(f, ERR_VALUE, "AV1: an OBU without its size");
        f->temporal_id = f->spatial_id = 0;
        if (ext) {
            if (pos >= n)
                av1_fail(f, ERR_VALUE, "AV1: an OBU extension ends early");
            f->temporal_id = data[pos] >> 5;
            f->spatial_id = (data[pos] >> 3) & 3;
            pos++;
        }
        uint64_t size;
        if (!leb128(data, n, &pos, &size))
            av1_fail(f, ERR_VALUE, "AV1: an OBU size ends early");
        if (size > (uint64_t)(n - pos))
            av1_fail(f, ERR_VALUE, "AV1: an OBU runs past the data");
        const uint8_t *p = data + pos;
        pos += (int64_t)size;
        /* libaom's operating point: 0 where the sequence has not as many */
        int op = !f->seq_seen ? 0 : f->op_idc[f->op_point < f->op_count ?
                                               f->op_point : 0];
        if (type != 1 && type != 2 && ext && op &&
            !((op >> f->temporal_id) & 1 && (op >> (f->spatial_id + 8)) & 1))
            continue; /* not in operating point 0 */
        Bits b = {f, p, (int64_t)size, 0};
        switch (type) {
        case 1:
            /* libaom: a sequence header that differs from the last starts
             * a new sequence (not inside a frame) */
            if (f->seq_seen && ((int64_t)size != f->seq_size ||
                                memcmp(p, f->seq, (size_t)size)))
                f->seq_changed = 1;
            sequence_header(f, &b);
            trailing_bits(f, &b, "sequence header");
            f->seq = p;
            f->seq_size = (int64_t)size;
            if (f->seq_changed && o.in_frame)
                av1_fail(f, ERR_VALUE, "AV1: a new sequence header inside a "
                         "frame");
            break;
        case 2:
            if (o.in_frame)
                av1_fail(f, ERR_VALUE, "AV1: a temporal delimiter inside a "
                         "frame");
            if (last_nonzero(p, (int64_t)size))
                av1_fail(f, ERR_VALUE, "AV1: a temporal delimiter with a "
                         "payload");
            break;
        case 3:
        case 6:
        case 7:
            frame_obu(f, &o, type, p, (int64_t)size, headers);
            break;
        case 4: {
            int done = 0;
            if (!o.in_frame)
                av1_fail(f, ERR_VALUE, "AV1: tiles outside a frame");
            tile_group(f, p, (int64_t)size, 0, &o.next_tile, &done, headers);
            if (done)
                o.in_frame = 0, o.frames++;
            break;
        }
        case 5:
            metadata(f, p, (int64_t)size);
            break;
        case 8:
            av1_fail(f, ERR_VALUE, "AV1: a tile list OBU");
            break;
        case 15:
            if (size && last_nonzero(p, (int64_t)size) != 0x80)
                av1_fail(f, ERR_VALUE, "AV1: padding without its trailing "
                         "bits");
            break;
        default: /* reserved types: skipped unless all zero */
            if (size && !last_nonzero(p, (int64_t)size))
                av1_fail(f, ERR_VALUE, "AV1: an OBU of reserved type %d "
                         "that is all zero", type);
        }
    }
    if (o.in_frame)
        av1_fail(f, ERR_VALUE, "AV1: the frame's tiles end early");
    if (!o.have_header || !o.frames)
        av1_fail(f, ERR_VALUE, "AV1: no frame in the data");
    if (!f->shown)
        av1_fail(f, ERR_VALUE, f->want_layer < 0 ? "AV1: no frame is shown"
                 : "AV1: no frame of the selected layer is shown");
    if (!headers && f->refused)
        av1_fail(f, ERR_NOTIMPL, "AVIF: %s", f->refused);
}

static Av1 *av1_open(char *err, int errlen)
{
    Av1 *f = calloc(1, sizeof(Av1));
    if (f) {
        f->err = err;
        f->errlen = errlen;
        f->want_layer = -1;
    }
    return f;
}


static void av1_close(Av1 *f)
{
    for (int p = 0; p < 3; p++)
        free(f->grained[p]);
    reset_slots(f);
    release_frame(f->shown);
    frame_free(f);
    free(f);
}

int av1_info(const uint8_t *data, int64_t n, int op, int layer,
             int32_t *info, char *err, int errlen)
{
    Av1 *f = av1_open(err, errlen);
    if (!f)
        return ERR_MEMORY;
    f->op_point = op;
    f->want_layer = layer;
    int code = setjmp(f->jb);
    if (code == 0) {
        decode_obus(f, data, n, 1);
        memcpy(info, f->shown->info, sizeof(f->shown->info));
    }
    av1_close(f);
    return code;
}

/* the frame output, as libaom's decoder outputs it: with its film
 * grain */
static void shown_frame(Av1 *f)
{
    struct Frame *fr = f->shown;
    f->W = fr->info[0];
    f->H = fr->info[1];
    f->bitdepth = fr->info[2];
    f->nplanes = fr->info[3] ? 1 : 3;
    f->ssx = fr->info[4];
    f->ssy = fr->info[5];
    f->mc = fr->info[6];
    f->stride = fr->stride;
    f->grain = fr->grain;
    for (int p = 0; p < 3; p++)
        f->out[p] = fr->plane[p];
    if (!f->grain.apply)
        return;
    /* the grain goes onto a copy: a slot may show the frame again */
    size_t rows = (size_t)((f->H + 7) & ~7) + 64;
    for (int p = 0; p < f->nplanes; p++) {
        f->grained[p] = av1_alloc(f, (size_t)f->stride * rows * 2);
        memcpy(f->grained[p], fr->plane[p], (size_t)f->stride * (size_t)(
                   p ? (f->H + f->ssy) >> f->ssy : f->H) * 2);
        f->out[p] = f->grained[p];
    }
    uint16_t *keep[3] = {f->plane[0], f->plane[1], f->plane[2]};
    memcpy(f->plane, f->out, sizeof(f->plane));
    double t0 = clock_ms();
    film_grain(f);
    f->grain_ms = clock_ms() - t0;
    memcpy(f->plane, keep, sizeof(f->plane));
}

int av1_decode(const uint8_t *data, int64_t n, int op, int layer,
               uint16_t *out, int planes, int64_t H, int64_t W, char *err,
               int errlen)
{
    Av1 *f = av1_open(err, errlen);
    if (!f)
        return ERR_MEMORY;
    f->op_point = op;
    f->want_layer = layer;
    int code = setjmp(f->jb);
    if (code == 0) {
        decode_obus(f, data, n, 0);
        shown_frame(f);
        if (f->W != W || f->H != H || f->nplanes != planes)
            av1_fail(f, ERR_VALUE, "AV1: the frame is not %lldx%lld",
                     (long long)W, (long long)H);
        uint16_t *dst = out;
        for (int p = 0; p < planes; p++) {
            int64_t w = p ? (W + f->ssx) >> f->ssx : W;
            int64_t h = p ? (H + f->ssy) >> f->ssy : H;
            for (int64_t y = 0; y < h; y++)
                memcpy(dst + y * w, f->out[p] + (size_t)y * f->stride,
                       (size_t)w * 2);
            dst += h * w;
        }
    }
    av1_close(f);
    return code;
}

int av1_lr_stats(const uint8_t *data, int64_t n, int32_t *counts, double *ms,
                 char *err, int errlen)
{
    Av1 *f = av1_open(err, errlen);
    if (!f)
        return ERR_MEMORY;
    int code = setjmp(f->jb);
    if (code == 0) {
        decode_obus(f, data, n, 0);
        memset(counts, 0, 9 * sizeof(int32_t));
        for (int p = 0; p < f->nplanes; p++)
            for (int k = 0; k < f->lr_rows[p] * f->lr_cols[p]; k++)
                counts[3 * p + f->lr_units[p][k].type]++;
        *ms = f->lr_ms;
    }
    av1_close(f);
    return code;
}

/* the frame's film_grain_params in the ints of libaom's aom_film_grain_t
 * (av1_tables.h film_grain_test_vectors): all zero where the frame has
 * no grain */
int av1_grain_params(const uint8_t *data, int64_t n, int32_t *v, char *err,
                     int errlen)
{
    Av1 *f = av1_open(err, errlen);
    if (!f)
        return ERR_MEMORY;
    int code = setjmp(f->jb);
    if (code == 0) {
        decode_obus(f, data, n, 1);
        const Grain *g = &f->shown->grain;
        memset(v, 0, 162 * sizeof(int32_t));
        if (g->apply) {
            int k = 0;
            v[k++] = 1;
            v[k++] = 1;
            for (int i = 0; i < 14; i++, k += 2)
                v[k] = g->pts_y[i][0], v[k + 1] = g->pts_y[i][1];
            v[k++] = g->ny;
            for (int i = 0; i < 10; i++, k += 2)
                v[k] = g->pts_cb[i][0], v[k + 1] = g->pts_cb[i][1];
            v[k++] = g->ncb;
            for (int i = 0; i < 10; i++, k += 2)
                v[k] = g->pts_cr[i][0], v[k + 1] = g->pts_cr[i][1];
            v[k++] = g->ncr;
            v[k++] = g->scaling_shift;
            v[k++] = g->lag;
            for (int i = 0; i < 24; i++)
                v[k++] = g->ar_y[i];
            for (int i = 0; i < 25; i++)
                v[k++] = g->ar_cb[i];
            for (int i = 0; i < 25; i++)
                v[k++] = g->ar_cr[i];
            int rest[13] = {g->ar_shift, g->cb_mult, g->cb_luma_mult,
                            g->cb_offset, g->cr_mult, g->cr_luma_mult,
                            g->cr_offset, g->overlap, g->clip,
                            f->shown->info[2], g->from_luma,
                            g->grain_scale_shift, g->seed};
            memcpy(v + k, rest, sizeof(rest));
        }
    }
    av1_close(f);
    return code;
}

/* the frame decoded and its grain added: ms[0] the milliseconds of the
 * whole, ms[1] of the grain, ms[2] of the superres upscaling, ms[3] of the
 * inter prediction; counts (NULL: not wanted) the inter frames' blocks by
 * tool (Av1's tools) */
int av1_decode_ms(const uint8_t *data, int64_t n, double *ms, int32_t *counts,
                  char *err, int errlen)
{
    Av1 *f = av1_open(err, errlen);
    if (!f)
        return ERR_MEMORY;
    double t0 = clock_ms();
    int code = setjmp(f->jb);
    if (code == 0) {
        decode_obus(f, data, n, 0);
        shown_frame(f);
        ms[0] = clock_ms() - t0;
        ms[1] = f->grain_ms;
        ms[2] = f->superres_ms;
        ms[3] = f->inter_ms;
        if (counts)
            memcpy(counts, f->tools, sizeof(f->tools));
    }
    av1_close(f);
    return code;
}

/* the inter prediction of one block, for the tests: reference plane ref
 * (stride samples a row) of a frame whose luma is rw x rh, predicting a
 * frame of luma fw x fh (the scale factors' sizes) at depth bits with
 * chroma subsampling ssx / ssy; p = {plane, x, y, w, h, vector row, vector
 * column (1/8 luma sample), filter y, filter x, warp, then the warp's six
 * parameters}: block_inter, or block_warp where warp is set, into out (h
 * rows of w) */
int av1_predict(const uint16_t *ref, int64_t stride, int rw, int rh, int fw,
                int fh, int depth, int ssx, int ssy, const int32_t *p,
                uint16_t *out, char *err, int errlen)
{
    Av1 *f = av1_open(err, errlen);
    if (!f)
        return ERR_MEMORY;
    int code = setjmp(f->jb);
    if (code == 0) {
        int plane = p[0], x = p[1], y = p[2], w = p[3], h = p[4];
        if (w < 1 || h < 1 || w > 128 || h > 128 || plane < 0 || plane > 2)
            av1_fail(f, ERR_VALUE, "a block of %d x %d", w, h);
        f->bitdepth = depth;
        f->ssx = ssx;
        f->ssy = ssy;
        f->W = fw;
        f->H = fh;
        RefView *v = &f->ref[1];
        v->plane[plane] = ref;
        v->stride = (int)stride;
        v->up_w = rw;
        v->h = rh;
        v->xs = ((rw << 14) + fw / 2) / fw;
        v->ys = ((rh << 14) + fh / 2) / fh;
        f->pred_tmp = av1_alloc(f, sizeof(int32_t) * 128 * 280);
        f->pred_blk = av1_alloc(f, sizeof(uint16_t) * 128 * 128);
        int mv[2] = {p[5], p[6]}, filt[2] = {p[7], p[8]};
        if (p[9])
            block_warp(f, plane, 1, p + 10, x, y, w, h, f->pred_blk);
        else
            block_inter(f, plane, 1, mv, filt, x, y, w, h, f->pred_blk);
        for (int i = 0; i < h; i++)
            memcpy(out + (size_t)i * w, f->pred_blk + i * 128,
                   (size_t)w * 2);
    }
    av1_close(f);
    return code;
}

/* the 16 wedge masks (sign 0) of block size bsize, each h rows of w, into
 * out; returns 0, or ERR_VALUE for a size without wedges */
int av1_wedge_masks(int bsize, uint8_t *out)
{
    static const int8_t sizes[9] = {3, 4, 5, 6, 7, 8, 9, 18, 19};
    int ok = 0;
    for (int k = 0; k < 9; k++)
        ok |= sizes[k] == bsize;
    if (!ok)
        return ERR_VALUE;
    int w = 4 << bw4_log2[bsize], h = 4 << bh4_log2[bsize];
    for (int k = 0; k < 16; k++)
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                *out++ = (uint8_t)wedge_mask(bsize, k, i, j);
    return 0;
}
