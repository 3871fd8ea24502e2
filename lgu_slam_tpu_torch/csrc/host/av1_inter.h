/* AV1 inter blocks for av1_core.h (included by it before decode_block):
 * the mode info of an inter frame (5.11.5-5.11.33: inter segment ids,
 * is_inter, the single reference frames, NEWMV / NEARESTMV / NEARMV /
 * GLOBALMV with the DRL index, the vectors, inter-intra with its wedge
 * and smooth masks, the motion modes SIMPLE, OBMC and LOCALWARP, the dual
 * interpolation filter), motion vector prediction (7.10.2: the spatial
 * scans, weights, sorting, the temporal candidates of use_ref_frame_mvs,
 * the extra search, clamping and the mode contexts; 7.10.4 the warp
 * samples), motion field estimation (7.9) and the saved motion field
 * (7.19), and inter prediction as libaom 3.14 computes it (7.11.3:
 * vectors scaled to a reference of another size, the 8- and 4-tap
 * sub-sample filters with the rounding of 8, 10 and 12 bits, sub-8x8
 * chroma from each luma block's vector, OBMC, local and global warp with
 * libaom's reduced-precision filter positions, the inter-intra masks).
 *
 * Compound prediction (two references, or a compound reference mode
 * symbol) and skip mode are refused by name where they are read: no
 * layered AVIF item references more than one earlier layer.  What is
 * decoded here but reached by no layered item here, so held against
 * libaom by no file (a reference frame other than LAST, a block
 * predicted from a reference with global motion and its global warp, dual
 * interpolation filters, a vector candidate of the extra search, a wedge
 * inter-intra block with 4:2:2 chroma), is named where it is read
 * (av1_refuse) and refused when the decode ends.
 */

enum { INTRA_FRAME = 0, LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME,
       BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME };
enum { NEARESTMV = 13, NEARMV, GLOBALMV, NEWMV };
enum { GM_IDENTITY, GM_TRANSLATION, GM_ROTZOOM, GM_AFFINE };
enum { MM_SIMPLE, MM_OBMC, MM_LOCALWARP };
enum { SEG_LVL_GLOBALMV = 7 };

/* get_relative_dist of two order hints */
static int rel_dist(Av1 *f, int a, int b)
{
    if (!f->enable_order_hint)
        return 0;
    int m = 1 << (f->order_hint_bits - 1), d = a - b;
    return (d & (m - 1)) - (d & m);
}

/* lower_mv_precision */
static void lower_prec(Av1 *f, int *mv)
{
    if (f->allow_hp)
        return;
    for (int i = 0; i < 2; i++) {
        if (f->force_intmv) {
            int a = (abs(mv[i]) + 3) >> 3;
            mv[i] = mv[i] > 0 ? a << 3 : -(a << 3);
        } else if (mv[i] & 1) {
            mv[i] += mv[i] > 0 ? -1 : 1;
        }
    }
}

/* the global motion vector of the block for reference frame ref
 * (setup_global_mv; libaom's gm_get_motion_vector, whose translation
 * takes the vertical component from the horizontal parameter) */
static void global_mv(Av1 *f, int ref, int *mv)
{
    int t = ref > INTRA_FRAME ? f->gm_type[ref] : GM_IDENTITY;
    const int32_t *g = f->gm[ref > 0 ? ref : 0];
    mv[0] = mv[1] = 0;
    if (t == GM_TRANSLATION) {
        mv[0] = g[0] >> 13;
        mv[1] = g[1] >> 13;
    } else if (t > GM_TRANSLATION) {
        int x = f->mi_col * 4 + (2 << bw4_log2[f->mi_sz]) - 1;
        int y = f->mi_row * 4 + (2 << bh4_log2[f->mi_sz]) - 1;
        int xc = (g[2] - 65536) * x + g[3] * y + g[0];
        int yc = g[4] * x + (g[5] - 65536) * y + g[1];
        if (f->allow_hp) {
            mv[0] = round2signed(yc, 13);
            mv[1] = round2signed(xc, 13);
        } else {
            mv[0] = round2signed(yc, 14) * 2;
            mv[1] = round2signed(xc, 14) * 2;
        }
    }
    lower_prec(f, mv);
}

static void stack_add(MvStack *st, const int *mv, int weight)
{
    for (int i = 0; i < st->n; i++)
        if (st->row[i] == mv[0] && st->col[i] == mv[1]) {
            st->weight[i] += weight;
            return;
        }
    if (st->n < 8) {
        st->row[st->n] = mv[0];
        st->col[st->n] = mv[1];
        st->weight[st->n] = weight;
        st->n++;
    }
}

/* add_ref_mv_candidate of a single reference block (search_stack) */
static void inter_candidate(Av1 *f, MvStack *st, int r, int c, int weight)
{
    size_t k = (size_t)r * f->MiCols + c;
    if (!f->is_inter[k])
        return;
    for (int list = 0; list < 2; list++) {
        if (f->ref_frames[2 * k + list] != f->ref_frame[0])
            continue;
        int sz = f->mi_size[k], mode = f->ymodes[k], mv[2];
        int large = bw4_log2[sz] >= 1 && bh4_log2[sz] >= 1;
        if (mode == GLOBALMV && f->gm_type[f->ref_frame[0]] > GM_TRANSLATION
            && large) {
            mv[0] = st->global[0];
            mv[1] = st->global[1];
        } else {
            mv[0] = f->mvs[4 * k + 2 * list];
            mv[1] = f->mvs[4 * k + 2 * list + 1];
        }
        lower_prec(f, mv);
        st->new_count += mode == NEWMV;
        st->found = 1;
        stack_add(st, mv, weight);
    }
}

/* get_mv_projection */
static void mv_projection(int *out, const int16_t *mv, int num, int den)
{
    den = den < 31 ? den : 31;
    num = num > 0 ? (num < 31 ? num : 31) : (num > -31 ? num : -31);
    int mult = den ? 16384 / den : 0;
    for (int i = 0; i < 2; i++) {
        int v = round2signed(mv[i] * num * mult, 14);
        out[i] = v < -(1 << 14) + 1 ? -(1 << 14) + 1
                 : v > (1 << 14) - 1 ? (1 << 14) - 1 : v;
    }
}

/* add_tpl_ref_mv: a temporal candidate at (dr, dc) of the block; returns
 * whether its unit holds a projected vector */
static int add_tpl(Av1 *f, MvStack *st, int dr, int dc)
{
    int r = (f->mi_row + dr) | 1, c = (f->mi_col + dc) | 1;
    if (!is_inside(f, r, c))
        return 0;
    size_t u = (size_t)(r >> 1) * f->mf_cols + (c >> 1);
    if (f->tpl_mv[2 * u] == -32768)
        return 0;
    int mv[2];
    mv_projection(mv, f->tpl_mv + 2 * u,
                  rel_dist(f, f->order_hint, f->ref[f->ref_frame[0]].order_hint),
                  f->tpl_off[u]);
    lower_prec(f, mv);
    if (dr == 0 && dc == 0 && (abs(mv[0] - st->global[0]) >= 16 ||
                               abs(mv[1] - st->global[1]) >= 16))
        st->found = 2; /* GLOBALMV's context */
    stack_add(st, mv, 2);
    f->tools[13]++;
    return 1;
}

/* the temporal scan (7.10.2.5); returns ZeroMvContext */
static int temporal_scan(Av1 *f, MvStack *st)
{
    int bw4 = f->bw4, bh4 = f->bh4, zero = 0;
    int sh = bh4 >= 16 ? 4 : 2, sw = bw4 >= 16 ? 4 : 2;
    int save = st->found;
    st->found = 0;
    for (int dr = 0; dr < (bh4 < 16 ? bh4 : 16); dr += sh)
        for (int dc = 0; dc < (bw4 < 16 ? bw4 : 16); dc += sw) {
            int ok = add_tpl(f, st, dr, dc);
            if (dr == 0 && dc == 0)
                zero = !ok || st->found == 2;
        }
    if (bh4 >= 2 && bh4 < 16 && bw4 >= 2 && bw4 < 16) {
        int pos[3][2] = {{bh4, -2}, {bh4, bw4}, {bh4 - 2, bw4}};
        for (int i = 0; i < 3; i++) {
            /* check_sb_border: inside the block's 64 x 64 unit */
            int rs = (f->mi_row & 15) + pos[i][0];
            int cs = (f->mi_col & 15) + pos[i][1];
            if (rs >= 0 && rs < 16 && cs >= 0 && cs < 16)
                add_tpl(f, st, pos[i][0], pos[i][1]);
        }
    }
    st->found = save;
    return zero;
}

/* the extra search (7.10.2.12) of a single reference */
static void extra_search(Av1 *f, MvStack *st)
{
    int w4 = f->bw4 < 16 ? f->bw4 : 16, h4 = f->bh4 < 16 ? f->bh4 : 16;
    w4 = w4 < f->MiCols - f->mi_col ? w4 : f->MiCols - f->mi_col;
    h4 = h4 < f->MiRows - f->mi_row ? h4 : f->MiRows - f->mi_row;
    int n4 = w4 < h4 ? w4 : h4;
    for (int pass = 0; pass < 2 && st->n < 2; pass++)
        for (int idx = 0; idx < n4 && st->n < 2;) {
            int r = pass ? f->mi_row + idx : f->mi_row - 1;
            int c = pass ? f->mi_col - 1 : f->mi_col + idx;
            if (!is_inside(f, r, c))
                break;
            size_t k = (size_t)r * f->MiCols + c;
            for (int list = 0; list < 2; list++) {
                int cref = f->ref_frames[2 * k + list];
                if (cref <= INTRA_FRAME || !f->is_inter[k])
                    continue;
                int mv[2] = {f->mvs[4 * k + 2 * list],
                             f->mvs[4 * k + 2 * list + 1]};
                if (f->sign_bias[cref] != f->sign_bias[f->ref_frame[0]])
                    mv[0] = -mv[0], mv[1] = -mv[1];
                int i;
                for (i = 0; i < st->n; i++)
                    if (st->row[i] == mv[0] && st->col[i] == mv[1])
                        break;
                if (i == st->n) {
                    av1_refuse(f, "an AV1 vector candidate of the extra "
                               "search");
                    st->row[i] = mv[0];
                    st->col[i] = mv[1];
                    st->weight[i] = 2;
                    st->n++;
                }
            }
            idx += pass ? 1 << bh4_log2[f->mi_size[k]]
                        : 1 << bw4_log2[f->mi_size[k]];
        }
    for (int i = st->n; i < 2; i++) {
        st->row[i] = st->global[0];
        st->col[i] = st->global[1];
    }
}

/* find_mv_stack of a single reference: the stack (NumMvFound at st->n,
 * the vectors clamped), and the contexts of new_mv, zero_mv, ref_mv */
static void find_mv_stack(Av1 *f, MvStack *st, int *ctx)
{
    int bw4 = f->bw4, bh4 = f->bh4;
    memset(st, 0, sizeof(*st));
    global_mv(f, f->ref_frame[0], st->global);
    scan_row(f, st, -1);
    int above = st->found;
    st->found = 0;
    scan_col(f, st, -1);
    int left = st->found;
    st->found = 0;
    if ((bw4 > bh4 ? bw4 : bh4) <= 16)
        scan_point(f, st, -1, bw4);
    above |= st->found;
    int close = above + left, nearest = st->n, num_new = st->new_count;
    for (int i = 0; i < nearest; i++)
        st->weight[i] += 640;
    int zero = 0;
    if (f->use_ref_mvs)
        zero = temporal_scan(f, st);
    st->found = 0;
    scan_point(f, st, -1, -1);
    above |= st->found;
    st->found = 0;
    scan_row(f, st, -3);
    above |= st->found;
    st->found = 0;
    scan_col(f, st, -3);
    left |= st->found;
    st->found = 0;
    if (bh4 > 1)
        scan_row(f, st, -5);
    above |= st->found;
    st->found = 0;
    if (bw4 > 1)
        scan_col(f, st, -5);
    left |= st->found;
    int total = above + left;
    sort_stack(st, 0, nearest);
    sort_stack(st, nearest, st->n);
    if (st->n < 2)
        extra_search(f, st);
    /* context_and_clamping */
    int top = -(f->mi_row * 32), bot = (f->MiRows - bh4 - f->mi_row) * 32;
    int lef = -(f->mi_col * 32), rig = (f->MiCols - bw4 - f->mi_col) * 32;
    for (int i = 0; i < st->n; i++) {
        int br = 128 + bh4 * 32, bc = 128 + bw4 * 32;
        st->row[i] = st->row[i] < top - br ? top - br : st->row[i] > bot + br
                     ? bot + br : st->row[i];
        st->col[i] = st->col[i] < lef - bc ? lef - bc : st->col[i] > rig + bc
                     ? rig + bc : st->col[i];
    }
    if (close == 0) {
        ctx[0] = total < 1 ? total : 1;
        ctx[2] = total;
    } else if (close == 1) {
        ctx[0] = 3 - (num_new < 1 ? num_new : 1);
        ctx[2] = 2 + total;
    } else {
        ctx[0] = 5 - (num_new < 1 ? num_new : 1);
        ctx[2] = 5;
    }
    ctx[1] = zero;
}

/* -- the mode info of an inter frame (5.11.5, 5.11.18-33) ---------------- */

/* inter_segment_id: the previous frame's segment ids (the least over the
 * block) where the map is not updated or predicted, else the spatial
 * segment id of read_segment_id */
static int prev_segment(Av1 *f)
{
    int id = 7;
    if (!f->prev_seg)
        return 0;
    for (int y = 0; y < f->bh4 && f->mi_row + y < f->MiRows; y++)
        for (int x = 0; x < f->bw4 && f->mi_col + x < f->MiCols; x++) {
            int v = MI(f->prev_seg, f->mi_row + y, f->mi_col + x);
            id = v < id ? v : id;
        }
    return id;
}

static void set_segment(Av1 *f, int id, int pred)
{
    for (int y = 0; y < f->bh4 && f->mi_row + y < f->MiRows; y++)
        for (int x = 0; x < f->bw4 && f->mi_col + x < f->MiCols; x++) {
            MI(f->seg_ids, f->mi_row + y, f->mi_col + x) = (uint8_t)id;
            MI(f->seg_preds, f->mi_row + y, f->mi_col + x) = (uint8_t)pred;
        }
    f->segment_id = id;
    f->blk_lossless = f->seg_lossless[id];
}

static void inter_segment_id(Av1 *f, int preskip)
{
    if (!f->seg_enabled) {
        set_segment(f, 0, 0);
        return;
    }
    if (!f->seg_update_map) {
        set_segment(f, prev_segment(f), 0);
        return;
    }
    if (preskip && !f->seg_preskip) {
        set_segment(f, 0, 0);
        return;
    }
    if (!preskip && f->skip) {
        read_segment_id(f, 1);
        set_segment(f, f->segment_id, 0);
        return;
    }
    if (f->seg_temporal) {
        int ctx = (f->avail_u ? MI(f->seg_preds, f->mi_row - 1, f->mi_col)
                              : 0) +
                  (f->avail_l ? MI(f->seg_preds, f->mi_row, f->mi_col - 1)
                              : 0);
        if (sym(f, f->cdf.seg_pred[ctx], 2, 0)) {
            set_segment(f, prev_segment(f), 1);
            return;
        }
    }
    read_segment_id(f, 0);
    set_segment(f, f->segment_id, 0);
}

static int count_refs(Av1 *f, int type)
{
    int c = 0;
    if (f->avail_u)
        c += (f->above_ref[0] == type) + (f->above_ref[1] == type);
    if (f->avail_l)
        c += (f->left_ref[0] == type) + (f->left_ref[1] == type);
    return c;
}

static int ref_count_ctx(int a, int b)
{
    return a < b ? 0 : a == b ? 1 : 2;
}

static int check_backward(int ref)
{
    return ref >= BWDREF_FRAME && ref <= ALTREF_FRAME;
}

/* read_ref_frames of a block that is not in skip mode */
static void read_ref_frames(Av1 *f)
{
    Cdfs *c = &f->cdf;
    f->ref_frame[1] = -1;
    if (seg_active(f, f->segment_id, SEG_LVL_REF_FRAME)) {
        f->ref_frame[0] = f->seg_data[f->segment_id][SEG_LVL_REF_FRAME];
        return;
    }
    if (seg_active(f, f->segment_id, SEG_LVL_SKIP) ||
        seg_active(f, f->segment_id, SEG_LVL_GLOBALMV)) {
        f->ref_frame[0] = LAST_FRAME;
        return;
    }
    if (f->ref_select && f->bw4 >= 2 && f->bh4 >= 2) {
        int ctx, au = f->avail_u, al = f->avail_l;
        int as = f->above_ref[1] <= INTRA_FRAME;
        int ls = f->left_ref[1] <= INTRA_FRAME;
        int ai = f->above_ref[0] <= INTRA_FRAME;
        int li = f->left_ref[0] <= INTRA_FRAME;
        if (au && al) {
            if (as && ls)
                ctx = check_backward(f->above_ref[0]) ^
                      check_backward(f->left_ref[0]);
            else if (as)
                ctx = 2 + (check_backward(f->above_ref[0]) || ai);
            else if (ls)
                ctx = 2 + (check_backward(f->left_ref[0]) || li);
            else
                ctx = 4;
        } else if (au) {
            ctx = as ? check_backward(f->above_ref[0]) : 3;
        } else if (al) {
            ctx = ls ? check_backward(f->left_ref[0]) : 3;
        } else {
            ctx = 1;
        }
        if (sym(f, c->comp_inter[ctx], 2, 0))
            av1_fail(f, ERR_NOTIMPL, "AVIF: an AV1 compound prediction");
    }
    int last = count_refs(f, LAST_FRAME), last2 = count_refs(f, LAST2_FRAME);
    int last3 = count_refs(f, LAST3_FRAME), gold = count_refs(f, GOLDEN_FRAME);
    int bwd = count_refs(f, BWDREF_FRAME), alt2 = count_refs(f, ALTREF2_FRAME);
    int alt = count_refs(f, ALTREF_FRAME);
    int ctx = ref_count_ctx(last + last2 + last3 + gold, bwd + alt2 + alt);
    if (sym(f, c->single_ref[ctx][0], 2, 0)) {
        ctx = ref_count_ctx(bwd + alt2, alt);
        if (!sym(f, c->single_ref[ctx][1], 2, 0)) {
            ctx = ref_count_ctx(bwd, alt2);
            f->ref_frame[0] = sym(f, c->single_ref[ctx][5], 2, 0)
                              ? ALTREF2_FRAME : BWDREF_FRAME;
        } else {
            f->ref_frame[0] = ALTREF_FRAME;
        }
    } else {
        ctx = ref_count_ctx(last + last2, last3 + gold);
        if (sym(f, c->single_ref[ctx][2], 2, 0)) {
            ctx = ref_count_ctx(last3, gold);
            f->ref_frame[0] = sym(f, c->single_ref[ctx][4], 2, 0)
                              ? GOLDEN_FRAME : LAST3_FRAME;
        } else {
            ctx = ref_count_ctx(last, last2);
            f->ref_frame[0] = sym(f, c->single_ref[ctx][3], 2, 0)
                              ? LAST2_FRAME : LAST_FRAME;
        }
    }
    if (f->ref_frame[0] != LAST_FRAME)
        av1_refuse(f, "an AV1 reference frame other than LAST");
}

/* read_mv_component (MvCtx 0) */
static int read_mv_component(Av1 *f, int base)
{
    uint16_t *m = f->cdf.mv_inter + base;
    int sign = sym(f, m + 27, 2, 0), cls = sym(f, m, 11, 0), mag;
    if (cls == 0) {
        int b = sym(f, m + 36, 2, 0);
        int fr = f->force_intmv ? 3 : sym(f, m + 12 + 5 * b, 4, 0);
        int hp = f->allow_hp ? sym(f, m + 30, 2, 0) : 1;
        mag = ((b << 3) | (fr << 1) | hp) + 1;
    } else {
        int d = 0;
        for (int i = 0; i < cls; i++)
            d |= sym(f, m + 39 + 3 * i, 2, 0) << i;
        mag = 2 << (cls + 2);
        int fr = f->force_intmv ? 3 : sym(f, m + 22, 4, 0);
        int hp = f->allow_hp ? sym(f, m + 33, 2, 0) : 1;
        mag += ((d << 3) | (fr << 1) | hp) + 1;
    }
    return sign ? -mag : mag;
}

/* the warp samples of the block (find_warp_samples, 7.10.4; libaom's
 * av1_findSamples, which steps over the neighbours above and left by
 * their own size, 4-sample ones included): NumSamples candidates (y, x of
 * the neighbour's centre and of its centre moved by its vector, 1/8
 * sample) */
static int add_sample(Av1 *f, int dr, int dc, int *scanned, int *n,
                      int cand[8][4])
{
    if (*scanned >= 8)
        return 0;
    int r = f->mi_row + dr, c = f->mi_col + dc;
    if (!is_inside(f, r, c) || !MI(f->written, r, c))
        return 0;
    size_t k = (size_t)r * f->MiCols + c;
    if (f->ref_frames[2 * k] != f->ref_frame[0] || f->ref_frames[2 * k + 1] != -1)
        return 0;
    int sz = f->mi_size[k];
    int w4 = 1 << bw4_log2[sz], h4 = 1 << bh4_log2[sz];
    int cr = r & ~(h4 - 1), cc = c & ~(w4 - 1);
    size_t ck = (size_t)cr * f->MiCols + cc;
    int midy = cr * 4 + h4 * 2 - 1, midx = cc * 4 + w4 * 2 - 1;
    int bw = f->bw4 * 4, bh = f->bh4 * 4, mx = bw > bh ? bw : bh;
    int thr = mx < 16 ? 16 : mx > 112 ? 112 : mx;
    int dy = abs(f->mvs[4 * ck] - f->mv[0][0]);
    int dx = abs(f->mvs[4 * ck + 1] - f->mv[0][1]);
    int valid = dy + dx <= thr;
    int v[4] = {midy * 8, midx * 8, midy * 8 + f->mvs[4 * ck],
                midx * 8 + f->mvs[4 * ck + 1]};
    *scanned += 1;
    if (!valid && *scanned > 1)
        return 0;
    memcpy(cand[*n], v, sizeof(v));
    *n += valid;
    return 1;
}

static int find_warp_samples(Av1 *f, int cand[8][4])
{
    int n = 0, scanned = 0, w4 = f->bw4, h4 = f->bh4;
    int top_left = 1, top_right = 1;
    if (f->avail_u) {
        int sw = 1 << bw4_log2[MI(f->mi_size, f->mi_row - 1, f->mi_col)];
        if (w4 <= sw) {
            int off = -(f->mi_col & (sw - 1));
            if (off < 0)
                top_left = 0;
            if (off + sw > w4)
                top_right = 0;
            add_sample(f, -1, 0, &scanned, &n, cand);
        } else {
            int end = w4 < f->MiCols - f->mi_col ? w4 : f->MiCols - f->mi_col;
            for (int i = 0; i < end;) {
                sw = 1 << bw4_log2[MI(f->mi_size, f->mi_row - 1,
                                      f->mi_col + i)];
                add_sample(f, -1, i, &scanned, &n, cand);
                i += sw;
            }
        }
    }
    if (f->avail_l) {
        int sh = 1 << bh4_log2[MI(f->mi_size, f->mi_row, f->mi_col - 1)];
        if (h4 <= sh) {
            if (-(f->mi_row & (sh - 1)) < 0)
                top_left = 0;
            add_sample(f, 0, -1, &scanned, &n, cand);
        } else {
            int end = h4 < f->MiRows - f->mi_row ? h4 : f->MiRows - f->mi_row;
            for (int i = 0; i < end;) {
                sh = 1 << bh4_log2[MI(f->mi_size, f->mi_row + i,
                                      f->mi_col - 1)];
                add_sample(f, i, -1, &scanned, &n, cand);
                i += sh;
            }
        }
    }
    if (top_left)
        add_sample(f, -1, -1, &scanned, &n, cand);
    if (top_right && (w4 > h4 ? w4 : h4) <= 16)
        add_sample(f, -1, w4, &scanned, &n, cand);
    if (n == 0 && scanned > 0)
        n = 1;
    return n;
}

/* resolve_divisor of libaom (64 bits) */
static int resolve_divisor(uint64_t d, int *shift)
{
    int n = 0;
    while (n < 63 && (d >> (n + 1)))
        n++;
    int64_t e = (int64_t)(d - ((uint64_t)1 << n)), fr;
    if (n > 8)
        fr = (e + ((int64_t)1 << (n - 9))) >> (n - 8);
    else
        fr = e << (8 - n);
    *shift = n + 14;
    return div_lut[fr];
}

static int64_t round2signed64(int64_t v, int n)
{
    if (!n)
        return v;
    int64_t h = (int64_t)1 << (n - 1);
    return v >= 0 ? (v + h) >> n : -((-v + h) >> n);
}

static int32_t clamp32(int64_t v, int64_t lo, int64_t hi)
{
    return (int32_t)(v < lo ? lo : v > hi ? hi : v);
}

/* libaom's av1_get_shear_params: alpha, beta, gamma, delta of the warp
 * w (reduced to multiples of 64); returns whether the warp is valid */
static int shear_params(const int32_t *w, int *sh)
{
    if (w[2] <= 0)
        return 0;
    int alpha = clamp32(w[2] - 65536, -32768, 32767);
    int beta = clamp32(w[3], -32768, 32767);
    int shift;
    int y = resolve_divisor((uint64_t)w[2], &shift);
    int64_t v = ((int64_t)w[4] * 65536) * y;
    int gamma = clamp32(round2signed64(v, shift), -32768, 32767);
    v = ((int64_t)w[3] * w[4]) * y;
    int delta = clamp32(w[5] - round2signed64(v, shift) - 65536, -32768,
                        32767);
    int p[4] = {alpha, beta, gamma, delta};
    for (int i = 0; i < 4; i++)
        sh[i] = (int16_t)(round2signed(p[i], 6) * 64);
    if (4 * abs(sh[0]) + 7 * abs(sh[1]) >= 65536)
        return 0;
    if (4 * abs(sh[2]) + 4 * abs(sh[3]) >= 65536)
        return 0;
    return 1;
}

/* the local warp of the block from its samples (libaom's find_affine_int,
 * then the shear check) */
static int warp_estimation(Av1 *f, int cand[8][4], int n, int32_t *w)
{
    int64_t A[2][2] = {{0, 0}, {0, 0}}, Bx[2] = {0, 0}, By[2] = {0, 0};
    int bw = f->bw4 * 4, bh = f->bh4 * 4;
    int midy = f->mi_row * 4 + bh / 2 - 1, midx = f->mi_col * 4 + bw / 2 - 1;
    int suy = midy * 8, sux = midx * 8;
    int duy = suy + f->mv[0][0], dux = sux + f->mv[0][1];
#define LSP(a, b, k) ((((int64_t)(a) * (b)) >> 2) + (a) + (b) + (k))
    for (int i = 0; i < n; i++) {
        int sy = cand[i][0] - suy, sx = cand[i][1] - sux;
        int dy = cand[i][2] - duy, dx = cand[i][3] - dux;
        if (abs(sx - dx) < 256 && abs(sy - dy) < 256) {
            A[0][0] += LSP(sx, sx, 8);
            A[0][1] += LSP(sx, sy, 4);
            A[1][1] += LSP(sy, sy, 8);
            Bx[0] += LSP(sx, dx, 8);
            Bx[1] += LSP(sy, dx, 4);
            By[0] += LSP(sx, dy, 4);
            By[1] += LSP(sy, dy, 8);
        }
    }
#undef LSP
    int64_t det = A[0][0] * A[1][1] - A[0][1] * A[0][1];
    if (det == 0)
        return 0;
    int shift;
    int64_t idet = resolve_divisor((uint64_t)(det < 0 ? -det : det), &shift)
                   * (det < 0 ? -1 : 1);
    shift -= 16;
    if (shift < 0) {
        idet = (int16_t)(idet << -shift);
        shift = 0;
    }
    int64_t px[2] = {A[1][1] * Bx[0] - A[0][1] * Bx[1],
                     -A[0][1] * Bx[0] + A[0][0] * Bx[1]};
    int64_t py[2] = {A[1][1] * By[0] - A[0][1] * By[1],
                     -A[0][1] * By[0] + A[0][0] * By[1]};
    w[2] = clamp32(round2signed64(px[0] * idet, shift), 65536 - 8191,
                   65536 + 8191);
    w[3] = clamp32(round2signed64(px[1] * idet, shift), -8191, 8191);
    w[4] = clamp32(round2signed64(py[0] * idet, shift), -8191, 8191);
    w[5] = clamp32(round2signed64(py[1] * idet, shift), 65536 - 8191,
                   65536 + 8191);
    int32_t vx = (int32_t)((int64_t)f->mv[0][1] * (1 << 13) -
                           ((int64_t)midx * (w[2] - 65536) +
                            (int64_t)midy * w[3]));
    int32_t vy = (int32_t)((int64_t)f->mv[0][0] * (1 << 13) -
                           ((int64_t)midx * w[4] +
                            (int64_t)midy * (w[5] - 65536)));
    w[0] = clamp32(vx, -(1 << 23), (1 << 23) - 1);
    w[1] = clamp32(vy, -(1 << 23), (1 << 23) - 1);
    int sh[4];
    return shear_params(w, sh);
}

/* has_overlappable_candidates */
static int overlappable(Av1 *f)
{
    if (f->avail_u)
        for (int x = f->mi_col; x < f->MiCols && x < f->mi_col + f->bw4;
             x += 2) {
            int x5 = (x | 1) < f->MiCols ? x | 1 : f->MiCols - 1;
            if (f->ref_frames[2 * ((size_t)(f->mi_row - 1) * f->MiCols + x5)]
                > INTRA_FRAME)
                return 1;
        }
    if (f->avail_l)
        for (int y = f->mi_row; y < f->MiRows && y < f->mi_row + f->bh4;
             y += 2) {
            int y5 = (y | 1) < f->MiRows ? y | 1 : f->MiRows - 1;
            if (f->ref_frames[2 * ((size_t)y5 * f->MiCols + f->mi_col - 1)]
                > INTRA_FRAME)
                return 1;
        }
    return 0;
}

static int ref_scaled(Av1 *f, int ref)
{
    return f->ref[ref].xs != 1 << 14 || f->ref[ref].ys != 1 << 14;
}

/* read_motion_mode */
static void read_motion_mode(Av1 *f)
{
    f->motion_mode = MM_SIMPLE;
    if (!f->switchable_motion || f->bw4 < 2 || f->bh4 < 2)
        return;
    if (!f->force_intmv && f->ymode == GLOBALMV &&
        f->gm_type[f->ref_frame[0]] > GM_TRANSLATION)
        return;
    if (f->ref_frame[1] == INTRA_FRAME || !overlappable(f))
        return;
    int cand[8][4];
    int n = find_warp_samples(f, cand);
    if (f->force_intmv || n == 0 || !f->allow_warp ||
        ref_scaled(f, f->ref_frame[0])) {
        f->motion_mode = sym(f, f->cdf.obmc[f->mi_sz], 2, 0);
    } else {
        f->motion_mode = sym(f, f->cdf.motion_mode[f->mi_sz], 3, 0);
    }
    if (f->motion_mode == MM_LOCALWARP)
        f->lw_valid = warp_estimation(f, cand, n, f->lw);
}

/* the interpolation filter context of direction dir */
static int interp_ctx(Av1 *f, int dir)
{
    int ctx = (dir & 1) * 2 * 4, lt = 3, at = 3;
    if (f->avail_l) {
        size_t k = (size_t)f->mi_row * f->MiCols + f->mi_col - 1;
        if (f->ref_frames[2 * k] == f->ref_frame[0] ||
            f->ref_frames[2 * k + 1] == f->ref_frame[0])
            lt = f->filters[2 * k + dir];
    }
    if (f->avail_u) {
        size_t k = (size_t)(f->mi_row - 1) * f->MiCols + f->mi_col;
        if (f->ref_frames[2 * k] == f->ref_frame[0] ||
            f->ref_frames[2 * k + 1] == f->ref_frame[0])
            at = f->filters[2 * k + dir];
    }
    if (lt == at)
        return ctx + lt;
    if (lt == 3)
        return ctx + at;
    if (at == 3)
        return ctx + lt;
    return ctx + 3;
}

static void inter_block_mode_info(Av1 *f)
{
    Cdfs *c = &f->cdf;
    MvStack st;
    int ctx[3];
    f->pal_y = f->pal_uv = 0;
    f->use_filter_intra = 0;
    f->angle_y = f->angle_uv = 0;
    f->uvmode = DC_PRED; /* not smooth to the edge filter of later blocks */
    f->cfl_u = f->cfl_v = 0;
    read_ref_frames(f);
    if (f->gm_type[f->ref_frame[0]] != GM_IDENTITY)
        av1_refuse(f, "an AV1 block predicted from a reference with global "
                   "motion");
    find_mv_stack(f, &st, ctx);
    if (seg_active(f, f->segment_id, SEG_LVL_SKIP) ||
        seg_active(f, f->segment_id, SEG_LVL_GLOBALMV)) {
        f->ymode = GLOBALMV;
    } else if (!sym(f, c->newmv[ctx[0]], 2, 0)) {
        f->ymode = NEWMV;
    } else if (!sym(f, c->zeromv[ctx[1]], 2, 0)) {
        f->ymode = GLOBALMV;
    } else {
        f->ymode = sym(f, c->refmv[ctx[2]], 2, 0) ? NEARMV : NEARESTMV;
    }
    int idx = 0;
    /* the DRL index (DrlCtxStack of the weights) */
    if (f->ymode == NEWMV || f->ymode == NEARMV) {
        int start = f->ymode == NEARMV;
        idx = start;
        for (int i = start; i < start + 2; i++) {
            if (st.n <= i + 1)
                break;
            int w0 = st.weight[i], w1 = st.weight[i + 1];
            int dctx = w0 >= 640 ? (w1 >= 640 ? 0 : 1) : w1 < 640 ? 2 : 0;
            if (!sym(f, c->drl[dctx], 2, 0)) {
                idx = i;
                break;
            }
            idx = i + 1;
        }
    }
    /* assign_mv */
    int pred[2];
    if (f->ymode == GLOBALMV) {
        pred[0] = st.global[0];
        pred[1] = st.global[1];
    } else {
        int pos = f->ymode == NEARESTMV ? 0 : idx;
        if (f->ymode == NEWMV && st.n <= 1)
            pos = 0;
        pred[0] = st.row[pos];
        pred[1] = st.col[pos];
    }
    f->mv[0][0] = pred[0];
    f->mv[0][1] = pred[1];
    if (f->ymode == NEWMV) {
        int joint = sym(f, c->mv_inter, 4, 0);
        if (joint == 2 || joint == 3)
            f->mv[0][0] += read_mv_component(f, 5);
        if (joint == 1 || joint == 3)
            f->mv[0][1] += read_mv_component(f, 74);
    }
    if (f->mv[0][0] <= -(1 << 14) || f->mv[0][0] >= 1 << 14 ||
        f->mv[0][1] <= -(1 << 14) || f->mv[0][1] >= 1 << 14)
        av1_fail(f, ERR_VALUE, "AV1: an invalid motion vector");
    /* read_interintra_mode */
    f->interintra = 0;
    if (f->enable_interintra && f->mi_sz >= BLOCK_8X8 && f->mi_sz <= 9) {
        int g = size_group[f->mi_sz];
        f->interintra = sym(f, c->interintra[g], 2, 0);
        if (f->interintra) {
            f->ii_mode = sym(f, c->interintra_mode[g], 4, 0);
            f->ref_frame[1] = INTRA_FRAME;
            f->wedge_ii = sym(f, c->wedge_interintra[f->mi_sz], 2, 0);
            if (f->wedge_ii)
                f->wedge_idx = sym(f, c->wedge_idx[f->mi_sz], 16, 0);
        }
    }
    read_motion_mode(f);
    /* the interpolation filters */
    int need = 1;
    if (f->motion_mode == MM_LOCALWARP)
        need = 0;
    else if (f->bw4 >= 2 && f->bh4 >= 2 && f->ymode == GLOBALMV)
        need = f->gm_type[f->ref_frame[0]] == GM_TRANSLATION;
    if (f->interp_filter != 4) {
        f->filt[0] = f->filt[1] = f->interp_filter;
    } else if (!need) {
        f->filt[0] = f->filt[1] = 0;
    } else {
        if (f->enable_dual_filter)
            av1_refuse(f, "an AV1 dual interpolation filter");
        for (int dir = 0; dir < (f->enable_dual_filter ? 2 : 1); dir++)
            f->filt[dir] = sym(f, c->interp[interp_ctx(f, dir)], 3, 0);
        if (!f->enable_dual_filter)
            f->filt[1] = f->filt[0];
    }
}

static void inter_frame_mode_info(Av1 *f)
{
    Cdfs *c = &f->cdf;
    Choice none = {0};
    size_t ka = (size_t)(f->mi_row - 1) * f->MiCols + f->mi_col;
    size_t kl = (size_t)f->mi_row * f->MiCols + f->mi_col - 1;
    f->above_ref[0] = f->avail_u ? f->ref_frames[2 * ka] : INTRA_FRAME;
    f->above_ref[1] = f->avail_u ? f->ref_frames[2 * ka + 1] : -1;
    f->left_ref[0] = f->avail_l ? f->ref_frames[2 * kl] : INTRA_FRAME;
    f->left_ref[1] = f->avail_l ? f->ref_frames[2 * kl + 1] : -1;
    f->skip = 0;
    inter_segment_id(f, 1);
    /* read_skip_mode */
    if (f->skip_mode_present && f->bw4 >= 2 && f->bh4 >= 2 &&
        !seg_active(f, f->segment_id, SEG_LVL_SKIP) &&
        !seg_active(f, f->segment_id, SEG_LVL_REF_FRAME) &&
        !seg_active(f, f->segment_id, SEG_LVL_GLOBALMV) &&
        sym(f, c->skip_mode[0], 2, 0))
        av1_fail(f, ERR_NOTIMPL, "AVIF: an AV1 skip mode");
    if (seg_active(f, f->segment_id, SEG_LVL_SKIP)) {
        f->skip = 1;
    } else {
        int ctx = (f->avail_u ? MI(f->skips, f->mi_row - 1, f->mi_col) : 0) +
                  (f->avail_l ? MI(f->skips, f->mi_row, f->mi_col - 1) : 0);
        f->skip = sym(f, c->skip[ctx], 2, 0);
    }
    if (!f->seg_preskip)
        inter_segment_id(f, 0);
    read_cdef(f);
    read_delta_qindex(f);
    read_delta_lf(f);
    f->blk_q = seg_q(f, f->segment_id, f->qindex);
    f->read_deltas = 0;
    /* read_is_inter */
    if (seg_active(f, f->segment_id, SEG_LVL_REF_FRAME)) {
        f->blk_inter = f->seg_data[f->segment_id][SEG_LVL_REF_FRAME] !=
                      INTRA_FRAME;
    } else if (seg_active(f, f->segment_id, SEG_LVL_GLOBALMV)) {
        f->blk_inter = 1;
    } else {
        int ctx, au = f->avail_u, al = f->avail_l;
        int ai = f->above_ref[0] <= INTRA_FRAME;
        int li = f->left_ref[0] <= INTRA_FRAME;
        if (au && al)
            ctx = ai && li ? 3 : ai || li;
        else if (au || al)
            ctx = 2 * (au ? ai : li);
        else
            ctx = 0;
        f->blk_inter = sym(f, c->intra_inter[ctx], 2, 0);
    }
    if (f->blk_inter) {
        inter_block_mode_info(f);
        f->tools[0]++;
        f->tools[2] += f->ymode == NEWMV;
        f->tools[3] += f->ymode == GLOBALMV;
        f->tools[4] += f->motion_mode == MM_OBMC;
        f->tools[5] += f->motion_mode == MM_LOCALWARP && f->lw_valid;
        f->tools[7] += f->interintra;
        f->tools[8] += f->interintra && f->wedge_ii;
        f->tools[11] += f->filt[0] != f->filt[1];
    } else {
        f->tools[1]++;
        intra_modes(f, &none);
    }
}

/* -- the saved motion field (7.19) and motion field estimation (7.9) ----- */

/* libaom's av1_copy_frame_mvs: each 8 x 8 unit of the block keeps the
 * vector of its last reference list that points backwards nowhere (a
 * reference of another order hint on the same side) */
static void save_frame_mvs(Av1 *f)
{
    int w = (f->bw4 < f->MiCols - f->mi_col ? f->bw4 : f->MiCols - f->mi_col);
    int h = (f->bh4 < f->MiRows - f->mi_row ? f->bh4 : f->MiRows - f->mi_row);
    w = (w + 1) >> 1;
    h = (h + 1) >> 1;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            size_t u = (size_t)((f->mi_row >> 1) + y) * f->mf_cols +
                       (f->mi_col >> 1) + x;
            f->save_ref[u] = -1;
            f->save_mv[2 * u] = f->save_mv[2 * u + 1] = 0;
            for (int list = 0; list < 2 && f->inter_frame; list++) {
                int ref = f->ref_frame[list];
                if (ref <= INTRA_FRAME || f->ref_side[ref])
                    continue;
                if (abs(f->mv[list][0]) > 4095 || abs(f->mv[list][1]) > 4095)
                    continue;
                f->save_ref[u] = (int8_t)ref;
                f->save_mv[2 * u] = (int16_t)f->mv[list][0];
                f->save_mv[2 * u + 1] = (int16_t)f->mv[list][1];
            }
        }
}

/* libaom's motion_field_projection of reference src (dir 2: LAST and
 * LAST2, projected backwards); returns whether it projected */
static int project(Av1 *f, int src, int dir)
{
    const RefView *r = &f->ref[src];
    if (r->intra || r->mi_rows != f->MiRows || r->mi_cols != f->MiCols ||
        !r->mf_ref)
        return 0;
    int off[8] = {0};
    int to_cur = rel_dist(f, r->order_hint, f->order_hint);
    for (int i = LAST_FRAME; i <= ALTREF_FRAME; i++)
        off[i] = rel_dist(f, r->order_hint, r->saved_hints[i]);
    if (dir == 2)
        to_cur = -to_cur;
    int rows = (f->MiRows + 1) >> 1, cols = (f->MiCols + 1) >> 1;
    for (int y = 0; y < rows; y++)
        for (int x = 0; x < cols; x++) {
            size_t u = (size_t)y * cols + x;
            int ref = r->mf_ref[u];
            if (ref <= INTRA_FRAME)
                continue;
            int ro = off[ref];
            if (!(abs(ro) <= 31 && ro > 0 && abs(to_cur) <= 31))
                continue;
            int mv[2];
            mv_projection(mv, r->mf_mv + 2 * u, to_cur, ro);
            int sign = dir >> 1;
            int dr = mv[0] >= 0 ? mv[0] >> 6 : -((-mv[0]) >> 6);
            int dc = mv[1] >= 0 ? mv[1] >> 6 : -((-mv[1]) >> 6);
            int py = sign ? y - dr : y + dr, px = sign ? x - dc : x + dc;
            int by = (y >> 3) << 3, bx = (x >> 3) << 3;
            if (py < 0 || py >= f->MiRows >> 1 || px < 0 ||
                px >= f->MiCols >> 1 || py < by || py >= by + 8 ||
                px < bx - 8 || px >= bx + 16)
                continue;
            size_t p = (size_t)py * f->mf_cols + px;
            f->tpl_mv[2 * p] = r->mf_mv[2 * u];
            f->tpl_mv[2 * p + 1] = r->mf_mv[2 * u + 1];
            f->tpl_off[p] = (int8_t)ro;
            f->tools[12]++;
        }
    return 1;
}

/* the sides of the references (ref_frame_side), and the motion field of
 * use_ref_frame_mvs (libaom's av1_setup_motion_field) */
static void motion_field(Av1 *f)
{
    memset(f->ref_side, 0, sizeof(f->ref_side));
    for (int i = LAST_FRAME; i <= ALTREF_FRAME && f->enable_order_hint; i++) {
        int h = f->ref[i].order_hint;
        if (rel_dist(f, h, f->order_hint) > 0)
            f->ref_side[i] = 1;
        else if (h == f->order_hint)
            f->ref_side[i] = -1;
    }
    size_t n = (size_t)f->mf_rows * f->mf_cols;
    for (size_t u = 0; u < n; u++) {
        f->tpl_mv[2 * u] = -32768;
        f->tpl_mv[2 * u + 1] = 0;
        f->tpl_off[u] = 0;
    }
    if (!f->use_ref_mvs || !f->enable_order_hint)
        return;
    int stamp = 2;
    const RefView *last = &f->ref[LAST_FRAME];
    if (last->saved_hints[ALTREF_FRAME] != f->order_hints[GOLDEN_FRAME])
        project(f, LAST_FRAME, 2);
    stamp--;
    if (rel_dist(f, f->order_hints[BWDREF_FRAME], f->order_hint) > 0 &&
        project(f, BWDREF_FRAME, 0))
        stamp--;
    if (rel_dist(f, f->order_hints[ALTREF2_FRAME], f->order_hint) > 0 &&
        project(f, ALTREF2_FRAME, 0))
        stamp--;
    if (rel_dist(f, f->order_hints[ALTREF_FRAME], f->order_hint) > 0 &&
        stamp >= 0 && project(f, ALTREF_FRAME, 0))
        stamp--;
    if (stamp >= 0)
        project(f, LAST2_FRAME, 2);
}

/* -- inter prediction (7.11.3; libaom's convolutions and warp) ----------- */

/* the w x h block at (x, y) of a plane predicted from reference frame ref
 * with vector mv (1/8 luma sample) and filters filt (y, x), as pixels
 * into out (stride 128): the motion vector scaling process and the block
 * inter prediction process (InterRound0 3 and InterRound1 11, 5 and 9 at
 * 12 bits) */
static void block_inter(Av1 *f, int plane, int ref, const int *mv,
                        const int *filt, int x, int y, int w, int h,
                        uint16_t *out)
{
    const RefView *r = &f->ref[ref];
    int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
    int r0 = f->bitdepth == 12 ? 5 : 3, r1 = f->bitdepth == 12 ? 9 : 11;
    int64_t ox = ((int64_t)x << 4) + ((2 * mv[1]) >> ssx) + 8;
    int64_t oy = ((int64_t)y << 4) + ((2 * mv[0]) >> ssy) + 8;
    int64_t bx = ox * r->xs - (8 << 14), by = oy * r->ys - (8 << 14);
    int sx0 = (int)round2signed64(bx, 8) + 32, sy0 = (int)round2signed64(by, 8) + 32;
    int xstep = round2signed(r->xs, 4), ystep = round2signed(r->ys, 4);
    int lastx = ((r->up_w + ssx) >> ssx) - 1, lasty = ((r->h + ssy) >> ssy) - 1;
    int fx = filt[1], fy = filt[0];
    if (w <= 4)
        fx = fx == 1 ? 5 : fx == 3 ? 3 : 4;
    if (h <= 4)
        fy = fy == 1 ? 5 : fy == 3 ? 3 : 4;
    int ih = (((h - 1) * ystep + (1 << 10) - 1) >> 10) + 8;
    const uint16_t *src = r->plane[plane];
    int32_t *tmp = f->pred_tmp;
    for (int i = 0; i < ih; i++) {
        int yy = (sy0 >> 10) + i - 3;
        yy = yy < 0 ? 0 : yy > lasty ? lasty : yy;
        const uint16_t *row = src + (size_t)yy * r->stride;
        for (int j = 0; j < w; j++) {
            int p = sx0 + xstep * j;
            const int16_t *k = subpel_filters[fx][(p >> 6) & 15];
            int s = 0;
            for (int t = 0; t < 8; t++) {
                int xx = (p >> 10) + t - 3;
                xx = xx < 0 ? 0 : xx > lastx ? lastx : xx;
                s += k[t] * row[xx];
            }
            tmp[i * 128 + j] = round2(s, r0);
        }
    }
    for (int i = 0; i < h; i++) {
        int p = (sy0 & 1023) + ystep * i;
        const int16_t *k = subpel_filters[fy][(p >> 6) & 15];
        const int32_t *col = tmp + (p >> 10) * 128;
        for (int j = 0; j < w; j++) {
            int s = 0;
            for (int t = 0; t < 8; t++)
                s += k[t] * col[t * 128 + j];
            out[i * 128 + j] = (uint16_t)clip1(f, round2(s, r1));
        }
    }
}

/* the warped prediction of the w x h block at (x, y) of a plane from
 * reference ref (libaom's av1_highbd_warp_affine_c: 8 x 8 blocks,
 * positions reduced to multiples of 64) */
static void block_warp(Av1 *f, int plane, int ref, const int32_t *wm,
                       int x, int y, int w, int h, uint16_t *out)
{
    const RefView *r = &f->ref[ref];
    int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
    int r0 = f->bitdepth == 12 ? 5 : 3, r1 = 14 - r0;
    int lastx = ((r->up_w + ssx) >> ssx) - 1, lasty = ((r->h + ssy) >> ssy) - 1;
    int sh[4];
    shear_params(wm, sh);
    int alpha = sh[0], beta = sh[1], gamma = sh[2], delta = sh[3];
    const uint16_t *src = r->plane[plane];
    int32_t tmp[15 * 8];
    for (int i = y; i < y + h; i += 8)
        for (int j = x; j < x + w; j += 8) {
            int32_t srcx = (j + 4) << ssx, srcy = (i + 4) << ssy;
            int64_t dx = (int64_t)wm[2] * srcx + (int64_t)wm[3] * srcy + wm[0];
            int64_t dy = (int64_t)wm[4] * srcx + (int64_t)wm[5] * srcy + wm[1];
            int64_t x4 = dx >> ssx, y4 = dy >> ssy;
            int ix4 = (int)(x4 >> 16), iy4 = (int)(y4 >> 16);
            int32_t sx4 = (int32_t)(x4 & 65535), sy4 = (int32_t)(y4 & 65535);
            sx4 += alpha * -4 + beta * -4;
            sy4 += gamma * -4 + delta * -4;
            sx4 &= ~63;
            sy4 &= ~63;
            for (int k = -7; k < 8; k++) {
                int iy = iy4 + k;
                iy = iy < 0 ? 0 : iy > lasty ? lasty : iy;
                const uint16_t *row = src + (size_t)iy * r->stride;
                int sx = sx4 + beta * (k + 4);
                for (int l = -4; l < 4; l++) {
                    int ix = ix4 + l - 3;
                    const int16_t *c = warped_filter[((sx + 512) >> 10) + 64];
                    int s = 0;
                    for (int m = 0; m < 8; m++) {
                        int xx = ix + m;
                        xx = xx < 0 ? 0 : xx > lastx ? lastx : xx;
                        s += row[xx] * c[m];
                    }
                    tmp[(k + 7) * 8 + l + 4] = round2(s, r0);
                    sx += alpha;
                }
            }
            for (int k = -4; k < 4 && i + k + 4 < y + h; k++) {
                int sy = sy4 + delta * (k + 4);
                for (int l = -4; l < 4 && j + l + 4 < x + w; l++) {
                    const int16_t *c = warped_filter[((sy + 512) >> 10) + 64];
                    int s = 0;
                    for (int m = 0; m < 8; m++)
                        s += tmp[(k + m + 4) * 8 + l + 4] * c[m];
                    out[(i - y + k + 4) * 128 + (j - x + l + 4)] =
                        (uint16_t)clip1(f, round2(s, r1));
                    sy += gamma;
                }
            }
        }
}

/* the wedge mask (64 levels) at (i, j) of block size bsize, wedge w, sign
 * 0 (libaom's get_wedge_mask_inplace over its master masks) */
static int wedge_master(int dir, int i, int j)
{
    /* WEDGE_HORIZONTAL 0, VERTICAL 1, OBLIQUE27 2, 63 3, 117 4, 153 5 */
    switch (dir) {
    case 0:
        return wedge_master_vertical[i];
    case 1:
        return wedge_master_vertical[j];
    case 2: /* the transpose of OBLIQUE63 */
        return wedge_master(3, j, i);
    case 3: {
        int shift = 16 - (i >> 1) - (i & 1);
        int k = j - shift;
        k = k < 0 ? 0 : k > 63 ? 63 : k;
        return (i & 1) ? wedge_master_odd[k] : wedge_master_even[k];
    }
    case 4:
        return 64 - wedge_master(3, i, 63 - j);
    default:
        return 64 - wedge_master(3, j, 63 - i);
    }
}

static int wedge_mask(int bsize, int w, int i, int j)
{
    int bw = 4 << bw4_log2[bsize], bh = 4 << bh4_log2[bsize];
    const int8_t *cb = wedge_codebook[bw == bh ? 0 : bh > bw ? 1 : 2][w];
    int woff = (cb[1] * bw) >> 3, hoff = (cb[2] * bh) >> 3;
    int m = wedge_master(cb[0], 32 - hoff + i, 32 - woff + j);
    return wedge_signflip[bsize][w] ? 64 - m : m;
}

/* the inter-intra blend of the w x h block at (x, y) of a plane: the intra
 * prediction in the plane, the inter one in pred (libaom's
 * combine_interintra: the wedge of the luma block size, averaged over
 * subsampled chroma, or the smooth mask of the plane's block size) */
static void interintra_blend(Av1 *f, int plane, int x, int y, int w, int h,
                             const uint16_t *pred)
{
    int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
    int pb = plane_bsize(f->mi_sz, ssx, ssy), scale = ii_size_scales[pb];
    if (f->wedge_ii && ssx && !ssy)
        av1_refuse(f, "an AV1 wedge inter-intra block with 4:2:2 chroma");
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int m;
            if (f->wedge_ii) {
                if (ssx && ssy)
                    m = (wedge_mask(f->mi_sz, f->wedge_idx, 2 * i, 2 * j) +
                         wedge_mask(f->mi_sz, f->wedge_idx, 2 * i, 2 * j + 1) +
                         wedge_mask(f->mi_sz, f->wedge_idx, 2 * i + 1, 2 * j) +
                         wedge_mask(f->mi_sz, f->wedge_idx, 2 * i + 1,
                                    2 * j + 1) + 2) >> 2;
                else if (ssx)
                    m = (wedge_mask(f->mi_sz, f->wedge_idx, i, 2 * j) +
                         wedge_mask(f->mi_sz, f->wedge_idx, i, 2 * j + 1) +
                         1) >> 1;
                else
                    m = wedge_mask(f->mi_sz, f->wedge_idx, i, j);
            } else {
                switch (f->ii_mode) {
                case 1: m = ii_weights1d[i * scale]; break;
                case 2: m = ii_weights1d[j * scale]; break;
                case 3: m = ii_weights1d[(i < j ? i : j) * scale]; break;
                default: m = 32;
                }
            }
            if (y + i < f->rows && x + j < f->stride) {
                uint16_t *d = &PX(plane, y + i, x + j);
                *d = (uint16_t)((m * *d + (64 - m) * pred[i * 128 + j] + 32)
                                >> 6);
            }
        }
}

static void put_block(Av1 *f, int plane, int x, int y, int w, int h,
                      const uint16_t *pred)
{
    for (int i = 0; i < h && y + i < f->rows; i++)
        for (int j = 0; j < w && x + j < f->stride; j++)
            PX(plane, y + i, x + j) = pred[i * 128 + j];
}

/* the prediction of one block of a plane from the unit (cr, cc)'s
 * reference and vector (predict_inter of 7.11.3.1), warped where the
 * block's motion or global motion warps */
static void predict_one(Av1 *f, int plane, int x, int y, int w, int h,
                        int cr, int cc)
{
    size_t k = (size_t)cr * f->MiCols + cc;
    int ref = f->ref_frames[2 * k];
    int mv[2] = {f->mvs[4 * k], f->mvs[4 * k + 1]};
    int filt[2] = {f->filters[2 * k], f->filters[2 * k + 1]};
    uint16_t *pred = f->pred_blk;
    const int32_t *wm = NULL;
    if (w >= 8 && h >= 8 && !f->force_intmv) {
        if (f->motion_mode == MM_LOCALWARP && f->lw_valid)
            wm = f->lw;
        else if (f->ymode == GLOBALMV && f->gm_type[ref] > GM_TRANSLATION &&
                 !ref_scaled(f, ref) && f->gm_valid[ref])
            wm = f->gm[ref];
    }
    if (plane == 0)
        f->tools[6] += wm && wm != f->lw;
    f->tools[9] += ref_scaled(f, ref);
    if (wm)
        block_warp(f, plane, ref, wm, x, y, w, h, pred);
    else
        block_inter(f, plane, ref, mv, filt, x, y, w, h, pred);
    if (f->interintra)
        interintra_blend(f, plane, x, y, w, h, pred);
    else
        put_block(f, plane, x, y, w, h, pred);
}

/* OBMC (libaom's dec_build_obmc_inter_predictors_sb): each overlappable
 * neighbour above, then left, predicts the block's edge strip with its
 * own vector; the strips are blended over the prediction */
static void obmc_side(Av1 *f, int left)
{
    static const uint8_t max_nb[6] = {0, 1, 2, 3, 4, 4};
    int n4 = left ? f->bh4 : f->bw4, pos = left ? f->mi_row : f->mi_col;
    int lim = left ? f->MiRows : f->MiCols;
    int end = pos + n4 < lim ? pos + n4 : lim, count = 0;
    int most = max_nb[left ? bh4_log2[f->mi_sz] : bw4_log2[f->mi_sz]];
    uint16_t *pred = f->pred_blk;
    if (!(left ? f->avail_l : f->avail_u))
        return;
    for (int p = pos; p < end && count < most;) {
        int r = left ? p : f->mi_row - 1, c = left ? f->mi_col - 1 : p;
        int sz = MI(f->mi_size, r, c);
        int step = 1 << (left ? bh4_log2[sz] : bw4_log2[sz]);
        step = step > 16 ? 16 : step;
        if (step == 1) {
            p &= ~1;
            if (left)
                r = p + 1;
            else
                c = p + 1;
            step = 2;
        }
        size_t k = (size_t)r * f->MiCols + c;
        if (f->ref_frames[2 * k] > INTRA_FRAME) {
            count++;
            int op = n4 < step ? n4 : step;
            int mv[2] = {f->mvs[4 * k], f->mvs[4 * k + 1]};
            int filt[2] = {f->filters[2 * k], f->filters[2 * k + 1]};
            for (int plane = 0; plane < 1 + 2 * f->has_chroma; plane++) {
                int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
                int pb = plane_bsize(f->mi_sz, ssx, ssy);
                /* libaom's av1_skip_u4x4_pred_in_obmc: a plane block of
                 * 4x4, 4x8 or 8x4 takes the left neighbours only */
                if (!left && (pb == 0 || pb == 1 || pb == 2))
                    continue;
                int bw = 4 << bw4_log2[f->mi_sz], bh = 4 << bh4_log2[f->mi_sz];
                int x, y, w, h, ov;
                if (left) {
                    x = (f->mi_col * 4) >> ssx;
                    y = (p * 4) >> ssy;
                    w = bw >> (ssx + 1);
                    w = w < 4 ? 4 : w > (32 >> ssx) ? 32 >> ssx : w;
                    h = (op * 4) >> ssy;
                    ov = (bw < 64 ? bw : 64) >> 1 >> ssx;
                } else {
                    x = (p * 4) >> ssx;
                    y = (f->mi_row * 4) >> ssy;
                    w = (op * 4) >> ssx;
                    h = bh >> (ssy + 1);
                    h = h < 4 ? 4 : h > (32 >> ssy) ? 32 >> ssy : h;
                    ov = (bh < 64 ? bh : 64) >> 1 >> ssy;
                }
                block_inter(f, plane, f->ref_frames[2 * k], mv, filt, x, y,
                            w, h, pred);
                const uint8_t *mask = ov == 2 ? obmc_mask_2 : ov == 4 ?
                                      obmc_mask_4 : ov == 8 ? obmc_mask_8 :
                                      ov == 16 ? obmc_mask_16 : obmc_mask_32;
                int bh2 = left ? h : ov, bw2 = left ? ov : w;
                for (int i = 0; i < bh2; i++)
                    for (int j = 0; j < bw2; j++) {
                        if (y + i >= f->rows || x + j >= f->stride)
                            continue;
                        int m = left ? mask[j] : mask[i];
                        uint16_t *d = &PX(plane, y + i, x + j);
                        *d = (uint16_t)((m * *d + (64 - m) *
                                         pred[i * 128 + j] + 32) >> 6);
                    }
            }
        }
        p += step;
    }
}

/* the prediction of an inter block (compute_prediction): each plane's
 * inter-intra intra part first, then the inter prediction (a chroma
 * block under several luma blocks from each one's vector, unless one is
 * intra), then OBMC */
static void predict_inter(Av1 *f)
{
#ifdef LR_CLOCK
    double t0 = LR_CLOCK();
#endif
    if (!f->pred_tmp) {
        f->pred_tmp = av1_alloc(f, sizeof(int32_t) * 128 * 280);
        f->pred_blk = av1_alloc(f, sizeof(uint16_t) * 128 * 128);
    }
    for (int plane = 0; plane < 1 + 2 * f->has_chroma; plane++) {
        int ssx = plane ? f->ssx : 0, ssy = plane ? f->ssy : 0;
        int pb = plane ? plane_bsize(f->mi_sz, ssx, ssy) : f->mi_sz;
        int n4w = 1 << bw4_log2[pb], n4h = 1 << bh4_log2[pb];
        int bx = (f->mi_col >> ssx) * 4, by = (f->mi_row >> ssy) * 4;
        int cr = (f->mi_row >> ssy) << ssy, cc = (f->mi_col >> ssx) << ssx;
        if (f->interintra) {
            static const uint8_t ii_intra[4] = {DC_PRED, V_PRED, H_PRED,
                                                SMOOTH_PRED};
            predict_intra(f, plane, bx, by,
                          plane ? f->avail_l_uv : f->avail_l,
                          plane ? f->avail_u_uv : f->avail_u, 0, 0,
                          ii_intra[f->ii_mode], bw4_log2[pb] + 2,
                          bh4_log2[pb] + 2);
        }
        int pw = (4 << bw4_log2[f->mi_sz]) >> ssx;
        int ph = (4 << bh4_log2[f->mi_sz]) >> ssy;
        int some_intra = 0;
        for (int r = 0; r < n4h << ssy; r++)
            for (int c = 0; c < n4w << ssx; c++)
                if (cr + r < f->MiRows && cc + c < f->MiCols &&
                    f->ref_frames[2 * ((size_t)(cr + r) * f->MiCols + cc + c)]
                    == INTRA_FRAME)
                    some_intra = 1;
        if (some_intra || (pw >= n4w * 4 && ph >= n4h * 4)) {
            pw = n4w * 4;
            ph = n4h * 4;
            cr = f->mi_row;
            cc = f->mi_col;
        }
        f->tools[10] += pw < n4w * 4 || ph < n4h * 4;
        for (int y = 0, r = 0; y < n4h * 4; y += ph, r++)
            for (int x = 0, c = 0; x < n4w * 4; x += pw, c++)
                predict_one(f, plane, bx + x, by + y, pw, ph, cr + r, cc + c);
    }
    if (f->motion_mode == MM_OBMC) {
        obmc_side(f, 0);
        obmc_side(f, 1);
    }
#ifdef LR_CLOCK
    f->inter_ms += LR_CLOCK() - t0;
#endif
}
