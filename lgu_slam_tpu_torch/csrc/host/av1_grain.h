/* AV1 film grain synthesis (specification 7.18.3), as libaom 3.14's
 * grain_synthesis.c applies it to the frame its decoder outputs: after
 * every in-loop filter, to the shown frame only (the reference stays
 * clean), before the caller's YUV to RGB.  Included by av1_decode.c.
 *
 * The grain templates: a 73 x 82 luma block (38 x 44 for 4:2:0 chroma,
 * 73 x 44 for 4:2:2, 73 x 82 for 4:4:4) of libaom's Gaussian sequence
 * drawn by a 16-bit LFSR from the frame's grain_seed (chroma from the
 * seed xor 0xb524 and 0x49d8), shifted by 12 - depth + grain_scale_shift,
 * then filtered by the auto-regressive coefficients of lag 0-3 (chroma
 * also from the co-located luma grain, averaged over its subsampling).
 * The noise: per stripe of 32 luma rows the LFSR restarts from the seed
 * and the stripe's number, and each 32 x 32 block takes the template at a
 * random offset; with overlap_flag the two columns (one for subsampled
 * chroma) at a block's left seam and the two rows at a stripe's top seam
 * are blended with the neighbour's grain (27/17, 17/27; 23/22).  Each
 * sample then gets Round2(scale(v) * noise, scaling_shift), scale() the
 * piecewise-linear scaling function of its plane (interpolated between
 * 8-bit entries above 8 bits), chroma's index mixing the co-located luma
 * (before luma's own noise; the mean of a pair where chroma is
 * subsampled horizontally, the last column repeated at an odd width)
 * with cb_mult / cb_luma_mult / cb_offset, or luma alone with
 * chroma_scaling_from_luma; clipped to 16-235 (16-240 chroma, 16-235
 * under the identity matrix) with clip_to_restricted_range.
 */
#ifndef AV1_GRAIN_H
#define AV1_GRAIN_H

#include "av1_core.h"

/* the specification's get_random_number over RandomRegister */
static int grain_random(uint16_t *reg, int bits)
{
    unsigned r = *reg;
    unsigned bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    r = (r >> 1) | (bit << 15);
    *reg = (uint16_t)r;
    return (int)((r >> (16 - bits)) & ((1u << bits) - 1));
}

/* libaom's init_random_generator: the seed, changed by the stripe (or
 * the template: 7 for Cb, 11 for Cr) number */
static uint16_t grain_seed_of(int seed, int num)
{
    unsigned r = (unsigned)seed & 0xFFFF;
    r ^= (unsigned)((num * 37 + 178) & 255) << 8;
    r ^= (unsigned)((num * 173 + 105) & 255);
    return (uint16_t)r;
}

static int grain_clip(int v, int lo, int hi)
{
    return v < lo ? lo : v > hi ? hi : v;
}

/* a template of h x w Gaussian values (zeros where its plane takes no
 * grain) */
static void grain_fill(int16_t *t, int h, int w, int on, uint16_t reg,
                       int shift)
{
    for (int i = 0; i < h * w; i++)
        t[i] = on ? (int16_t)((gaussian_sequence[grain_random(&reg, 11)] +
                               ((1 << shift) >> 1)) >> shift) : 0;
}

/* the scaling function of one plane's points, at 256 8-bit indices */
static void grain_lut(const int (*pts)[2], int n, int lut[256])
{
    memset(lut, 0, 256 * sizeof(int));
    if (!n)
        return;
    for (int i = 0; i < pts[0][0]; i++)
        lut[i] = pts[0][1];
    for (int k = 0; k < n - 1; k++) {
        int dy = pts[k + 1][1] - pts[k][1], dx = pts[k + 1][0] - pts[k][0];
        int64_t delta = (int64_t)dy * ((65536 + (dx >> 1)) / dx);
        for (int x = 0; x < dx; x++)
            lut[pts[k][0] + x] = pts[k][1] + (int)((x * delta + 32768) >> 16);
    }
    for (int i = pts[n - 1][0]; i < 256; i++)
        lut[i] = pts[n - 1][1];
}

static int grain_scale(const int lut[256], int index, int bd)
{
    int shift = bd - 8, x = index >> shift;
    if (!shift || x == 255)
        return lut[x];
    return lut[x] + (((lut[x + 1] - lut[x]) * (index & ((1 << shift) - 1)) +
                      (1 << (shift - 1))) >> shift);
}

/* Round2(a * w0 + b * w1, 5), clipped to the grain's range */
static int16_t grain_blend(int a, int b, int w0, int w1, int lo, int hi)
{
    return (int16_t)grain_clip((a * w0 + b * w1 + 16) >> 5, lo, hi);
}

/* adds the grain of f->grain to the frame's planes (W x H) */
static void film_grain(Av1 *f)
{
    const Grain *g = &f->grain;
    int bd = f->bitdepth, W = f->W, H = f->H, np = f->nplanes;
    int ssx = f->ssx, ssy = f->ssy;
    int lo = -(128 << (bd - 8)), hi = (128 << (bd - 8)) - 1;
    int shift = 12 - bd + g->grain_scale_shift;
    int cw = ssx ? 44 : 82, ch = ssy ? 38 : 73, lag = g->lag;
    int on[3] = {g->ny > 0, g->ncb > 0 || g->from_luma,
                 g->ncr > 0 || g->from_luma};
    int16_t *tmpl[3];
    for (int p = 0; p < 3; p++)
        f->grain_buf[p] = tmpl[p] = av1_alloc(
            f, (size_t)(p ? ch * cw : 73 * 82) * sizeof(int16_t));
    /* the templates and their auto-regressive filter */
    grain_fill(tmpl[0], 73, 82, on[0], (uint16_t)g->seed, shift);
    int round = 1 << (g->ar_shift - 1);
    for (int y = 3; y < 73; y++)
        for (int x = 3; x < 82 - 3; x++) {
            int sum = 0, pos = 0;
            for (int dr = -lag; dr <= 0; dr++)
                for (int dc = -lag; dc <= lag && (dr || dc); dc++)
                    sum += g->ar_y[pos++] * tmpl[0][(y + dr) * 82 + x + dc];
            int16_t *t = &tmpl[0][y * 82 + x];
            *t = (int16_t)grain_clip(*t + ((sum + round) >> g->ar_shift), lo,
                                     hi);
        }
    if (np > 1) {
        grain_fill(tmpl[1], ch, cw, on[1], grain_seed_of(g->seed, 7), shift);
        grain_fill(tmpl[2], ch, cw, on[2], grain_seed_of(g->seed, 11),
                   shift);
        for (int y = 3; y < ch; y++)
            for (int x = 3; x < cw - 3; x++) {
                int s0 = 0, s1 = 0, pos = 0;
                for (int dr = -lag; dr <= 0; dr++)
                    for (int dc = -lag; dc <= lag; dc++) {
                        if (!dr && !dc) {
                            if (g->ny) {
                                int luma = 0;
                                int ly = ((y - 3) << ssy) + 3;
                                int lx = ((x - 3) << ssx) + 3;
                                for (int i = 0; i <= ssy; i++)
                                    for (int j = 0; j <= ssx; j++)
                                        luma += tmpl[0][(ly + i) * 82 + lx +
                                                        j];
                                luma = (luma + ((1 << (ssx + ssy)) >> 1)) >>
                                       (ssx + ssy);
                                s0 += luma * g->ar_cb[pos];
                                s1 += luma * g->ar_cr[pos];
                            }
                            break;
                        }
                        int k = (y + dr) * cw + x + dc;
                        s0 += g->ar_cb[pos] * tmpl[1][k];
                        s1 += g->ar_cr[pos] * tmpl[2][k];
                        pos++;
                    }
                int16_t *t1 = &tmpl[1][y * cw + x], *t2 = &tmpl[2][y * cw + x];
                if (on[1])
                    *t1 = (int16_t)grain_clip(
                        *t1 + ((s0 + round) >> g->ar_shift), lo, hi);
                if (on[2])
                    *t2 = (int16_t)grain_clip(
                        *t2 + ((s1 + round) >> g->ar_shift), lo, hi);
            }
    }
    int lut[3][256];
    grain_lut(g->pts_y, g->ny, lut[0]);
    if (g->from_luma) {
        memcpy(lut[1], lut[0], sizeof(lut[0]));
        memcpy(lut[2], lut[0], sizeof(lut[0]));
    } else {
        grain_lut(g->pts_cb, g->ncb, lut[1]);
        grain_lut(g->pts_cr, g->ncr, lut[2]);
    }
    int min_v = 0, max_y = (256 << (bd - 8)) - 1, max_c = max_y;
    if (g->clip) {
        min_v = 16 << (bd - 8);
        max_y = 235 << (bd - 8);
        max_c = f->mc == 0 ? max_y : 240 << (bd - 8);
    }
    int mult[3] = {0, g->cb_mult - 128, g->cr_mult - 128};
    int lmult[3] = {0, g->cb_luma_mult - 128, g->cr_luma_mult - 128};
    int offs[3] = {0, (g->cb_offset - 256) * (1 << (bd - 8)),
                   (g->cr_offset - 256) * (1 << (bd - 8))};
    /* the noise of two stripes of each plane: 34 rows (17 for 4:2:0
     * chroma) of the plane's width and one block more */
    int pw[3], ph[3], sw[3];
    int16_t *stripe[2][3];
    for (int p = 0; p < np; p++) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        pw[p] = (W + sx) >> sx;
        ph[p] = (H + sy) >> sy;
        sw[p] = pw[p] + 34;
        for (int k = 0; k < 2; k++)
            f->grain_buf[3 + 2 * p + k] = stripe[k][p] = av1_alloc(
                f, (size_t)34 * sw[p] * sizeof(int16_t));
    }
    int nstripes = (((H + 1) / 2) + 15) / 16;
    for (int s = 0; s < nstripes; s++) {
        int16_t **cur = stripe[s & 1], **prev = stripe[(s & 1) ^ 1];
        uint16_t reg = grain_seed_of(g->seed, s);
        for (int x = 0; x < (W + 1) / 2; x += 16) {
            int r = grain_random(&reg, 8), ox = r >> 4, oy = r & 15;
            for (int p = 0; p < np; p++) {
                int sx = p ? ssx : 0, sy = p ? ssy : 0;
                int px = sx ? 6 + ox : 9 + ox * 2;
                int py = sy ? 6 + oy : 9 + oy * 2;
                int tw = p ? cw : 82;
                for (int i = 0; i < (34 >> sy); i++)
                    for (int j = 0; j < (34 >> sx); j++) {
                        int v = tmpl[p][(py + i) * tw + px + j];
                        int col = sx ? x + j : x * 2 + j;
                        int16_t *o = &cur[p][i * sw[p] + col];
                        if (g->overlap && x > 0 && !sx && j < 2)
                            v = j ? grain_blend(*o, v, 17, 27, lo, hi)
                                  : grain_blend(*o, v, 27, 17, lo, hi);
                        else if (g->overlap && x > 0 && sx && j == 0)
                            v = grain_blend(*o, v, 23, 22, lo, hi);
                        *o = (int16_t)v;
                    }
            }
        }
        /* the stripe's rows of each plane: chroma first (luma before its
         * noise), the top rows blended with the stripe above */
        for (int p = np - 1; p >= 0; p--) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            if (!(p ? on[p] : g->ny > 0))
                continue;
            for (int i = 0; i < (32 >> sy); i++) {
                int y = (s << (5 - sy)) + i;
                if (y >= ph[p])
                    break;
                uint16_t *row = f->plane[p] + (size_t)y * f->stride;
                const uint16_t *luma = f->plane[0] + (size_t)(y << sy) *
                                       f->stride;
                for (int x = 0; x < pw[p]; x++) {
                    int n = cur[p][i * sw[p] + x];
                    if (g->overlap && s > 0 && i < (sy ? 1 : 2)) {
                        int old = prev[p][(i + (32 >> sy)) * sw[p] + x];
                        n = sy ? grain_blend(old, n, 23, 22, lo, hi)
                          : i ? grain_blend(old, n, 17, 27, lo, hi)
                              : grain_blend(old, n, 27, 17, lo, hi);
                    }
                    int orig = row[x], idx = orig, top = max_y;
                    if (p) {
                        int lx = x << sx, avg = luma[lx];
                        if (sx)
                            avg = (avg + luma[lx + 1 < W ? lx + 1 : W - 1] +
                                   1) >> 1;
                        idx = g->from_luma ? avg : grain_clip(
                            ((avg * lmult[p] + orig * mult[p]) >> 6) +
                            offs[p], 0, (256 << (bd - 8)) - 1);
                        top = max_c;
                    }
                    int noise = (grain_scale(lut[p], idx, bd) * n +
                                 (1 << (g->scaling_shift - 1))) >>
                                g->scaling_shift;
                    row[x] = (uint16_t)grain_clip(orig + noise, min_v, top);
                }
            }
        }
    }
    for (int k = 0; k < 9; k++) {
        free(f->grain_buf[k]);
        f->grain_buf[k] = NULL;
    }
}

#endif
