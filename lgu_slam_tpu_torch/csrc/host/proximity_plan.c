/* Host-side graph planning for the factor graph: the distance-ranked
 * proximity edge selection with Manhattan non-maximum suppression
 * (FactorGraph.add_proximity_factors) and the DBA row grouping by depth
 * frame, with the contract of the JAX package's C++ extension
 * (native/lgu_native.cpp): the same edges in the same order, ties ranked
 * by candidate index (a stable sort), the same max_factors cap.
 *
 * Built by the host C compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/utils/native.py, which holds the plain Python
 * versions the tests hold these against).
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

typedef struct {
    float d;
    int64_t k;
} cand_t;

/* ascending distance, NaN last (numpy's order), then candidate index */
static int by_distance(const void *a, const void *b)
{
    const cand_t *x = a, *y = b;
    int xn = isnan(x->d), yn = isnan(y->d);
    if (xn != yn)
        return xn - yn;
    if (!xn && x->d != y->d)
        return x->d < y->d ? -1 : 1;
    return (x->k > y->k) - (x->k < y->k);
}

typedef struct {
    float *d;
    int64_t t0, t1, t, nms;
} grid_t;

static void suppress(const grid_t *g, int64_t i, int64_t j)
{
    int64_t a = llabs(i - j) - 2;
    int64_t lim = a < g->nms ? a : g->nms;
    if (lim < 0)
        lim = 0;
    for (int64_t di = -g->nms; di <= g->nms; di++)
        for (int64_t dj = -g->nms; dj <= g->nms; dj++) {
            if (llabs(di) + llabs(dj) > lim)
                continue;
            int64_t i1 = i + di, j1 = j + dj;
            if (g->t0 <= i1 && i1 < g->t && g->t1 <= j1 && j1 < g->t)
                g->d[(i1 - g->t0) * (g->t - g->t1) + (j1 - g->t1)] = INFINITY;
        }
}

static int push(int32_t *out, int64_t *m, int64_t cap, int64_t i, int64_t j)
{
    if (*m >= cap)
        return 0;
    out[2 * *m] = (int32_t)i;
    out[2 * *m + 1] = (int32_t)j;
    (*m)++;
    return 1;
}

/* d, ii, jj: the n candidates of the grid [t0, t) x [t1, t) in row-major
 * order; eii, ejj: the ne edges to suppress around (active, bad, inactive).
 * Writes (i, j) pairs to out (room for cap pairs) and returns their count;
 * -1 out of memory, -2 out too small. */
int64_t proximity_plan(const float *d_in, const int32_t *ii,
                       const int32_t *jj, int64_t n, const int32_t *eii,
                       const int32_t *ejj, int64_t ne, int64_t t0, int64_t t1,
                       int64_t t, int64_t rad, int64_t nms, double thresh,
                       int64_t max_factors, int stereo, int32_t *out,
                       int64_t cap)
{
    float *d = malloc(sizeof(float) * (size_t)(n > 0 ? n : 1));
    if (d == NULL)
        return -1;
    grid_t g = {d, t0, t1, t, nms};
    for (int64_t k = 0; k < n; k++) {
        d[k] = d_in[k];
        if (ii[k] - rad < jj[k] || d[k] > 100.0f)
            d[k] = INFINITY;
    }
    for (int64_t k = 0; k < ne; k++)
        suppress(&g, eii[k], ejj[k]);

    int64_t m = 0;
    for (int64_t i = t0; i < t; i++) {
        if (stereo) {
            if (!push(out, &m, cap, i, i))
                goto small;
            if (t1 <= i)
                d[(i - t0) * (t - t1) + (i - t1)] = INFINITY;
        }
        for (int64_t j = i - rad - 1 > 0 ? i - rad - 1 : 0; j < i; j++) {
            if (!push(out, &m, cap, i, j) || !push(out, &m, cap, j, i))
                goto small;
            if (t1 <= j && j < t)
                d[(i - t0) * (t - t1) + (j - t1)] = INFINITY;
        }
    }

    /* only candidates under the threshold now can be taken later:
     * suppression only raises distances */
    int64_t nc = 0;
    for (int64_t k = 0; k < n; k++)
        nc += !(d[k] > thresh);
    cand_t *c = malloc(sizeof(cand_t) * (size_t)(nc > 0 ? nc : 1));
    if (c == NULL) {
        free(d);
        return -1;
    }
    nc = 0;
    for (int64_t k = 0; k < n; k++)
        if (!(d[k] > thresh))
            c[nc++] = (cand_t){d_in[k], k};
    qsort(c, (size_t)nc, sizeof(cand_t), by_distance);
    for (int64_t r = 0; r < nc; r++) {
        int64_t k = c[r].k;
        if (d[k] > thresh)
            continue;
        if (m > max_factors)
            break;
        if (!push(out, &m, cap, ii[k], jj[k]) ||
            !push(out, &m, cap, jj[k], ii[k])) {
            free(c);
            goto small;
        }
        suppress(&g, ii[k], jj[k]);
    }
    free(c);
    free(d);
    return m;
small:
    free(d);
    return -2;
}

/* rows_of_frame [num_frames, dmax] (dmax >= 1): frame k's own row k first,
 * then the rows num_frames + e of the edges e with ii[e] == k, -1 padding;
 * edges outside [0, num_frames) are skipped.  Returns 0, 1 + the first
 * frame whose degree exceeds dmax, or -1 out of memory. */
int64_t dba_group_rows(const int32_t *ii, int64_t E, int64_t num_frames,
                       int64_t dmax, int32_t *rows)
{
    for (int64_t k = 0; k < num_frames * dmax; k++)
        rows[k] = -1;
    for (int64_t k = 0; k < num_frames; k++)
        rows[k * dmax] = (int32_t)k;
    int64_t *fill = calloc((size_t)(num_frames > 0 ? num_frames : 1),
                           sizeof(int64_t));
    if (fill == NULL)
        return -1;
    for (int64_t k = 0; k < num_frames; k++)
        fill[k] = 1;
    int64_t status = 0;
    for (int64_t e = 0; e < E; e++) {
        int64_t k = ii[e];
        if (k < 0 || k >= num_frames)
            continue;
        if (fill[k] >= dmax) {
            status = 1 + k;
            break;
        }
        rows[k * dmax + fill[k]++] = (int32_t)(num_frames + e);
    }
    free(fill);
    return status;
}
