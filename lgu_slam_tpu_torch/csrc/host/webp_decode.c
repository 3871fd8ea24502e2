/* WebP bitstream decoding for the port's data layer: VP8L (lossless), VP8
 * (lossy, RFC 6386) and the ALPH alpha plane, as libwebp 1.6 (src/dec/,
 * src/dsp/, src/utils/) decodes them for cv2.imread.  The RIFF container,
 * VP8X, ANIM / ANMF and the choice of what to decode are in
 * lgu_slam_tpu_torch/data/webp.py.
 *
 * - webp_vp8l_decode: a VP8L bitstream (its 5-byte header first) -> ARGB
 *   words; its prefix codes (simple and normal, two-level lookup tables),
 *   meta prefix codes, the colour cache, LZ77 backward references with the
 *   120-entry distance map, and the predictor (14 modes), cross-colour,
 *   subtract-green and colour-indexing (pixel bundling) transforms.  A
 *   stream that reads past its end fails, as libwebp's non-incremental
 *   decoder fails on it.
 * - webp_alpha_decode: an ALPH chunk's payload -> the alpha plane: raw or
 *   a headerless VP8L stream of its green channel, then the horizontal,
 *   vertical or gradient unfilter.  libwebp's 8-bit path (one colour
 *   indexing transform, no colour cache, single-symbol red / blue / alpha
 *   codes) accepts a stream whose last symbol reads past the end.
 * - webp_vp8_decode: a VP8 key frame -> BGR: the boolean decoder, the
 *   frame header, coefficient probability updates and tokens, 16x16, 4x4
 *   and chroma intra prediction with libwebp's edge samples (127 above,
 *   129 left), dequantisation, the inverse WHT and DCT, the simple and
 *   normal loop filters with sharpness, then YUV 4:2:0 to BGR with
 *   libwebp's fancy upsampling and 14-bit fixed-point VP8YUVToR/G/B.  A
 *   partition that ends before its macroblocks do fails, as in libwebp.
 *
 * Every read of the input is bounds-checked.  Built by the host C compiler
 * at first use and called through ctypes (data/webp.py).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define WEBP_OK 0
#define WEBP_CORRUPT 1
#define WEBP_NOMEM 3

/* ------------------------------------------------------------------ */
/* VP8L bit reader (utils/bit_reader_utils.c): 64-bit window, LSB first */

typedef struct {
    uint64_t val;
    const uint8_t *buf;
    size_t len, pos;
    int bit_pos, eos;
} lbits;

static const uint32_t kBitMask[25] = {
    0, 0x1, 0x3, 0x7, 0xf, 0x1f, 0x3f, 0x7f, 0xff, 0x1ff, 0x3ff, 0x7ff,
    0xfff, 0x1fff, 0x3fff, 0x7fff, 0xffff, 0x1ffff, 0x3ffff, 0x7ffff,
    0xfffff, 0x1fffff, 0x3fffff, 0x7fffff, 0xffffff};

static void lb_init(lbits *br, const uint8_t *start, size_t length)
{
    size_t i, load = length < 8 ? length : 8;
    br->val = 0;
    for (i = 0; i < load; ++i)
        br->val |= (uint64_t)start[i] << (8 * i);
    br->buf = start;
    br->len = length;
    br->pos = load;
    br->bit_pos = 0;
    br->eos = 0;
}

static int lb_is_eos(const lbits *br)
{
    return br->eos || (br->pos == br->len && br->bit_pos > 64);
}

static void lb_set_eos(lbits *br)
{
    br->eos = 1;
    br->bit_pos = 0;
}

static void lb_shift(lbits *br)
{
    while (br->bit_pos >= 8 && br->pos < br->len) {
        br->val >>= 8;
        br->val |= (uint64_t)br->buf[br->pos] << 56;
        ++br->pos;
        br->bit_pos -= 8;
    }
    if (lb_is_eos(br))
        lb_set_eos(br);
}

static uint32_t lb_peek(const lbits *br)
{
    return (uint32_t)(br->val >> (br->bit_pos & 63));
}

static uint32_t lb_read(lbits *br, int n)
{
    if (!br->eos && n <= 24) {
        uint32_t v = lb_peek(br) & kBitMask[n];
        br->bit_pos += n;
        lb_shift(br);
        return v;
    }
    lb_set_eos(br);
    return 0;
}

static void lb_fill(lbits *br)
{
    if (br->bit_pos >= 32)
        lb_shift(br);
}

/* ------------------------------------------------------------------ */
/* prefix codes (utils/huffman_utils.c) */

#define ROOT_BITS 8
#define LENGTHS_BITS 7
#define MAX_CODE_LEN 15
#define NUM_LITERAL 256
#define NUM_LENGTH 24
#define NUM_DISTANCE 40
#define NUM_CODE_LENGTH_CODES 19

typedef struct {
    uint8_t bits;
    uint16_t value;
} hcode;

static uint32_t next_key(uint32_t key, int len)
{
    uint32_t step = 1u << (len - 1);
    while (key & step)
        step >>= 1;
    return step ? (key & (step - 1)) + step : key;
}

static void replicate(hcode *table, int step, int end, hcode code)
{
    do {
        end -= step;
        table[end] = code;
    } while (end > 0);
}

static int next_table_bits(const int *count, int len, int root_bits)
{
    int left = 1 << (len - root_bits);
    while (len < MAX_CODE_LEN) {
        left -= count[len];
        if (left <= 0)
            break;
        ++len;
        left <<= 1;
    }
    return len - root_bits;
}

/* BuildHuffmanTable: the table's size, or 0 for lengths that make no
 * code (all zero, over-subscribed, or incomplete with two or more
 * symbols).  With `root` NULL it only sizes. */
static int build_table(hcode *root, int root_bits, const int *lengths,
                       int n, uint16_t *sorted)
{
    hcode *table = root;
    int total = 1 << root_bits, len, sym, count[MAX_CODE_LEN + 1] = {0},
        offset[MAX_CODE_LEN + 1];
    for (sym = 0; sym < n; ++sym) {
        if (lengths[sym] > MAX_CODE_LEN)
            return 0;
        ++count[lengths[sym]];
    }
    if (count[0] == n)
        return 0;
    offset[1] = 0;
    for (len = 1; len < MAX_CODE_LEN; ++len) {
        if (count[len] > (1 << len))
            return 0;
        offset[len + 1] = offset[len] + count[len];
    }
    for (sym = 0; sym < n; ++sym)
        if (lengths[sym] > 0)
            sorted[offset[lengths[sym]]++] = (uint16_t)sym;
    if (offset[MAX_CODE_LEN] == 1) { /* one symbol: a code of 0 bits */
        if (root) {
            hcode code = {0, sorted[0]};
            replicate(table, 1, total, code);
        }
        return total;
    }
    {
        int step, num_nodes = 1, num_open = 1, table_bits = root_bits,
                  table_size = 1 << root_bits;
        uint32_t low = 0xffffffffu, mask = (uint32_t)total - 1, key = 0;
        sym = 0;
        for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
            num_open <<= 1;
            num_nodes += num_open;
            num_open -= count[len];
            if (num_open < 0)
                return 0;
            for (; count[len] > 0; --count[len]) {
                if (root) {
                    hcode code = {(uint8_t)len, sorted[sym]};
                    replicate(&table[key], step, table_size, code);
                }
                ++sym;
                key = next_key(key, len);
            }
        }
        for (len = root_bits + 1, step = 2; len <= MAX_CODE_LEN;
             ++len, step <<= 1) {
            num_open <<= 1;
            num_nodes += num_open;
            num_open -= count[len];
            if (num_open < 0)
                return 0;
            for (; count[len] > 0; --count[len]) {
                if ((key & mask) != low) {
                    if (root)
                        table += table_size;
                    table_bits = next_table_bits(count, len, root_bits);
                    table_size = 1 << table_bits;
                    total += table_size;
                    low = key & mask;
                    if (root) {
                        root[low].bits = (uint8_t)(table_bits + root_bits);
                        root[low].value = (uint16_t)((table - root) - low);
                    }
                }
                if (root) {
                    hcode code = {(uint8_t)(len - root_bits), sorted[sym]};
                    replicate(&table[key >> root_bits], step, table_size,
                              code);
                }
                ++sym;
                key = next_key(key, len);
            }
        }
        if (num_nodes != 2 * offset[MAX_CODE_LEN] - 1)
            return 0;
    }
    return total;
}

/* a built table on the heap (NULL with *status set on failure) */
static hcode *make_table(int root_bits, const int *lengths, int n,
                         int *status)
{
    uint16_t *sorted = malloc(sizeof(uint16_t) * (size_t)n);
    hcode *table = NULL;
    int size;
    if (!sorted) {
        *status = WEBP_NOMEM;
        return NULL;
    }
    size = build_table(NULL, root_bits, lengths, n, sorted);
    if (size == 0) {
        *status = WEBP_CORRUPT;
    } else if (!(table = calloc((size_t)size, sizeof(hcode)))) {
        *status = WEBP_NOMEM;
    } else {
        build_table(table, root_bits, lengths, n, sorted);
    }
    free(sorted);
    return table;
}

static int read_symbol(const hcode *table, lbits *br)
{
    uint32_t val = lb_peek(br);
    int nbits;
    table += val & ((1u << ROOT_BITS) - 1);
    nbits = table->bits - ROOT_BITS;
    if (nbits > 0) {
        br->bit_pos += ROOT_BITS;
        val = lb_peek(br);
        table += table->value;
        table += val & ((1u << nbits) - 1);
    }
    br->bit_pos += table->bits;
    return table->value;
}

/* ------------------------------------------------------------------ */
/* VP8L decoder (dec/vp8l_dec.c) */

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2,
       COLOR_INDEXING = 3 };

static const int kAlphabetSize[5] = {NUM_LITERAL + NUM_LENGTH, NUM_LITERAL,
                                     NUM_LITERAL, NUM_LITERAL, NUM_DISTANCE};
static const uint8_t kCodeLengthCodeOrder[NUM_CODE_LENGTH_CODES] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
/* the 120 (dx, dy) of short distances, as dy * 16 + 8 - dx */
static const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
    0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
    0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
    0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
    0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
    0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
    0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

typedef struct {
    hcode *trees[5];
} hgroup;

typedef struct {
    int cache_bits;
    uint32_t *cache;
    int huff_bits, huff_xsize;
    uint32_t *huff_image; /* group per tile */
    hgroup *groups;
    int n_groups;
} meta;

typedef struct {
    int type, bits, xsize;
    uint32_t *data;
} transform;

typedef struct {
    lbits br;
    transform tr[4];
    int n_tr;
    unsigned seen;
    int status;
} vp8l;

static void free_meta(meta *m)
{
    int i, j;
    for (i = 0; i < m->n_groups; ++i)
        for (j = 0; j < 5; ++j)
            free(m->groups[i].trees[j]);
    free(m->groups);
    free(m->huff_image);
    free(m->cache);
    memset(m, 0, sizeof(*m));
}

static int subsample(int size, int bits)
{
    return (size + (1 << bits) - 1) >> bits;
}

static int fail(vp8l *d, int status)
{
    if (d->status == WEBP_OK)
        d->status = status;
    return 0;
}

/* ReadHuffmanCodeLengths */
static int read_code_lengths(vp8l *d, const int *cl_lengths, int n,
                             int *lengths)
{
    lbits *br = &d->br;
    int status = WEBP_OK, symbol = 0, max_symbol, prev = 8, ok = 0;
    hcode *table = make_table(LENGTHS_BITS, cl_lengths,
                              NUM_CODE_LENGTH_CODES, &status);
    if (!table)
        return fail(d, status);
    if (lb_read(br, 1)) {
        int nbits = 2 + 2 * (int)lb_read(br, 3);
        max_symbol = 2 + (int)lb_read(br, nbits);
        if (max_symbol > n)
            goto end;
    } else {
        max_symbol = n;
    }
    while (symbol < n) {
        const hcode *p;
        int code_len;
        if (max_symbol-- == 0)
            break;
        lb_fill(br);
        p = &table[lb_peek(br) & ((1u << LENGTHS_BITS) - 1)];
        br->bit_pos += p->bits;
        code_len = p->value;
        if (code_len < 16) {
            lengths[symbol++] = code_len;
            if (code_len != 0)
                prev = code_len;
        } else {
            static const int extra[3] = {2, 3, 7}, off[3] = {3, 3, 11};
            int slot = code_len - 16, repeat, value;
            repeat = (int)lb_read(br, extra[slot]) + off[slot];
            if (symbol + repeat > n)
                goto end;
            value = code_len == 16 ? prev : 0;
            while (repeat-- > 0)
                lengths[symbol++] = value;
        }
    }
    ok = 1;
end:
    free(table);
    return ok ? 1 : fail(d, WEBP_CORRUPT);
}

/* ReadHuffmanCode: the table of one code of `n` symbols, or NULL */
static hcode *read_code(vp8l *d, int n, int *lengths)
{
    lbits *br = &d->br;
    int status = WEBP_OK, ok;
    hcode *table;
    memset(lengths, 0, sizeof(int) * (size_t)n);
    if (lb_read(br, 1)) { /* simple code: one or two symbols */
        int num = (int)lb_read(br, 1) + 1;
        int first_bits = lb_read(br, 1) ? 8 : 1;
        int symbol = (int)lb_read(br, first_bits);
        if (symbol < n)
            lengths[symbol] = 1;
        if (num == 2) {
            symbol = (int)lb_read(br, 8);
            if (symbol < n)
                lengths[symbol] = 1;
        }
        ok = 1;
    } else {
        int i, cl[NUM_CODE_LENGTH_CODES] = {0};
        int num_codes = (int)lb_read(br, 4) + 4;
        for (i = 0; i < num_codes; ++i)
            cl[kCodeLengthCodeOrder[i]] = (int)lb_read(br, 3);
        ok = read_code_lengths(d, cl, n, lengths);
    }
    if (!(ok && !br->eos)) {
        fail(d, WEBP_CORRUPT);
        return NULL;
    }
    table = make_table(ROOT_BITS, lengths, n, &status);
    if (!table)
        fail(d, status);
    return table;
}

static int decode_stream(vp8l *d, int xsize, int ysize, int level0,
                         meta *m, uint32_t **out);

/* ReadHuffmanCodes (+ ReadHuffmanCodesHelper): the meta image and every
 * group's five codes */
static int read_codes(vp8l *d, int xsize, int ysize, int cache_bits,
                      int allow_recursion, meta *m)
{
    lbits *br = &d->br;
    int i, j, n_max = 1, n_groups = 1, *mapping = NULL, *lengths = NULL,
              ok = 0;
    m->huff_bits = 0;
    if (allow_recursion && lb_read(br, 1)) {
        int bits = 2 + (int)lb_read(br, 3);
        int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
        int64_t k, npix = (int64_t)hx * hy;
        meta sub = {0};
        if (!decode_stream(d, hx, hy, 0, &sub, &m->huff_image))
            return 0;
        m->huff_bits = bits;
        m->huff_xsize = hx;
        for (k = 0; k < npix; ++k) {
            int group = (m->huff_image[k] >> 8) & 0xffff;
            m->huff_image[k] = (uint32_t)group;
            if (group >= n_max)
                n_max = group + 1;
        }
        if (n_max > 1000 || n_max > xsize * ysize) {
            /* only the groups the meta image uses are kept, renumbered */
            mapping = malloc(sizeof(int) * (size_t)n_max);
            if (!mapping)
                return fail(d, WEBP_NOMEM);
            memset(mapping, 0xff, sizeof(int) * (size_t)n_max);
            n_groups = 0;
            for (k = 0; k < npix; ++k) {
                int *mapped = &mapping[m->huff_image[k]];
                if (*mapped == -1)
                    *mapped = n_groups++;
                m->huff_image[k] = (uint32_t)*mapped;
            }
        } else {
            n_groups = n_max;
        }
    }
    if (br->eos) {
        fail(d, WEBP_CORRUPT);
        goto end;
    }
    lengths = calloc((size_t)(kAlphabetSize[0] + (cache_bits > 0 ?
                                                  1 << cache_bits : 0)),
                     sizeof(int));
    m->groups = calloc((size_t)n_groups, sizeof(hgroup));
    if (!lengths || !m->groups) {
        fail(d, WEBP_NOMEM);
        goto end;
    }
    m->n_groups = n_groups;
    for (i = 0; i < n_max; ++i) {
        hgroup scratch = {{0}}, *g = (mapping && mapping[i] == -1) ?
            &scratch : &m->groups[mapping ? mapping[i] : i];
        for (j = 0; j < 5; ++j) {
            int size = kAlphabetSize[j];
            if (j == 0 && cache_bits > 0)
                size += 1 << cache_bits;
            g->trees[j] = read_code(d, size, lengths);
            if (!g->trees[j])
                break;
        }
        if (g == &scratch)
            for (j = 0; j < 5; ++j)
                free(scratch.trees[j]);
        if (j < 5)
            goto end;
    }
    ok = 1;
end:
    free(mapping);
    free(lengths);
    return ok;
}

static uint32_t cache_key(uint32_t argb, int bits)
{
    return (0x1e35a7bdu * argb) >> (32 - bits);
}

static int copy_distance(int symbol, lbits *br)
{
    int extra, offset;
    if (symbol < 4)
        return symbol + 1;
    extra = (symbol - 2) >> 1;
    offset = (2 + (symbol & 1)) << extra;
    return offset + (int)lb_read(br, extra) + 1;
}

static int plane_distance(int xsize, int code)
{
    if (code > 120)
        return code - 120;
    {
        int dist_code = kCodeToPlane[code - 1];
        int dist = (dist_code >> 4) * xsize + (8 - (dist_code & 0xf));
        return dist >= 1 ? dist : 1;
    }
}

static const hgroup *group_at(const meta *m, int x, int y)
{
    if (m->huff_bits == 0)
        return &m->groups[0];
    return &m->groups[m->huff_image[(int64_t)m->huff_xsize *
                                    (y >> m->huff_bits) +
                                    (x >> m->huff_bits)]];
}

/* DecodeImageData: every pixel of an xsize x ysize image; a read past the
 * end of the data fails */
static int decode_pixels(vp8l *d, const meta *m, uint32_t *data, int width,
                         int height)
{
    lbits *br = &d->br;
    int64_t pos = 0, end = (int64_t)width * height, cached = 0;
    int col = 0, row = 0;
    while (pos < end) {
        const hgroup *g = group_at(m, col, row);
        int code;
        lb_fill(br);
        code = read_symbol(g->trees[GREEN], br);
        if (lb_is_eos(br))
            break;
        if (code < NUM_LITERAL) {
            int red = read_symbol(g->trees[RED], br), blue, alpha;
            lb_fill(br);
            blue = read_symbol(g->trees[BLUE], br);
            alpha = read_symbol(g->trees[ALPHA], br);
            if (lb_is_eos(br))
                break;
            data[pos] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) |
                        ((uint32_t)code << 8) | (uint32_t)blue;
            ++pos;
            if (++col >= width) {
                col = 0;
                ++row;
            }
        } else if (code < NUM_LITERAL + NUM_LENGTH) {
            int length = copy_distance(code - NUM_LITERAL, br), dist;
            int dist_symbol = read_symbol(g->trees[DIST], br);
            int64_t k;
            lb_fill(br);
            dist = plane_distance(width, copy_distance(dist_symbol, br));
            if (lb_is_eos(br))
                break;
            if (pos < dist || end - pos < length)
                return fail(d, WEBP_CORRUPT);
            for (k = 0; k < length; ++k)
                data[pos + k] = data[pos + k - dist];
            pos += length;
            col += length;
            while (col >= width) {
                col -= width;
                ++row;
            }
        } else if (m->cache && code < NUM_LITERAL + NUM_LENGTH +
                                          (1 << m->cache_bits)) {
            for (; cached < pos; ++cached)
                m->cache[cache_key(data[cached], m->cache_bits)] =
                    data[cached];
            data[pos] = m->cache[code - NUM_LITERAL - NUM_LENGTH];
            ++pos;
            if (++col >= width) {
                col = 0;
                ++row;
            }
        } else {
            return fail(d, WEBP_CORRUPT);
        }
        if (m->cache)
            for (; cached < pos; ++cached)
                m->cache[cache_key(data[cached], m->cache_bits)] =
                    data[cached];
    }
    if (lb_is_eos(br))
        return fail(d, WEBP_CORRUPT);
    return 1;
}

/* ReadTransform */
static int read_transform(vp8l *d, int *xsize, int ysize)
{
    lbits *br = &d->br;
    int type = (int)lb_read(br, 2);
    transform *t;
    if (d->seen & (1u << type))
        return fail(d, WEBP_CORRUPT);
    d->seen |= 1u << type;
    t = &d->tr[d->n_tr++];
    t->type = type;
    t->xsize = *xsize;
    t->data = NULL;
    if (type == PREDICTOR || type == CROSS_COLOR) {
        meta sub = {0};
        t->bits = 2 + (int)lb_read(br, 3);
        return decode_stream(d, subsample(t->xsize, t->bits),
                             subsample(ysize, t->bits), 0, &sub, &t->data);
    }
    if (type == COLOR_INDEXING) {
        meta sub = {0};
        int num = (int)lb_read(br, 8) + 1, i, final;
        uint32_t *map;
        uint8_t *in, *out;
        t->bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
        *xsize = subsample(t->xsize, t->bits);
        if (!decode_stream(d, num, 1, 0, &sub, &t->data))
            return 0;
        final = 1 << (8 >> t->bits); /* ExpandColorMap: deltas summed */
        map = calloc((size_t)final, sizeof(uint32_t));
        if (!map)
            return fail(d, WEBP_NOMEM);
        in = (uint8_t *)t->data;
        out = (uint8_t *)map;
        map[0] = t->data[0];
        for (i = 4; i < 4 * num; ++i)
            out[i] = (uint8_t)(in[i] + out[i - 4]);
        free(t->data);
        t->data = map;
    }
    return 1;
}

/* DecodeImageStream: the transforms (level 0), the colour cache and the
 * codes; then, below level 0, the pixels into *out */
static int decode_stream(vp8l *d, int xsize, int ysize, int level0,
                         meta *m, uint32_t **out)
{
    lbits *br = &d->br;
    int txsize = xsize, ok = 1, cache_bits = 0;
    if (level0)
        while (ok && lb_read(br, 1))
            ok = read_transform(d, &txsize, ysize);
    if (ok && lb_read(br, 1)) {
        cache_bits = (int)lb_read(br, 4);
        if (cache_bits < 1 || cache_bits > 11)
            ok = fail(d, WEBP_CORRUPT);
    }
    ok = ok && read_codes(d, txsize, ysize, cache_bits, level0, m);
    if (ok && cache_bits > 0) {
        m->cache_bits = cache_bits;
        m->cache = calloc((size_t)1 << cache_bits, sizeof(uint32_t));
        if (!m->cache)
            ok = fail(d, WEBP_NOMEM);
    }
    if (!ok || level0) {
        if (!ok) {
            fail(d, WEBP_CORRUPT);
            free_meta(m);
        }
        return ok;
    }
    *out = malloc(sizeof(uint32_t) * (size_t)txsize * (size_t)ysize);
    if (!*out) {
        free_meta(m);
        return fail(d, WEBP_NOMEM);
    }
    ok = decode_pixels(d, m, *out, txsize, ysize) && !br->eos;
    free_meta(m);
    if (!ok) {
        free(*out);
        *out = NULL;
        return fail(d, WEBP_CORRUPT);
    }
    return 1;
}

static uint32_t add_pixels(uint32_t a, uint32_t b)
{
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

static uint32_t average2(uint32_t a, uint32_t b)
{
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static int clip255(uint32_t a)
{
    return a < 256 ? (int)a : (int)(~a >> 24);
}

static int sub3(int a, int b, int c)
{
    int pb = b - c, pa = a - c;
    return abs(pb) - abs(pa);
}

static uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c)
{
    int s = sub3(a >> 24, b >> 24, c >> 24) +
            sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
            sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
            sub3(a & 0xff, b & 0xff, c & 0xff);
    return s <= 0 ? a : b;
}

static uint32_t clamp_full(uint32_t c0, uint32_t c1, uint32_t c2)
{
    uint32_t out = 0;
    int s;
    for (s = 24; s >= 0; s -= 8) {
        int v = clip255((uint32_t)(((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) -
                                   ((c2 >> s) & 0xff)));
        out |= (uint32_t)v << s;
    }
    return out;
}

/* the predictor of mode `mode` for the pixel at out[x] (top = the row
 * above, its element width being the current row's first pixel) */
static uint32_t predict(int mode, const uint32_t *out, const uint32_t *top,
                        int x)
{
    uint32_t L = out[x - 1], T = top[x], TL = top[x - 1], TR = top[x + 1];
    switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_full(L, T, TL);
    case 13: {
        /* ClampedAddSubtractHalf(Average2(L, T), TL) */
        uint32_t ave = average2(L, T), res = 0;
        int s;
        for (s = 24; s >= 0; s -= 8) {
            int a = (ave >> s) & 0xff, b = (TL >> s) & 0xff;
            res |= (uint32_t)clip255((uint32_t)(a + (a - b) / 2)) << s;
        }
        return res;
    }
    default: return 0xff000000u; /* 0, and the unused modes 14 and 15 */
    }
}

static int color_delta(int8_t pred, int8_t color)
{
    return ((int)pred * color) >> 5;
}

/* VP8LInverseTransform of the whole image: in (t->xsize of the transform's
 * input width, i.e. subsampled for colour indexing) -> out */
static void inverse_transform(const transform *t, int height,
                              const uint32_t *in, uint32_t *out)
{
    int width = t->xsize, x, y;
    if (t->type == PREDICTOR) {
        int tiles = subsample(width, t->bits);
        for (y = 0; y < height; ++y) {
            uint32_t *o = out + (int64_t)y * width;
            const uint32_t *src = in + (int64_t)y * width;
            const uint32_t *top = o - width;
            for (x = 0; x < width; ++x) {
                uint32_t pred;
                if (y == 0)
                    pred = x == 0 ? 0xff000000u : o[x - 1];
                else if (x == 0)
                    pred = top[0];
                else
                    pred = predict((int)((t->data[(y >> t->bits) * tiles +
                                                  (x >> t->bits)] >> 8) &
                                         0xf), o, top, x);
                o[x] = add_pixels(src[x], pred);
            }
        }
    } else if (t->type == CROSS_COLOR) {
        int tiles = subsample(width, t->bits);
        for (y = 0; y < height; ++y) {
            for (x = 0; x < width; ++x) {
                int64_t i = (int64_t)y * width + x;
                uint32_t code = t->data[(y >> t->bits) * tiles +
                                        (x >> t->bits)];
                int8_t g2r = (int8_t)(code & 0xff),
                       g2b = (int8_t)((code >> 8) & 0xff),
                       r2b = (int8_t)((code >> 16) & 0xff);
                uint32_t argb = in[i];
                int8_t green = (int8_t)(argb >> 8);
                int new_red = (argb >> 16) & 0xff, new_blue = argb & 0xff;
                new_red += color_delta(g2r, green);
                new_red &= 0xff;
                new_blue += color_delta(g2b, green);
                new_blue += color_delta(r2b, (int8_t)new_red);
                new_blue &= 0xff;
                out[i] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) |
                         (uint32_t)new_blue;
            }
        }
    } else if (t->type == SUBTRACT_GREEN) {
        int64_t i, n = (int64_t)width * height;
        for (i = 0; i < n; ++i) {
            uint32_t argb = in[i], green = (argb >> 8) & 0xff;
            uint32_t rb = (argb & 0x00ff00ffu) + ((green << 16) | green);
            out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
        }
    } else { /* colour indexing, with pixel bundling */
        int bits_per_pixel = 8 >> t->bits, in_w = subsample(width, t->bits);
        uint32_t mask = (1u << bits_per_pixel) - 1;
        int count_mask = (1 << t->bits) - 1;
        for (y = height - 1; y >= 0; --y) { /* in place: back to front */
            const uint32_t *src = in + (int64_t)y * in_w;
            uint32_t *dst = out + (int64_t)y * width, packed = 0;
            for (x = width - 1; x >= 0; --x) {
                packed = (src[x >> t->bits] >> 8) & 0xff;
                dst[x] = t->data[(packed >> (bits_per_pixel *
                                             (x & count_mask))) & mask];
            }
        }
    }
}

/* the level-0 image's pixels (after decode_stream read its header and
 * codes into m, which this frees), then the transforms undone, the last
 * one read first: the ARGB words of width x height in *out */
static int argb_image(vp8l *d, meta *m, int width, int height,
                      uint32_t **out)
{
    int i, txsize = width;
    uint32_t *pix, *buf;
    /* the pixels are coded at the width colour indexing bundles them to */
    for (i = 0; i < d->n_tr; ++i)
        if (d->tr[i].type == COLOR_INDEXING)
            txsize = subsample(d->tr[i].xsize, d->tr[i].bits);
    pix = malloc(sizeof(uint32_t) * (size_t)width * (size_t)height);
    buf = malloc(sizeof(uint32_t) * (size_t)width * (size_t)height);
    if (!pix || !buf) {
        free(pix);
        free(buf);
        free_meta(m);
        return fail(d, WEBP_NOMEM);
    }
    if (!decode_pixels(d, m, pix, txsize, height)) {
        free(pix);
        free(buf);
        free_meta(m);
        return 0;
    }
    free_meta(m);
    for (i = d->n_tr - 1; i >= 0; --i) {
        if (d->tr[i].type == PREDICTOR) { /* reads its own output */
            uint32_t *tmp = pix;
            inverse_transform(&d->tr[i], height, pix, buf);
            pix = buf;
            buf = tmp;
        } else {
            inverse_transform(&d->tr[i], height, pix, pix);
        }
    }
    free(buf);
    *out = pix;
    return 1;
}

static void free_transforms(vp8l *d)
{
    int i;
    for (i = 0; i < d->n_tr; ++i)
        free(d->tr[i].data);
    d->n_tr = 0;
}

/* A VP8L bitstream of `size` bytes (from its signature byte to the end of
 * the data) -> `width` x `height` ARGB words; WEBP_OK or an error. */
int webp_vp8l_decode(const uint8_t *data, int64_t size, int64_t width,
                     int64_t height, uint32_t *argb)
{
    vp8l d;
    meta m = {0};
    uint32_t *pix = NULL;
    int w, h;
    memset(&d, 0, sizeof(d));
    lb_init(&d.br, data, (size_t)size);
    if (lb_read(&d.br, 8) != 0x2f)
        return WEBP_CORRUPT;
    w = (int)lb_read(&d.br, 14) + 1;
    h = (int)lb_read(&d.br, 14) + 1;
    lb_read(&d.br, 1);
    if (lb_read(&d.br, 3) != 0 || d.br.eos || w != width || h != height)
        return WEBP_CORRUPT;
    if (!decode_stream(&d, w, h, 1, &m, NULL) ||
        !argb_image(&d, &m, w, h, &pix)) {
        free_transforms(&d);
        return d.status ? d.status : WEBP_CORRUPT;
    }
    memcpy(argb, pix, sizeof(uint32_t) * (size_t)w * (size_t)h);
    free(pix);
    free_transforms(&d);
    return WEBP_OK;
}

/* DecodeAlphaData: libwebp's 8-bit path, one byte per pixel (the colour
 * indexing transform's indices); a read past the end is allowed in the
 * symbol that completes the image */
static int decode_alpha_8b(vp8l *d, const meta *m, uint8_t *data, int width,
                           int height)
{
    lbits *br = &d->br;
    int64_t pos = 0, end = (int64_t)width * height;
    int col = 0, row = 0;
    while (!br->eos && pos < end) {
        const hgroup *g = group_at(m, col, row);
        int code;
        lb_fill(br);
        code = read_symbol(g->trees[GREEN], br);
        if (code < NUM_LITERAL) {
            data[pos++] = (uint8_t)code;
            if (++col >= width) {
                col = 0;
                ++row;
            }
        } else if (code < NUM_LITERAL + NUM_LENGTH) {
            int length = copy_distance(code - NUM_LITERAL, br), dist;
            int dist_symbol = read_symbol(g->trees[DIST], br);
            int64_t k;
            lb_fill(br);
            dist = plane_distance(width, copy_distance(dist_symbol, br));
            if (!(pos >= dist && end - pos >= length))
                return fail(d, WEBP_CORRUPT);
            for (k = 0; k < length; ++k)
                data[pos + k] = data[pos + k - dist];
            pos += length;
            col += length;
            while (col >= width) {
                col -= width;
                ++row;
            }
        } else {
            return fail(d, WEBP_CORRUPT);
        }
        br->eos = lb_is_eos(br);
    }
    br->eos = lb_is_eos(br);
    if (br->eos && pos < end)
        return fail(d, WEBP_CORRUPT);
    return 1;
}

static void unfilter_row(int filter, const uint8_t *prev, uint8_t *row,
                         int width)
{
    int i;
    if (filter == 0)
        return;
    if (prev == NULL || filter == 1) {
        uint8_t pred = prev == NULL ? 0 : prev[0];
        for (i = 0; i < width; ++i)
            pred = row[i] = (uint8_t)(pred + row[i]);
    } else if (filter == 2) {
        for (i = 0; i < width; ++i)
            row[i] = (uint8_t)(prev[i] + row[i]);
    } else {
        uint8_t top = prev[0], top_left = top, left = top;
        for (i = 0; i < width; ++i) {
            int g;
            top = prev[i];
            g = left + top - top_left;
            g = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
            left = (uint8_t)(row[i] + g);
            top_left = top;
            row[i] = left;
        }
    }
}

/* An ALPH chunk's payload -> the `width` x `height` alpha plane (ALPHInit,
 * ALPHDecode, the unfilters); WEBP_OK or an error. */
int webp_alpha_decode(const uint8_t *data, int64_t size, int64_t width,
                      int64_t height, uint8_t *alpha)
{
    int method, filter, pre, rsrv, y, w = (int)width, h = (int)height;
    int64_t n = width * height;
    if (size <= 1)
        return WEBP_CORRUPT;
    method = data[0] & 3;
    filter = (data[0] >> 2) & 3;
    pre = (data[0] >> 4) & 3;
    rsrv = (data[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0)
        return WEBP_CORRUPT;
    if (method == 0) {
        if (size - 1 < n)
            return WEBP_CORRUPT;
        memcpy(alpha, data + 1, (size_t)n);
    } else {
        vp8l d;
        meta m = {0};
        int ok;
        memset(&d, 0, sizeof(d));
        lb_init(&d.br, data + 1, (size_t)(size - 1));
        if (!decode_stream(&d, w, h, 1, &m, NULL)) {
            free_transforms(&d);
            return d.status ? d.status : WEBP_CORRUPT;
        }
        if (d.n_tr == 1 && d.tr[0].type == COLOR_INDEXING &&
            m.cache == NULL) {
            int i, eight_bit = 1;
            for (i = 0; i < m.n_groups; ++i)
                if (m.groups[i].trees[RED][0].bits > 0 ||
                    m.groups[i].trees[BLUE][0].bits > 0 ||
                    m.groups[i].trees[ALPHA][0].bits > 0)
                    eight_bit = 0;
            if (eight_bit) {
                const transform *t = &d.tr[0];
                int tx = subsample(w, t->bits), x;
                uint8_t *idx = malloc((size_t)tx * (size_t)h);
                if (!idx) {
                    free_meta(&m);
                    free_transforms(&d);
                    return WEBP_NOMEM;
                }
                ok = decode_alpha_8b(&d, &m, idx, tx, h);
                free_meta(&m);
                if (ok) {
                    int bpp = 8 >> t->bits, cm = (1 << t->bits) - 1;
                    for (y = 0; y < h; ++y)
                        for (x = 0; x < w; ++x) {
                            int packed = idx[(int64_t)y * tx +
                                             (x >> t->bits)];
                            int k = (packed >> (bpp * (x & cm))) &
                                    ((1 << bpp) - 1);
                            alpha[(int64_t)y * w + x] =
                                (uint8_t)((t->data[k] >> 8) & 0xff);
                        }
                }
                free(idx);
                free_transforms(&d);
                if (!ok)
                    return d.status ? d.status : WEBP_CORRUPT;
                goto unfilter;
            }
        }
        {
            /* the 32-bit path: the whole ARGB image, its green channel */
            uint32_t *pix = NULL;
            int64_t k;
            ok = argb_image(&d, &m, w, h, &pix);
            if (ok)
                for (k = 0; k < n; ++k)
                    alpha[k] = (uint8_t)((pix[k] >> 8) & 0xff);
            free(pix);
            free_transforms(&d);
            if (!ok)
                return d.status ? d.status : WEBP_CORRUPT;
        }
    }
unfilter:
    for (y = 0; y < h; ++y)
        unfilter_row(filter, y ? alpha + (int64_t)(y - 1) * w : NULL,
                     alpha + (int64_t)y * w, w);
    return WEBP_OK;
}

/* ------------------------------------------------------------------ */
/* VP8 boolean decoder (utils/bit_reader_utils.c, bit_reader_inl_utils.h) */

typedef struct {
    const uint8_t *buf, *end;
    uint64_t value;
    uint32_t range; /* the range minus 1 */
    int bits, eof;
} vp8bits;

static void vb_load(vp8bits *br)
{
    if (br->buf < br->end) {
        br->bits += 8;
        br->value = (br->value << 8) | *br->buf++;
    } else if (!br->eof) {
        br->value <<= 8;
        br->bits += 8;
        br->eof = 1;
    } else {
        br->bits = 0;
    }
}

static void vb_init(vp8bits *br, const uint8_t *start, size_t size)
{
    br->range = 255 - 1;
    br->value = 0;
    br->bits = -8;
    br->eof = 0;
    br->buf = start;
    br->end = start + size;
    vb_load(br);
}

static int log2_floor(uint32_t v)
{
    int n = 0;
    while (v >>= 1)
        ++n;
    return n;
}

static int vb_bit(vp8bits *br, int prob)
{
    uint32_t range = br->range, split, value;
    int pos, bit, shift;
    if (br->bits < 0)
        vb_load(br);
    pos = br->bits;
    split = (range * (uint32_t)prob) >> 8;
    value = (uint32_t)(br->value >> pos);
    bit = value > split;
    if (bit) {
        range -= split;
        br->value -= (uint64_t)(split + 1) << pos;
    } else {
        range = split + 1;
    }
    shift = 7 ^ log2_floor(range);
    range <<= shift;
    br->bits -= shift;
    br->range = range - 1;
    return bit;
}

/* VP8GetSigned: a sign at probability 1/2 */
static int vb_signed(vp8bits *br, int v)
{
    uint32_t split, value;
    int32_t mask;
    int pos;
    if (br->bits < 0)
        vb_load(br);
    pos = br->bits;
    split = br->range >> 1;
    value = (uint32_t)(br->value >> pos);
    mask = (int32_t)(split - value) >> 31;
    br->bits -= 1;
    br->range += (uint32_t)mask;
    br->range |= 1;
    br->value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
}

static uint32_t vb_value(vp8bits *br, int bits)
{
    uint32_t v = 0;
    while (bits-- > 0)
        v |= (uint32_t)vb_bit(br, 0x80) << bits;
    return v;
}

static int32_t vb_signed_value(vp8bits *br, int bits)
{
    int value = (int)vb_value(br, bits);
    return vb_value(br, 1) ? -value : value;
}

/* ------------------------------------------------------------------ */
/* VP8 tables: RFC 6386 13.5 (default coefficient probabilities), 13.4
 * (their update probabilities) and 11.5 (key-frame 4x4 mode probabilities,
 * in libwebp's mode order DC TM VE HE RD VR LD VL HD HU) */

static const uint8_t kCoeffsProba0[4][8][3][11] =
    {{{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
           {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
           {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
      {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
           {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
           {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
      {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
           {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
           {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
      {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
           {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
           {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
      {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
           {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
           {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
      {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
           {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
           {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
      {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
           {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
           {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
      {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
           {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
           {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
           {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
           {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
      {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
           {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
           {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
      {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
           {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
           {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
      {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
           {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
           {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
      {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
           {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
           {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
      {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
           {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
           {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
      {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
           {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
           {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
      {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
           {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
           {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
 {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
           {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
           {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
      {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
           {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
           {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
      {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
           {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
           {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
      {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
           {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
           {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
      {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
           {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
           {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
      {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
           {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
           {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
      {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
           {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
           {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
      {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
           {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
           {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
           {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
           {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
      {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
           {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
           {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
      {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
           {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
           {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
      {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
           {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
           {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
      {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
           {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
           {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
      {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
           {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
           {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
      {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
           {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
           {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
      {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
           {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
           {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] =
    {{{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
           {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
           {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
           {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
           {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
           {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
      {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
           {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
           {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
           {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
      {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
      {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
           {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
           {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
           {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
      {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
           {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
           {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
           {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
           {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
      {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
           {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};
static const uint8_t kBModesProba[10][10][9] =
    {{{231, 120, 48, 89, 115, 113, 120, 152, 112},
      {152, 179, 64, 126, 170, 118, 46, 70, 95},
      {175, 69, 143, 80, 85, 82, 72, 155, 103},
      {56, 58, 10, 171, 218, 189, 17, 13, 152},
      {114, 26, 17, 163, 44, 195, 21, 10, 173},
      {121, 24, 80, 195, 26, 62, 44, 64, 85},
      {144, 71, 10, 38, 171, 213, 144, 34, 26},
      {170, 46, 55, 19, 136, 160, 33, 206, 71},
      {63, 20, 8, 114, 114, 208, 12, 9, 226},
      {81, 40, 11, 96, 182, 84, 29, 16, 36}},
 {{134, 183, 89, 137, 98, 101, 106, 165, 148},
      {72, 187, 100, 130, 157, 111, 32, 75, 80},
      {66, 102, 167, 99, 74, 62, 40, 234, 128},
      {41, 53, 9, 178, 241, 141, 26, 8, 107},
      {74, 43, 26, 146, 73, 166, 49, 23, 157},
      {65, 38, 105, 160, 51, 52, 31, 115, 128},
      {104, 79, 12, 27, 217, 255, 87, 17, 7},
      {87, 68, 71, 44, 114, 51, 15, 186, 23},
      {47, 41, 14, 110, 182, 183, 21, 17, 194},
      {66, 45, 25, 102, 197, 189, 23, 18, 22}},
 {{88, 88, 147, 150, 42, 46, 45, 196, 205},
      {43, 97, 183, 117, 85, 38, 35, 179, 61},
      {39, 53, 200, 87, 26, 21, 43, 232, 171},
      {56, 34, 51, 104, 114, 102, 29, 93, 77},
      {39, 28, 85, 171, 58, 165, 90, 98, 64},
      {34, 22, 116, 206, 23, 34, 43, 166, 73},
      {107, 54, 32, 26, 51, 1, 81, 43, 31},
      {68, 25, 106, 22, 64, 171, 36, 225, 114},
      {34, 19, 21, 102, 132, 188, 16, 76, 124},
      {62, 18, 78, 95, 85, 57, 50, 48, 51}},
 {{193, 101, 35, 159, 215, 111, 89, 46, 111},
      {60, 148, 31, 172, 219, 228, 21, 18, 111},
      {112, 113, 77, 85, 179, 255, 38, 120, 114},
      {40, 42, 1, 196, 245, 209, 10, 25, 109},
      {88, 43, 29, 140, 166, 213, 37, 43, 154},
      {61, 63, 30, 155, 67, 45, 68, 1, 209},
      {100, 80, 8, 43, 154, 1, 51, 26, 71},
      {142, 78, 78, 16, 255, 128, 34, 197, 171},
      {41, 40, 5, 102, 211, 183, 4, 1, 221},
      {51, 50, 17, 168, 209, 192, 23, 25, 82}},
 {{138, 31, 36, 171, 27, 166, 38, 44, 229},
      {67, 87, 58, 169, 82, 115, 26, 59, 179},
      {63, 59, 90, 180, 59, 166, 93, 73, 154},
      {40, 40, 21, 116, 143, 209, 34, 39, 175},
      {47, 15, 16, 183, 34, 223, 49, 45, 183},
      {46, 17, 33, 183, 6, 98, 15, 32, 183},
      {57, 46, 22, 24, 128, 1, 54, 17, 37},
      {65, 32, 73, 115, 28, 128, 23, 128, 205},
      {40, 3, 9, 115, 51, 192, 18, 6, 223},
      {87, 37, 9, 115, 59, 77, 64, 21, 47}},
 {{104, 55, 44, 218, 9, 54, 53, 130, 226},
      {64, 90, 70, 205, 40, 41, 23, 26, 57},
      {54, 57, 112, 184, 5, 41, 38, 166, 213},
      {30, 34, 26, 133, 152, 116, 10, 32, 134},
      {39, 19, 53, 221, 26, 114, 32, 73, 255},
      {31, 9, 65, 234, 2, 15, 1, 118, 73},
      {75, 32, 12, 51, 192, 255, 160, 43, 51},
      {88, 31, 35, 67, 102, 85, 55, 186, 85},
      {56, 21, 23, 111, 59, 205, 45, 37, 192},
      {55, 38, 70, 124, 73, 102, 1, 34, 98}},
 {{125, 98, 42, 88, 104, 85, 117, 175, 82},
      {95, 84, 53, 89, 128, 100, 113, 101, 45},
      {75, 79, 123, 47, 51, 128, 81, 171, 1},
      {57, 17, 5, 71, 102, 57, 53, 41, 49},
      {38, 33, 13, 121, 57, 73, 26, 1, 85},
      {41, 10, 67, 138, 77, 110, 90, 47, 114},
      {115, 21, 2, 10, 102, 255, 166, 23, 6},
      {101, 29, 16, 10, 85, 128, 101, 196, 26},
      {57, 18, 10, 102, 102, 213, 34, 20, 43},
      {117, 20, 15, 36, 163, 128, 68, 1, 26}},
 {{102, 61, 71, 37, 34, 53, 31, 243, 192},
      {69, 60, 71, 38, 73, 119, 28, 222, 37},
      {68, 45, 128, 34, 1, 47, 11, 245, 171},
      {62, 17, 19, 70, 146, 85, 55, 62, 70},
      {37, 43, 37, 154, 100, 163, 85, 160, 1},
      {63, 9, 92, 136, 28, 64, 32, 201, 85},
      {75, 15, 9, 9, 64, 255, 184, 119, 16},
      {86, 6, 28, 5, 64, 255, 25, 248, 1},
      {56, 8, 17, 132, 137, 255, 55, 116, 128},
      {58, 15, 20, 82, 135, 57, 26, 121, 40}},
 {{164, 50, 31, 137, 154, 133, 25, 35, 218},
      {51, 103, 44, 131, 131, 123, 31, 6, 158},
      {86, 40, 64, 135, 148, 224, 45, 183, 128},
      {22, 26, 17, 131, 240, 154, 14, 1, 209},
      {45, 16, 21, 91, 64, 222, 7, 1, 197},
      {56, 21, 39, 155, 60, 138, 23, 102, 213},
      {83, 12, 13, 54, 192, 255, 68, 47, 28},
      {85, 26, 85, 85, 128, 128, 32, 146, 171},
      {18, 11, 7, 63, 144, 171, 4, 4, 246},
      {35, 27, 10, 146, 174, 171, 12, 26, 128}},
 {{190, 80, 35, 99, 180, 80, 126, 54, 45},
      {85, 126, 47, 87, 176, 51, 41, 20, 32},
      {101, 75, 128, 139, 118, 146, 116, 128, 85},
      {56, 41, 15, 176, 236, 85, 37, 9, 62},
      {71, 30, 17, 119, 118, 255, 17, 18, 138},
      {101, 38, 60, 138, 55, 70, 43, 26, 142},
      {146, 36, 19, 30, 171, 255, 97, 27, 20},
      {138, 45, 61, 62, 219, 1, 81, 188, 64},
      {32, 41, 20, 117, 151, 142, 20, 21, 163},
      {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148,
    151, 154, 157};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146,
    149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254,
    259, 264, 269, 274, 279, 284};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                   6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                    9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                                153, 140, 133, 130, 129, 0};
static const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

/* libwebp's mode numbers */
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, V_PRED = B_VE, H_PRED = B_HE, TM_PRED = B_TM,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

#define BPS 32

typedef struct {
    int simple, level, sharpness, use_lf_delta;
    int ref_lf_delta[4], mode_lf_delta[4];
} filter_header;

typedef struct {
    uint8_t limit, ilevel, inner, hev_thresh;
} finfo;

typedef struct {
    int y1[2], y2[2], uv[2];
} quant;

typedef struct {
    uint8_t nz, nz_dc;
} nzctx;

typedef struct {
    int width, height, mb_w, mb_h;
    vp8bits br, parts[8];
    int num_parts_minus_one;
    int use_segment, update_map, absolute_delta;
    int quantizer[4], filter_strength[4];
    uint8_t segment_probs[3];
    filter_header fh;
    int filter_type;
    uint8_t proba[4][8][3][11];
    int use_skip_proba, skip_p;
    quant dqm[4];
    finfo fstrengths[4][2];
    /* per macroblock of the row being decoded */
    uint8_t *intra_t; /* 4 per macroblock column */
    uint8_t intra_l[4];
    nzctx *nz; /* nz[-1] is the left context */
    uint8_t *top_y, *top_u, *top_v; /* unfiltered bottom rows, per column */
    uint8_t *Y, *U, *V;             /* the frame, padded to macroblocks */
    int ystride, uvstride;
} vp8dec;

typedef struct {
    int segment, skip, is_i4x4;
    uint8_t imodes[16];
    int uvmode;
    int16_t coeffs[384];
    uint32_t non_zero_y, non_zero_uv;
} mbdata;

/* ParseSegmentHeader, ParseFilterHeader, ParsePartitions, VP8ParseQuant,
 * VP8ParseProba */
static int parse_headers(vp8dec *dec, const uint8_t *buf, size_t size)
{
    vp8bits *br = &dec->br;
    int i, s, t, b, c, p;
    size_t part_len, last, size_left;
    const uint8_t *sz, *part_start, *buf_end;
    uint32_t bits;
    if (size < 4)
        return 0;
    bits = buf[0] | (buf[1] << 8) | ((uint32_t)buf[2] << 16);
    if (bits & 1) /* not a key frame */
        return 0;
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1))
        return 0;
    part_len = bits >> 5;
    buf += 3;
    size -= 3;
    if (size < 7 || buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
        return 0;
    dec->width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    dec->height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    dec->mb_w = (dec->width + 15) >> 4;
    dec->mb_h = (dec->height + 15) >> 4;
    memset(dec->segment_probs, 255, 3);
    dec->use_segment = dec->update_map = 0;
    dec->absolute_delta = 1;
    memset(dec->quantizer, 0, sizeof(dec->quantizer));
    memset(dec->filter_strength, 0, sizeof(dec->filter_strength));
    if (part_len > size)
        return 0;
    vb_init(br, buf, part_len);
    buf += part_len;
    size -= part_len;
    vb_value(br, 1); /* colour space */
    vb_value(br, 1); /* clamping type */
    dec->use_segment = (int)vb_value(br, 1);
    if (dec->use_segment) {
        dec->update_map = (int)vb_value(br, 1);
        if (vb_value(br, 1)) {
            dec->absolute_delta = (int)vb_value(br, 1);
            for (s = 0; s < 4; ++s)
                dec->quantizer[s] = vb_value(br, 1) ?
                    vb_signed_value(br, 7) : 0;
            for (s = 0; s < 4; ++s)
                dec->filter_strength[s] = vb_value(br, 1) ?
                    vb_signed_value(br, 6) : 0;
        }
        if (dec->update_map)
            for (s = 0; s < 3; ++s)
                dec->segment_probs[s] = vb_value(br, 1) ?
                    (uint8_t)vb_value(br, 8) : 255;
    }
    if (br->eof)
        return 0;
    dec->fh.simple = (int)vb_value(br, 1);
    dec->fh.level = (int)vb_value(br, 6);
    dec->fh.sharpness = (int)vb_value(br, 3);
    dec->fh.use_lf_delta = (int)vb_value(br, 1);
    if (dec->fh.use_lf_delta && vb_value(br, 1)) {
        for (i = 0; i < 4; ++i)
            if (vb_value(br, 1))
                dec->fh.ref_lf_delta[i] = vb_signed_value(br, 6);
        for (i = 0; i < 4; ++i)
            if (vb_value(br, 1))
                dec->fh.mode_lf_delta[i] = vb_signed_value(br, 6);
    }
    dec->filter_type = dec->fh.level == 0 ? 0 : dec->fh.simple ? 1 : 2;
    if (br->eof)
        return 0;
    /* the token partitions run to the end of the data */
    dec->num_parts_minus_one = (1 << vb_value(br, 2)) - 1;
    last = (size_t)dec->num_parts_minus_one;
    if (size < 3 * last)
        return 0;
    sz = buf;
    buf_end = buf + size;
    part_start = buf + last * 3;
    size_left = size - last * 3;
    for (p = 0; p < (int)last; ++p) {
        size_t psize = sz[0] | (sz[1] << 8) | ((size_t)sz[2] << 16);
        if (psize > size_left)
            psize = size_left;
        vb_init(&dec->parts[p], part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
    }
    vb_init(&dec->parts[last], part_start, size_left);
    if (part_start >= buf_end)
        return 0;
    {
        int base_q0 = (int)vb_value(br, 7);
        int dqy1_dc = vb_value(br, 1) ? vb_signed_value(br, 4) : 0;
        int dqy2_dc = vb_value(br, 1) ? vb_signed_value(br, 4) : 0;
        int dqy2_ac = vb_value(br, 1) ? vb_signed_value(br, 4) : 0;
        int dquv_dc = vb_value(br, 1) ? vb_signed_value(br, 4) : 0;
        int dquv_ac = vb_value(br, 1) ? vb_signed_value(br, 4) : 0;
        for (i = 0; i < 4; ++i) {
            int q;
            quant *m = &dec->dqm[i];
            if (dec->use_segment) {
                q = dec->quantizer[i];
                if (!dec->absolute_delta)
                    q += base_q0;
            } else if (i > 0) {
                dec->dqm[i] = dec->dqm[0];
                continue;
            } else {
                q = base_q0;
            }
#define CLIP(v, M) ((v) < 0 ? 0 : (v) > (M) ? (M) : (v))
            m->y1[0] = kDcTable[CLIP(q + dqy1_dc, 127)];
            m->y1[1] = kAcTable[CLIP(q, 127)];
            m->y2[0] = kDcTable[CLIP(q + dqy2_dc, 127)] * 2;
            m->y2[1] = (kAcTable[CLIP(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m->y2[1] < 8)
                m->y2[1] = 8;
            m->uv[0] = kDcTable[CLIP(q + dquv_dc, 117)];
            m->uv[1] = kAcTable[CLIP(q + dquv_ac, 127)];
#undef CLIP
        }
    }
    vb_value(br, 1); /* refresh entropy probabilities: ignored */
    for (t = 0; t < 4; ++t)
        for (b = 0; b < 8; ++b)
            for (c = 0; c < 3; ++c)
                for (p = 0; p < 11; ++p)
                    dec->proba[t][b][c][p] =
                        vb_bit(br, kCoeffsUpdateProba[t][b][c][p]) ?
                        (uint8_t)vb_value(br, 8) :
                        kCoeffsProba0[t][b][c][p];
    dec->use_skip_proba = (int)vb_value(br, 1);
    if (dec->use_skip_proba)
        dec->skip_p = (int)vb_value(br, 8);
    return 1;
}

/* PrecomputeFilterStrengths */
static void filter_strengths(vp8dec *dec)
{
    int s, i4x4;
    if (dec->filter_type == 0)
        return;
    for (s = 0; s < 4; ++s) {
        int base = dec->fh.level;
        if (dec->use_segment) {
            base = dec->filter_strength[s];
            if (!dec->absolute_delta)
                base += dec->fh.level;
        }
        for (i4x4 = 0; i4x4 <= 1; ++i4x4) {
            finfo *info = &dec->fstrengths[s][i4x4];
            int level = base;
            if (dec->fh.use_lf_delta) {
                level += dec->fh.ref_lf_delta[0];
                if (i4x4)
                    level += dec->fh.mode_lf_delta[0];
            }
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            if (level > 0) {
                int ilevel = level;
                if (dec->fh.sharpness > 0) {
                    ilevel >>= dec->fh.sharpness > 4 ? 2 : 1;
                    if (ilevel > 9 - dec->fh.sharpness)
                        ilevel = 9 - dec->fh.sharpness;
                }
                if (ilevel < 1)
                    ilevel = 1;
                info->ilevel = (uint8_t)ilevel;
                info->limit = (uint8_t)(2 * level + ilevel);
                info->hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                info->limit = 0;
            }
            info->inner = (uint8_t)i4x4;
        }
    }
}

/* ParseIntraMode */
static void parse_intra_mode(vp8dec *dec, int mb_x, mbdata *block)
{
    vp8bits *br = &dec->br;
    uint8_t *top = dec->intra_t + 4 * mb_x, *left = dec->intra_l;
    if (dec->update_map)
        block->segment = !vb_bit(br, dec->segment_probs[0]) ?
            vb_bit(br, dec->segment_probs[1]) :
            vb_bit(br, dec->segment_probs[2]) + 2;
    else
        block->segment = 0;
    block->skip = dec->use_skip_proba ? vb_bit(br, dec->skip_p) : 0;
    block->is_i4x4 = !vb_bit(br, 145);
    if (!block->is_i4x4) {
        int ymode = vb_bit(br, 156) ?
            (vb_bit(br, 128) ? TM_PRED : H_PRED) :
            (vb_bit(br, 163) ? V_PRED : DC_PRED);
        block->imodes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
    } else {
        uint8_t *modes = block->imodes;
        int y, x;
        for (y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (x = 0; x < 4; ++x) {
                const uint8_t *prob = kBModesProba[top[x]][ymode];
                ymode = !vb_bit(br, prob[0]) ? B_DC :
                    !vb_bit(br, prob[1]) ? B_TM :
                    !vb_bit(br, prob[2]) ? B_VE :
                    !vb_bit(br, prob[3]) ?
                        (!vb_bit(br, prob[4]) ? B_HE :
                         (!vb_bit(br, prob[5]) ? B_RD : B_VR)) :
                        (!vb_bit(br, prob[6]) ? B_LD :
                         (!vb_bit(br, prob[7]) ? B_VL :
                          (!vb_bit(br, prob[8]) ? B_HD : B_HU)));
                top[x] = (uint8_t)ymode;
            }
            memcpy(modes, top, 4);
            modes += 4;
            left[y] = (uint8_t)ymode;
        }
    }
    block->uvmode = !vb_bit(br, 142) ? DC_PRED :
        !vb_bit(br, 114) ? V_PRED :
        vb_bit(br, 183) ? TM_PRED : H_PRED;
}

static int large_value(vp8bits *br, const uint8_t *p)
{
    int v;
    if (!vb_bit(br, p[3])) {
        if (!vb_bit(br, p[4]))
            v = 2;
        else
            v = 3 + vb_bit(br, p[5]);
    } else if (!vb_bit(br, p[6])) {
        if (!vb_bit(br, p[7])) {
            v = 5 + vb_bit(br, 159);
        } else {
            v = 7 + 2 * vb_bit(br, 165);
            v += vb_bit(br, 145);
        }
    } else {
        const uint8_t *tab;
        int bit1 = vb_bit(br, p[8]);
        int bit0 = vb_bit(br, p[9 + bit1]);
        int cat = 2 * bit1 + bit0;
        v = 0;
        for (tab = kCat3456[cat]; *tab; ++tab)
            v += v + vb_bit(br, *tab);
        v += 3 + (8 << cat);
    }
    return v;
}

/* GetCoeffs: the position after the last non-zero coefficient */
static int get_coeffs(vp8bits *br, const uint8_t (*prob)[3][11], int ctx,
                      const int *dq, int n, int16_t *out)
{
    const uint8_t *p = prob[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!vb_bit(br, p[0]))
            return n;
        while (!vb_bit(br, p[1])) {
            p = prob[kBands[++n]][0];
            if (n == 16)
                return 16;
        }
        {
            const uint8_t (*p_ctx)[11] = prob[kBands[n + 1]];
            int v;
            if (!vb_bit(br, p[2])) {
                v = 1;
                p = p_ctx[1];
            } else {
                v = large_value(br, p);
                p = p_ctx[2];
            }
            out[kZigzag[n]] = (int16_t)(vb_signed(br, v) * dq[n > 0]);
        }
    }
    return 16;
}

static void transform_wht(const int16_t *in, int16_t *out)
{
    int tmp[16], i;
    for (i = 0; i < 4; ++i) {
        int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (i = 0; i < 4; ++i) {
        int dc = tmp[0 + i * 4] + 3;
        int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

/* ParseResiduals: the macroblock's coefficients; 1 if all are zero */
static int parse_residuals(vp8dec *dec, int mb_x, mbdata *block,
                           vp8bits *tbr)
{
    const quant *q = &dec->dqm[block->segment];
    nzctx *mb = &dec->nz[mb_x], *left_mb = &dec->nz[-1];
    int16_t *dst = block->coeffs;
    uint8_t tnz, lnz;
    uint32_t non_zero_y = 0, non_zero_uv = 0, out_t_nz, out_l_nz;
    int x, y, ch, first;
    const uint8_t (*ac_proba)[3][11];
    memset(dst, 0, sizeof(block->coeffs));
    if (!block->is_i4x4) {
        int16_t dc[16] = {0};
        int ctx = mb->nz_dc + left_mb->nz_dc;
        int nz = get_coeffs(tbr, (const uint8_t (*)[3][11])dec->proba[1],
                            ctx, q->y2, 0, dc);
        mb->nz_dc = left_mb->nz_dc = (uint8_t)(nz > 0);
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            int i, dc0 = (dc[0] + 3) >> 3;
            for (i = 0; i < 16 * 16; i += 16)
                dst[i] = (int16_t)dc0;
        }
        first = 1;
        ac_proba = (const uint8_t (*)[3][11])dec->proba[0];
    } else {
        first = 0;
        ac_proba = (const uint8_t (*)[3][11])dec->proba[3];
    }
    tnz = mb->nz & 0x0f;
    lnz = left_mb->nz & 0x0f;
    for (y = 0; y < 4; ++y) {
        int l = lnz & 1;
        uint32_t nz_coeffs = 0;
        for (x = 0; x < 4; ++x) {
            int ctx = l + (tnz & 1);
            int nz = get_coeffs(tbr, ac_proba, ctx, q->y1, first, dst);
            l = nz > first;
            tnz = (uint8_t)((tnz >> 1) | (l << 7));
            nz_coeffs = (nz_coeffs << 2) |
                (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
            dst += 16;
        }
        tnz >>= 4;
        lnz = (uint8_t)((lnz >> 1) | (l << 7));
        non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    out_t_nz = tnz;
    out_l_nz = lnz >> 4;
    for (ch = 0; ch < 4; ch += 2) {
        uint32_t nz_coeffs = 0;
        tnz = (uint8_t)(mb->nz >> (4 + ch));
        lnz = (uint8_t)(left_mb->nz >> (4 + ch));
        for (y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (x = 0; x < 2; ++x) {
                int ctx = l + (tnz & 1);
                int nz = get_coeffs(tbr,
                                    (const uint8_t (*)[3][11])dec->proba[2],
                                    ctx, q->uv, 0, dst);
                l = nz > 0;
                tnz = (uint8_t)((tnz >> 1) | (l << 3));
                nz_coeffs = (nz_coeffs << 2) |
                    (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
                dst += 16;
            }
            tnz >>= 2;
            lnz = (uint8_t)((lnz >> 1) | (l << 5));
        }
        non_zero_uv |= nz_coeffs << (4 * ch);
        out_t_nz |= (uint32_t)(tnz << 4) << ch;
        out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
    }
    mb->nz = (uint8_t)out_t_nz;
    left_mb->nz = (uint8_t)out_l_nz;
    block->non_zero_y = non_zero_y;
    block->non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
}

/* ------------------------------------------------------------------ */
/* reconstruction (dsp/dec.c) */

static uint8_t clip_8b(int v)
{
    return (!(v & ~0xff)) ? (uint8_t)v : v < 0 ? 0 : 255;
}

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)
#define STORE(x, y, v) \
    dst[(x) + (y) * BPS] = clip_8b(dst[(x) + (y) * BPS] + ((v) >> 3))

static void transform_one(const int16_t *in, uint8_t *dst)
{
    int C[16], *tmp = C, i;
    for (i = 0; i < 4; ++i) {
        int a = in[0] + in[8], b = in[0] - in[8];
        int c = MUL2(in[4]) - MUL1(in[12]), d = MUL1(in[4]) + MUL2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
        tmp += 4;
        in++;
    }
    tmp = C;
    for (i = 0; i < 4; ++i) {
        int dc = tmp[0] + 4, a = dc + tmp[8], b = dc - tmp[8];
        int c = MUL2(tmp[4]) - MUL1(tmp[12]), d = MUL1(tmp[4]) +
                                                 MUL2(tmp[12]);
        STORE(0, 0, a + d);
        STORE(1, 0, b + c);
        STORE(2, 0, b - c);
        STORE(3, 0, a - d);
        tmp++;
        dst += BPS;
    }
}

/* DoTransform / DoUVTransform: the full transform equals the DC-only and
 * three-coefficient shortcuts on what they are chosen for */
static void do_transform(uint32_t bits, const int16_t *src, uint8_t *dst)
{
    if (bits >> 30)
        transform_one(src, dst);
}

static void do_uv_transform(uint32_t bits, const int16_t *src, uint8_t *dst)
{
    if (bits & 0xff) {
        transform_one(src, dst);
        transform_one(src + 16, dst + 4);
        transform_one(src + 32, dst + 4 * BPS);
        transform_one(src + 48, dst + 4 * BPS + 4);
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static void true_motion(uint8_t *dst, int size)
{
    const uint8_t *top = dst - BPS;
    int x, y;
    for (y = 0; y < size; ++y) {
        for (x = 0; x < size; ++x)
            dst[x] = clip_8b(top[x] + dst[-1] - top[-1]);
        dst += BPS;
    }
}

static void pred_luma4(int mode, uint8_t *dst)
{
    const uint8_t *top = dst - BPS;
    int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
        L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0], B = top[1],
        C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
        H = top[7], i;
    switch (mode) {
    case B_DC: {
        uint32_t dc = 4;
        for (i = 0; i < 4; ++i)
            dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc >>= 3;
        for (i = 0; i < 4; ++i)
            memset(dst + i * BPS, (int)dc, 4);
        break;
    }
    case B_TM:
        true_motion(dst, 4);
        break;
    case B_VE: {
        uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                           AVG3(C, D, E)};
        for (i = 0; i < 4; ++i)
            memcpy(dst + i * BPS, vals, 4);
        break;
    }
    case B_HE:
        memset(dst + 0 * BPS, AVG3(X, I, J), 4);
        memset(dst + 1 * BPS, AVG3(I, J, K), 4);
        memset(dst + 2 * BPS, AVG3(J, K, L), 4);
        memset(dst + 3 * BPS, AVG3(K, L, L), 4);
        break;
    case B_RD:
        DST(0, 3) = AVG3(J, K, L);
        DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
        DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
        DST(3, 0) = AVG3(D, C, B);
        break;
    case B_LD:
        DST(0, 0) = AVG3(A, B, C);
        DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
        DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
        DST(3, 3) = AVG3(G, H, H);
        break;
    case B_VR:
        DST(0, 0) = DST(1, 2) = (uint8_t)AVG2(X, A);
        DST(1, 0) = DST(2, 2) = (uint8_t)AVG2(A, B);
        DST(2, 0) = DST(3, 2) = (uint8_t)AVG2(B, C);
        DST(3, 0) = (uint8_t)AVG2(C, D);
        DST(0, 3) = AVG3(K, J, I);
        DST(0, 2) = AVG3(J, I, X);
        DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
        DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
        DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
        DST(3, 1) = AVG3(B, C, D);
        break;
    case B_VL:
        DST(0, 0) = (uint8_t)AVG2(A, B);
        DST(1, 0) = DST(0, 2) = (uint8_t)AVG2(B, C);
        DST(2, 0) = DST(1, 2) = (uint8_t)AVG2(C, D);
        DST(3, 0) = DST(2, 2) = (uint8_t)AVG2(D, E);
        DST(0, 1) = AVG3(A, B, C);
        DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
        DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
        DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
        DST(3, 2) = AVG3(E, F, G);
        DST(3, 3) = AVG3(F, G, H);
        break;
    case B_HU:
        DST(0, 0) = (uint8_t)AVG2(I, J);
        DST(2, 0) = DST(0, 1) = (uint8_t)AVG2(J, K);
        DST(2, 1) = DST(0, 2) = (uint8_t)AVG2(K, L);
        DST(1, 0) = AVG3(I, J, K);
        DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
        DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
            DST(3, 3) = (uint8_t)L;
        break;
    default: /* B_HD */
        DST(0, 0) = DST(2, 1) = (uint8_t)AVG2(I, X);
        DST(0, 1) = DST(2, 2) = (uint8_t)AVG2(J, I);
        DST(0, 2) = DST(2, 3) = (uint8_t)AVG2(K, J);
        DST(0, 3) = (uint8_t)AVG2(L, K);
        DST(3, 0) = AVG3(A, B, C);
        DST(2, 0) = AVG3(X, A, B);
        DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
        DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
        DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
        DST(1, 3) = AVG3(L, K, J);
        break;
    }
}

/* 16x16 luma (size 16) and 8x8 chroma (size 8) prediction */
static void pred_block(int mode, uint8_t *dst, int size)
{
    int i, j, shift = size == 16 ? 4 : 3;
    uint32_t dc = 0;
    switch (mode) {
    case V_PRED:
        for (j = 0; j < size; ++j)
            memcpy(dst + j * BPS, dst - BPS, (size_t)size);
        break;
    case H_PRED:
        for (j = 0; j < size; ++j)
            memset(dst + j * BPS, dst[j * BPS - 1], (size_t)size);
        break;
    case TM_PRED:
        true_motion(dst, size);
        break;
    default:
        if (mode == DC_PRED) {
            for (i = 0; i < size; ++i)
                dc += dst[i - BPS] + dst[-1 + i * BPS];
            dc = (dc + (uint32_t)size) >> (shift + 1);
        } else if (mode == DC_NOTOP) {
            for (i = 0; i < size; ++i)
                dc += dst[-1 + i * BPS];
            dc = (dc + (uint32_t)(size >> 1)) >> shift;
        } else if (mode == DC_NOLEFT) {
            for (i = 0; i < size; ++i)
                dc += dst[i - BPS];
            dc = (dc + (uint32_t)(size >> 1)) >> shift;
        } else {
            dc = 0x80;
        }
        for (j = 0; j < size; ++j)
            memset(dst + j * BPS, (int)dc, (size_t)size);
        break;
    }
}

static int check_mode(int mb_x, int mb_y, int mode)
{
    if (mode == B_DC) {
        if (mb_x == 0)
            return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
        return mb_y == 0 ? DC_NOTOP : DC_PRED;
    }
    return mode;
}

/* ReconstructRow for one macroblock; the work buffers (BPS stride) carry
 * the left samples from the previous macroblock of the row */
static void reconstruct(vp8dec *dec, int mb_x, int mb_y,
                        const mbdata *block, uint8_t *y_dst, uint8_t *u_dst,
                        uint8_t *v_dst)
{
    int j, n;
    uint8_t *top_y = dec->top_y + 16 * mb_x, *top_u = dec->top_u + 8 * mb_x,
            *top_v = dec->top_v + 8 * mb_x;
    const int16_t *coeffs = block->coeffs;
    uint32_t bits = block->non_zero_y;
    if (mb_x > 0) {
        for (j = -1; j < 16; ++j)
            memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (j = -1; j < 8; ++j) {
            memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
            memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
    }
    if (mb_y > 0) {
        memcpy(y_dst - BPS, top_y, 16);
        memcpy(u_dst - BPS, top_u, 8);
        memcpy(v_dst - BPS, top_v, 8);
    }
    if (block->is_i4x4) {
        uint8_t *top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
            if (mb_x >= dec->mb_w - 1)
                memset(top_right, top_y[15], 4);
            else
                memcpy(top_right, top_y + 16, 4);
        }
        memcpy(top_right + 4 * BPS, top_right, 4);
        memcpy(top_right + 8 * BPS, top_right, 4);
        memcpy(top_right + 12 * BPS, top_right, 4);
        for (n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t *dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred_luma4(block->imodes[n], dst);
            do_transform(bits, coeffs + n * 16, dst);
        }
    } else {
        pred_block(check_mode(mb_x, mb_y, block->imodes[0]), y_dst, 16);
        if (bits != 0)
            for (n = 0; n < 16; ++n, bits <<= 2)
                do_transform(bits, coeffs + n * 16,
                             y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    {
        int mode = check_mode(mb_x, mb_y, block->uvmode);
        pred_block(mode, u_dst, 8);
        pred_block(mode, v_dst, 8);
        do_uv_transform(block->non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
        do_uv_transform(block->non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
    }
    if (mb_y < dec->mb_h - 1) {
        memcpy(top_y, y_dst + 15 * BPS, 16);
        memcpy(top_u, u_dst + 7 * BPS, 8);
        memcpy(top_v, v_dst + 7 * BPS, 8);
    }
    for (j = 0; j < 16; ++j)
        memcpy(dec->Y + (int64_t)(mb_y * 16 + j) * dec->ystride + mb_x * 16,
               y_dst + j * BPS, 16);
    for (j = 0; j < 8; ++j) {
        memcpy(dec->U + (int64_t)(mb_y * 8 + j) * dec->uvstride + mb_x * 8,
               u_dst + j * BPS, 8);
        memcpy(dec->V + (int64_t)(mb_y * 8 + j) * dec->uvstride + mb_x * 8,
               v_dst + j * BPS, 8);
    }
}

/* ------------------------------------------------------------------ */
/* loop filters (dsp/dec.c) */

static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
static uint8_t uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

static void do_filter2(uint8_t *p, int step)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = uclip(p0 + a2);
    p[0] = uclip(q0 - a1);
}

static void do_filter4(uint8_t *p, int step)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    int a3 = (a1 + 1) >> 1;
    p[-2 * step] = uclip(p1 + a3);
    p[-step] = uclip(p0 + a2);
    p[0] = uclip(q0 - a1);
    p[step] = uclip(q1 - a3);
}

static void do_filter6(uint8_t *p, int step)
{
    int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
        a3 = (9 * a + 63) >> 7;
    p[-3 * step] = uclip(p2 + a3);
    p[-2 * step] = uclip(p1 + a2);
    p[-step] = uclip(p0 + a1);
    p[0] = uclip(q0 - a1);
    p[step] = uclip(q1 - a2);
    p[2 * step] = uclip(q2 - a3);
}

static int hev(const uint8_t *p, int step, int thresh)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

static int needs_filter(const uint8_t *p, int step, int t)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

static int needs_filter2(const uint8_t *p, int step, int t, int it)
{
    int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
        q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t)
        return 0;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
           abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

/* the simple filter across one edge of 16 pixels: `step` across it,
 * `stride` along it */
static void simple_edge(uint8_t *p, int step, int stride, int thresh)
{
    int i, t2 = 2 * thresh + 1;
    for (i = 0; i < 16; ++i)
        if (needs_filter(p + i * stride, step, t2))
            do_filter2(p + i * stride, step);
}

/* FilterLoop26 (macroblock edges) and FilterLoop24 (inner edges) */
static void normal_edge(uint8_t *p, int step, int stride, int size,
                        int thresh, int ithresh, int hev_thresh, int mb_edge)
{
    int t2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, step, t2, ithresh)) {
            if (hev(p, step, hev_thresh))
                do_filter2(p, step);
            else if (mb_edge)
                do_filter6(p, step);
            else
                do_filter4(p, step);
        }
        p += stride;
    }
}

static void do_filter(vp8dec *dec, int mb_x, int mb_y, const finfo *f)
{
    int ys = dec->ystride, uvs = dec->uvstride, limit = f->limit, k;
    uint8_t *y_dst = dec->Y + (int64_t)mb_y * 16 * ys + mb_x * 16;
    uint8_t *u_dst = dec->U + (int64_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t *v_dst = dec->V + (int64_t)mb_y * 8 * uvs + mb_x * 8;
    int il = f->ilevel, hv = f->hev_thresh;
    if (limit == 0)
        return;
    if (dec->filter_type == 1) {
        if (mb_x > 0)
            simple_edge(y_dst, 1, ys, limit + 4);
        if (f->inner)
            for (k = 1; k <= 3; ++k)
                simple_edge(y_dst + 4 * k, 1, ys, limit);
        if (mb_y > 0)
            simple_edge(y_dst, ys, 1, limit + 4);
        if (f->inner)
            for (k = 1; k <= 3; ++k)
                simple_edge(y_dst + 4 * k * ys, ys, 1, limit);
        return;
    }
    if (mb_x > 0) {
        normal_edge(y_dst, 1, ys, 16, limit + 4, il, hv, 1);
        normal_edge(u_dst, 1, uvs, 8, limit + 4, il, hv, 1);
        normal_edge(v_dst, 1, uvs, 8, limit + 4, il, hv, 1);
    }
    if (f->inner) {
        for (k = 1; k <= 3; ++k)
            normal_edge(y_dst + 4 * k, 1, ys, 16, limit, il, hv, 0);
        normal_edge(u_dst + 4, 1, uvs, 8, limit, il, hv, 0);
        normal_edge(v_dst + 4, 1, uvs, 8, limit, il, hv, 0);
    }
    if (mb_y > 0) {
        normal_edge(y_dst, ys, 1, 16, limit + 4, il, hv, 1);
        normal_edge(u_dst, uvs, 1, 8, limit + 4, il, hv, 1);
        normal_edge(v_dst, uvs, 1, 8, limit + 4, il, hv, 1);
    }
    if (f->inner) {
        for (k = 1; k <= 3; ++k)
            normal_edge(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hv, 0);
        normal_edge(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hv, 0);
        normal_edge(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hv, 0);
    }
}

/* ------------------------------------------------------------------ */
/* YUV -> BGR (dsp/yuv.h) and fancy upsampling (dsp/upsampling.c) */

static int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

static int clip8(int v)
{
    return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}

static void yuv_to_bgr(int y, int u, int v, uint8_t *bgr)
{
    bgr[2] = (uint8_t)clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    bgr[1] = (uint8_t)clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                            mult_hi(v, 13320) + 8708);
    bgr[0] = (uint8_t)clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

/* one output row of luma `y`, its chroma interpolated between chroma rows
 * `near` (weight 3/4) and `far` (1/4) as UpsampleBgrLinePair does it */
static void upsample_row(const uint8_t *y, const uint8_t *nu,
                         const uint8_t *nv, const uint8_t *fu,
                         const uint8_t *fv, uint8_t *dst, int len)
{
    int x, last_pair = (len - 1) >> 1;
    int n_u = nu[0], n_v = nv[0], f_u = fu[0], f_v = fv[0];
    /* (3 * near + far + 2) >> 2 at the left edge */
    yuv_to_bgr(y[0], (3 * n_u + f_u + 2) >> 2, (3 * n_v + f_v + 2) >> 2, dst);
    for (x = 1; x <= last_pair; ++x) {
        int n_u1 = nu[x], n_v1 = nv[x], f_u1 = fu[x], f_v1 = fv[x];
        /* near row: a = near[x-1], b = near[x]; far row: c, d */
        int avg_u = n_u + n_u1 + f_u + f_u1 + 8;
        int avg_v = n_v + n_v1 + f_v + f_v1 + 8;
        int d12_u = (avg_u + 2 * (n_u1 + f_u)) >> 3;
        int d03_u = (avg_u + 2 * (n_u + f_u1)) >> 3;
        int d12_v = (avg_v + 2 * (n_v1 + f_v)) >> 3;
        int d03_v = (avg_v + 2 * (n_v + f_v1)) >> 3;
        yuv_to_bgr(y[2 * x - 1], (d12_u + n_u) >> 1, (d12_v + n_v) >> 1,
                   dst + (2 * x - 1) * 3);
        yuv_to_bgr(y[2 * x], (d03_u + n_u1) >> 1, (d03_v + n_v1) >> 1,
                   dst + 2 * x * 3);
        n_u = n_u1;
        n_v = n_v1;
        f_u = f_u1;
        f_v = f_v1;
    }
    if (!(len & 1))
        yuv_to_bgr(y[len - 1], (3 * n_u + f_u + 2) >> 2,
                   (3 * n_v + f_v + 2) >> 2, dst + (len - 1) * 3);
}

/* the frame -> BGR rows, as EmitFancyRGB emits them over the image */
static void emit_bgr(const vp8dec *dec, uint8_t *bgr)
{
    int r, W = dec->width, H = dec->height, uv_h = (H + 1) / 2;
    for (r = 0; r < H; ++r) {
        int near, far;
        if (r == 0) {
            near = far = 0;
        } else if (r & 1) { /* top of a pair: chroma rows k-1 and k */
            near = (r - 1) / 2;
            far = (r + 1) / 2 < uv_h ? (r + 1) / 2 : near;
        } else { /* bottom of a pair */
            near = r / 2;
            far = r / 2 - 1;
        }
        upsample_row(dec->Y + (int64_t)r * dec->ystride,
                     dec->U + (int64_t)near * dec->uvstride,
                     dec->V + (int64_t)near * dec->uvstride,
                     dec->U + (int64_t)far * dec->uvstride,
                     dec->V + (int64_t)far * dec->uvstride,
                     bgr + (int64_t)r * W * 3, W);
    }
}

static void free_vp8(vp8dec *dec)
{
    free(dec->intra_t);
    free(dec->nz ? dec->nz - 1 : NULL);
    free(dec->top_y);
    free(dec->top_u);
    free(dec->top_v);
    free(dec->Y);
    free(dec->U);
    free(dec->V);
}

/* A VP8 frame of `size` bytes (from its frame tag to the end of the data,
 * as libwebp takes it) -> `width` x `height` BGR; WEBP_OK or an error. */
int webp_vp8_decode(const uint8_t *data, int64_t size, int64_t width,
                    int64_t height, uint8_t *bgr)
{
    vp8dec *dec = calloc(1, sizeof(vp8dec));
    mbdata *row = NULL;
    uint8_t ybuf[17 * BPS + BPS], ubuf[9 * BPS + BPS], vbuf[9 * BPS + BPS];
    uint8_t *y_dst = ybuf + BPS + 8, *u_dst = ubuf + BPS + 8,
            *v_dst = vbuf + BPS + 8;
    int status = WEBP_CORRUPT, mb_x, mb_y, j;
    finfo *fi = NULL;
    if (!dec)
        return WEBP_NOMEM;
    if (!parse_headers(dec, data, (size_t)size) || dec->width != width ||
        dec->height != height || dec->width == 0 || dec->height == 0)
        goto end;
    filter_strengths(dec);
    dec->ystride = dec->mb_w * 16;
    dec->uvstride = dec->mb_w * 8;
    dec->intra_t = malloc(4 * (size_t)dec->mb_w);
    dec->nz = calloc((size_t)dec->mb_w + 1, sizeof(nzctx));
    dec->top_y = calloc((size_t)dec->mb_w, 16);
    dec->top_u = calloc((size_t)dec->mb_w, 8);
    dec->top_v = calloc((size_t)dec->mb_w, 8);
    dec->Y = malloc((size_t)dec->ystride * dec->mb_h * 16);
    dec->U = malloc((size_t)dec->uvstride * dec->mb_h * 8);
    dec->V = malloc((size_t)dec->uvstride * dec->mb_h * 8);
    row = malloc(sizeof(mbdata) * (size_t)dec->mb_w);
    fi = malloc(sizeof(finfo) * (size_t)dec->mb_w);
    if (dec->nz)
        dec->nz += 1;
    if (!dec->intra_t || !dec->nz || !dec->top_y || !dec->top_u ||
        !dec->top_v || !dec->Y || !dec->U || !dec->V || !row || !fi) {
        status = WEBP_NOMEM;
        goto end;
    }
    memset(dec->intra_t, B_DC, 4 * (size_t)dec->mb_w);
    memset(ybuf, 0, sizeof(ybuf));
    memset(ubuf, 0, sizeof(ubuf));
    memset(vbuf, 0, sizeof(vbuf));
    for (mb_y = 0; mb_y < dec->mb_h; ++mb_y) {
        vp8bits *tbr = &dec->parts[mb_y & dec->num_parts_minus_one];
        for (mb_x = 0; mb_x < dec->mb_w; ++mb_x)
            parse_intra_mode(dec, mb_x, &row[mb_x]);
        if (dec->br.eof)
            goto end;
        for (mb_x = 0; mb_x < dec->mb_w; ++mb_x) {
            mbdata *block = &row[mb_x];
            int skip = dec->use_skip_proba ? block->skip : 0;
            if (!skip) {
                skip = parse_residuals(dec, mb_x, block, tbr);
            } else {
                dec->nz[-1].nz = dec->nz[mb_x].nz = 0;
                if (!block->is_i4x4)
                    dec->nz[-1].nz_dc = dec->nz[mb_x].nz_dc = 0;
                block->non_zero_y = 0;
                block->non_zero_uv = 0;
            }
            if (dec->filter_type > 0) {
                fi[mb_x] = dec->fstrengths[block->segment][block->is_i4x4];
                fi[mb_x].inner |= (uint8_t)!skip;
            }
            if (tbr->eof)
                goto end;
        }
        /* VP8InitScanline */
        dec->nz[-1].nz = dec->nz[-1].nz_dc = 0;
        memset(dec->intra_l, B_DC, 4);
        /* ReconstructRow: 129 on the left, 127 above the first row */
        for (j = 0; j < 16; ++j)
            y_dst[j * BPS - 1] = 129;
        for (j = 0; j < 8; ++j)
            u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            memset(u_dst - BPS - 1, 127, 8 + 1);
            memset(v_dst - BPS - 1, 127, 8 + 1);
        }
        for (mb_x = 0; mb_x < dec->mb_w; ++mb_x)
            reconstruct(dec, mb_x, mb_y, &row[mb_x], y_dst, u_dst, v_dst);
        if (dec->filter_type > 0)
            for (mb_x = 0; mb_x < dec->mb_w; ++mb_x)
                do_filter(dec, mb_x, mb_y, &fi[mb_x]);
    }
    emit_bgr(dec, bgr);
    status = WEBP_OK;
end:
    free(row);
    free(fi);
    free_vp8(dec);
    free(dec);
    return status;
}
