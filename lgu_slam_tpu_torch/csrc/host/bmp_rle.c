/* RLE8 and RLE4 decoding of BMP pixel data for the port's data layer, as
 * OpenCV 5.0's BMP reader (grfmt_bmp.cpp) decodes them for cv2.imread.
 *
 * The output is palette indices, `height` rows of `width` in the order the
 * data fills them (the first row is the file's bottom row unless the image
 * is top-down).  The reader's rules, which the port's tests measure against
 * cv2.imread:
 *   - an encoded run (count, value) or an absolute run (0, count >= 3, the
 *     values padded to a 16-bit word) that would pass the row's end makes
 *     the whole image fail;
 *   - RLE8: end-of-line (0, 0) fills the rest of the row with index 0 and
 *     goes to the next one, unless the previous run ended exactly at a
 *     row's end (it went to the next row already); end-of-bitmap (0, 1)
 *     fills every pixel left with index 0; a delta (0, 2, dx, dy) fills
 *     the dx + dy * width pixels it skips with index 0;
 *   - RLE4: end-of-line and end-of-bitmap fill the rest of the row with
 *     index 0 and go to the next one; a delta fills dx pixels (its dy is
 *     read and ignored);
 *   - the data ends when the last row is filled; data that ends before
 *     that makes the image fail.
 * Every read of the input is bounds-checked.
 *
 * Built by the host C compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/data/image_io.py).
 */
#include <stdint.h>
#include <string.h>

#define BMP_OK 0
#define BMP_CORRUPT 1

typedef struct {
    uint8_t *idx;
    int64_t W, H, x, y;
} cursor;

/* grfmt_bmp.cpp FillUniColor: `count` pixels of `v` from the cursor on,
 * wrapping to the next row at a row's end (also when count is 0 and the
 * cursor stands at the end) */
static void fill(cursor *c, int64_t count, uint8_t v)
{
    do {
        int64_t end = c->x + count < c->W ? c->x + count : c->W;
        count -= end - c->x;
        if (end > c->x)
            memset(c->idx + c->y * c->W + c->x, v, (size_t)(end - c->x));
        c->x = end;
        if (c->x >= c->W) {
            c->x = 0;
            if (++c->y >= c->H)
                break;
        }
    } while (count > 0);
}

int bmp_rle_decode(const uint8_t *src, int64_t n, int rle4, int64_t width,
                   int64_t height, uint8_t *idx)
{
    cursor c = {idx, width, height, 0, 0};
    int64_t pos = 0;
    int line_end_flag = 0;
    for (;;) {
        if (pos + 2 > n)
            return BMP_CORRUPT; /* the data ends before the image */
        int len = src[pos], code = src[pos + 1];
        pos += 2;
        if (len != 0) { /* encoded run */
            if (c.x + len > c.W)
                return BMP_CORRUPT;
            if (rle4) {
                uint8_t *row = idx + c.y * c.W + c.x;
                for (int k = 0; k < len; k++)
                    row[k] = (uint8_t)(k & 1 ? code & 15 : code >> 4);
                c.x += len;
            } else {
                int64_t prev_y = c.y;
                fill(&c, len, (uint8_t)code);
                line_end_flag = c.y != prev_y;
                if (c.y >= c.H)
                    break;
            }
        } else if (code > 2) { /* absolute run */
            if (c.x + code > c.W)
                return BMP_CORRUPT;
            int64_t sz = rle4 ? (((code + 1) >> 1) + 1) & ~1 : (code + 1) & ~1;
            if (pos + sz > n)
                return BMP_CORRUPT;
            uint8_t *row = idx + c.y * c.W + c.x;
            for (int k = 0; k < code; k++)
                row[k] = rle4 ? (uint8_t)(k & 1 ? src[pos + k / 2] & 15
                                                : src[pos + k / 2] >> 4)
                              : src[pos + k];
            c.x += code;
            pos += sz;
            line_end_flag = 0;
        } else if (rle4) { /* end of line, of bitmap, or a delta */
            int64_t shift = c.W - c.x;
            if (code == 2) {
                if (pos + 2 > n)
                    return BMP_CORRUPT;
                shift = src[pos];
                pos += 2;
            }
            fill(&c, shift, 0);
            if (c.y >= c.H)
                break;
        } else {
            int64_t shift = c.W - c.x, yshift = c.H - c.y;
            if (code || !line_end_flag || shift < c.W) {
                if (code == 2) {
                    if (pos + 2 > n)
                        return BMP_CORRUPT;
                    shift = src[pos];
                    yshift = src[pos + 1];
                    pos += 2;
                }
                if (code != 0)
                    shift += yshift * c.W;
                if (c.y >= c.H)
                    break;
                fill(&c, shift, 0);
                if (c.y >= c.H)
                    break;
            }
            line_end_flag = 0;
            if (c.y >= c.H)
                break;
        }
    }
    return BMP_OK;
}
