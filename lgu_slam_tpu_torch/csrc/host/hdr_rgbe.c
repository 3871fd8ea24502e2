/* Radiance HDR pixel decoding for the port's data layer, as OpenCV 5.0's
 * HDR reader (rgbe.cpp, after Bruce Walter's RGBE code) reads a file's
 * scanlines for cv2.imread, and its float BGR-to-gray conversion.
 *
 * hdr_read_pixels follows RGBE_ReadPixels_RLE: widths below 8 or above
 * 32767 are read flat; otherwise each scanline starts with 2, 2 and its
 * width in two bytes, then its four channels run-length coded (a count
 * above 128 repeats the next byte count - 128 times, a count of 1..128
 * copies that many bytes; a zero count or a run past the scanline is an
 * error).  A scanline that does not start so ends the run-length reading:
 * that pixel and every pixel after it are read flat (old-style run-length
 * pixels are not expanded).  Data that ends early is an error.  RGBE to
 * float: m * 2^(e - 136), 0 where e is 0 (rgbe2float), stored B, G, R.
 *
 * hdr_gray is cv2.cvtColor(COLOR_BGR2GRAY) of float32 BGR rows as the
 * x86-64 build of OpenCV 5.0 computes it (measured against it): pixels in
 * whole groups of 8 from the row's start, and the rest, as
 * fma(R, 0.299, fma(B, 0.114, G * 0.587)); where 4 or more are left after
 * the groups, the 1st and 3rd of them as fma(R, 0.299, fma(G, 0.587,
 * B * 0.114)).
 *
 * Every read of the input is bounds-checked.  Built by the host C
 * compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/data/hdr.py).
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#define HDR_OK 0
#define HDR_CORRUPT 1
#define HDR_NOMEM 3

static void rgbe_to_bgr(const uint8_t *rgbe, float *bgr)
{
    if (rgbe[3]) {
        float f = (float)ldexp(1.0, rgbe[3] - (128 + 8));
        bgr[2] = rgbe[0] * f;
        bgr[1] = rgbe[1] * f;
        bgr[0] = rgbe[2] * f;
    } else {
        bgr[0] = bgr[1] = bgr[2] = 0.0f;
    }
}

/* RGBE_ReadPixels: `count` flat pixels */
static int read_flat(const uint8_t *src, int64_t n, int64_t *pos,
                     float *out, int64_t count)
{
    int64_t i;
    for (i = 0; i < count; ++i) {
        if (*pos + 4 > n)
            return HDR_CORRUPT;
        rgbe_to_bgr(src + *pos, out + 3 * i);
        *pos += 4;
    }
    return HDR_OK;
}

int hdr_read_pixels(const uint8_t *src, int64_t n, int64_t width,
                    int64_t height, float *out)
{
    int64_t pos = 0, y, i;
    uint8_t *line;
    if (width < 8 || width > 0x7fff)
        return read_flat(src, n, &pos, out, width * height);
    line = malloc((size_t)(4 * width));
    if (!line)
        return HDR_NOMEM;
    for (y = 0; y < height; ++y) {
        const uint8_t *rgbe = src + pos;
        int ch;
        if (pos + 4 > n)
            goto corrupt;
        pos += 4;
        if (rgbe[0] != 2 || rgbe[1] != 2 || (rgbe[2] & 0x80)) {
            float *rest = out + 3 * y * width;
            rgbe_to_bgr(rgbe, rest);
            free(line);
            return read_flat(src, n, &pos, rest + 3,
                             width * (height - y) - 1);
        }
        if (((rgbe[2] << 8) | rgbe[3]) != width)
            goto corrupt;
        for (ch = 0; ch < 4; ++ch) {
            uint8_t *ptr = line + ch * width, *end = ptr + width;
            while (ptr < end) {
                int count;
                if (pos + 2 > n)
                    goto corrupt;
                count = src[pos];
                if (count > 128) {
                    count -= 128;
                    if (count > end - ptr)
                        goto corrupt;
                    while (count-- > 0)
                        *ptr++ = src[pos + 1];
                    pos += 2;
                } else {
                    if (count == 0 || count > end - ptr)
                        goto corrupt;
                    *ptr++ = src[pos + 1];
                    pos += 2;
                    if (--count > 0) {
                        if (pos + count > n)
                            goto corrupt;
                        for (i = 0; i < count; ++i)
                            *ptr++ = src[pos + i];
                        pos += count;
                    }
                }
            }
        }
        for (i = 0; i < width; ++i) {
            uint8_t px[4] = {line[i], line[i + width], line[i + 2 * width],
                             line[i + 3 * width]};
            rgbe_to_bgr(px, out + 3 * (y * width + i));
        }
    }
    free(line);
    return HDR_OK;
corrupt:
    free(line);
    return HDR_CORRUPT;
}

void hdr_gray(const float *bgr, int64_t height, int64_t width, float *gray)
{
    const float cb = 0.114f, cg = 0.587f, cr = 0.299f;
    int64_t y, x, tail = width - width % 8;
    for (y = 0; y < height; ++y) {
        for (x = 0; x < width; ++x) {
            const float *p = bgr + 3 * (y * width + x);
            int other = width - tail >= 4 && (x == tail || x == tail + 2);
            gray[y * width + x] = other ?
                fmaf(p[2], cr, fmaf(p[1], cg, p[0] * cb)) :
                fmaf(p[2], cr, fmaf(p[0], cb, p[1] * cg));
        }
    }
}
