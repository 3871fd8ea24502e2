/* Row unfilter of a decompressed, non-interlaced PNG image (PNG spec,
 * section 9: filter method 0, types None, Sub, Up, Average and Paeth).
 *
 * Average and Paeth are sequential along a row: each byte depends on the
 * byte one pixel to its left, already unfiltered.  Built by the host C
 * compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/data/image_io.py holds a numpy version of the same
 * function, which the tests hold it against).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

/* src: height rows of (1 filter-type byte + rowbytes bytes); dst: height *
 * rowbytes bytes; bpp: bytes per complete pixel, at least 1.  Returns 0, or
 * 1 + the index of the first row whose filter type is not 0-4 (dst is then
 * filled up to that row). */
int png_unfilter(const uint8_t *src, uint8_t *dst, int64_t height,
                 int64_t rowbytes, int64_t bpp)
{
    uint8_t *zero = calloc((size_t)rowbytes + 1, 1);
    if (zero == NULL)
        return -1;
    const uint8_t *up = zero; /* the row above the first is all zeros */
    int status = 0;
    for (int64_t y = 0; y < height && status == 0; y++) {
        const uint8_t *in = src + y * (rowbytes + 1) + 1;
        uint8_t *out = dst + y * rowbytes;
        int64_t i;
        switch (in[-1]) {
        case 0:
            memcpy(out, in, (size_t)rowbytes);
            break;
        case 1:
            for (i = 0; i < bpp && i < rowbytes; i++)
                out[i] = in[i];
            for (; i < rowbytes; i++)
                out[i] = (uint8_t)(in[i] + out[i - bpp]);
            break;
        case 2:
            for (i = 0; i < rowbytes; i++)
                out[i] = (uint8_t)(in[i] + up[i]);
            break;
        case 3:
            for (i = 0; i < bpp && i < rowbytes; i++)
                out[i] = (uint8_t)(in[i] + (up[i] >> 1));
            for (; i < rowbytes; i++)
                out[i] = (uint8_t)(in[i] + ((out[i - bpp] + up[i]) >> 1));
            break;
        case 4:
            for (i = 0; i < bpp && i < rowbytes; i++)
                out[i] = (uint8_t)(in[i] + up[i]);
            for (; i < rowbytes; i++)
                out[i] = (uint8_t)(in[i] + paeth(out[i - bpp], up[i],
                                                 up[i - bpp]));
            break;
        default:
            status = (int)(y + 1);
        }
        up = out;
    }
    free(zero);
    return status;
}
