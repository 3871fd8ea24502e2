/* The colour conversions of TIFF samples for the port's data layer, as
 * libtiff 4.7's RGBA interface makes them for cv2.imread: CIE L*a*b* ->
 * RGB (tif_color.c TIFFCIELabToXYZ / TIFFCIELab16ToXYZ, then TIFFXYZToRGB
 * with tif_getimage.c's sRGB display) in the same float32 steps, so that
 * the result is libtiff's bit for bit, CMYK -> RGB and YCbCr -> RGB.  The
 * gamma ramp (1501 entries), the reference white and the YCbCr tables come
 * from the caller (lgu_slam_tpu_torch/data/tiff.py).
 *
 * Built by the host C compiler at first use (-std=c99: no contraction of
 * a * b + c into a fused multiply-add, which libtiff's build does not do
 * either) and called through ctypes.
 */
#include <stdint.h>

/* the sRGB display's XYZ -> luminance matrix */
static const float MAT[3][3] = {{3.2410F, -1.5374F, -0.4986F},
                                {-0.9692F, 1.8760F, 0.0416F},
                                {0.0556F, -0.2040F, 1.0570F}};

static inline float inverse_f(float t, float white)
{
    return t < 0.2069F ? white * (t - 0.13793F) / 7.787F : white * t * t * t;
}

static inline uint8_t gun(float v, const float *ramp, float step)
{
    v = v > 1.0F ? v : 1.0F; /* the black pixel's residual light */
    v = v < 100.0F ? v : 100.0F;
    int i = (int)((v - 1.0F) / step);
    i = i < 1500 ? i : 1500;
    double r = ramp[i];
    uint32_t c = (uint32_t)(r > 0 ? r + 0.5 : r - 0.5);
    return (uint8_t)(c < 255 ? c : 255);
}

/* n pixels of L*, a*, b* (8-bit: unsigned L, signed a and b, as
 * `bits` 8; 16-bit: uint16 L, int16 a and b in the host's order) ->
 * n RGB triples. */
void tiff_lab_to_rgb(const void *src, int64_t n, int bits, float x0,
                     float y0, float z0, const float *ramp, uint8_t *dst)
{
    const float step = (100.0F - 1.0F) / 1500;
    for (int64_t k = 0; k < n; k++) {
        float L, a, b;
        if (bits == 8) {
            const uint8_t *p = (const uint8_t *)src + 3 * k;
            L = (float)p[0] * 100.0F / 255.0F;
            a = (float)(int8_t)p[1] / 500.0F;
            b = (float)(int8_t)p[2] / 200.0F;
        } else {
            const uint16_t *p = (const uint16_t *)src + 3 * k;
            L = (float)p[0] * 100.0F / 65535.0F;
            a = (float)(int16_t)p[1] / 256.0F / 500.0F;
            b = (float)(int16_t)p[2] / 256.0F / 200.0F;
        }
        float X, Y, Z, cby;
        if (L < 8.856F) {
            Y = (L * y0) / 903.292F;
            cby = 7.787F * (Y / y0) + 16.0F / 116.0F;
        } else {
            cby = (L + 16.0F) / 116.0F;
            Y = y0 * cby * cby * cby;
        }
        X = inverse_f(a + cby, x0);
        Z = inverse_f(cby - b, z0);
        for (int c = 0; c < 3; c++)
            dst[3 * k + c] = gun(MAT[c][0] * X + MAT[c][1] * Y + MAT[c][2] * Z,
                                 ramp, step);
    }
}

/* Separated CMYK -> RGB (tif_getimage.c putRGBcontig8bitCMYKtile): n
 * pixels of C, M, Y, K -> n RGB triples, (255 - K) * (255 - C) / 255
 * truncated. */
void tiff_cmyk_to_rgb(const uint8_t *src, int64_t n, uint8_t *dst)
{
    for (int64_t k = 0; k < n; k++) {
        int black = 255 - src[4 * k + 3];
        for (int c = 0; c < 3; c++)
            dst[3 * k + c] = (uint8_t)(black * (255 - src[4 * k + c]) / 255);
    }
}

static inline uint8_t clamp255(int32_t v)
{
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* YCbCr -> RGB (tif_color.c TIFFYCbCrtoRGB) with the caller's tables of
 * TIFFYCbCrToRGBInit, 256 entries each: Y, Cr -> R, Cb -> B, Cr -> G
 * (times 2^16), Cb -> G (times 2^16, plus one half). */
void tiff_ycbcr_to_rgb(const uint8_t *src, int64_t n, const int32_t *tab,
                       uint8_t *dst)
{
    const int32_t *y_tab = tab, *cr_r = tab + 256, *cb_b = tab + 512;
    const int32_t *cr_g = tab + 768, *cb_g = tab + 1024;
    for (int64_t k = 0; k < n; k++) {
        int32_t y = y_tab[src[3 * k]];
        uint8_t cb = src[3 * k + 1], cr = src[3 * k + 2];
        dst[3 * k] = clamp255(y + cr_r[cr]);
        dst[3 * k + 1] = clamp255(y + ((cb_g[cb] + cr_g[cr]) >> 16));
        dst[3 * k + 2] = clamp255(y + cb_b[cb]);
    }
}
