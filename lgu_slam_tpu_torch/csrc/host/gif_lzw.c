/* GIF LZW decoding for the port's data layer, as OpenCV 5.0's own GIF
 * reader (grfmt_gif.cpp) decodes a frame's image data for cv2.imread.
 *
 * The input is the frame's data sub-blocks joined (their length bytes
 * removed); the output is the first `npix` palette indices.  The reader's
 * rules, which the port's tests measure against cv2.imread:
 *   - codes are LSB first, of min_code_size + 1 bits growing to 12, the
 *     table of 4096 entries; a full table adds no entry and keeps 12-bit
 *     codes until a clear code (a deferred clear);
 *   - a byte is taken when the bits held are fewer than a code's, then
 *     every code the bits hold is decoded; a clear code resets the table,
 *     and so does an end code, which also stops that round (decoding goes
 *     on while data is left: codes held when the data ends stay unread);
 *   - before the image is full, a code past the next free entry, a first
 *     code after a reset that is not a literal, and a code whose string
 *     runs past the last pixel fail the frame;
 *   - after it is full, codes still count their strings' lengths (a code
 *     that is not valid counts 1) without being written; a byte taken
 *     when the count is already past the last pixel fails the frame, and
 *     so does data that ends before the image is full.
 * Every read of the input is bounds-checked.
 *
 * Built by the host C compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/data/gif.py).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define GIF_OK 0
#define GIF_CORRUPT 1

#define TABLE 4096

int gif_lzw_decode(const uint8_t *src, int64_t n, int min_code_size,
                   int64_t npix, uint8_t *out)
{
    uint16_t prefix[TABLE], length[TABLE];
    uint8_t suffix[TABLE], first[TABLE];
    int clear = 1 << min_code_size, eoi = clear + 1, next = clear + 2;
    int width = min_code_size + 1, prev = -1, i, left = 0;
    uint32_t bits = 0;
    int64_t pos = 0, idx = 0;
    if (min_code_size < 2 || min_code_size > 11)
        return GIF_CORRUPT;
    for (i = 0; i < clear; ++i) {
        prefix[i] = 0xffff;
        suffix[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    while (pos < n) {
        if (idx > npix)
            return GIF_CORRUPT;
        if (left < width) {
            bits |= (uint32_t)src[pos++] << left;
            left += 8;
        }
        while (left >= width) {
            int code = (int)(bits & ((1u << width) - 1)), len, c;
            bits >>= width;
            left -= width;
            if (code == clear || code == eoi) {
                next = clear + 2;
                width = min_code_size + 1;
                prev = -1;
                if (code == eoi)
                    break;
                continue;
            }
            if ((prev < 0 && code >= clear) || code > next) {
                if (idx < npix)
                    return GIF_CORRUPT;
                ++idx; /* past the image: counted, not written */
                continue;
            }
            if (prev >= 0 && next < TABLE) {
                /* the entry the previous code's string and this code's
                 * first byte make (KwKwK: this code is that entry) */
                prefix[next] = (uint16_t)prev;
                suffix[next] = first[code == next ? prev : code];
                first[next] = first[prev];
                length[next] = (uint16_t)(length[prev] + 1);
                ++next;
                if (next == (1 << width) && width < 12)
                    ++width;
            }
            len = length[code];
            if (idx < npix) {
                if (idx + len > npix)
                    return GIF_CORRUPT;
                for (c = code, i = len - 1; i >= 0; c = prefix[c], --i)
                    out[idx + i] = suffix[c];
            }
            idx += len;
            prev = code;
        }
    }
    return idx >= npix ? GIF_OK : GIF_CORRUPT;
}
