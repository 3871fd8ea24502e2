/* CCITT decoding of 1-bit TIFF strips and tiles for the port's data layer,
 * as libtiff 4.7 (tif_fax3.c, tif_fax3.h) decodes them for cv2.imread:
 * modified Huffman runs without EOLs (compression 2, byte-aligned rows;
 * 32771, 16-bit aligned rows), T.4 Group 3 (compression 3, 1-D, or 2-D
 * READ where T4Options bit 0 is set, each row after an EOL) and T.6
 * Group 4 (compression 4).
 *
 * Rows come out packed, most significant bit first, a black pixel 1 and a
 * white pixel 0, `rowbytes` bytes a row.  Damaged data is decoded as
 * libtiff decodes it: a code that is not in a table ends the row (the rest
 * of it white, or black where the last run was white), a row that runs
 * out of data is filled the same way and ends the strip, and a run table
 * that would overflow ends the strip before its row is written; rows the
 * decoder never reached are left as the caller gave them (zeros).
 *
 * The run arrays persist across the strips of an image, as libtiff's do
 * (a reference row reads stale entries past its end), and so does a
 * Group 3 file's switch to reading without EOLs: the caller hands in one
 * state for the whole image (ccitt_state_size).
 *
 * Built by the host C compiler at first use and called through ctypes
 * (lgu_slam_tpu_torch/data/tiff.py).
 */
#include <stdint.h>
#include <string.h>

#define CCITT_OK 0
#define CCITT_ERROR 1

/* table entry states (libtiff's mkg3states.c) */
enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
       S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

typedef struct {
    uint8_t state;
    uint8_t width;
    uint16_t param;
} tabent;

static tabent main_tab[128], white_tab[4096], black_tab[8192];

/* the T.4 code words, most significant bit first, for runs of 0, 1, ...
 * (terminating), 64, 128, ... (make-up) and 1792, 1856, ... (the make-up
 * codes both colours share) */
static const char *const TERM_W[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
static const char *const MAKEUP_W[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
static const char *const TERM_B[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
static const char *const MAKEUP_B[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
static const char *const MAKEUP_X[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

/* Every index of a `size`-bit table whose low bits (read first) are the
 * code: the tables are indexed by bits in the order they are read, the
 * first in bit 0 (mkg3states.c FillTable). */
static void fill(tabent *t, int size, const char *code, int state, int param)
{
    int width = (int)strlen(code), lsb = 0;
    for (int i = 0; i < width; i++)
        lsb |= (code[i] == '1') << i;
    for (int k = lsb; k < 1 << size; k += 1 << width) {
        t[k].state = (uint8_t)state;
        t[k].width = (uint8_t)width;
        t[k].param = (uint16_t)param;
    }
}

__attribute__((constructor)) static void build_tables(void)
{
    static const struct { const char *code; int state, param; } modes[] = {
        {"0001", S_Pass, 0}, {"001", S_Horiz, 0}, {"1", S_V0, 0},
        {"011", S_VR, 1}, {"000011", S_VR, 2}, {"0000011", S_VR, 3},
        {"010", S_VL, 1}, {"000010", S_VL, 2}, {"0000010", S_VL, 3},
        {"0000001", S_Ext, 0}, {"0000000", S_EOL, 0}};
    for (size_t i = 0; i < sizeof modes / sizeof modes[0]; i++)
        fill(main_tab, 7, modes[i].code, modes[i].state, modes[i].param);
    for (int i = 0; i < 27; i++) {
        fill(white_tab, 12, MAKEUP_W[i], S_MakeUpW, 64 * (i + 1));
        fill(black_tab, 13, MAKEUP_B[i], S_MakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; i++) {
        fill(white_tab, 12, MAKEUP_X[i], S_MakeUp, 1792 + 64 * i);
        fill(black_tab, 13, MAKEUP_X[i], S_MakeUp, 1792 + 64 * i);
    }
    for (int i = 0; i < 64; i++) {
        fill(white_tab, 12, TERM_W[i], S_TermW, i);
        fill(black_tab, 13, TERM_B[i], S_TermB, i);
    }
    /* eleven zeros: an EOL, whose final 1 bit is left to the next row's
     * synchronisation */
    fill(white_tab, 12, "00000000000", S_EOL, 0);
    fill(black_tab, 13, "00000000000", S_EOL, 0);
}

/* The run-array length libtiff allocates per row (Fax3SetupState):
 * rowpixels + 1 rounded up to 32, doubled for 2-D coding.  The state
 * holds a flag (Group 3 read without EOLs), two such arrays (this row,
 * the reference row) and two spare entries. */
int64_t ccitt_nruns(int64_t rowpixels, int two_d)
{
    int64_t n = (rowpixels + 1 + 31) / 32 * 32;
    return two_d ? 2 * n : n;
}

int64_t ccitt_state_size(int64_t rowpixels, int two_d)
{
    return 2 * ccitt_nruns(rowpixels, two_d) + 3;
}

/* libtiff's _TIFFFax3fillruns: white runs as 0 bits, black as 1, each
 * clipped to the row (and the clipped length written back, which is what
 * the next row then refers to). */
static void fill_runs(uint8_t *buf, uint32_t *runs, uint32_t *erun,
                      uint32_t lastx)
{
    if ((erun - runs) & 1)
        *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        for (int colour = 0; colour < 2; colour++) {
            uint32_t run = runs[colour];
            if (x + run > lastx || run > lastx)
                run = runs[colour] = lastx - x;
            if (!run)
                continue;
            for (uint32_t k = x; k < x + run; k++) {
                if (colour)
                    buf[k >> 3] |= (uint8_t)(0x80 >> (k & 7));
                else
                    buf[k >> 3] &= (uint8_t)~(0x80 >> (k & 7));
            }
            x += runs[colour];
        }
    }
}

typedef struct {
    const uint8_t *cp, *ep;
    const uint8_t *base; /* for the 16-bit alignment of RLEW rows */
    int64_t base_odd;
    uint32_t acc;
    int avail;
    int reverse;
} bits_t;

static uint8_t rev8(uint8_t b)
{
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

static inline uint32_t next_byte(bits_t *s)
{
    uint8_t b = *s->cp++;
    return s->reverse ? rev8(b) : b;
}

/* NeedBits8 / NeedBits16: at least n bits, or zeros past the data's end
 * (0: no bits left at all) */
static inline int need8(bits_t *s, int n)
{
    if (s->avail < n) {
        if (s->cp >= s->ep) {
            if (s->avail == 0)
                return 0;
            s->avail = n;
        } else {
            s->acc |= next_byte(s) << s->avail;
            s->avail += 8;
        }
    }
    return 1;
}

static inline int need16(bits_t *s, int n)
{
    if (s->avail < n) {
        if (s->cp >= s->ep) {
            if (s->avail == 0)
                return 0;
            s->avail = n;
        } else {
            s->acc |= next_byte(s) << s->avail;
            if ((s->avail += 8) < n) {
                if (s->cp >= s->ep) {
                    s->avail = n;
                } else {
                    s->acc |= next_byte(s) << s->avail;
                    s->avail += 8;
                }
            }
        }
    }
    return 1;
}

#define GETBITS(n) (s->acc & ((1u << (n)) - 1))
#define CLRBITS(n)       \
    do {                 \
        s->avail -= (n); \
        s->acc >>= (n);  \
    } while (0)
#define LOOKUP8(wid, tab, eoflab)  \
    do {                           \
        if (!need8(s, wid))        \
            goto eoflab;           \
        te = &tab[GETBITS(wid)];   \
        CLRBITS(te->width);        \
    } while (0)
#define LOOKUP16(wid, tab, eoflab) \
    do {                           \
        if (!need16(s, wid))       \
            goto eoflab;           \
        te = &tab[GETBITS(wid)];   \
        CLRBITS(te->width);        \
    } while (0)

/* a run into this row's array; past its end libtiff stops the strip */
#define SETVALUE(x)                          \
    do {                                     \
        if (pa >= thisrun + nruns)           \
            goto overflow;                   \
        *pa++ = (uint32_t)(runlength + (x)); \
        a0 += (x);                           \
        runlength = 0;                       \
    } while (0)

/* the row's runs made to cover it exactly (CLEANUP_RUNS) */
#define CLEANUP_RUNS()                                     \
    do {                                                   \
        if (runlength)                                     \
            SETVALUE(0);                                   \
        if (a0 != lastx) {                                 \
            while (a0 > lastx && pa > thisrun)             \
                a0 -= (int)*--pa;                          \
            if (a0 < lastx) {                              \
                if (a0 < 0)                                \
                    a0 = 0;                                \
                if ((pa - thisrun) & 1)                    \
                    SETVALUE(0);                           \
                SETVALUE(lastx - a0);                      \
            } else if (a0 > lastx) {                       \
                SETVALUE(lastx);                           \
                SETVALUE(0);                               \
            }                                              \
        }                                                  \
    } while (0)

/* SYNC_EOL: skip to the 1 bit that ends an EOL (its eleven zeros first,
 * unless the last row ended on one), then past it.  Where the data ends
 * while zero bytes are skipped, libtiff 4.7 takes the strip for Group 3
 * written without EOLs: from then on (this image's later strips too) no
 * row looks for one, and this row is decoded again from the strip's
 * first bit ("Try to decode (read) fax Group 3 data without EOL"). */
#define SYNC_EOL(eoflab, retrylab)                 \
    do {                                           \
        if (state[0])                              \
            break;                                 \
        if (eolcnt == 0) {                         \
            for (;;) {                             \
                if (!need16(s, 11))                \
                    goto eoflab;                   \
                if (GETBITS(11) == 0)              \
                    break;                         \
                CLRBITS(1);                        \
            }                                      \
        }                                          \
        for (;;) {                                 \
            if (!need8(s, 8))                      \
                goto noeol##retrylab;              \
            if (GETBITS(8))                        \
                break;                             \
            CLRBITS(8);                            \
        }                                          \
        while (GETBITS(1) == 0)                    \
            CLRBITS(1);                            \
        CLRBITS(1);                                \
        eolcnt = 0;                                \
        break;                                     \
    noeol##retrylab:                               \
        state[0] = 1;                              \
        s->cp = s->base;                           \
        s->acc = 0;                                \
        s->avail = 0;                              \
        goto retrylab;                             \
    } while (0)

/* one row of white and black modified Huffman runs (EXPAND1D) */
#define EXPAND1D(eoflab)                                      \
    do {                                                      \
        for (;;) {                                            \
            for (;;) {                                        \
                LOOKUP16(12, white_tab, eof1d##eoflab);       \
                switch (te->state) {                          \
                case S_EOL:                                   \
                    eolcnt = 1;                               \
                    goto done1d##eoflab;                      \
                case S_TermW:                                 \
                    SETVALUE(te->param);                      \
                    goto donewhite1d##eoflab;                 \
                case S_MakeUpW:                               \
                case S_MakeUp:                                \
                    a0 += te->param;                          \
                    runlength += te->param;                   \
                    break;                                    \
                default:                                      \
                    goto done1d##eoflab;                      \
                }                                             \
            }                                                 \
        donewhite1d##eoflab:                                  \
            if (a0 >= lastx)                                  \
                goto done1d##eoflab;                          \
            for (;;) {                                        \
                LOOKUP16(13, black_tab, eof1d##eoflab);       \
                switch (te->state) {                          \
                case S_EOL:                                   \
                    eolcnt = 1;                               \
                    goto done1d##eoflab;                      \
                case S_TermB:                                 \
                    SETVALUE(te->param);                      \
                    goto doneblack1d##eoflab;                 \
                case S_MakeUpB:                               \
                case S_MakeUp:                                \
                    a0 += te->param;                          \
                    runlength += te->param;                   \
                    break;                                    \
                default:                                      \
                    goto done1d##eoflab;                      \
                }                                             \
            }                                                 \
        doneblack1d##eoflab:                                  \
            if (a0 >= lastx)                                  \
                goto done1d##eoflab;                          \
            if (*(pa - 1) == 0 && *(pa - 2) == 0)             \
                pa -= 2;                                      \
        }                                                     \
    eof1d##eoflab:                                            \
        CLEANUP_RUNS();                                       \
        goto eoflab;                                          \
    done1d##eoflab:                                           \
        CLEANUP_RUNS();                                       \
    } while (0)

/* b1 moved past a0 on the reference row (CHECK_b1) */
#define CHECK_B1                                        \
    do {                                                \
        if (pa != thisrun)                              \
            while (b1 <= a0 && b1 < lastx) {            \
                if (pb + 1 >= refruns + nruns)          \
                    goto overflow;                      \
                b1 += (int)(pb[0] + pb[1]);             \
                pb += 2;                                \
            }                                           \
    } while (0)

/* one run of `colour` (0 white, 1 black) in horizontal mode */
#define HRUN(tab, wid, term, makeup, bad, done, eof) \
    for (;;) {                                    \
        LOOKUP16(wid, tab, eof);                  \
        switch (te->state) {                      \
        case term:                                \
            SETVALUE(te->param);                  \
            goto done;                            \
        case makeup:                              \
        case S_MakeUp:                            \
            a0 += te->param;                      \
            runlength += te->param;               \
            break;                                \
        default:                                  \
            goto bad;                             \
        }                                         \
    }                                             \
    done:

/* one row of 2-D READ codes against the reference row (EXPAND2D) */
#define EXPAND2D(eoflab, id)                                                  \
    do {                                                                  \
        while (a0 < lastx) {                                              \
            if (pa >= thisrun + nruns)                                    \
                goto overflow;                                            \
            LOOKUP8(7, main_tab, eof2d##id);                                  \
            switch (te->state) {                                          \
            case S_Pass:                                                  \
                CHECK_B1;                                                 \
                if (pb + 1 >= refruns + nruns)                            \
                    goto overflow;                                        \
                b1 += (int)*pb++;                                         \
                runlength += b1 - a0;                                     \
                a0 = b1;                                                  \
                b1 += (int)*pb++;                                         \
                break;                                                    \
            case S_Horiz:                                                 \
                if ((pa - thisrun) & 1) {                                 \
                    HRUN(black_tab, 13, S_TermB, S_MakeUpB, badblack2d##id,   \
                         hb1##id, eof2d##id)                                             \
                    HRUN(white_tab, 12, S_TermW, S_MakeUpW, badwhite2d##id,   \
                         hw1##id, eof2d##id)                                             \
                } else {                                                  \
                    HRUN(white_tab, 12, S_TermW, S_MakeUpW, badwhite2d##id,   \
                         hw2##id, eof2d##id)                                             \
                    HRUN(black_tab, 13, S_TermB, S_MakeUpB, badblack2d##id,   \
                         hb2##id, eof2d##id)                                             \
                }                                                         \
                CHECK_B1;                                                 \
                break;                                                    \
            case S_V0:                                                    \
                CHECK_B1;                                                 \
                SETVALUE(b1 - a0);                                        \
                if (pb >= refruns + nruns)                                \
                    goto overflow;                                        \
                b1 += (int)*pb++;                                         \
                break;                                                    \
            case S_VR:                                                    \
                CHECK_B1;                                                 \
                SETVALUE(b1 - a0 + te->param);                            \
                if (pb >= refruns + nruns)                                \
                    goto overflow;                                        \
                b1 += (int)*pb++;                                         \
                break;                                                    \
            case S_VL:                                                    \
                CHECK_B1;                                                 \
                if (b1 < a0 + te->param)                                  \
                    goto eol2d##id;                                           \
                SETVALUE(b1 - a0 - te->param);                            \
                b1 -= (int)*--pb;                                         \
                break;                                                    \
            case S_Ext:                                                   \
                *pa++ = (uint32_t)(lastx - a0);                           \
                goto eol2d##id;                                               \
            case S_EOL:                                                   \
                *pa++ = (uint32_t)(lastx - a0);                           \
                if (!need8(s, 4))                                         \
                    goto eof2d##id;                                           \
                CLRBITS(4);                                               \
                eolcnt = 1;                                               \
                goto eol2d##id;                                               \
            default:                                                      \
            badmain2d##id:                                                    \
            badblack2d##id:                                                   \
            badwhite2d##id:                                                   \
                goto eol2d##id;                                               \
            eof2d##id:                                                        \
                CLEANUP_RUNS();                                           \
                goto eoflab;                                              \
            }                                                             \
        }                                                                 \
        if (runlength) {                                                  \
            if (runlength + a0 < lastx) {                                 \
                if (!need8(s, 1))                                         \
                    goto eof2d##id;                                           \
                if (!GETBITS(1))                                          \
                    goto badmain2d##id;                                       \
                CLRBITS(1);                                               \
            }                                                             \
            SETVALUE(0);                                                  \
        }                                                                 \
    eol2d##id:                                                                \
        CLEANUP_RUNS();                                                   \
    } while (0)

/* Decode one strip or tile of `rows` rows of `lastx` pixels from
 * src[0:n] into dst (rows x rowbytes, zeroed by the caller).
 * scheme: 2 (RLE), 32771 (RLEW), 3 (Group 3; `two_d`: T4Options bit 0),
 * 4 (Group 4).  `reverse`: FillOrder 1 (the bits of each byte are read
 * from the most significant); `base_odd`: whether the data starts at an
 * odd file offset (RLEW aligns rows to even offsets in the file).
 * `state`: ccitt_state_size ints kept across the image's strips, zeroed
 * before the first.  Returns CCITT_OK or CCITT_ERROR (libtiff's -1). */
int ccitt_decode(const uint8_t *src, int64_t n, uint8_t *dst, int64_t rows,
                 int64_t rowpixels, int64_t rowbytes, int scheme, int two_d,
                 int reverse, int base_odd, uint32_t *state)
{
    int use2d = scheme == 4 || (scheme == 3 && two_d);
    int64_t nruns = ccitt_nruns(rowpixels, use2d);
    /* state[0]: Group 3 read without EOLs (SYNC_EOL); the run arrays
     * follow, this row's first at each strip (Fax3PreDecode) */
    uint32_t *runs = state + 1;
    uint32_t *curruns = runs;
    uint32_t *refruns = use2d ? runs + nruns : NULL;
    bits_t bs = {src, src + n, src, base_odd, 0, 0, reverse};
    bits_t *s = &bs;
    const tabent *te;
    int lastx = (int)rowpixels, eolcnt = 0, status = CCITT_OK;
    int a0, runlength, b1 = 0;
    uint32_t *pa, *pb = NULL, *thisrun = curruns;
    int64_t line = 0;
    int start_line = 0;

    if (refruns) { /* the reference row before the first: all white */
        refruns[0] = (uint32_t)rowpixels;
        refruns[1] = 0;
    }
    uint8_t *buf = dst;
    if (scheme == 2 || scheme == 32771) {
        for (; line < rows; line++) {
            a0 = 0;
            runlength = 0;
            pa = thisrun;
            EXPAND1D(eof_rle);
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            int drop = s->avail & (scheme == 2 ? 7 : 15);
            CLRBITS(drop);
            if (scheme == 32771) {
                if (s->avail == 0 && ((s->cp - s->base) + s->base_odd) & 1)
                    s->cp++;
            }
            buf += rowbytes;
            continue;
        eof_rle:
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            status = CCITT_ERROR;
            goto end;
        }
    } else if (scheme == 3 && !two_d) {
        for (; line < rows; line++) {
            a0 = 0;
            runlength = 0;
            pa = thisrun;
            SYNC_EOL(eof_g31, retry_g31);
        retry_g31:
            EXPAND1D(eof_g31);
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            buf += rowbytes;
            continue;
        eof_g31:
            CLEANUP_RUNS();
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            status = CCITT_ERROR;
            goto end;
        }
    } else if (scheme == 3) {
        for (; line < rows; line++) {
            a0 = 0;
            runlength = 0;
            pa = thisrun = curruns;
            SYNC_EOL(eof_g32, retry_g32);
        retry_g32:
            if (!need8(s, 1))
                goto eof_g32;
            int is1d = (int)GETBITS(1);
            CLRBITS(1);
            pb = refruns;
            b1 = (int)*pb++;
            if (is1d)
                EXPAND1D(eof_g32a);
            else
                EXPAND2D(eof_g32a, g3);
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            if (pa < thisrun + nruns)
                SETVALUE(0); /* the imaginary change the next row refers to */
            {
                uint32_t *t = curruns;
                curruns = refruns;
                refruns = t;
            }
            buf += rowbytes;
            continue;
        eof_g32:
            CLEANUP_RUNS();
        eof_g32a:
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            status = CCITT_ERROR;
            goto end;
        }
    } else {
        for (; line < rows; line++) {
            a0 = 0;
            runlength = 0;
            pa = thisrun = curruns;
            pb = refruns;
            b1 = (int)*pb++;
            EXPAND2D(eof_g4, g4);
            if (eolcnt)
                goto eof_g4;
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            SETVALUE(0);
            {
                uint32_t *t = curruns;
                curruns = refruns;
                refruns = t;
            }
            buf += rowbytes;
            continue;
        eof_g4:
            /* the EOFB, or the data's end: the row as far as it went,
             * then the strip ends (an error only on its first row) */
            fill_runs(buf, thisrun, pa, (uint32_t)lastx);
            status = line != start_line ? CCITT_OK : CCITT_ERROR;
            goto end;
        }
    }
end:
    return status;
overflow:
    /* "Buffer overflow": the strip ends, this row unwritten */
    return CCITT_ERROR;
}
