"""libyuv's ``ScalePlane`` and ``ScalePlane_12``, as libavif 1.4.2's
``avifImageScale`` calls them (with ``kFilterBox``) on each plane of a
frame whose size is not its item's: OpenCV's AVIF reader returns the
scaled image.  The paths are libyuv's, picked as its ``ScalePlane`` picks
them (``ScaleFilterReduce``, then the special ratios, then the general
bilinear and box scalers), each computed as its C row functions compute
it (16.16 fixed-point steps from ``ScaleSlope``).

8-bit samples take ``ScalePlane``, 10- and 12-bit ones ``ScalePlane_12``
(which differs from the 8-bit scaler in its column filter's 16-bit
fraction and in taking the C rows of 3/4 and 3/8 throughout).  The 2x
upsampling rows serve libavif's chroma upsampling too (``avif.py``).
"""

from __future__ import annotations

import numpy as np

NONE, LINEAR, BILINEAR, BOX = range(4)


def _reduce(sw: int, sh: int, dw: int, dh: int) -> int:
    """libyuv's ScaleFilterReduce of kFilterBox, the filter libavif
    passes."""
    f = BOX
    if dw * 2 >= sw or dh * 2 >= sh:
        f = BILINEAR
    if f == BILINEAR:
        if sh == 1 or dh == sh or dh * 3 == sh:
            f = LINEAR
        if sw == 1:
            f = NONE
    if f == LINEAR and (sw == 1 or dw == sw or dw * 3 == sw):
        f = NONE
    return f


def _div(num: int, div: int) -> int:
    return (num << 16) // div


def _div1(num: int, div: int) -> int:
    return ((num << 16) - 0x00010001) // (div - 1)


def _slope(sw: int, sh: int, dw: int, dh: int, f: int) -> tuple:
    """libyuv's ScaleSlope: (x, y, dx, dy), 16.16 fixed point."""
    if dw == 1 and sw >= 32768:
        dw = sw
    if dh == 1 and sh >= 32768:
        dh = sh
    x = y = dx = dy = 0
    if f == BOX:
        return 0, 0, _div(sw, dw), _div(sh, dh)
    if f in (BILINEAR, LINEAR):
        if dw <= sw:
            dx = _div(sw, dw)
            x = (dx >> 1) - 32768
        elif sw > 1 and dw > 1:
            dx = _div1(sw, dw)
        if f == LINEAR:
            dy = _div(sh, dh)
            return x, dy >> 1, dx, dy
        if dh <= sh:
            dy = _div(sh, dh)
            y = (dy >> 1) - 32768
        elif sh > 1 and dh > 1:
            dy = _div1(sh, dh)
        return x, y, dx, dy
    dx, dy = _div(sw, dw), _div(sh, dh)
    return dx >> 1, dy >> 1, dx, dy


def _interp(a: np.ndarray, b: np.ndarray, f) -> np.ndarray:
    """InterpolateRow_C / _16_C: (a (256 - f) + b f + 128) >> 8 per row."""
    f = np.asarray(f, np.int64).reshape(-1, 1)
    return np.where(f == 0, a, (a * (256 - f) + b * f + 128) >> 8)


def _cols(rows: np.ndarray, dw: int, x: int, dx: int, wide: bool
          ) -> np.ndarray:
    """ScaleFilterCols_C (a 7-bit fraction) or ScaleFilterCols_16_C (16
    bits) of each row."""
    xs = x + dx * np.arange(dw, dtype=np.int64)
    xi = xs >> 16
    a = rows[:, xi]
    b = rows[:, np.minimum(xi + 1, rows.shape[1] - 1)]
    if wide:
        return a + (((xs & 0xFFFF) * (b - a) + 0x8000) >> 16)
    return a + ((((xs & 0xFFFF) >> 9) * (b - a) + 0x40) >> 7)


def _bilinear_down(src, dw, dh, f, wide):
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    ys = np.minimum(y + dy * np.arange(dh, dtype=np.int64), max_y)
    yi = ys >> 16
    if f == LINEAR:
        rows = src[yi]
    else:
        rows = _interp(src[yi], src[np.minimum(yi + 1, sh - 1)],
                       (ys >> 8) & 255)
    return _cols(rows, dw, x, dx, wide)


def _bilinear_up(src, dw, dh, f, wide):
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    cols = _cols(src, dw, x, dx, wide)
    ys = np.minimum(y + dy * np.arange(dh, dtype=np.int64), max_y)
    yi = ys >> 16
    if f == LINEAR:
        return cols[yi]
    return _interp(cols[yi], cols[np.minimum(yi + 1, sh - 1)],
                   (ys >> 8) & 255)


def _vertical(src, dh, f):
    """ScalePlaneVertical (the width unchanged): its last rows clamp to
    (sh - 1) << 16 less one."""
    sh, sw = src.shape
    if dh <= sh:
        dy = _div(sh, dh)
        y = (dy >> 1) - 32768
    else:
        dy = _div1(sh, dh) if sh > 1 and dh > 1 else 0
        y = 0
    max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
    ys = np.minimum(y + dy * np.arange(dh, dtype=np.int64), max_y)
    yi = ys >> 16
    yf = (ys >> 8) & 255 if f else np.zeros_like(ys)
    return _interp(src[yi], src[np.minimum(yi + 1, sh - 1)], yf)


def _box(src, dw, dh):
    """ScalePlaneBox: each output the truncated mean of its box (a sum
    times 65536 / area, >> 16)."""
    sh, sw = src.shape
    _, _, dx, dy = _slope(sw, sh, dw, dh, BOX)
    out = np.empty((dh, dw), np.int64)
    y = 0
    csum = np.concatenate([np.zeros((1, sw), np.int64),
                           np.cumsum(src, 0)], 0)
    xs = dx * np.arange(dw + 1, dtype=np.int64)
    ix = xs[:-1] >> 16
    for j in range(dh):
        iy = y >> 16
        y = min(y + dy, sh << 16)
        bh = max((y >> 16) - iy, 1)
        row = csum[iy + bh] - csum[iy]
        rsum = np.concatenate([[0], np.cumsum(row)])
        if dx & 0xFFFF:
            bw = np.maximum((xs[1:] >> 16) - ix, 1)
            mw = dx >> 16
            scale = np.where(bw - mw == 0, 65536 // (max(mw, 1) * bh),
                             65536 // (max(mw + 1, 1) * bh))
        elif dx != 0x10000:
            bw = np.full(dw, max(dx >> 16, 1))
            ix = (xs[0] >> 16) + bw * np.arange(dw)
            scale = 65536 // (bw * bh)
        else:
            bw = np.ones(dw, np.int64)
            scale = np.full(dw, 65536 // bh)
        out[j] = ((rsum[ix + bw] - rsum[ix]) * scale) >> 16
    return out


def _down2(src, dw, dh):
    s = src[:2 * dh, :2 * dw]
    return (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
            + 2) >> 2


def _down4(src, dw, dh):
    s = src[:4 * dh, :4 * dw].reshape(dh, 4, dw, 4)
    return (s.sum((1, 3)) + 8) >> 4


def _h34(rows: np.ndarray, n: int) -> np.ndarray:
    """The horizontal 4 -> 3 filter of ScaleRowDown34_*_Box (3 : 1, 1 : 1,
    1 : 3) of ``n`` outputs per row."""
    s = rows[:, :4 * (n // 3)].reshape(len(rows), -1, 4)
    a0 = (s[..., 0] * 3 + s[..., 1] + 2) >> 2
    a1 = (s[..., 1] + s[..., 2] + 1) >> 1
    a2 = (s[..., 2] + s[..., 3] * 3 + 2) >> 2
    return np.stack([a0, a1, a2], -1).reshape(len(rows), -1)


def _avg(a, b):
    """pavgb: (a + b + 1) >> 1."""
    return (a + b + 1) >> 1


def _down34(src, dw, dh, wide):
    """ScalePlaneDown34: rows 0-3 of every 4 -> 3, ScaleRowDown34_0_Box
    (3 : 1 of two rows) and _1_Box (1 : 1).  The C rows filter each row
    along it, then the two together; 8-bit rows take libyuv's SSSE3 ones
    (every 24 outputs; the C rows the rest), which average the two rows
    first (pavgb: 3 : 1 as avg(s, avg(t, s)))."""
    sh = src.shape[0]
    n = 0 if wide else dw - dw % 24
    flt = _h34(src, dw)
    out = np.empty((dh, dw), np.int64)
    r = 0
    for j in range(dh):
        k = j % 3
        last = j == dh - 1 and dh % 3 and (dh % 3 == 1 or k == 1)
        s_, t_ = (r + 1, r) if k == 2 else (r, r if last else min(
            r + 1, sh - 1))
        a, b = flt[s_], flt[t_]
        out[j] = (a * 3 + b + 2) >> 2 if k != 1 else (a + b + 1) >> 1
        if n:
            vs, vt = src[s_:s_ + 1], src[t_:t_ + 1]
            v = _avg(vs, _avg(vt, vs)) if k != 1 else _avg(vs, vt)
            out[j, :n] = _h34(v, n)[0]
        r += 2 if k == 2 else 1
    return out


def _down38(src, dw, dh, wide):
    """ScalePlaneDown38: boxes of 3 x 3, 3 x 2, 2 x 3, 2 x 2 samples, sum *
    (65536 / n) >> 16 (ScaleRowDown38_3_Box / _2_Box).  libyuv's 8-bit
    SSSE3 _2_Box (every 6 outputs; the C row the rest) averages its two
    rows first (pavgb), then sums 3 (or 2) of them times 65536 / 3 (/ 2)."""
    sh = src.shape[0]
    n_simd = 0 if wide else dw - dw % 6
    out = np.empty((dh, dw), np.int64)
    r = 0
    for j in range(dh):
        n = 2 if j % 3 == 2 else 3
        lastrow = j == dh - 1 and dh % 3 and j % 3 < 2 and (
            dh % 3 == 1 or j % 3 == 1)
        rows = src[[r] * n] if lastrow else src[r:r + n]
        r += n
        s = rows[:, :8 * (dw // 3)].reshape(n, -1, 8).sum(0)
        c = [s[:, 0:3].sum(-1), s[:, 3:6].sum(-1), s[:, 6:8].sum(-1)]
        div = [3 * n, 3 * n, 2 * n]
        out[j] = np.stack([(c[k] * (65536 // div[k])) >> 16
                           for k in range(3)], -1).reshape(-1)
        if n == 2 and n_simd:
            v = _avg(rows[0], rows[1])[:8 * (n_simd // 3)].reshape(-1, 8)
            out[j, :n_simd] = np.stack([
                (v[:, 0:3].sum(-1) * (65536 // 3)) >> 16,
                (v[:, 3:6].sum(-1) * (65536 // 3)) >> 16,
                (v[:, 6:8].sum(-1) * (65536 // 2)) >> 16], -1).reshape(-1)
    return out


def up2_bilinear(c: np.ndarray, H: int, W: int) -> np.ndarray:
    """libyuv's bilinear 2x chroma upsampling of a 4:2:0 plane (its
    ScaleRowUp2_Linear / _Bilinear rows and their edge rules, as
    I420ToARGBMatrixFilter uses them): each sample (9 near + 3 + 3 + 1
    diagonal + 8) >> 4 of the chroma samples around it, the first and last
    column (and the first row, and an even height's last) taking only the
    near sample in that direction; one rounding, as libyuv's (the weights
    are applied along rows, then columns, before it)."""
    rn, rf, rwn, rwf = _taps(H, H % 2 == 0)
    cn, cf, cwn, cwf = _taps(W, True)
    c = c.astype(np.int32)
    rows = c[:, cn] * cwn.astype(np.int32) + c[:, cf] * cwf.astype(np.int32)
    return (rows[rn] * rwn[:, None].astype(np.int32) + rows[rf]
            * rwf[:, None].astype(np.int32) + 8) >> 4


def _taps(n: int, last: bool) -> tuple:
    """(near, far, near weight, far weight) of each of ``n`` upsampled
    positions: 3 and 1, the first (and with ``last`` the last) the near
    sample alone (4 and 0)."""
    k = np.arange(n)
    near = np.where(k % 2 == 1, (k - 1) // 2, k // 2)
    edge = (k == 0) | ((k == n - 1) & last)
    far = np.where(edge, near, np.where(k % 2 == 1, near + 1, near - 1))
    return near, far, np.where(edge, 4, 3), np.where(edge, 0, 1)


def up2_linear(c: np.ndarray, W: int) -> np.ndarray:
    """libyuv's linear 2x horizontal chroma upsampling of a 4:2:2 plane
    (ScaleRowUp2_Linear, as I422ToARGBMatrixFilter uses it): (3 near + 1
    far + 2) >> 2, the first and last column the near sample."""
    cn, cf, cwn, cwf = _taps(W, True)
    c = c.astype(np.int32)
    return (c[:, cn] * cwn.astype(np.int32) + c[:, cf] * cwf.astype(np.int32)
            + 2) >> 2


def _up2(src, dw, dh, f):
    """ScalePlaneUp2_Bilinear (9 : 3 : 3 : 1 of the nearest samples) and
    ScalePlaneUp2_Linear (3 : 1 along rows), edges repeated."""
    if f == LINEAR:
        return up2_linear(src, dw).astype(np.int64)
    return up2_bilinear(src, dh, dw).astype(np.int64)


def _simple(src, dw, dh):
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, NONE)
    if sw * 2 == dw and x < 0x8000:
        xi = np.arange(dw) // 2
    else:
        xi = (x + dx * np.arange(dw, dtype=np.int64)) >> 16
    return src[((y + dy * np.arange(dh, dtype=np.int64)) >> 16)][:, xi]


def scale_plane(src: np.ndarray, dw: int, dh: int, wide: bool
                ) -> np.ndarray:
    """``src`` (uint16 samples) scaled to ``dh`` x ``dw`` as libyuv's
    ScalePlane (``wide``: ScalePlane_12) does under kFilterBox."""
    src = np.asarray(src, np.int64)
    sh, sw = src.shape
    f = _reduce(sw, sh, dw, dh)
    if (dw, dh) == (sw, sh):
        out = src
    elif dw == sw and f != BOX:
        out = _vertical(src, dh, f)
    elif (dw <= sw and dh <= sh) and (
            4 * dw == 3 * sw and 4 * dh == 3 * sh) and f:
        out = _down34(src, dw, dh, wide)
    elif dw <= sw and dh <= sh and 2 * dw == sw and 2 * dh == sh and f:
        if f == LINEAR:
            s = src[1 - 1:2 * dh:2, :2 * dw]
            out = (s[:, 0::2] + s[:, 1::2] + 1) >> 1
        else:
            out = _down2(src, dw, dh)
    elif dw <= sw and dh <= sh and 8 * dw == 3 * sw and 8 * dh == 3 * sh \
            and f:
        out = _down38(src, dw, dh, wide)
    elif dw <= sw and dh <= sh and 4 * dw == sw and 4 * dh == sh and \
            f == BOX:
        out = _down4(src, dw, dh)
    elif f == BOX and dh * 2 < sh:
        out = _box(src, dw, dh)
    elif (dw + 1) // 2 == sw and f == LINEAR:
        out = _up2(src, dw, dh, LINEAR)
    elif (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in (BILINEAR,
                                                              BOX):
        out = _up2(src, dw, dh, BILINEAR)
    elif f and dh > sh:
        out = _bilinear_up(src, dw, dh, f, wide)
    elif f:
        out = _bilinear_down(src, dw, dh, f, wide)
    else:
        out = _simple(src, dw, dh)
    return out.astype(np.uint16)
