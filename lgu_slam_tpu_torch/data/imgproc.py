"""The OpenCV image operations of the JAX package's data layer, in numpy on
the host: :func:`resize` (``cv2.resize``, linear and nearest),
:func:`init_undistort_rectify_map` (``cv2.initUndistortRectifyMap``),
:func:`remap` (``cv2.remap``, bilinear, constant border 0) and
:func:`undistort` (``cv2.undistort``).  Sizes are ``(width, height)``, as
OpenCV's ``dsize`` and ``size`` are.

Each follows OpenCV's arithmetic, so that the port's frames equal the JAX
package's bit for bit where the tests measured it
(tests/test_torch_imgproc.py):

- linear resize of ``uint8``: half-pixel centres, no antialiasing, 11-bit
  fixed-point weights (``INTER_RESIZE_COEF_BITS``), the horizontal pass
  exact in integers and the vertical pass rounded as OpenCV's vector code
  rounds it; an exact 2x shrink is a 2 x 2 box mean (OpenCV switches to
  ``INTER_AREA`` there);
- nearest resize: source index ``floor(dst * src / dst_size)``, no
  half-pixel offset (torch's ``"nearest"``, not ``"nearest-exact"``);
- remap with float maps: bilinear in float32 (x, then y), rounded half to
  even (OpenCV 4.11 and later);
- undistort: the map rounded from float64 to 1/32 px, 15-bit bilinear
  weights (OpenCV's fixed-point remap of ``CV_16SC2`` maps);

and taps outside the image read 0.
"""

from __future__ import annotations

import numpy as np

LINEAR, NEAREST = "linear", "nearest"
COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
TAB_BITS = 5  # INTER_BITS: remap positions in 1/32 px
REMAP_BITS = 15  # INTER_REMAP_COEF_BITS


def _linear_taps(dst: int, src: int, clamp: bool):
    """Per output index along one axis: the first source index and the two
    fixed-point weights, as OpenCV's ``resize`` computes them (float32
    fraction; the horizontal axis clamps at both borders, the vertical one
    keeps the fraction and clips its rows)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s = np.clip(s, 0, src - 1)
    one = np.float32(1 << COEF_BITS)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int32)
    w1 = np.rint(f * one).astype(np.int32)
    return s, w0, w1


def _resize_linear_u8(src: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = src.shape[:2]
    if sw == 2 * w and sh == 2 * h:  # INTER_AREA: the 2 x 2 box mean
        s = src.astype(np.int32)
        box = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((box + 2) >> 2).astype(np.uint8)
    xs, a0, a1 = _linear_taps(w, sw, clamp=True)
    ys, b0, b1 = _linear_taps(h, sh, clamp=False)
    extra = (None,) * (src.ndim - 2)
    a0, a1 = a0[(slice(None),) + extra], a1[(slice(None),) + extra]
    # horizontal pass, exact in int32 (at most 255 * 2048 per sample)
    rows = (np.take(src, xs, axis=1).astype(np.int32) * a0
            + np.take(src, np.minimum(xs + 1, sw - 1), axis=1) * a1)
    r0 = np.take(rows, np.clip(ys, 0, sh - 1), axis=0) >> 4
    r1 = np.take(rows, np.clip(ys + 1, 0, sh - 1), axis=0) >> 4
    b0, b1 = b0[(slice(None), None) + extra], b1[(slice(None), None) + extra]
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize(src: np.ndarray, dsize, interpolation: str = LINEAR) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=...)``: ``dsize = (width,
    height)``; ``LINEAR`` takes ``uint8`` images, ``NEAREST`` any dtype."""
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = src.shape[:2]
    if (w, h) == (sw, sh):
        return src.copy()
    if interpolation == NEAREST:
        # OpenCV: floor(x * (1 / (w / sw))), clamped to the last index
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))), sw - 1)
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))), sh - 1)
        return src[ys.astype(np.int64)][:, xs.astype(np.int64)]
    if interpolation != LINEAR:
        raise ValueError(f"interpolation {interpolation!r}")
    if src.dtype != np.uint8:
        raise TypeError(f"linear resize takes uint8 images, not {src.dtype}")
    return _resize_linear_u8(src, w, h)


def _distort_points(x, y, dist):
    """Normalised undistorted -> distorted coordinates under OpenCV's
    radial-tangential model (k1 k2 p1 p2 [k3 [k4 k5 k6]])."""
    k = np.zeros(8)
    k[:len(dist)] = np.asarray(dist, np.float64).reshape(-1)[:8]
    k1, k2, p1, p2, k3, k4, k5, k6 = k
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / \
        (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    return xd, yd


def _source_coords(K, dist, R, P, size, row0: float = 0.0):
    """The float64 source coordinates (u, v) of every output pixel, as
    OpenCV's ``initUndistortRectifyMap`` accumulates them along each row;
    ``row0`` shifts the output rows (``undistort``'s stripes)."""
    w, h = size
    K = np.asarray(K, np.float64)
    Ar = np.asarray(P, np.float64)[:3, :3].copy()
    Ar[1, 2] -= row0
    ir = np.linalg.inv(Ar @ np.asarray(R, np.float64)).reshape(-1)
    i = np.arange(h, dtype=np.float64)[:, None]

    def accumulate(c0, c1, c2):  # _x += ir[0] along the row, sequentially
        return np.cumsum(np.concatenate(
            [i * c1 + c2, np.broadcast_to(c0, (h, w - 1))], axis=1), axis=1)

    _x = accumulate(ir[0], ir[1], ir[2])
    _y = accumulate(ir[3], ir[4], ir[5])
    _w = accumulate(ir[6], ir[7], ir[8])
    inv = 1.0 / _w
    xd, yd = _distort_points(_x * inv, _y * inv, dist)
    return K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]


def init_undistort_rectify_map(K, dist, R, P, size):
    """``cv2.initUndistortRectifyMap(K, dist, R, P, size, cv2.CV_32F)``:
    ``size = (width, height)``; only ``P[:3, :3]`` is used.  Returns the
    float32 maps (map_x, map_y), each ``[height, width]``."""
    u, v = _source_coords(K, dist, R, P, size)
    return u.astype(np.float32), v.astype(np.float32)


PAD = 2  # zero border of the gathered source: corners off the image read it


def _corner_index(x0, y0, src_hw):
    """Flat indices ``[4, ...]`` of the bilinear corners (x0, y0), (x0+1,
    y0), (x0, y0+1), (x0+1, y0+1) in the source zero-padded by ``PAD``;
    corners off the image land in the padding."""
    sh, sw = src_hw
    pw = sw + 2 * PAD
    base = (np.clip(y0, -PAD, sh) + PAD) * pw + np.clip(x0, -PAD, sw) + PAD
    return np.stack([base, base + 1, base + pw, base + pw + 1])


def _corners(src: np.ndarray, index: np.ndarray) -> np.ndarray:
    """The 4 corner values ``[4, h, w, ...]`` of ``src`` at ``index``."""
    pad = ((PAD, PAD), (PAD, PAD)) + ((0, 0),) * (src.ndim - 2)
    flat = np.pad(src, pad).reshape((-1,) + src.shape[2:])
    return np.take(flat, index, axis=0)


class FixedRemap:
    """A remap with positions in 1/32 px and 15-bit bilinear weights
    (OpenCV's remap of fixed-point maps), prepared once for a source size:
    :meth:`__call__` maps one ``uint8`` image."""

    def __init__(self, iu: np.ndarray, iv: np.ndarray, src_hw):
        self.src_hw = tuple(src_hw)
        self.index = _corner_index(iu >> TAB_BITS, iv >> TAB_BITS, src_hw)
        fx, fy = (iu & 31).astype(np.int32), (iv & 31).astype(np.int32)
        # 32 * 32 * 32 = 1 << REMAP_BITS
        self.weights = 32 * np.stack([(32 - fx) * (32 - fy), fx * (32 - fy),
                                      (32 - fx) * fy, fx * fy])

    def __call__(self, src: np.ndarray) -> np.ndarray:
        if src.dtype != np.uint8 or src.shape[:2] != self.src_hw:
            raise ValueError(f"a {self.src_hw} uint8 image, not "
                             f"{src.shape} {src.dtype}")
        v = _corners(src, self.index).astype(np.int32)
        w = self.weights.reshape(self.weights.shape + (1,) * (src.ndim - 2))
        acc = (v * w).sum(axis=0, dtype=np.int32)
        return np.clip((acc + (1 << (REMAP_BITS - 1))) >> REMAP_BITS, 0,
                       255).astype(np.uint8)


class FloatRemap:
    """OpenCV's remap of float32 maps, bilinear in float32 (along x, then
    along y) and rounded half to even, prepared once for a source size:
    :meth:`__call__` maps one ``uint8`` image."""

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray, src_hw):
        x = np.asarray(map_x, np.float32)
        y = np.asarray(map_y, np.float32)
        x0, y0 = np.floor(x), np.floor(y)
        self.src_hw = tuple(src_hw)
        self.a, self.b = x - x0, y - y0
        self.index = _corner_index(x0.astype(np.int64), y0.astype(np.int64),
                                   src_hw)

    def __call__(self, src: np.ndarray) -> np.ndarray:
        if src.dtype != np.uint8 or src.shape[:2] != self.src_hw:
            raise ValueError(f"a {self.src_hw} uint8 image, not "
                             f"{src.shape} {src.dtype}")
        v00, v01, v10, v11 = _corners(src, self.index).astype(np.float32)
        extra = (...,) + (None,) * (src.ndim - 2)
        a, b = self.a[extra], self.b[extra]
        i0 = v00 + a * (v01 - v00)
        i1 = v10 + a * (v11 - v10)
        return np.clip(np.rint(i0 + b * (i1 - i0)), 0, 255).astype(np.uint8)


def remap(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(src, map_x, map_y, cv2.INTER_LINEAR)`` with the default
    constant border 0, for ``uint8`` images and float32 maps (to map many
    frames, prepare a :class:`FloatRemap` once)."""
    return FloatRemap(map_x, map_y, src.shape[:2])(src)


def undistort_maps(K, dist, size) -> FixedRemap:
    """``cv2.undistort``'s remap for images of ``size = (width, height)``:
    the map with ``R = I`` and ``P = K``, built in OpenCV's stripes of
    ``4096 // width`` rows and rounded from float64 to 1/32 px."""
    w, h = size
    stripe = min(max(1, 4096 // max(w, 1)), h)
    iu, iv = [], []
    for y in range(0, h, stripe):
        rows = min(stripe, h - y)
        u, v = _source_coords(K, dist, np.eye(3), K, (w, rows), row0=y)
        iu.append(np.rint(u * (1 << TAB_BITS)).astype(np.int64))
        iv.append(np.rint(v * (1 << TAB_BITS)).astype(np.int64))
    return FixedRemap(np.concatenate(iu), np.concatenate(iv), (h, w))


def undistort(src: np.ndarray, K, dist) -> np.ndarray:
    """``cv2.undistort(src, K, dist)`` (to undistort many frames, prepare
    :func:`undistort_maps` once)."""
    h, w = src.shape[:2]
    return undistort_maps(K, dist, (w, h))(src)
