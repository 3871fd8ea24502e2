"""Model FLOPs counted from the configuration's shapes, whatever implements
a layer.

The layer list is LGUNet's (the original model's layout): the feature and
context encoders, the FPN offset heads and the Gaussian mask MLP, the
level-0 correlation product, the correlation taps of the backend's
on-the-fly correlation, the update operator (correlation and flow
encoders, the KAN-biased ConvGRU, the delta / weight heads, GraphAgg) and
the dense bundle adjustment's Schur product.  A multiply-add counts two.
Elementwise work, bilinear sampling, normalisation and the KAN branch on
pooled vectors are left out: they are a small share and have no peak to
be held to.
"""

from __future__ import annotations

C = 128  # feature, hidden and input channels
COR_PLANES = 4 * 7 * 7  # 196 correlation features per pixel


def conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    """A k x k convolution producing [h, w, cout] from cin channels."""
    return 2.0 * h * w * cin * cout * k * k


def encoder(H: int, W: int, out: int) -> float:
    """BasicEncoder on one [H, W, 3] image: 7 x 7 stride-2 stem, three
    stages of two residual blocks (stride 1, 2, 2), 1 x 1 head."""
    h, w = H // 2, W // 2
    f = conv(h, w, 3, 32, 7)
    cin = 32
    for dim, stride in ((32, 1), (64, 2), (128, 2)):
        h, w = h // stride, w // stride
        f += conv(h, w, cin, dim, 3) + conv(h, w, dim, dim, 3)
        if stride != 1 or cin != dim:
            f += conv(h, w, cin, dim, 1)
        f += 2 * conv(h, w, dim, dim, 3)
        cin = dim
    return f + conv(h, w, 128, out, 1)


def offsets(h: int, w: int) -> float:
    """The FPN offset heads of one edge: 3 x 3 convolutions of the 256
    channel feature pair to 98 offsets at 1/8 and at 1/16 resolution."""
    return conv(h, w, 2 * C, 98, 3) + conv(h // 2, w // 2, 2 * C, 98, 3)


def gaussian_mask(h: int, w: int) -> float:
    """GaussianMask.predict of one edge: 256 -> 16 -> 2 + 2 per pixel."""
    return 2.0 * h * w * (2 * C * 16 + 16 * 4)


def volume(h: int, w: int) -> float:
    """The level-0 correlation product of one edge: [P, C] x [C, P]."""
    P = h * w
    return 2.0 * P * P * C


def build_corr(h: int, w: int) -> float:
    """One edge's correlation pyramid (volume path)."""
    return offsets(h, w) + gaussian_mask(h, w) + volume(h, w)


def alt_corr(h: int, w: int) -> float:
    """One edge's on-the-fly correlation (backend): the offsets and a
    128-channel dot per tap (4 levels x 49 taps, and the 9-tap probe)."""
    return offsets(h, w) + 2.0 * h * w * C * (COR_PLANES + 9)


def update_edge(h: int, w: int) -> float:
    """The update operator's per-edge layers."""
    return (conv(h, w, COR_PLANES, C, 1) + conv(h, w, C, C, 3)  # corr enc
            + conv(h, w, 4, C, 7) + conv(h, w, C, 64, 3)  # flow encoder
            + 3 * conv(h, w, C + 2 * C + 64, C, 3)  # GRU z, r, q
            + conv(h, w, C, C, 1)  # GRU pooling gate
            + 2 * (conv(h, w, C, C, 3) + conv(h, w, C, 2, 3))  # delta, weight
            + conv(h, w, C, C, 3))  # GraphAgg conv1


def update_frame(h: int, w: int) -> float:
    """GraphAgg's per-frame layers: conv2, eta and the upsampling mask."""
    return conv(h, w, C, C, 3) + conv(h, w, C, 1, 3) + conv(h, w, C, 576, 1)


def dba_iteration(h: int, w: int, edges: int, slots: int, rows: int,
                  poses: int) -> float:
    """One Gauss-Newton iteration of the dense BA over ``edges`` edges:
    the per-edge Hessian blocks, the Schur product of each of ``slots``
    depth slots over its ``rows`` (padded) rows, [6 rows, HW] x [HW,
    6 rows], and the Cholesky solve of the [6 poses]^2 system."""
    hw = h * w
    return (1250.0 * edges * hw + 2.0 * slots * (6 * rows) ** 2 * hw
            + (6.0 * poses) ** 3 / 3.0)
