"""SE(3) / SO(3) quaternion ops on torch tensors.

Port of the JAX package's ``lie/se3.py`` with the same conventions:

- quaternion layout (x, y, z, w), Hamilton product, unit norm;
- SE(3) element ``g = [t(3), q(4)]`` acts on points as ``x' = R(q) x + t``;
- tangent vector ``xi = [v(3), w(3)]`` (translation first);
- retraction is left-multiplicative: ``retr(g, xi) = exp(xi) * g``.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------

def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, layout (x, y, z, w)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by unit quaternion q: R(q) v."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def so3_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from unit quaternion; shape [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


# ---------------------------------------------------------------------------
# SO(3) exp / log with small-angle series
# ---------------------------------------------------------------------------

def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector [..., 3] -> unit quaternion [..., 4]."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    half = 0.5 * theta
    small = theta_sq < 1e-8
    s = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    c = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([s * w, c], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Log map: unit quaternion -> rotation vector [..., 3]."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qv = qv * sign
    qw = qw * sign
    nv_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    nv = torch.sqrt(torch.clamp(nv_sq, min=1e-24))
    angle = 2.0 * torch.atan2(nv, qw)
    small = nv_sq < 1e-8
    factor = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS), angle / nv)
    return factor * qv


def _so3_left_jacobian_terms(w: torch.Tensor):
    """Coefficients (A, B) of V = I + A [w]x + B [w]x^2."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < 1e-8
    A = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    B = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    return A, B


def _apply_V(w: torch.Tensor, v: torch.Tensor,
             inverse: bool = False) -> torch.Tensor:
    """Apply the SO(3) left Jacobian V(w) (or its inverse) to v."""
    A, B = _so3_left_jacobian_terms(w)
    wxv = _cross(w, v)
    wxwxv = _cross(w, wxv)
    if not inverse:
        return v + A * wxv + B * wxwxv
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < 1e-8
    half = 0.5 * theta
    cot = torch.where(
        small, 1.0,
        half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-20),
    )
    C = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - cot) / torch.clamp(theta_sq, min=1e-24))
    return v - 0.5 * wxv + C * wxwxv


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    return g


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """exp: twist [..., 6] (v, w) -> SE(3) element [..., 7]."""
    v, w = xi[..., :3], xi[..., 3:6]
    return torch.cat([_apply_V(w, v), so3_exp(w)], dim=-1)


def se3_log(g: torch.Tensor) -> torch.Tensor:
    """log: SE(3) element -> twist [..., 6] (v, w)."""
    t, q = g[..., :3], g[..., 3:7]
    w = so3_log(q)
    return torch.cat([_apply_V(w, t, inverse=True), w], dim=-1)


def se3_inv(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:7]
    qi = quat_conj(q)
    return torch.cat([-quat_rotate(qi, t), qi], dim=-1)


def se3_mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Group composition g1 * g2 (apply g2 first)."""
    t1, q1 = g1[..., :3], g1[..., 3:7]
    t2, q2 = g2[..., :3], g2[..., 3:7]
    return torch.cat([quat_rotate(q1, t2) + t1, quat_mul(q1, q2)], dim=-1)


def se3_rel(gi: torch.Tensor, gj: torch.Tensor) -> torch.Tensor:
    """Relative transform g_ij = g_j * g_i^{-1}."""
    return se3_mul(gj, se3_inv(gi))


def se3_act(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Act on 3-D points: x' = R x + t."""
    return quat_rotate(g[..., 3:7], x) + g[..., :3]


def se3_act4(g: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Act on homogeneous-depth points (X, Y, Z, D): (R X[:3] + D t, D)."""
    t, q = g[..., :3], g[..., 3:7]
    p = quat_rotate(q, X[..., :3]) + X[..., 3:4] * t
    return torch.cat([p, X[..., 3:4]], dim=-1)


def se3_adjT_apply(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = Ad_g^T x for twists x = [a, b]: [R^T a; R^T (b - t x a)]."""
    t, q = g[..., :3], g[..., 3:7]
    a, b = x[..., :3], x[..., 3:6]
    qi = quat_conj(q)
    return torch.cat(
        [quat_rotate(qi, a), quat_rotate(qi, b - _cross(t, a))], dim=-1
    )


def se3_retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: exp(xi) * g."""
    return se3_mul(se3_exp(xi), g)


def se3_matrix(g: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix."""
    t, q = g[..., :3], g[..., 3:7]
    top = torch.cat([so3_matrix(q), t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype,
                          device=g.device).expand(t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(T: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`se3_matrix` (batched, numerically safe)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + tr, min=1e-12))
    qx = 0.5 * torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12))
    qy = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12))
    qz = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12))

    def sgn(d):
        return torch.sign(torch.where(d == 0, torch.ones_like(d), d))

    qx = qx * sgn(m21 - m12)
    qy = qy * sgn(m02 - m20)
    qz = qz * sgn(m10 - m01)
    q = quat_normalize(torch.stack([qx, qy, qz, qw], dim=-1))
    return torch.cat([t, q], dim=-1)
