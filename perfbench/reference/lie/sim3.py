"""Sim(3) ops, scale-augmented SE(3) (port of the JAX package's
``lie/sim3.py``): trajectory alignment and scale-fitted losses.

Layout: ``[..., 8]`` = (tx, ty, tz, qx, qy, qz, qw, s); tangent
``[..., 7]`` = (v, w, sigma) with s = exp(sigma).  Action: x' = s R x + t.
"""

from __future__ import annotations

import torch

from perfbench.reference.lie.se3 import (
    _apply_V,
    quat_conj,
    quat_mul,
    quat_rotate,
    so3_exp,
    so3_log,
)


def sim3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def sim3_from_se3(g: torch.Tensor, s: torch.Tensor | None = None
                  ) -> torch.Tensor:
    if s is None:
        s = torch.ones(g.shape[:-1] + (1,), dtype=g.dtype, device=g.device)
    elif s.ndim == g.ndim - 1:
        s = s[..., None]
    return torch.cat([g, s.expand(g.shape[:-1] + (1,))], dim=-1)


def sim3_mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1, s1 = g1[..., :3], g1[..., 3:7], g1[..., 7:8]
    t2, q2, s2 = g2[..., :3], g2[..., 3:7], g2[..., 7:8]
    q = quat_mul(q1, q2)
    t = s1 * quat_rotate(q1, t2) + t1
    return torch.cat([t, q, s1 * s2], dim=-1)


def sim3_inv(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qi = quat_conj(q)
    si = 1.0 / s
    ti = -si * quat_rotate(qi, t)
    return torch.cat([ti, qi, si], dim=-1)


def sim3_act(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    return s * quat_rotate(q, x) + t


def sim3_scale(g: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply the scale component by ``s``."""
    if s.ndim == g.ndim - 1:
        s = s[..., None]
    return torch.cat([g[..., :7], g[..., 7:8] * s], dim=-1)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """The JAX package's simplified exp: the translation through the SE(3)
    V-matrix, the scale as exp(sigma)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    return torch.cat([_apply_V(w, v), so3_exp(w), torch.exp(sigma)], dim=-1)


def sim3_log(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    w = so3_log(q)
    v = _apply_V(w, t, inverse=True)
    return torch.cat([v, w, torch.log(torch.clamp(s, min=1e-12))], dim=-1)
