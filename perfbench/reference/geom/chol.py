"""Damped Cholesky and Schur-complement solvers of the training BA (port of
the JAX package's ``geom/chol.py``).

A solve that fails returns zeros, without a host branch: the factor of a
system whose ``cholesky_ex`` reports an error, or whose factor is not finite
(NaN input need not set the error), is replaced by the identity before the
triangular solves and the solution is zeroed.  Nothing here synchronises
with the host.
"""

from __future__ import annotations

import torch

EP, LM = 0.1, 1e-4  # damping: ep + lm * diagonal (the reference's values)


def _safe_cho_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H [..., D, D] SPD after damping; b [..., D, K].  Returns x, 0 for
    every system whose factorisation failed."""
    L, info = torch.linalg.cholesky_ex(H)
    ok = (info == 0) & torch.isfinite(L).all(dim=(-2, -1))
    ok = ok[..., None, None]
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    x = torch.cholesky_solve(b, torch.where(ok, L, eye))
    return torch.where(ok, x, torch.zeros_like(x))


def block_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H [B, N, N, D, D] pose-block Hessian, b [B, N, D] -> dx [B, N, D].

    As in the JAX package, the damping ``EP + LM * H`` goes onto the
    diagonal of every D x D block, off-diagonal blocks included."""
    B, N, _, D, _ = H.shape
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    H = H + (EP + LM * H) * eye
    H = H.permute(0, 1, 3, 2, 4).reshape(B, N * D, N * D)
    x = _safe_cho_solve(H, b.reshape(B, N * D, 1))
    return x.reshape(B, N, D)


def schur_solve(H, E, C, v, w):
    """Schur-complement solve of the pose/depth system.

    H [B, P, P, D, D], E [B, P, M, D, HW], C [B, M, HW] (the depth
    diagonal), v [B, P, D], w [B, M, HW].  Returns (dx [B, P, D],
    dz [B, M, HW])."""
    B, P, M, D, HW = E.shape
    H = H.permute(0, 1, 3, 2, 4).reshape(B, P * D, P * D)
    E = E.permute(0, 1, 3, 2, 4).reshape(B, P * D, M * HW)
    Q = (1.0 / C).reshape(B, M * HW, 1)
    eye = torch.eye(P * D, dtype=H.dtype, device=H.device)
    H = H + (EP + LM * H) * eye
    v = v.reshape(B, P * D, 1)
    w = w.reshape(B, M * HW, 1)
    Et = E.transpose(1, 2)
    S = H - torch.matmul(E, Q * Et)
    rhs = v - torch.matmul(E, Q * w)
    dx = _safe_cho_solve(S, rhs)
    dz = Q * (w - torch.matmul(Et, dx))
    return dx.reshape(B, P, D), dz.reshape(B, M, HW)
