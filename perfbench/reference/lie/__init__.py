"""Quaternion Lie-group library on torch tensors: SE(3) and Sim(3).

Layouts match the JAX package's ``lie`` so trajectories interoperate:

- SE(3):  ``[..., 7]`` = (tx, ty, tz, qx, qy, qz, qw)
- Sim(3): ``[..., 8]`` = SE(3) + scale
- tangent: translation-first ``(v, w)`` (Sim(3): ``(v, w, sigma)``)
"""

from perfbench.reference.lie.se3 import (
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    se3_act,
    se3_act4,
    se3_adjT_apply,
    se3_exp,
    se3_from_matrix,
    se3_identity,
    se3_inv,
    se3_log,
    se3_matrix,
    se3_mul,
    se3_rel,
    se3_retr,
    so3_exp,
    so3_log,
    so3_matrix,
)
from perfbench.reference.lie.sim3 import (
    sim3_act,
    sim3_exp,
    sim3_from_se3,
    sim3_identity,
    sim3_inv,
    sim3_log,
    sim3_mul,
    sim3_scale,
)

__all__ = [k for k in dir() if not k.startswith("_")]
