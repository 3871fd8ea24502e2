"""Quaternion Lie-group library on torch tensors (SE(3) only; Sim(3), which
no ported path uses, comes with slice 5 of the port).

Layouts match the JAX package's ``lie`` so trajectories interoperate:

- SE(3):  ``[..., 7]`` = (tx, ty, tz, qx, qy, qz, qw)
- tangent: translation-first ``(v, w)``
"""

from lgu_slam_tpu_torch.lie.se3 import (
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

__all__ = [k for k in dir() if not k.startswith("_")]
