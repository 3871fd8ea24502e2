"""Multi-view depth consistency filter (port of the JAX package's
``geom/depth_filter.py``; reference: src/droid_kernels.cu:661-775
``depth_filter_kernel``): for each query frame, project every pixel into
6 neighbor frames (i-1..i-3, i+3..i+5) and count in how many the
neighbor's stored disparity agrees with the induced disparity within a
threshold.  Used by the reconstruction export to mask unreliable depth
(visualization.py:102-107, view_reconstruction.py)."""

from __future__ import annotations

import torch

from lgu_slam_tpu_torch.geom.projective import iproj
from lgu_slam_tpu_torch.lie import se3_act4, se3_rel

_NEIGHBOR_OFFSETS = (-1, -2, -3, 3, 4, 5)  # droid_kernels.cu:695


def depth_filter(
    poses: torch.Tensor,
    disps: torch.Tensor,
    intrinsics: torch.Tensor,
    inds: torch.Tensor,
    thresh: torch.Tensor,
) -> torch.Tensor:
    """poses [N,7], disps [N,h,w], intrinsics [4], inds [K] query frames,
    thresh [K] per-frame disparity tolerance.  Returns counts [K, h, w]."""
    N, ht, wd = disps.shape
    K = inds.shape[0]
    fx, fy, cx, cy = intrinsics.unbind()

    X = iproj(disps[inds], intrinsics.expand(K, 4))  # [K, h, w, 4]
    dflat = disps.reshape(N, ht * wd)

    def count_neighbor(off):
        jx = inds + off
        ok_frame = (jx >= 0) & (jx < N)
        jx_safe = torch.clamp(jx, 0, N - 1)
        Gij = se3_rel(poses[inds], poses[jx_safe])
        Xj = se3_act4(Gij[:, None, None, :], X)
        z = Xj[..., 2]
        zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        uj = fx * Xj[..., 0] / zs + cx
        vj = fy * Xj[..., 1] / zs + cy
        dj = Xj[..., 3] / zs  # induced disparity in frame j

        u0 = torch.floor(uj).long()
        v0 = torch.floor(vj).long()
        inb = (u0 >= 0) & (v0 >= 0) & (u0 < wd - 1) & (v0 < ht - 1)
        u0c = torch.clamp(u0, 0, wd - 2)
        v0c = torch.clamp(v0, 0, ht - 2)

        def corner(dv, du):
            idx = (v0c + dv) * wd + (u0c + du)
            vals = torch.gather(dflat[jx_safe], 1,
                                idx.reshape(K, -1)).reshape(idx.shape)
            return torch.abs(1.0 / dj - 1.0 / vals) < thresh[:, None, None]

        agree = corner(0, 0) | corner(0, 1) | corner(1, 0) | corner(1, 1)
        return (agree & inb & ok_frame[:, None, None]).to(torch.float32)

    return sum(count_neighbor(off) for off in _NEIGHBOR_OFFSETS)
