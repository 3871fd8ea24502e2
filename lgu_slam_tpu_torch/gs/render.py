"""Differentiable 3-D Gaussian splatting renderer in plain PyTorch (port of
the JAX package's ``gs/render.py``).

The reference's CUDA tile rasterizer
(to3DGS/diff_gaussian_rasterization/cuda_rasterizer/{forward,backward}.cu)
as tensor ops, the way the JAX package writes it:

- EWA projection of 3-D Gaussians to 2-D conics (forward.cu
  ``preprocess``), including the 0.3-pixel low-pass dilation;
- 16x16 tile binning by a device-side sort of (tile, depth-rank) keys with
  a per-Gaussian span x span tile cap and per-tile top-K depth-sorted
  lists;
- front-to-back alpha compositing as a cumulative product over the K list
  (forward.cu ``renderCUDA``), over whole tiles;
- the backward pass is autograd through all of it.  The gathers' backward
  is a scatter-add, which uses atomics on the card, so gradients there are
  not bit-reproducible.

Used with sh_degree=0 and precomputed colors only (executeSlam.py), so SH
evaluation is out of scope.  Depth and silhouette render with the same
weights as (z, z^2) pseudo-colors (slam_helpers.py:172-213).
"""

from __future__ import annotations

import torch

from lgu_slam_tpu_torch.utils.device import to_device

TILE = 16
ALPHA_MIN = 1.0 / 255.0


def quat_to_rotmat_wxyz(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3] (to3DGS convention:
    slam_external build_rotation)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q.split(1, dim=-1)
    r0 = torch.cat(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1
    )
    r1 = torch.cat(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1
    )
    r2 = torch.cat(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
    )
    return torch.stack([r0, r1, r2], dim=-2)


def project_gaussians(means_cam, quats, scales, intr):
    """EWA projection (forward.cu computeCov2D).

    means_cam [N,3] camera-space; quats [N,4] wxyz; scales [N,3];
    intr (fx, fy, cx, cy).  Returns (xy [N,2], depth [N], conic [N,3]
    (a, b, c of inverse cov), radius [N]).
    """
    fx, fy, cx, cy = to_device(intr, means_cam.device).unbind()
    X, Y, Z = means_cam.unbind(-1)
    Zs = torch.clamp(Z, min=1e-6)
    x = fx * X / Zs + cx
    y = fy * Y / Zs + cy

    R = quat_to_rotmat_wxyz(quats)
    M = R * scales[:, None, :]  # R @ diag(s)
    cov3d = M @ M.transpose(1, 2)

    o = torch.zeros_like(Zs)
    J = torch.stack(
        [
            torch.stack([fx / Zs, o, -fx * X / (Zs * Zs)], -1),
            torch.stack([o, fy / Zs, -fy * Y / (Zs * Zs)], -1),
        ],
        dim=-2,
    )  # [N, 2, 3]
    cov2d = J @ cov3d @ J.transpose(1, 2)

    # low-pass dilation (forward.cu: += 0.3)
    a = cov2d[:, 0, 0] + 0.3
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3
    det = torch.clamp(a * c - b * b, min=1e-12)
    conic = torch.stack([c / det, -b / det, a / det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    return torch.stack([x, y], -1), Z, conic, radius


def _composite(g_xy, g_conic, g_op, g_col, g_z, kok, px, py):
    """Front-to-back compositing of each tile's K list over its pixels:
    [t, K, ...] per-Gaussian data, [t, P] pixel coordinates -> image
    [t, P, C], accumulated alpha [t, P], depth [t, P]."""
    d_x = px[:, :, None] + 0.5 - g_xy[:, None, :, 0]
    d_y = py[:, :, None] + 0.5 - g_xy[:, None, :, 1]
    power = -0.5 * (
        g_conic[:, None, :, 0] * d_x * d_x
        + g_conic[:, None, :, 2] * d_y * d_y
    ) - g_conic[:, None, :, 1] * d_x * d_y
    alpha = torch.clamp(
        g_op[:, None, :] * torch.exp(torch.clamp(power, max=0.0)), max=0.99
    )
    alpha = torch.where(kok[:, None, :] & (alpha >= ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))
    # exclusive transmittance, as the JAX package writes it (an exclusive
    # cumprod is the same forward but not the same gradients)
    one_m = 1.0 - alpha
    T_incl = torch.cumprod(one_m, dim=-1)
    T_excl = T_incl / torch.clamp(one_m, min=1e-10)
    wgt = T_excl * alpha  # [t, p, K]
    img = torch.bmm(wgt, g_col)
    acc = torch.sum(wgt, dim=-1)
    dep = torch.bmm(wgt, g_z[:, :, None])[..., 0]
    return img, acc, dep


def render_gaussians(
    means3d,
    quats,
    scales,
    opacities,
    colors,
    alive,
    w2c_rot,
    w2c_trans,
    intr,
    *,
    img_size: tuple,
    span: int = 6,
    k_max: int = 96,
    xy_offset=None,
    with_stats: bool = False,
):
    """Render [H, W, C] image + [H, W] silhouette + [H, W] depth.

    means3d [N,3] world; quats [N,4] wxyz; scales [N,3]; opacities [N];
    colors [N,C]; alive [N] bool mask; w2c_rot [3,3], w2c_trans [3].

    ``span`` caps the tile footprint of one Gaussian at span x span tiles;
    ``k_max`` caps depth-sorted Gaussians per tile.  Both caps TRUNCATE
    silently (the reference rasterizer is exact: rasterizer_impl.cu bins
    every duplicate key); pass ``with_stats=True`` to get drop telemetry
    for them.  All tiles composite in one pass (the JAX package's
    ``tile_chunk`` bounds XLA's buffers; autograd keeps every tile's
    activations whichever way they are split).
    Returns (image, alpha, depth_exp) -- plus a stats dict
    {dropped_pairs_kmax, clamped_radius, max_tile_load} of 0-d tensors
    when ``with_stats``.
    """
    H, W = img_size
    N = means3d.shape[0]
    dev = means3d.device
    n_tx = (W + TILE - 1) // TILE
    n_ty = (H + TILE - 1) // TILE
    n_tiles = n_tx * n_ty
    alive = torch.as_tensor(alive, device=dev)
    w2c_rot = to_device(w2c_rot, dev)
    w2c_trans = to_device(w2c_trans, dev)

    means_cam = means3d @ w2c_rot.T + w2c_trans
    xy, depth, conic, radius = project_gaussians(
        means_cam, quats, scales, intr
    )
    if xy_offset is not None:
        # zero-valued probe: grad wrt xy_offset == dL/dmeans2D, the
        # densification signal (gs_external.accumulate_mean2d_gradient)
        xy = xy + xy_offset

    valid = alive & (depth > 0.01) & (radius > 0)
    radius_cap = (span * TILE) / 2.0 - 1.0
    n_clamped = torch.sum(valid & (radius > radius_cap))
    radius = torch.clamp(radius, max=radius_cap)

    # tile span (no gradient flows through the binning)
    xy_d = xy.detach()
    tx0 = torch.clamp(torch.floor((xy_d[:, 0] - radius) / TILE), 0, n_tx - 1)
    ty0 = torch.clamp(torch.floor((xy_d[:, 1] - radius) / TILE), 0, n_ty - 1)
    tx0 = tx0.long()
    ty0 = ty0.long()

    # depth rank for within-tile ordering (stable, as jnp.argsort)
    order = torch.sort(depth.detach(), stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=dev)

    # (gaussian, tile) pairs: span x span window from (tx0, ty0)
    d = torch.arange(span, device=dev)
    txs = tx0[:, None, None] + d[None, None, :]
    tys = ty0[:, None, None] + d[None, :, None]
    # touch test: tile overlaps the circle(xy, radius)
    tcx = (txs + 0.5) * TILE
    tcy = (tys + 0.5) * TILE
    ddx = torch.clamp(torch.abs(xy_d[:, 0, None, None] - tcx) - TILE / 2,
                      min=0.0)
    ddy = torch.clamp(torch.abs(xy_d[:, 1, None, None] - tcy) - TILE / 2,
                      min=0.0)
    touches = (ddx * ddx + ddy * ddy) <= (radius[:, None, None] ** 2)
    inb = (txs < n_tx) & (tys < n_ty)
    pair_ok = touches & inb & valid[:, None, None]

    tile_id = torch.where(pair_ok, tys * n_tx + txs,
                          torch.full_like(txs, n_tiles))
    # int64 keys: tile * N + rank sorts by tile, then depth, for any N
    key = (tile_id * N + rank[:, None, None]).reshape(-1)
    gid = torch.arange(N, device=dev)[:, None, None].expand(
        tile_id.shape).reshape(-1)

    key_sorted, sort_idx = torch.sort(key, stable=True)
    gid_sorted = gid[sort_idx]
    tile_sorted = torch.div(key_sorted, N, rounding_mode="floor")

    # per-tile ranges
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(n_tiles + 1, device=dev))
    starts, ends = bounds[:-1], bounds[1:]
    tile_load = ends - starts
    dropped_kmax = torch.sum(torch.clamp(tile_load - k_max, min=0))

    # top-K per tile (front-most K by depth)
    kidx = starts[:, None] + torch.arange(k_max, device=dev)[None, :]
    kok = kidx < ends[:, None]
    kidx = torch.clamp(kidx, 0, key.shape[0] - 1)
    tg = gid_sorted[kidx]  # [n_tiles, K]

    # gather per-gaussian data
    g_xy = xy[tg]  # [T, K, 2]
    g_conic = conic[tg]
    g_op = opacities[tg]
    g_col = colors[tg]  # [T, K, C]
    g_z = depth[tg]

    # pixel coordinates per tile
    t_ids = torch.arange(n_tiles, device=dev)
    t_x0 = (t_ids % n_tx) * TILE
    t_y0 = (t_ids // n_tx) * TILE
    lane = torch.arange(TILE, device=dev)
    px = (t_x0[:, None] + lane.repeat(TILE)[None, :]).float()
    py = (t_y0[:, None] + lane.repeat_interleave(TILE)[None, :]).float()

    img, acc, dep = _composite(g_xy, g_conic, g_op, g_col, g_z, kok, px, py)

    def untile(x):
        c = x.shape[-1] if x.dim() == 3 else 1
        x = x.reshape(n_ty, n_tx, TILE, TILE, c)
        x = x.permute(0, 2, 1, 3, 4).reshape(n_ty * TILE, n_tx * TILE, c)
        return x[:H, :W]

    out = (untile(img), untile(acc)[..., 0], untile(dep)[..., 0])
    if with_stats:
        stats = {
            # (gaussian, tile) pairs past the per-tile top-K cap -- these
            # contributions are silently lost (reference is exact)
            "dropped_pairs_kmax": dropped_kmax,
            # Gaussians whose projected radius exceeded the span cap --
            # their far tiles are not covered
            "clamped_radius": n_clamped,
            "max_tile_load": torch.max(tile_load),
        }
        return out + (stats,)
    return out


def render_rgbd(params, alive, w2c_rot, w2c_trans, intr, img_size, **kw):
    """Render RGB + (depth, silhouette, depth^2) as ONE 5-channel pass, so
    the projection, tile binning, key sort and compositing weights are
    computed once (the reference runs the rasterizer twice with identical
    geometry, loss.py:48-58)."""
    means = params["means3D"]
    quats = params["unnorm_rotations"]
    scales = torch.exp(params["log_scales"].repeat(1, 3))
    ops = torch.sigmoid(params["logit_opacities"][:, 0])
    rgb = params["rgb_colors"]

    # depth + depth^2 pseudo-colors share the compositing weights
    w2c_rot = to_device(w2c_rot, means.device)
    w2c_trans = to_device(w2c_trans, means.device)
    zcam = means @ w2c_rot.T + w2c_trans
    z = zcam[:, 2:3]
    cols = torch.cat([rgb, z, z * z], dim=-1)

    out = render_gaussians(
        means, quats, scales, ops, cols, alive, w2c_rot, w2c_trans, intr,
        img_size=img_size, **kw,
    )
    img5, acc = out[0], out[1]
    img = img5[..., :3]
    depth = img5[..., 3]
    depth_sq = img5[..., 4]
    sil = acc
    if kw.get("with_stats"):
        return img, depth, sil, depth_sq, out[3]
    return img, depth, sil, depth_sq
