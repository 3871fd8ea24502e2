"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where no GPU is
present.  This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX).
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_port import cuda_device, tiny_config_kwargs  # noqa: F401

from lgu_slam_tpu_torch.geom.dba import DbaPlan, dba_step
from lgu_slam_tpu_torch.geom.projective import projective_transform
from lgu_slam_tpu_torch.lie import se3_exp, se3_mul

from lgu_slam_tpu_torch.models.net import init_state_dict
from lgu_slam_tpu_torch.ops.k2_parts import (
    k2_one_level,
    k2_one_level_plain,
    k2_stream_floor,
    k2_stream_floor_plain,
)
from lgu_slam_tpu_torch.ops.masked_corr import (
    masked_corr_level0,
    masked_corr_level0_plain,
)
from lgu_slam_tpu_torch.ops.pyramid_lookup import (
    fused_pyramid_lookup,
    fused_pyramid_lookup_plain,
    level_dims,
)
from lgu_slam_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat, window_deltas
from lgu_slam_tpu_torch.ops.window_lookup import window_lookup
from lgu_slam_tpu_torch.parallel.dba_shard import dba_step_sharded
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.device import use_full_fp32

pytestmark = pytest.mark.cuda


def corr_inputs(gen, E, H, W, dev):
    f1 = torch.randn(E, H, W, 128, generator=gen)
    f2 = torch.randn(E, H, W, 128, generator=gen)
    mean = torch.rand(E, H, W, 2, generator=gen) * torch.tensor([W, H])
    cov = 0.05 + 5 * torch.rand(E, H, W, 2, generator=gen)
    return [x.to(dev) for x in (f1, f2, mean, cov)]


@pytest.mark.parametrize("ehw", [(3, 30, 40), (2, 7, 9), (4, 48, 64)])
def test_masked_corr_kernel(cuda_device, ehw):
    """fp32 out: atol 2e-4 / rtol 1e-4 (a 128-channel dot product summed
    in another order); bf16 out: one bf16 step, |err| / (|ref| + 1) < 0.02."""
    use_full_fp32()
    args = corr_inputs(torch.Generator().manual_seed(0), *ehw, cuda_device)
    n = masked_corr_level0.launches
    out = masked_corr_level0(*args, out_dtype=torch.float32)
    ref = masked_corr_level0_plain(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert masked_corr_level0.launches == n + 1
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-4)
    out = masked_corr_level0(*args, out_dtype=torch.bfloat16).float()
    ref = masked_corr_level0_plain(*args, out_dtype=torch.bfloat16).float()
    assert ((out - ref).abs() / (ref.abs() + 1)).max().item() < 0.02


def edge_inputs(gen, E, H, W, dev):
    """bf16 features; every mean on a window's edge case: a third on an
    integer, a third just below one (floor's edges), the rest anywhere,
    scattered +-3 pixels so that windows cross the kernel's 128-pixel
    tiles; covariances up to 20, so that the Gaussian is felt at the
    window's edge."""
    f1 = torch.randn(E, H, W, 128, generator=gen).bfloat16()
    f2 = torch.randn(E, H, W, 128, generator=gen).bfloat16()
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H),
                                      indexing="xy"), -1).float()
    mean = grid + 3.0 * torch.randn(E, H, W, 2, generator=gen)
    pick = torch.randint(0, 3, (E, H, W, 1), generator=gen)
    mean = torch.where(pick == 0, torch.round(mean), mean)
    mean = torch.where(pick == 1, torch.floor(mean) + 0.999, mean)
    cov = 0.05 + 20.0 * torch.rand(E, H, W, 2, generator=gen) ** 2
    return [x.to(dev) for x in (f1, f2, mean, cov)]


@pytest.mark.parametrize("ehw", [(3, 30, 40), (2, 7, 9), (4, 48, 64)])
def test_masked_corr_bf16_operand_kernel(cuda_device, ehw):
    """The wgmma kernel (bf16 operands) against the plain version, which
    widens them: fp32 out within atol 2e-4 / rtol 1e-4 (the same
    function, summed in another order), bf16 out within one bf16
    step; it counts a launch, a bf16 launch and E edges."""
    args = edge_inputs(torch.Generator().manual_seed(1), *ehw, cuda_device)
    k1 = masked_corr_level0
    before = (k1.launches, k1.launches_bf16, k1.edges)
    out = k1(*args, out_dtype=torch.float32)
    ref = masked_corr_level0_plain(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_bf16, k1.edges) == (
        before[0] + 1, before[1] + 1, before[2] + ehw[0])
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-4)
    out = k1(*args, out_dtype=torch.bfloat16).float()
    ref = masked_corr_level0_plain(*args, out_dtype=torch.bfloat16).float()
    assert ((out - ref).abs() / (ref.abs() + 1)).max().item() < 0.02


def test_masked_corr_dispatch_counts(cuda_device):
    """fp32 operands launch the 3xTF32 kernel: launches, launches_fp32 and
    edges advance, launches_bf16 does not."""
    args = corr_inputs(torch.Generator().manual_seed(3), 2, 4, 6,
                       cuda_device)
    k1 = masked_corr_level0
    before = (k1.launches, k1.launches_bf16, k1.launches_fp32, k1.edges)
    k1(*args)
    assert (k1.launches, k1.launches_bf16, k1.launches_fp32, k1.edges) == (
        before[0] + 1, before[1], before[2] + 1, before[3] + 2)


@pytest.mark.parametrize("ehw", [(3, 30, 40), (2, 7, 9), (1, 48, 64)])
def test_masked_corr_fp32_operand_kernel(cuda_device, ehw):
    """The 3xTF32 kernel on full-mantissa fp32 features (the lo terms
    matter), means on floor's edges, covariances up to 20: fp32 out within
    atol 2e-4 / rtol 1e-4, bf16 out within one bf16 step; it counts a
    launch, an fp32-operand launch and E edges."""
    f1, f2, mean, cov = edge_inputs(torch.Generator().manual_seed(7), *ehw,
                                    cuda_device)
    gen = torch.Generator().manual_seed(8)
    f1, f2 = (torch.randn(f1.shape, generator=gen).to(cuda_device)
              for _ in range(2))
    args = (f1, f2, mean, cov)
    k1 = masked_corr_level0
    before = (k1.launches, k1.launches_fp32, k1.launches_bf16, k1.edges)
    out = k1(*args, out_dtype=torch.float32)
    ref = masked_corr_level0_plain(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_fp32, k1.launches_bf16, k1.edges) == (
        before[0] + 1, before[1] + 1, before[2], before[3] + ehw[0])
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-4)
    out = k1(*args, out_dtype=torch.bfloat16).float()
    ref = masked_corr_level0_plain(*args, out_dtype=torch.bfloat16).float()
    assert ((out - ref).abs() / (ref.abs() + 1)).max().item() < 0.02


def test_masked_corr_fp32_kernel_rejects_bad_inputs(cuda_device):
    """fp32 operands of other than 128 channels raise before any launch."""
    f1, f2, mean, cov = corr_inputs(torch.Generator().manual_seed(9), 1, 4,
                                    6, cuda_device)
    n = masked_corr_level0.launches
    with pytest.raises(ValueError, match="128 channels"):
        masked_corr_level0(f1[..., :64].contiguous(),
                           f2[..., :64].contiguous(), mean, cov)
    with pytest.raises(ValueError, match="128 channels"):
        masked_corr_level0(torch.cat([f1, f1], -1), torch.cat([f2, f2], -1),
                           mean, cov)
    assert masked_corr_level0.launches == n


def test_masked_corr_bf16_kernel_rejects_bad_inputs(cuda_device):
    f1, f2, mean, cov = edge_inputs(torch.Generator().manual_seed(4), 1, 4,
                                    6, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        masked_corr_level0(f1.transpose(1, 2).contiguous().transpose(1, 2),
                           f2, mean, cov)
    with pytest.raises(ValueError, match="contiguous"):
        masked_corr_level0(f1, f2[:, :, :5], mean, cov)
    with pytest.raises(ValueError, match="128 channels"):
        masked_corr_level0(f1[..., :64].contiguous(),
                           f2[..., :64].contiguous(), mean, cov)
    with pytest.raises(ValueError, match="float32"):
        masked_corr_level0(f1, f2, mean.bfloat16(), cov)
    with pytest.raises(ValueError, match="both be float32 or both"):
        masked_corr_level0(f1, f2.float(), mean, cov)


@pytest.mark.parametrize("ehw", [(2, 12, 24), (1, 13, 17), (2, 48, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pyramid_lookup_kernel(cuda_device, ehw, dtype):
    """Coordinates up to 20 % outside the plane, offsets past the +-4 clip;
    fp32 bilinear taps of the same level values: atol 2e-4."""
    E, H, W = ehw
    gen = torch.Generator().manual_seed(1)
    levels = [torch.randn(E, H * W, h * w, generator=gen).to(cuda_device,
                                                              dtype)
              for h, w in level_dims(H, W)]
    cflat = (torch.rand(E, H * W, 2, generator=gen) * 1.4 - 0.2) \
        * torch.tensor([W, H])
    off0 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 9 - 4.5
    off1 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 9 - 4.5
    cflat, off0, off1 = (x.to(cuda_device) for x in (cflat, off0, off1))
    n = fused_pyramid_lookup.launches
    out = fused_pyramid_lookup(levels, cflat, off0, off1, H, W)
    ref = fused_pyramid_lookup_plain(levels, cflat, off0, off1, H, W)
    torch.cuda.synchronize()
    assert fused_pyramid_lookup.launches == n + 1
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("E", [1, 8, 24])
def test_pyramid_lookup_kernel_edge_counts(cuda_device, E):
    """At the call sites' edge counts (the motion filter's 1, a backend
    sub-chunk's 8, the frontend's ~24) on the tracking planes (48 x 64):
    offsets past the +-4 clip, coordinates up to 20 % outside the plane,
    and a few NaN coordinates, whose taps are 0 as in the plain version;
    atol 2e-4.  Each launch is counted under its E."""
    H, W = 48, 64
    gen = torch.Generator().manual_seed(10 + E)
    levels = [torch.randn(E, H * W, h * w, generator=gen).to(
        cuda_device, torch.bfloat16) for h, w in level_dims(H, W)]
    cflat = (torch.rand(E, H * W, 2, generator=gen) * 1.4 - 0.2) \
        * torch.tensor([W, H])
    cflat[:, ::97, 0] = float("nan")
    cflat[:, 5::101] = float("nan")
    off0 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 9 - 4.5
    off1 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 9 - 4.5
    cflat, off0, off1 = (x.to(cuda_device) for x in (cflat, off0, off1))
    k2 = fused_pyramid_lookup
    n, n_e = k2.launches, k2.launches_by_edges.get(E, 0)
    out = k2(levels, cflat, off0, off1, H, W)
    ref = fused_pyramid_lookup_plain(levels, cflat, off0, off1, H, W)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_by_edges[E]) == (n + 1, n_e + 1)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)
    assert (out[:, ::97] == 0).all() and (out[:, 5::101] == 0).all()


def test_pyramid_lookup_kernel_misaligned_views(cuda_device):
    """Coordinates and offsets that are contiguous views starting at an odd
    float (the kernel reads offset pairs as 8-byte words): the same result
    as on aligned copies, bit for bit."""
    E, H, W = 2, 13, 17
    gen = torch.Generator().manual_seed(20)
    levels = [torch.randn(E, H * W, h * w, generator=gen).to(
        cuda_device, torch.bfloat16) for h, w in level_dims(H, W)]
    cflat = (torch.rand(E, H * W, 2, generator=gen) * 1.4 - 0.2) \
        * torch.tensor([W, H])
    off0 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 9 - 4.5
    off1 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 9 - 4.5
    aligned = [x.to(cuda_device) for x in (cflat, off0, off1)]
    shifted = []
    for x in aligned:
        buf = torch.empty(x.numel() + 1, device=cuda_device)
        shifted.append(buf[1:].view(x.shape))
        shifted[-1].copy_(x)
    out = fused_pyramid_lookup(levels, *shifted, H, W)
    ref = fused_pyramid_lookup(levels, *aligned, H, W)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    torch.testing.assert_close(
        ref, fused_pyramid_lookup_plain(levels, *aligned, H, W), atol=2e-4,
        rtol=0)


@pytest.mark.parametrize("geometry", [(48, 64, 3, 4), (24, 32, 1, 0),
                                      (6, 8, 3, 0), (13, 17, 3, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_lookup_kernel(cuda_device, geometry, dtype):
    """K3/K4: taps of a (2r+1)^2 window plus offsets up to +-max_off around
    bases up to 20 % outside the plane, some positions NaN (read as 0);
    fp32 bilinear taps of the same plane values: atol 2e-4."""
    h, w, r, max_off = geometry
    E, P1, K = 2, 96, (2 * r + 1) ** 2
    gen = torch.Generator().manual_seed(4)
    vol = torch.randn(E, P1, h * w, generator=gen).to(cuda_device, dtype)
    base = (torch.rand(E, P1, 2, generator=gen) * 1.4 - 0.2) \
        * torch.tensor([w, h])
    off = (torch.rand(E, P1, K, 2, generator=gen) * 2 - 1) * max_off
    dx, dy = window_deltas(r)
    px = base[..., 0:1] + off[..., 0] + dx
    py = base[..., 1:2] + off[..., 1] + dy
    px[:, ::5, 0] = float("nan")
    py[:, 1::5, K - 1] = float("nan")
    px, py = px.to(cuda_device), py.to(cuda_device)
    n = window_lookup.launches
    out = window_lookup(vol, h, w, px, py)
    ref = sample_taps_flat(vol, h, w, px, py)
    torch.cuda.synchronize()
    assert window_lookup.launches == n + 1
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)
    assert (out[:, ::5, 0] == 0).all() and (out[:, 1::5, K - 1] == 0).all()


def edge_positions(h, w):
    """Positions on and one ulp below the integers at a plane's edges and
    just inside them (0, 1, w - 1, w and the like on each axis; below 0
    the smallest normal step: the card flushes denormals), paired in every
    combination, and NaN: [n] x and y."""
    def axis(n):
        on = np.array([0, 1, n - 2, n - 1, n], np.float32)
        below = np.nextafter(on, np.float32(-1))
        below[0] = -np.float32(2.0 ** -126)
        return np.concatenate([on, below, [np.nan]]).astype(np.float32)
    xs, ys = np.meshgrid(axis(w), axis(h), indexing="ij")
    return torch.from_numpy(xs.ravel()), torch.from_numpy(ys.ravel())


@pytest.mark.parametrize("hwk", [(13, 17, 49), (24, 32, 9), (7, 5, 81),
                                 (6, 8, 49)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_lookup_kernel_edges(cuda_device, hwk, dtype):
    """K3/K4 on positions exactly on, and one ulp below, integers at the
    planes' edges (where the boundary rule flips a tap to 0), NaN among
    them, on odd planes, fp32 and bf16, K of both lane layouts and above
    64: within 2e-4 of the plain version, and exactly 0 where the plain
    version is 0."""
    h, w, K = hwk
    xs, ys = edge_positions(h, w)
    E, P1 = 2, 40
    gen = torch.Generator().manual_seed(7)
    pick = torch.randint(0, xs.numel(), (E, P1, K), generator=gen)
    px, py = xs[pick].to(cuda_device), ys[pick].to(cuda_device)
    vol = torch.randn(E, P1, h * w, generator=gen).to(cuda_device, dtype)
    out = window_lookup(vol, h, w, px, py)
    ref = sample_taps_flat(vol, h, w, px, py)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)
    assert torch.equal(out == 0, ref == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_lookup_kernel_scattered(cuda_device, dtype):
    """K3: taps anywhere on and around the plane, not a window: no tile or
    box of a pixel's corners holds them (the path a staging design falls
    back from), 49 per pixel on 48 x 64 planes, NaN among them."""
    h, w, K = 48, 64, 49
    E, P1 = 2, 64
    gen = torch.Generator().manual_seed(8)
    vol = torch.randn(E, P1, h * w, generator=gen).to(cuda_device, dtype)
    px = torch.rand(E, P1, K, generator=gen) * (w + 4) - 2
    py = torch.rand(E, P1, K, generator=gen) * (h + 4) - 2
    px[:, ::3, 5] = float("nan")
    px, py = px.to(cuda_device), py.to(cuda_device)
    out = window_lookup(vol, h, w, px, py)
    ref = sample_taps_flat(vol, h, w, px, py)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)
    assert (out[:, ::3, 5] == 0).all()


@pytest.mark.parametrize("ehw", [(2, 9, 15), (1, 17, 23), (2, 13, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_one_level_kernel_edges(cuda_device, ehw, dtype):
    """K6 one_level on the four levels of odd pyramids (down to 1 x 1,
    planes smaller than the kernel's patch): coordinates on, and one ulp
    below, integers at the levels' edges (scaled by 2^l so that each level
    sees them), coordinates whose tap at +3 rounds up across the next
    integer (8 - 2^-21 + 3 rounds to 11: a floor the patch does not hold
    with its +1 corner, read from global memory), huge and NaN ones:
    within 2e-4 of the plain version, exactly 0 where it is 0."""
    E, H, W = ehw
    gen = torch.Generator().manual_seed(9)
    P1 = H * W
    for lvl, (h, w) in enumerate(level_dims(H, W)):
        xs, ys = edge_positions(h, w)
        special = torch.tensor([[8 - 2.0 ** -21, 8 - 2.0 ** -21],
                                [8 - 2.0 ** -21, 3.5], [1e30, 2.0],
                                [-1e30, float("nan")]])
        pos = torch.cat([torch.stack([xs, ys], -1), special])
        pick = torch.randint(0, pos.shape[0], (E, P1), generator=gen)
        cflat = (pos[pick] * 2.0 ** lvl).to(cuda_device).contiguous()
        level = torch.randn(E, P1, h * w, generator=gen).to(cuda_device,
                                                           dtype)
        out = k2_one_level(level, cflat, lvl, H, W)
        ref = k2_one_level_plain(level, cflat, lvl, H, W)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)
        assert torch.equal(out == 0, ref == 0), lvl


@pytest.mark.parametrize("shape", [(2, 96, 24, 128), (3, 40, 7, 48)])
def test_row_gather_kernel(cuda_device, shape):
    """K5: exact (a bf16 value read as fp32), indices outside [0, S) too."""
    gen = torch.Generator().manual_seed(5)
    V = torch.randn(*shape, generator=gen).to(cuda_device, torch.bfloat16)
    S = shape[2]
    s = torch.randint(-2, S + 2, shape[:2] + shape[3:], generator=gen,
                      dtype=torch.int32).to(cuda_device)
    n = row_gather.launches
    out = row_gather(V, s)
    torch.cuda.synchronize()
    assert row_gather.launches == n + 1
    assert torch.equal(out, row_gather_plain(V, s))


def k2_probe_inputs(gen, E, H, W, dev):
    levels = [torch.randn(E, H * W, h * w, generator=gen).to(
        dev, torch.bfloat16) for h, w in level_dims(H, W)]
    gy, gx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(1, H * W, 2).float()
    cflat = grid + 1.5 * torch.randn(E, H * W, 2, generator=gen)
    off0 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 6 - 3
    off1 = torch.rand(E, H * W, 7, 7, 2, generator=gen) * 6 - 3
    return levels, cflat.to(dev), off0.to(dev), off1.to(dev)


@pytest.mark.parametrize("ehw", [(2, 13, 17), (1, 12, 24), (2, 48, 64)])
def test_k2_parts_kernels(cuda_device, ehw):
    """K6: the stream floor (sums of up to ~50 values of unit scale in
    another order: atol 1e-3) and each level alone on bf16 and fp32 planes
    (fp32 bilinear taps of the same values: atol 2e-4)."""
    E, H, W = ehw
    levels, cflat, off0, off1 = k2_probe_inputs(
        torch.Generator().manual_seed(6), E, H, W, cuda_device)
    n = k2_stream_floor.launches
    out = k2_stream_floor(levels, cflat, off0, off1)
    ref = k2_stream_floor_plain(levels, cflat, off0, off1)
    torch.cuda.synchronize()
    assert k2_stream_floor.launches == n + 1
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=0)
    for lvl in range(4):
        for v in (levels[lvl], levels[lvl].float()):
            n = k2_one_level.launches
            out = k2_one_level(v, cflat, lvl, H, W)
            ref = k2_one_level_plain(v, cflat, lvl, H, W)
            torch.cuda.synchronize()
            assert k2_one_level.launches == n + 1
            torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)


def test_wrappers_reject_bad_inputs(cuda_device):
    args = corr_inputs(torch.Generator().manual_seed(2), 1, 4, 6,
                       cuda_device)
    with pytest.raises(ValueError, match="float32"):
        masked_corr_level0(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        masked_corr_level0(args[0].transpose(1, 2).contiguous()
                           .transpose(1, 2), *args[1:])
    levels = [torch.zeros(1, 24, h * w, device=cuda_device)
              for h, w in level_dims(4, 6)]
    cflat = torch.zeros(1, 24, 2, device=cuda_device)
    off = torch.zeros(1, 24, 7, 7, 2, device=cuda_device)
    with pytest.raises(ValueError, match="level 2"):
        fused_pyramid_lookup(levels[:2] + [levels[2][:, :, :0]] + levels[3:],
                             cflat, off, off, 4, 6)
    with pytest.raises(ValueError, match="cflat"):
        fused_pyramid_lookup(levels, cflat.double(), off, off, 4, 6)
    vol = torch.zeros(1, 24, 12, device=cuda_device)
    pos = torch.zeros(1, 24, 9, device=cuda_device)
    with pytest.raises(ValueError, match="px"):
        window_lookup(vol, 3, 4, pos.double(), pos)
    with pytest.raises(ValueError, match="vol"):
        window_lookup(vol[:, :, :11], 3, 4, pos, pos)
    with pytest.raises(ValueError, match="neither"):
        window_lookup(vol.half(), 3, 4, pos, pos)
    V = torch.zeros(1, 2, 3, 4, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        row_gather(V.float(), torch.zeros(1, 2, 4, dtype=torch.int32,
                                          device=cuda_device))
    with pytest.raises(ValueError, match="int32"):
        row_gather(V, torch.zeros(1, 2, 4, dtype=torch.int64,
                                  device=cuda_device))
    with pytest.raises(ValueError, match="level 0"):
        k2_stream_floor([lv.float() for lv in levels], cflat, off, off)
    with pytest.raises(ValueError, match="cflat"):
        k2_one_level(levels[0], cflat.double(), 0, 4, 6)


def test_small_track_cuda_matches_cpu(cuda_device):
    """track() of a tiny fp32 configuration on the card (kernels) and on
    the CPU (plain versions) from one state dict: the same keyframes and
    edges, poses within 1e-2 (sums in another order, grown through 8
    frames of random-weight tracking)."""
    cfg = SLAMConfig(**tiny_config_kwargs())
    sd = init_state_dict(cfg, seed=0)
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, size=(96, 128, 3)).astype(np.uint8)
    intr = np.asarray([80.0, 80.0, 48.0, 32.0], np.float32)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        slam = LGUSlam(sd, cfg, device=dev)
        for k in range(8):
            slam.track(float(k), base[3 * k:3 * k + 64, 2 * k:2 * k + 96],
                       intrinsics=intr)
        g = slam.frontend.graph
        runs.append((slam.video.counter, g.ii.tolist(), g.jj.tolist(),
                     slam.video.poses[:slam.video.counter].cpu()))
    assert runs[0][:3] == runs[1][:3]
    torch.testing.assert_close(runs[0][3], runs[1][3], atol=1e-2, rtol=0)


# -- the multi-device paths at world size 1 (one card, NCCL) -----------------

@pytest.fixture(scope="module")
def nccl_group():
    """A process group of this process alone on the card, under NCCL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_sharded_dba_world_size_1_matches_dba_step(cuda_device, nccl_group):
    """tests/test_dba_shard.py's scene (8 frames of 8 x 12, 26 edges) on
    the card: the sharded DBA at world size 1 against the one-process
    ``dba_step``, poses atol 2e-5 / rtol 1e-4, disparities 2e-4 / 1e-3."""
    use_full_fp32()
    gen = torch.Generator().manual_seed(0)
    N, H, W = 8, 8, 12
    poses_gt = se3_exp(torch.cumsum(torch.randn(N, 6, generator=gen) * 0.03,
                                    0)).to(cuda_device)
    disps_gt = (0.6 + 0.2 * torch.rand(N, H, W, generator=gen)).to(
        cuda_device)
    intr = torch.tensor([15.0, 15.0, W / 2, H / 2], device=cuda_device)
    ii, jj = (np.asarray(x) for x in zip(*[
        (i, j) for i in range(N) for j in range(N) if 0 < abs(i - j) <= 2]))
    target, _ = projective_transform(
        poses_gt, disps_gt, intr.expand(N, 4),
        torch.as_tensor(ii, device=cuda_device),
        torch.as_tensor(jj, device=cuda_device))
    poses0 = se3_mul(se3_exp((torch.randn(N, 6, generator=gen) * 0.02).to(
        cuda_device)), poses_gt)
    disps0 = disps_gt + (torch.randn(N, H, W, generator=gen) * 0.02).to(
        cuda_device)
    args = (poses0, disps0, intr, torch.zeros_like(disps0), target,
            torch.ones_like(target), torch.full_like(disps0, 1e-3))
    p, d = dba_step_sharded(nccl_group, *args, ii, jj, 1, N, iters=2)
    p_ref, d_ref = dba_step(*args, DbaPlan.build(ii, jj, 1, N, cuda_device),
                            iters=2)
    torch.testing.assert_close(p, p_ref, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(d, d_ref, atol=2e-4, rtol=1e-3)


def test_sharded_backend_world_size_1_matches_one_process(cuda_device,
                                                          nccl_group):
    """tests/test_backend_shard.py's aligned case on the card: 16 staged
    keyframes at 64 x 96, every frame 4 out-edges in ii order, chunks of 8,
    2 steps, fp32 compute and hidden state.  At world size 1 the sharded
    chunks are the one-process chunks (K2 on each sub-chunk in both), and
    the sharded pass launches K2 as often as the one-process pass.  The
    card's ``index_add_`` scatters are atomic, so the one-process pass
    differs from itself run to run (poses 3e-6, disparities 7e-5 on this
    case); the two passes are held to about 10 x that: poses atol 5e-5,
    disparities atol 5e-4 / rtol 1e-3, damping atol 1e-5 / rtol 1e-4."""
    use_full_fp32()
    cfg = SLAMConfig(
        image_size=(64, 96), buffer=16, warmup=4, max_factors=64,
        edge_bucket=64, inactive_bucket=8, pose_bucket=16,
        backend_edge_cap=64, backend_chunk=8, compute_dtype="float32",
        backend_hidden_dtype="float32")
    net = LGUSlam(init_state_dict(cfg, seed=0), cfg, device=cuda_device).net
    gen = torch.Generator().manual_seed(7)
    T, h, w = 16, cfg.ht8, cfg.wd8
    staged = dict(
        fmaps=torch.randn(T, 1, h, w, 128, generator=gen),
        nets=torch.randn(T, h, w, 128, generator=gen),
        inps=torch.randn(T, h, w, 128, generator=gen),
        poses=se3_exp(torch.cumsum(torch.randn(T, 6, generator=gen) * 0.02,
                                   0)),
        disps=0.5 + 0.3 * torch.rand(T, h, w, generator=gen),
        intrinsics=torch.tensor([w * 4.0, w * 4.0, w / 2, h / 2]).expand(
            T, 4))
    ii, jj = [], []
    for i in range(T):
        js = [j for j in (i + d for d in (1, 2, 3, 4, -1, -2, -3, -4))
              if 0 <= j < T][:4]
        ii += [i] * 4
        jj += js
    out = []
    for group in (nccl_group, None):
        v = Video(cfg, cuda_device)
        for name, x in staged.items():
            getattr(v, name)[:T] = x.to(cuda_device)
        v.counter = T
        g = FactorGraph(net, v, cfg, corr_impl="alt",
                        max_factors=cfg.max_factors,
                        edge_bucket=cfg.backend_edge_cap, inactive_bucket=8)
        g.add_factors(np.asarray(ii), np.asarray(jj))
        n = fused_pyramid_lookup.launches
        g.update_lowmem(steps=2, group=group)
        torch.cuda.synchronize()
        out.append((v.poses[:T], v.disps[:T], v.damping[:T],
                    fused_pyramid_lookup.launches - n))
    (p, d, e, k2), (p_ref, d_ref, e_ref, k2_ref) = out
    assert k2 == k2_ref > 0
    for a, b, atol, rtol in ((p, p_ref, 5e-5, 1e-4), (d, d_ref, 5e-4, 1e-3),
                             (e, e_ref, 1e-5, 1e-4)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
