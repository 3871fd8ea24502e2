"""Port parity of the two kernels' plain versions, and of the plain
sampling pieces they are built from, against the JAX package.

- K1: ``masked_corr_level0_plain`` against the Pallas kernel
  ``masked_corr_level0`` in interpret mode (tests/test_pallas.py's sizes,
  plus a plane whose size is no multiple of any tile), with fp32 operands
  and with bf16 operands holding bf16-exact values; the fp32-operand
  kernel's arithmetic (3xTF32) emulated in plain torch against the same
  reference; the wrapper's operand dtype rules, its input checks and the
  fp32-operand kernel's grid.
- K2: ``fused_pyramid_lookup_plain`` against the Pallas kernel
  ``fused_pyramid_lookup`` in interpret mode over ``pack_pyramid`` levels,
  at tests/test_pallas.py's geometries (16 x 16, and 12 x 24 whose halving
  chain ends at 1 x 3) with coordinates up to 20 % outside the plane, at
  the call sites' edge counts 1 (the motion filter's probe) and 8 (a
  backend sub-chunk) as well as 2.
- K3/K4: ``window_lookup`` (plain on the CPU) against the Pallas kernels
  ``window_lookup_packed`` and ``dense_lookup_packed`` in interpret mode
  over ``pack_level`` planes, at tests/test_pallas.py's six geometries.
- K5: ``row_gather`` (plain on the CPU) against the probe
  ``_prof_sublane.run(chain_kernel)`` in interpret mode at its CPU size.
- K6: ``k2_one_level`` against JAX ``sample_taps_flat`` at the probe's
  positions (``_prof_kparts.py`` runs at E = 48 on import, so the function
  its kernel computes is the reference), and ``k2_stream_floor`` against a
  numpy statement of its sum.

On the CPU the wrappers run the plain versions and launch nothing; the
CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import close, t, torch_single_thread  # noqa: F401

from lgu_slam_tpu.ops import pallas_corr as jcorr
from lgu_slam_tpu.ops import pallas_lookup as jlookup
from lgu_slam_tpu.ops import sampler as jsampler
from lgu_slam_tpu_torch.ops import k2_parts as tparts
from lgu_slam_tpu_torch.ops import masked_corr as tcorr
from lgu_slam_tpu_torch.ops import pyramid_lookup as tlookup
from lgu_slam_tpu_torch.ops import row_gather as trow
from lgu_slam_tpu_torch.ops import sampler as tsampler
from lgu_slam_tpu_torch.ops import window_lookup as twindow


def corr_inputs(rng, E, H, W, cov_lo=0.1):
    f1 = rng.normal(size=(E, H, W, 128)).astype(np.float32)
    f2 = rng.normal(size=(E, H, W, 128)).astype(np.float32)
    mean = (rng.random(size=(E, H, W, 2)) * np.array([W, H])).astype(
        np.float32)
    cov = (cov_lo + 5 * rng.random(size=(E, H, W, 2))).astype(np.float32)
    return f1, f2, mean, cov


@pytest.mark.parametrize("ehw", [(2, 8, 16), (2, 5, 7)])
def test_masked_corr_plain_matches_pallas_fp32(rng, ehw):
    """fp32 out; tolerances of tests/test_pallas.py (a 128-channel dot
    product summed in another order)."""
    args = corr_inputs(rng, *ehw)
    ref = jcorr.masked_corr_level0(*map(jnp.asarray, args),
                                   out_dtype=jnp.float32, interpret=True,
                                   flat=True)
    out = tcorr.masked_corr_level0(*map(t, args), out_dtype=torch.float32)
    assert out.shape == ref.shape and out.dtype == torch.float32
    close(out, ref, atol=2e-4, rtol=1e-4)


def test_masked_corr_plain_matches_pallas_bf16(rng):
    """bf16 out: both round the same fp32 value, so they differ by at most
    one bf16 step; the criterion of tests/test_pallas.py."""
    args = corr_inputs(rng, 1, 8, 16, cov_lo=0.5)
    ref = np.asarray(jcorr.masked_corr_level0(
        *map(jnp.asarray, args), out_dtype=jnp.bfloat16, interpret=True,
        flat=True).astype(jnp.float32))
    out = tcorr.masked_corr_level0(*map(t, args), out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    rel = np.abs(out.float().numpy() - ref) / (np.abs(ref) + 1.0)
    assert rel.max() < 0.02


def test_masked_corr_plain_bf16_operands_equal_widened(rng):
    """The plain version widens bf16 operands: its result on them is its
    result on their ``.float()``, bit for bit, for both output dtypes."""
    f1, f2, mean, cov = map(t, corr_inputs(rng, 2, 5, 7))
    b1, b2 = f1.to(torch.bfloat16), f2.to(torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):
        out = tcorr.masked_corr_level0_plain(b1, b2, mean, cov, out_dtype=dt)
        ref = tcorr.masked_corr_level0_plain(b1.float(), b2.float(), mean,
                                             cov, out_dtype=dt)
        assert out.dtype == dt and torch.equal(out, ref)


@pytest.mark.parametrize("ehw", [(2, 8, 16), (2, 5, 7)])
def test_masked_corr_bf16_operands_match_pallas(rng, ehw):
    """bf16 operands holding bf16-exact values against the Pallas kernel
    on the same values in fp32, fp32 out: the fp32 test's tolerances."""
    f1, f2, mean, cov = corr_inputs(rng, *ehw)
    f1, f2 = (t(x).to(torch.bfloat16) for x in (f1, f2))
    ref = jcorr.masked_corr_level0(
        *map(jnp.asarray, (f1.float().numpy(), f2.float().numpy(), mean,
                           cov)),
        out_dtype=jnp.float32, interpret=True, flat=True)
    out = tcorr.masked_corr_level0(f1, f2, t(mean), t(cov),
                                   out_dtype=torch.float32)
    close(out, ref, atol=2e-4, rtol=1e-4)


def tf32(x):
    """x with its low 13 mantissa bits cleared: the TF32 value that the
    tensor cores read from an fp32 word."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def tf32_volume(f1, f2, mean, cov, passes):
    """The fp32-operand kernel's function emulated in plain torch, fp32 out:
    corr as fp32 sums of TF32 products, a_hi b_hi alone (``passes=1``) or
    a_hi b_hi + a_hi b_lo + a_lo b_hi (``passes=3``, lo = x - hi, itself
    read as TF32), then the plain version's window epilogue."""
    E, H, W, C = f1.shape
    a, b = (x.reshape(E, H * W, C) for x in (f1, f2))
    a_hi, b_hi = tf32(a), tf32(b)
    corr = torch.bmm(a_hi, b_hi.transpose(1, 2))
    if passes == 3:
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        corr = corr + torch.bmm(a_hi, b_lo.transpose(1, 2)) \
            + torch.bmm(a_lo, b_hi.transpose(1, 2))
    corr = (corr / 16.0).reshape(E, H, W, H, W)
    return tcorr.window_epilogue(corr, mean, cov, 4).reshape(E, H * W, H * W)


def window_edge_inputs(rng, E, H, W):
    """Full-mantissa fp32 features (all 24 bits, so the lo terms matter);
    means scattered +-3 pixels around each pixel, a third on an integer and
    a third just below one (floor's edges); covariances from 0.05 to 20:
    chip_smoke.py's draw."""
    f1 = rng.normal(size=(E, H, W, 128)).astype(np.float32)
    f2 = rng.normal(size=(E, H, W, 128)).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    mean = np.stack([gx, gy], -1) + 3.0 * rng.normal(size=(E, H, W, 2))
    pick = rng.integers(0, 3, size=(E, H, W, 1))
    mean = np.where(pick == 0, np.round(mean), mean)
    mean = np.where(pick == 1, np.floor(mean) + 0.999, mean)
    cov = 0.05 + 20.0 * rng.random(size=(E, H, W, 2)) ** 2
    return f1, f2, mean.astype(np.float32), cov.astype(np.float32)


@pytest.mark.parametrize("ehw", [(2, 8, 16), (1, 5, 7)])
def test_masked_corr_3xtf32_matches_pallas_fp32(rng, ehw):
    """The fp32-operand kernel's 3xTF32 arithmetic, emulated, against the
    Pallas kernel's fp32 dot on full-mantissa features: within the fp32
    tolerance (atol 2e-4, rtol 1e-4).  One TF32 product (a_hi b_hi alone,
    a relative error near 2^-11) misses it: the three are needed."""
    args = window_edge_inputs(rng, *ehw)
    ref = np.asarray(jcorr.masked_corr_level0(
        *map(jnp.asarray, args), out_dtype=jnp.float32, interpret=True,
        flat=True))
    f1, f2, mean, cov = map(t, args)
    close(tf32_volume(f1, f2, mean, cov, passes=3), ref, atol=2e-4,
          rtol=1e-4)
    one = tf32_volume(f1, f2, mean, cov, passes=1).numpy()
    assert not np.allclose(one, ref, atol=2e-4, rtol=1e-4)


def test_tf32_schedule_covers_every_tile():
    """The fp32-operand kernel's grid: 64-pixel row blocks; the target tiles
    of a row block split into runs only where E x row blocks would leave
    the card idle (the motion filter's one edge: 288 blocks), every tile in
    exactly one run, no run empty, and at least half the target count of
    blocks wherever there are that many tiles."""
    assert tcorr.tf32_schedule(1, 3072) == (48, 6, 8)
    assert tcorr.tf32_schedule(48, 3072) == (48, 1, 48)
    for E, P in ((1, 3072), (8, 3072), (24, 3072), (48, 3072), (3, 1200),
                 (2, 63), (1, 1), (1, 640), (5, 1200)):
        rows, runs, per_run = tcorr.tf32_schedule(E, P)
        tiles = -(-P // 64)
        assert rows == tiles
        assert runs * per_run >= tiles > (runs - 1) * per_run
        assert E * rows * runs >= min(tcorr.BLOCKS_TARGET // 2,
                                      E * rows * tiles)


def test_masked_corr_kernel_input_checks(rng):
    """What the kernels refuse, checked before any launch: operands of
    other than 128 channels (fp32 and bf16 alike), non-contiguous operands,
    mean/cov of another dtype, a volume of another dtype."""
    f1, f2, mean, cov = map(t, corr_inputs(rng, 1, 4, 6))
    check = tcorr.check_kernel_inputs
    check(f1, f2, mean, cov, torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="128 channels"):
            check(f1[..., :64].contiguous().to(dt),
                  f2[..., :64].contiguous().to(dt), mean, cov, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        check(f1.transpose(1, 2).contiguous().transpose(1, 2), f2, mean, cov,
              torch.float32)
    with pytest.raises(ValueError, match="float32"):
        check(f1, f2, mean.double(), cov, torch.float32)
    with pytest.raises(ValueError, match="neither"):
        check(f1, f2, mean, cov, torch.float16)


def test_masked_corr_cpu_fp32_counts_no_launch(rng):
    """fp32 CPU tensors run the plain version and advance none of the
    wrapper's counters, the fp32-operand kernel's included."""
    f1, f2, mean, cov = map(t, corr_inputs(rng, 2, 4, 6))
    k1 = tcorr.masked_corr_level0
    before = (k1.launches, k1.launches_bf16, k1.launches_fp32, k1.edges)
    out = k1(f1, f2, mean, cov, out_dtype=torch.float32)
    assert torch.equal(out, tcorr.masked_corr_level0_plain(
        f1, f2, mean, cov, out_dtype=torch.float32))
    assert (k1.launches, k1.launches_bf16, k1.launches_fp32,
            k1.edges) == before


def test_masked_corr_cpu_bf16_counts_no_launch(rng):
    """bf16 CPU tensors run the plain version and advance none of the
    wrapper's counters."""
    f1, f2, mean, cov = map(t, corr_inputs(rng, 2, 4, 6))
    b1, b2 = f1.to(torch.bfloat16), f2.to(torch.bfloat16)
    k1 = tcorr.masked_corr_level0
    before = (k1.launches, k1.launches_bf16, k1.launches_fp32, k1.edges)
    out = k1(b1, b2, mean, cov)
    assert torch.equal(out, tcorr.masked_corr_level0_plain(b1, b2, mean,
                                                           cov))
    assert (k1.launches, k1.launches_bf16, k1.launches_fp32,
            k1.edges) == before


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16), (torch.float64, torch.float64)])
def test_masked_corr_rejects_operand_dtypes(rng, dtypes):
    """Mixed, fp16 or fp64 operands raise on every device."""
    f1, f2, mean, cov = map(t, corr_inputs(rng, 1, 4, 6))
    with pytest.raises(ValueError, match="both be float32 or both bfloat16"):
        tcorr.masked_corr_level0(f1.to(dtypes[0]), f2.to(dtypes[1]), mean,
                                 cov)


def test_gaussian_window_mask(rng):
    vol = rng.normal(size=(2, 4, 5, 6, 7)).astype(np.float32)
    mean = (rng.random(size=(2, 4, 5, 2)) * 12 - 3).astype(np.float32)
    cov = (0.1 + rng.random(size=(2, 4, 5, 2))).astype(np.float32)
    close(tsampler.gaussian_window_mask(t(vol), t(mean), t(cov), 2),
          jsampler.gaussian_window_mask(jnp.asarray(vol), jnp.asarray(mean),
                                        jnp.asarray(cov), 2), atol=1e-6)


def test_sample_taps_flat(rng):
    """The CUDA boundary rule: taps whose floor corner is outside are 0,
    +1 corners outside read 0."""
    H2, W2, K = 5, 7, 9
    vol = rng.normal(size=(2, 3, H2 * W2)).astype(np.float32)
    px = rng.uniform(-2, W2 + 1, size=(2, 3, K)).astype(np.float32)
    py = rng.uniform(-2, H2 + 1, size=(2, 3, K)).astype(np.float32)
    px[0, 0, :2] = [W2 - 0.5, -0.5]
    py[0, 0, :2] = [H2 - 0.5, 1.0]
    out = tsampler.sample_taps_flat(t(vol), H2, W2, t(px), t(py))
    ref = jsampler.sample_taps_flat(jnp.asarray(vol), H2, W2,
                                    jnp.asarray(px), jnp.asarray(py))
    close(out, ref, atol=1e-6)
    assert float(out[0, 0, 1]) == 0.0
    # a NaN position has no in-bounds floor corner: 0, as in the CUDA
    # kernel (the JAX gather casts NaN to an index and returns NaN)
    px[0, 0, 2] = np.nan
    out = tsampler.sample_taps_flat(t(vol), H2, W2, t(px), t(py))
    assert float(out[0, 0, 2]) == 0.0


def test_nan_taps_match_jax_patch_formulation(rng):
    """At NaN positions the port's taps equal those of the JAX package's
    patch formulation, ``sample_taps_patch_flat``, which its ``corr_lookup``
    runs off the TPU and its training forward runs: 0.  (Its gather
    formulation, ``sample_taps_flat``, returns NaN there.)"""
    H2, W2, r = 6, 8, 3
    rd = 2 * r + 1
    vol = rng.normal(size=(2, 5, H2 * W2)).astype(np.float32)
    base = (rng.uniform(-0.2, 1.2, size=(2, 5, 2))
            * np.array([W2, H2])).astype(np.float32)
    d = np.arange(rd, dtype=np.float32) - r
    px = (base[..., 0:1] + np.repeat(d, rd)).astype(np.float32)
    py = (base[..., 1:2] + np.tile(d, rd)).astype(np.float32)
    px[0, 1, 3] = np.nan
    py[1, 4, :] = np.nan
    ref = np.asarray(jsampler.sample_taps_patch_flat(
        jnp.asarray(vol), H2, W2, jnp.asarray(base), jnp.asarray(px),
        jnp.asarray(py), r))
    out = tsampler.sample_taps_flat(t(vol), H2, W2, t(px), t(py))
    assert ref[0, 1, 3] == 0.0 and (ref[1, 4] == 0.0).all()
    close(out, ref, atol=1e-5)
    assert np.isnan(np.asarray(jsampler.sample_taps_flat(
        jnp.asarray(vol), H2, W2, jnp.asarray(px), jnp.asarray(py)))[0, 1, 3])


def test_row_gather_plain_matches_probe(monkeypatch):
    """K5's plain version against the probe's select-chain kernel in
    interpret mode, at the size its own CPU run uses (E, NB = 2, 1:
    V [2, 256, 24, 128]); exact (a bf16 value read as fp32)."""
    import _prof_sublane as probe

    monkeypatch.setattr(probe, "E", 2)
    monkeypatch.setattr(probe, "NB", 1)
    rng = np.random.default_rng(0)
    shape = (probe.E, probe.NB * probe.TP, probe.S, 128)
    v = rng.normal(size=shape).astype(np.float32)
    st = rng.integers(0, probe.S, size=shape[:2] + (128,)).astype(np.int32)
    v_j = jnp.asarray(v).astype(jnp.bfloat16)
    ref = probe.run(probe.chain_kernel, v_j, jnp.asarray(st), True)
    V = t(np.asarray(v_j.astype(jnp.float32))).to(torch.bfloat16)
    before = trow.row_gather.launches
    out = trow.row_gather(V, t(st))
    assert trow.row_gather.launches == before  # plain on the CPU
    assert out.shape == ref.shape and out.dtype == torch.float32
    close(out, ref, atol=0)
    # an index outside [0, S) reads 0
    st[0, 0, :3] = [-1, probe.S, 10 ** 6]
    assert not trow.row_gather(V, t(st))[0, 0, :3].any()


def probe_cflat(rng, E, H, W):
    """The probe's coordinates: the pixel grid plus 1.5 N(0, 1)."""
    gy, gx = np.mgrid[0:H, 0:W]
    grid = np.stack([gx, gy], -1).reshape(1, H * W, 2)
    return (grid + 1.5 * rng.normal(size=(E, H * W, 2))).astype(np.float32)


@pytest.mark.parametrize("hw", [(16, 24), (13, 17)])
def test_k2_one_level_plain_matches_jax(rng, hw):
    """The probe's function (``_prof_kparts.py:72-83``): lanes k < 49 tap
    (k // 7 - 3, k % 7 - 3) around cflat / 2^lvl, lanes 49-63 the centre;
    JAX ``sample_taps_flat`` at those positions is the reference."""
    H, W = hw
    E = 2
    cflat = probe_cflat(rng, E, H, W)
    l64 = np.arange(64)
    live = (l64 < 49).astype(np.float32)
    dx = ((l64 // 7) - 3) * live
    dy = ((l64 % 7) - 3) * live
    for lvl, (h, w) in enumerate(tlookup.level_dims(H, W)):
        vol = rng.normal(size=(E, H * W, h * w)).astype(np.float32)
        px = (cflat[..., 0:1] * 0.5 ** lvl + dx).astype(np.float32)
        py = (cflat[..., 1:2] * 0.5 ** lvl + dy).astype(np.float32)
        ref = jsampler.sample_taps_flat(jnp.asarray(vol), h, w,
                                        jnp.asarray(px), jnp.asarray(py))
        for dtype in (torch.float32, torch.bfloat16):
            v = t(vol).to(dtype)
            before = tparts.k2_one_level.launches
            out = tparts.k2_one_level(v, t(cflat), lvl, H, W)
            assert tparts.k2_one_level.launches == before
            assert out.shape == (E, H * W, 64)
            if dtype == torch.float32:
                close(out, ref, atol=1e-5)
            else:  # bf16 planes are read exactly as their fp32 values
                close(out, tsampler.sample_taps_flat(
                    v.float(), h, w, t(px), t(py)), atol=0)


def test_k2_stream_floor_plain_matches_numpy(rng):
    """Element k of a pixel's output sums, over every input row of that
    (edge, pixel), the elements whose index in the row is k mod 64 (rows
    of 221, 48, 12, 2, 2 and 98 elements)."""
    E, H, W = 2, 13, 17
    levels = [rng.normal(size=(E, H * W, h * w)).astype(np.float32)
              for h, w in tlookup.level_dims(H, W)]
    cflat = probe_cflat(rng, E, H, W)
    off0 = rng.uniform(-3, 3, size=(E, H * W, 7, 7, 2)).astype(np.float32)
    off1 = rng.uniform(-3, 3, size=(E, H * W, 7, 7, 2)).astype(np.float32)
    ref = np.zeros((E, H * W, 64))
    for row in levels + [cflat, off0.reshape(E, H * W, 98),
                         off1.reshape(E, H * W, 98)]:
        for k in range(64):
            ref[..., k] += row[..., k::64].astype(np.float64).sum(-1)
    lv = [t(v).to(torch.bfloat16) for v in levels]
    ref_bf16 = ref - sum(
        np.pad(v - v16.float().numpy(), ((0, 0), (0, 0),
                                         (0, (-v.shape[-1]) % 64)))
        .reshape(E, H * W, -1, 64).sum(2) for v, v16 in zip(levels, lv))
    before = tparts.k2_stream_floor.launches
    out = tparts.k2_stream_floor(lv, t(cflat), t(off0), t(off1))
    assert tparts.k2_stream_floor.launches == before
    assert out.shape == (E, H * W, 64) and out.dtype == torch.float32
    close(out, ref_bf16, atol=1e-4)


def lookup_problem(rng, E, H, W):
    dims = tlookup.level_dims(H, W)
    levels = [rng.normal(size=(E, H * W, h * w)).astype(np.float32)
              for h, w in dims]
    off0 = rng.uniform(-4, 4, size=(E, H * W, 7, 7, 2)).astype(np.float32)
    off1 = rng.uniform(-4, 4, size=(E, H * W, 7, 7, 2)).astype(np.float32)
    cflat = (rng.uniform(-0.2, 1.2, size=(E, H * W, 2))
             * np.array([W, H])).astype(np.float32)
    return levels, cflat, off0, off1


@pytest.mark.parametrize("E", [1, 2, 8])
@pytest.mark.parametrize("hw", [(16, 16), (12, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pyramid_lookup_plain_matches_pallas(rng, hw, dtype, E):
    """fp32 bilinear taps of the same level values (bf16 levels are
    rounded once, identically, on both sides); tolerance of
    tests/test_pallas.py.  On the CPU no launch is counted, per edge count
    neither."""
    H, W = hw
    levels, cflat, off0, off1 = lookup_problem(rng, E, H, W)
    lv_j = [jnp.asarray(v).astype(dtype) for v in levels]
    ref = jlookup.fused_pyramid_lookup(
        tuple(jlookup.pack_pyramid(lv_j, H, W)), jnp.asarray(cflat),
        jnp.asarray(off0), jnp.asarray(off1), H, W, interpret=True,
        tile_p=8)
    lv_t = [t(v).to(getattr(torch, dtype)) for v in levels]
    k2 = tlookup.fused_pyramid_lookup
    before = (k2.launches, dict(k2.launches_by_edges))
    out = k2(lv_t, t(cflat), t(off0), t(off1), H, W)
    assert (k2.launches, k2.launches_by_edges) == before  # plain on CPU
    assert out.shape == (E, H * W, 196) and out.dtype == torch.float32
    close(out, ref, atol=2e-4)


@pytest.mark.parametrize("H2, W2, r, max_off, dense", [
    (48, 64, 3, 4, False),  # level 0, deformable
    (24, 32, 3, 4, False),  # level 1, deformable
    (12, 16, 3, 0, False),  # level 2, plain window
    (6, 8, 3, 0, True),  # level 3, K4's dense tent
    (24, 32, 1, 0, False),  # the radius-1 variance probe
    (13, 17, 3, 4, False),  # odd (TUM-like) plane
])
def test_window_lookup_matches_pallas(rng, H2, W2, r, max_off, dense):
    """tests/test_pallas.py's check: taps of a (2r+1)^2 window plus
    offsets up to +-max_off around bases from 2 planes left/above to 20 %
    beyond the plane, fp32 volume; its tolerance, 1e-4."""
    E, P1, rd = 2, 16, 2 * r + 1
    K = rd * rd
    vol = rng.normal(size=(E, P1, H2 * W2)).astype(np.float32)
    base = (rng.uniform(-2, 1.2, size=(E, P1, 2))
            * np.array([W2, H2])).astype(np.float32)
    off = rng.uniform(-max_off, max_off, size=(E, P1, K, 2)).astype(
        np.float32)
    d = np.stack(np.meshgrid(np.arange(rd) - r, np.arange(rd) - r,
                             indexing="ij"), -1).reshape(K, 2)
    px = (base[..., 0:1] + off[..., 0] + d[:, 0]).astype(np.float32)
    py = (base[..., 1:2] + off[..., 1] + d[:, 1]).astype(np.float32)
    W2p = jlookup.pad_w2(W2)
    NS = jlookup.pick_ns(2 * (r + max_off) + 2, 128 // W2p)
    vol4, _ = jlookup.pack_level(jnp.asarray(vol), H2, W2, NS)
    if dense:
        ref = jlookup.dense_lookup_packed(vol4, jnp.asarray(px),
                                          jnp.asarray(py), H2, W2, W2p,
                                          interpret=True, tile_p=8)
    else:
        ref = jlookup.window_lookup_packed(vol4, jnp.asarray(px),
                                           jnp.asarray(py), H2, W2, W2p, NS,
                                           interpret=True, tile_p=8)
    before = twindow.window_lookup.launches
    out = twindow.window_lookup(t(vol), H2, W2, t(px), t(py))
    assert twindow.window_lookup.launches == before  # plain on the CPU
    assert out.shape == (E, P1, K) and out.dtype == torch.float32
    close(out, ref, atol=1e-4)
    # bf16 planes are read exactly as their fp32 values
    vb = t(vol).to(torch.bfloat16)
    close(twindow.window_lookup(vb, H2, W2, t(px), t(py)),
          tsampler.sample_taps_flat(vb.float(), H2, W2, t(px), t(py)),
          atol=0)


def test_wrappers_dispatch_by_device(rng):
    """CPU tensors run the plain versions and count no launch; a device
    with no kernel raises instead of falling back."""
    f1, f2, mean, cov = map(t, corr_inputs(rng, 1, 4, 6))
    n1 = tcorr.masked_corr_level0.launches
    out = tcorr.masked_corr_level0(f1, f2, mean, cov,
                                   out_dtype=torch.float32)
    plain = tcorr.masked_corr_level0_plain(f1, f2, mean, cov,
                                           out_dtype=torch.float32)
    assert torch.equal(out, plain)
    assert tcorr.masked_corr_level0.launches == n1
    with pytest.raises(ValueError, match="no kernel"):
        tcorr.masked_corr_level0(*(x.to("meta") for x in (f1, f2, mean,
                                                          cov)))
    levels, cflat, off0, off1 = lookup_problem(rng, 1, 8, 8)
    with pytest.raises(ValueError, match="no kernel"):
        tlookup.fused_pyramid_lookup(
            [t(v).to("meta") for v in levels], t(cflat).to("meta"),
            t(off0).to("meta"), t(off1).to("meta"), 8, 8)
    with pytest.raises(ValueError, match="no kernel"):
        twindow.window_lookup(t(levels[1]).to("meta"), 4, 4,
                              t(cflat).to("meta"), t(cflat).to("meta"))
    meta = [t(v).to("meta") for v in levels]
    with pytest.raises(ValueError, match="no kernel"):
        tparts.k2_stream_floor(meta, t(cflat).to("meta"), t(off0).to("meta"),
                               t(off1).to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tparts.k2_one_level(meta[0], t(cflat).to("meta"), 0, 8, 8)
    with pytest.raises(ValueError, match="no kernel"):
        trow.row_gather(torch.zeros(1, 2, 3, 4, device="meta"),
                        torch.zeros(1, 2, 4, dtype=torch.int32,
                                    device="meta"))


def test_distinct_sectors_counts_32_byte_granules(rng):
    """K2's sector count (utils/measure.py) against a numpy statement: the
    distinct 32-byte sectors of the flat [E, P1, h*w] array that the
    in-bounds bilinear corners of each (edge, pixel)'s taps fall in."""
    from lgu_slam_tpu_torch.utils.measure import (
        distinct_corners,
        distinct_sectors,
    )

    E, P1, K, h, w = 2, 3, 5, 6, 16
    px = rng.random(size=(E, P1, K)).astype(np.float32) * 20 - 2
    py = rng.random(size=(E, P1, K)).astype(np.float32) * 8 - 1
    for esize in (2, 4):
        want = 0
        corners = 0
        for e in range(E):
            for p in range(P1):
                base = (e * P1 + p) * h * w
                seen, cells = set(), set()
                for x, y in zip(np.floor(px[e, p]), np.floor(py[e, p])):
                    if not (0 <= x < w and 0 <= y < h):
                        continue
                    for dy in (0, 1):
                        for dx in (0, 1):
                            if x + dx < w and y + dy < h:
                                i = int((y + dy) * w + x + dx)
                                cells.add(i)
                                seen.add((base + i) * esize // 32)
                want += len(seen)
                corners += len(cells)
        assert distinct_sectors(t(px), t(py), h, w, esize) == want
        assert distinct_corners(t(px), t(py), h, w) == corners
