"""The yardstick's arithmetic on hand-made readings: rates over the whole
window, the p90 over all calls, the union-of-intervals idle share, the
kernels' bounds and the FLOP counts against hand counts at tiny shapes."""

from __future__ import annotations

import math
import statistics

import pytest
import torch
import torch.nn as nn

from perfbench.harness import flops, readers, roofline
from perfbench.harness.core import Run, load_cell
from perfbench.harness.trace import Trace, idle_gaps, top_ops


def make_run(calls, window_s, **kw):
    run = Run(load_cell("eth3d_rgbd.global_ba"), 1, torch.device("cpu"))
    run.calls = calls
    run.window_s = window_s
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_rates_over_the_whole_window():
    # 4 calls of 1, 1, 1 and 2 units in a 10 s window (time between calls
    # counts): 2 s per unit whatever the calls' own times
    run = make_run([(0.5, 1), (3.0, 1), (0.5, 1), (1.0, 2)], 10.0)
    assert readers.per_unit_ms(run) == pytest.approx(2000.0)
    assert readers.per_unit_ms(make_run([], 1.0)) is None


def test_state_copies_stay_out_of_the_window():
    """What a driver keeps for the check between calls is timed apart: the
    window's length and the calls' latencies leave it out."""
    import time

    from perfbench.harness import core

    class Driver:
        n = 0

        def keep(self, when):
            if when == "before" and self.n % 2 == 0:
                time.sleep(0.05)
                return True
            return False

        def call(self):
            self.n += 1
            time.sleep(0.01)
            return 1.0

    run = make_run([], 0.0)
    core.window(Driver(), 0.1, run, True)
    assert len(run.calls) >= 10
    assert all(t < 0.04 for t, _ in run.calls)
    assert run.window_s < 0.01 * len(run.calls) + 0.05


def test_p90_over_every_call():
    lat = [0.1 * k for k in range(1, 21)]
    run = make_run([(t, 1) for t in lat], 10.0)
    want = statistics.quantiles([1e3 * t for t in lat], n=100,
                                method="inclusive")[89]
    assert readers.call_quantile_ms(run, 90) == pytest.approx(want)
    assert want == pytest.approx(1810.0)


def test_spans_per_unit():
    run = make_run([(1, 1)] * 4, 4.0, spans={"dba": [10.0, 20.0, 30.0]})
    assert readers.span_ms_per_unit(run, "dba") == pytest.approx(15.0)
    assert readers.span_ms_per_unit(run, "missing") is None


def trace(ops, t0=0, t1=100, host=(), units=2.0):
    return Trace(list(ops), t0, t1, units, 2, list(host))


def test_idle_share_is_the_union_of_intervals():
    # [10, 30) and [20, 40) overlap: busy 30 of 100, not their sum 40
    t = trace([("a", 10, 30), ("b", 20, 40), ("Memcpy DtoD", 60, 70)])
    assert t.busy_s == pytest.approx(40e-9)
    run = make_run([], 1.0, trace=t)
    assert readers.idle_share(run) == pytest.approx(60.0)
    assert readers.kernels_per_unit(run) == pytest.approx(1.0)  # 2 kernels


def test_idle_gaps_named_by_the_open_span():
    t = trace([("a", 10, 30), ("b", 70, 80)],
              host=[("frontend", 0, 100), ("dba", 25, 65)])
    gaps = idle_gaps(t, 3)
    assert [g[0] for g in gaps] == ["dba", "frontend", "frontend"]
    assert [round(g[1] * 1e9) for g in gaps] == [40, 20, 10]
    assert top_ops(t) == [["a", 20e-9], ["b", 10e-9]]


def test_conv_kernels_by_name():
    t = trace([("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn", 0, 10),
               ("void DSE::vector_fft<0>", 10, 15),
               ("sm90_xmma_fprop_implicit_gemm_bf16", 15, 20),
               ("void gemv2N_kernel<int>", 20, 40),
               ("nvjet_tst_192x192_64x4", 40, 50)], units=1.0)
    run = make_run([], 1.0, trace=t)
    assert readers.conv_ms_per_unit(run) == pytest.approx(20e-6)


def test_roofline_share_and_mfu():
    run = make_run([], 2.0, samples={"k2": [(1.0, 2.0), (3.0, 4.0)]},
                   counts={"flops": 4e12}, peak_flops=1e12)
    assert readers.roofline_share(run, "k2") == pytest.approx(400 / 6)
    assert readers.roofline_share(run, "k1") is None
    assert readers.mfu(run) == pytest.approx(200.0)


def test_k1_bound_hand_count():
    E, H, W, C = 2, 4, 6, 128
    P = H * W
    nbytes = 2 * E * P * C * 2 + 2 * E * P * 2 * 4 + E * P * P * 2
    flop = 2 * E * P * P * C
    want = 1e3 * max(nbytes / 3.35e12, flop / 989e12)
    assert roofline.k1_bound_ms(E, H, W, C, 2, 2) == pytest.approx(want)
    want32 = 1e3 * max((2 * E * P * C * 4 + 2 * E * P * 2 * 4
                        + E * P * P * 4) / 3.35e12, 3 * flop / 494.7e12)
    assert roofline.k1_bound_ms(E, H, W, C, 4, 4) == pytest.approx(want32)


def test_k2_sectors_hand_count():
    """At one pixel and zero offsets the taps of each level, counted by hand
    as sets of 32-byte sectors, give the bound's bytes."""
    H, W = 16, 16
    P1 = H * W
    g = torch.Generator().manual_seed(0)
    dims = roofline.level_dims(H, W)
    level1 = torch.rand(1, P1, dims[1][0] * dims[1][1], generator=g)
    cflat = torch.zeros(1, P1, 2)
    cflat[..., 0] = 5.25
    cflat[..., 1] = 6.5
    off = torch.zeros(1, P1, 7, 7, 2)
    es = 2  # bf16 elements
    sectors = 0
    for lvl, (h, w) in enumerate(dims):
        x, y = 5.25 / 2 ** lvl, 6.5 / 2 ** lvl
        radii = [3] + ([1] if lvl == 1 else [])
        for p in range(P1):
            seen = set()
            for r in radii:
                for dx in range(-r, r + 1):
                    for dy in range(-r, r + 1):
                        x1, y1 = math.floor(x + dx), math.floor(y + dy)
                        if not (0 <= x1 < w and 0 <= y1 < h):
                            continue
                        for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                            if x1 + cx < w and y1 + cy < h:
                                flat = p * h * w + (y1 + cy) * w + x1 + cx
                                seen.add(flat * es // 32)
            sectors += len(seen)
    nbytes = (32 * sectors + cflat.numel() * 4 + 2 * off.numel() * 4
              + P1 * 196 * 4)
    got = roofline.k2_bound_ms(level1, cflat, off, off, H, W, es)
    assert got == pytest.approx(1e3 * nbytes / 3.35e12)


def conv_flops_by_hooks(module, *inputs) -> float:
    """2 x MACs of every Conv2d / Linear run by ``module(*inputs)``."""
    total = [0.0]

    def hook(mod, inp, out):
        if isinstance(mod, nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2.0 * out.numel() * mod.in_channels * k
        elif isinstance(mod, nn.Linear):
            total[0] += 2.0 * out.numel() * mod.in_features

    hs = [m.register_forward_hook(hook) for m in module.modules()
          if isinstance(m, (nn.Conv2d, nn.Linear))]
    with torch.no_grad():
        module(*inputs)
    for h in hs:
        h.remove()
    return total[0]


def test_encoder_flops_against_the_network():
    from perfbench.reference.models.extractor import BasicEncoder
    H, W = 32, 48
    for out in (128, 256):
        enc = BasicEncoder(out, "instance")
        got = conv_flops_by_hooks(enc, torch.zeros(1, H, W, 3))
        assert flops.encoder(H, W, out) == pytest.approx(got)


def test_update_flops_against_the_network():
    from perfbench.reference.models.update import UpdateModule
    h, w, E, F = 4, 6, 3, 2
    upd = UpdateModule()
    net = torch.zeros(1, E, h, w, 128)
    corr = torch.zeros(1, E, h, w, 196)
    flow = torch.zeros(1, E, h, w, 4)
    ii = torch.tensor([0, 1, 1])
    # the KAN layers (no nn.Linear) are left out on both sides
    got = conv_flops_by_hooks(upd, net, net, corr, flow, ii, F)
    want = E * flops.update_edge(h, w) + F * flops.update_frame(h, w)
    assert want == pytest.approx(got)


def test_offset_and_mask_flops_against_the_network():
    from perfbench.reference.models.gaussian_mask import GaussianMask
    from perfbench.reference.models.conv import Conv
    h, w = 4, 6
    t = torch.zeros(1, h, w, 256)
    got = conv_flops_by_hooks(Conv(256, 98, 3, 1, 1), t) + \
        conv_flops_by_hooks(Conv(256, 98, 3, 1, 1), t[:, ::2, ::2])
    assert flops.offsets(h, w) == pytest.approx(got)
    ga = GaussianMask()

    class Predict(nn.Module):
        def __init__(self):
            super().__init__()
            self.ga = ga

        def forward(self, x):
            return self.ga.predict(x)

    assert flops.gaussian_mask(h, w) == pytest.approx(
        conv_flops_by_hooks(Predict(), t))
    assert flops.volume(h, w) == 2.0 * (h * w) ** 2 * 128
