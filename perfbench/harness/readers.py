"""Arithmetic shared by the metric readers (``metrics/<name>.py``).

Each reader takes a :class:`~perfbench.harness.core.Run` and returns its
number, or None where the run has nothing to read (the metric is then left
out of the result line).  A rate is taken over all the window's work and
time; a tail over all of the window's calls.
"""

from __future__ import annotations

import statistics

# kernels of cuDNN's convolution algorithms by name: implicit GEMM (fprop,
# dgrad, wgrad), Winograd, FFT (cuDNN's FFT kernels, its complex cf32 GEMMs
# and complex region transforms: the port has no other complex
# arithmetic), and the layout transforms cuDNN runs around them
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "fft",
                "DSE::", "cf32", "region_transform", "implicit",
                "flip_filter", "nchwToNhwc", "nhwcToNchw", "cudnn")


def per_unit_ms(run) -> float | None:
    """Window milliseconds per unit of work (frame, 128 edge-updates,
    step)."""
    if not run.calls or run.units <= 0:
        return None
    return 1e3 * run.window_s / run.units


def call_quantile_ms(run, q: int) -> float | None:
    """The q-th percentile of the calls' latencies, over every call of the
    window (statistics.quantiles, inclusive)."""
    lat = [1e3 * t for t, _ in run.calls]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1]


def span_ms_per_unit(run, name: str) -> float | None:
    """A span's device milliseconds summed over the window, per unit."""
    spans = run.spans.get(name)
    if not spans or run.units <= 0:
        return None
    return sum(spans) / run.units


def kernels_per_unit(run) -> float | None:
    """Device kernels launched per unit of work in the traced calls."""
    t = run.trace
    if t is None or t.units <= 0 or not t.kernels:
        return None
    return len(t.kernels) / t.units


def conv_ms_per_unit(run) -> float | None:
    """Device milliseconds in convolution kernels per unit of work in the
    traced calls."""
    t = run.trace
    if t is None or t.units <= 0 or not t.kernels:
        return None
    ns = sum(e - s for name, s, e in t.kernels
             if any(k in name for k in CONV_KERNELS))
    return 1e-6 * ns / t.units


def idle_share(run) -> float | None:
    """Per cent of the traced window with no operation on the device."""
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_share(run, kernel: str) -> float | None:
    """Per cent: the kernel's bound over its measured time, summed over the
    sampled launches."""
    pairs = run.samples.get(kernel) if run.samples else None
    if not pairs:
        return None
    return 100.0 * sum(b for b, _ in pairs) / sum(t for _, t in pairs)


def mfu(run) -> float | None:
    """Per cent of the configuration's peak: the model FLOPs counted over
    the window over its time."""
    f = run.counts.get("flops") if run.counts else None
    if not f or run.window_s <= 0 or run.peak_flops <= 0:
        return None
    return 100.0 * f / run.window_s / run.peak_flops
