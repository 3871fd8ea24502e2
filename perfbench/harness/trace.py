"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
only (recording every host operation would slow the host several-fold and
make the device look idler than it is) over a few calls, reduced to the
device's operations, its busy time (the union of their intervals), the
kernels in launch order, and the idle gaps named by the harness span that
the host was in (its wrappers' intervals, on the profiler's clock)."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Trace:
    """Device operations [(name, start_ns, end_ns)] inside the traced
    window [t0, t1] (ns, the profiler's clock), the kernels among them in
    start order, the host's span intervals, and the traced calls' work."""

    ops: list
    t0: int
    t1: int
    units: float
    calls: int
    host: list = field(default_factory=list)

    @property
    def kernels(self) -> list:
        return [op for op in self.ops if _is_kernel(op[0])]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return _union(self.ops) * 1e-9


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(ops) -> int:
    if not ops:
        return 0
    iv = sorted((s, e) for _, s, e in ops)
    total, cur_s, cur_e = 0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return int(total + cur_e - cur_s)


def _device_events(prof):
    """(name, start_ns, end_ns) of every device operation profiled."""
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    out = []
    if raw is not None:
        for e in raw:
            if "CUDA" not in str(e.device_type()):
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = 1000 * e.start_us(), 1000 * e.duration_us()
            out.append((e.name(), int(s), int(s + d)))
        return out
    for e in prof.events():
        if "CUDA" in str(e.device_type):
            out.append((e.name, int(1000 * e.time_range.start),
                        int(1000 * e.time_range.end)))
    return out


def profile_calls(call, n: int, device, spans) -> Trace:
    """Profile ``n`` calls of ``call()`` (each returning its work units);
    ``spans.profiling`` is on meanwhile."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    acts = ([torch.profiler.ProfilerActivity.CUDA] if cuda else
            [torch.profiler.ProfilerActivity.CPU])
    units = 0.0
    spans.profiling = True
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time_ns()
        for _ in range(n):
            units += call()
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    spans.profiling = False
    ops = sorted(((name, max(s, t0), min(e, t1))
                  for name, s, e in _device_events(prof)
                  if e > t0 and s < t1), key=lambda op: op[1])
    host = [h for h in spans.host if h[2] > t0 and h[1] < t1]
    return Trace(ops, t0, t1, units, n, host)


def top_ops(trace: Trace, n: int = 10, width: int = 160):
    """The ``n`` device operations that took most time: [[name, s]], the
    profiler's names cut to ``width`` characters."""
    by = defaultdict(int)
    for name, s, e in trace.ops:
        by[name[:width]] += e - s
    return [[name, ns * 1e-9] for name, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10):
    """The ``n`` longest stretches with no device operation: [[the
    innermost harness span open on the host at the gap's start ("host"
    outside every span), s]]."""
    gaps, cur = [], trace.t0
    for _, s, e in trace.ops:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if trace.t1 > cur:
        gaps.append((cur, trace.t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    hs = np.asarray([h[1] for h in trace.host], np.int64)
    he = np.asarray([h[2] for h in trace.host], np.int64)
    out = []
    for s, e in gaps:
        inside = np.nonzero((hs <= s) & (he > s))[0] if len(hs) else []
        what = (trace.host[max(inside, key=lambda k: hs[k])][0]
                if len(inside) else "host")
        out.append([what, (e - s) * 1e-9])
    return out
