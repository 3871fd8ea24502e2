"""Tracing / profiling (port of the JAX package's ``utils/profiling.py``).

- :class:`PhaseTimer`: wall-clock accumulators per pipeline phase
  (decode, track, backend, ...), with a device synchronisation at the end of
  a phase so that timings are honest under asynchronous launches.
- :func:`trace`: context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``) into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def _synchronize(sync) -> None:
    """Wait for the card that holds ``sync`` (a tensor or a device); a CPU
    tensor or device needs no wait."""
    device = getattr(sync, "device", sync)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; pass a tensor or a device in ``sync`` to wait for
        its card (``torch.cuda.synchronize``) before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3)}
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def trace(logdir: str = "build/trace"):
    """``torch.profiler`` over the block (CPU, and CUDA where available);
    writes ``<logdir>/trace.json`` (Chrome trace format) at the end and
    yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
