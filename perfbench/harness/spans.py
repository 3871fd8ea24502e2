"""Spans and counters recorded by the benchmark around the port's calls.

In a traced run the harness replaces a few attributes of the port's modules
(a method of a class, a function a module imported by name) with wrappers.
While timing, a wrapper records a CUDA event before and after the call and
adds to counters what a reader needs (FLOPs from shapes); while the device
is profiled, it records the call's host interval (``time.time_ns``, the
profiler's clock) so that idle gaps can be named, and may keep what a
kernel's bound needs.  Nothing synchronises until :meth:`Spans.durations`
reads the events after the window.  :meth:`Spans.restore` puts every
attribute back.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events = defaultdict(list)
        self.counts = defaultdict(float)
        self.samples = defaultdict(list)
        self.host = []  # (name, start_ns, end_ns) while profiling
        self.timing = False
        self.profiling = False
        self._saved = []

    def wrap(self, owner, attr: str, name: str, count=None, around=None):
        """Wrap ``owner.attr``.  ``count(args, kwargs, result)`` returns a
        dict added to the counters; ``around(name, call)`` may replace the
        call itself (a launch sample)."""
        orig = owner.__dict__[attr] if isinstance(owner, type) else \
            getattr(owner, attr)
        spans = self

        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            if spans.timing and spans.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            if around is not None:
                out = around(lambda: orig(*args, **kwargs), args, kwargs)
            else:
                out = orig(*args, **kwargs)
            if spans.timing and spans.cuda:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                spans.events[name].append((e0, e1))
            if spans.profiling:
                spans.host.append((name, t0, time.time_ns()))
            if spans.timing and count is not None:
                for key, value in count(args, kwargs, out).items():
                    spans.counts[key] += value
            return out

        self._saved.append((owner, attr, orig))
        setattr(owner, attr, wrapper)

    def restore(self):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()

    def start(self):
        """Drop the spans and counters recorded so far; time from now on."""
        self.events.clear()
        self.counts.clear()
        self.timing = True

    def stop(self):
        self.timing = False

    def durations(self) -> dict:
        """name -> [ms of each call], after a synchronise."""
        if self.cuda:
            torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) for a, b in pairs]
                for name, pairs in self.events.items()}
