"""Drivers: one per entry of the port that a window repeats.  A traffic
file names its driver; the driver builds the system under test from the
configuration and the mix, repeats one call, and compares what the timed
path produced with the plain reference."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import flops


class Base:
    sync_each = True  # each call ends in a synchronise
    failed = 0
    peak_flops = 0.0

    def __init__(self, cell, seed: int, device, impl: str):
        if impl not in ("program", "control"):
            raise ValueError(f"impl {impl!r}")
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.impl = impl
        self.traffic = cell.traffic
        self.limits = cell.limits
        self.readings = []  # the check's readings, for standard error

    def instrument(self, spans):
        """Install the traced run's wrappers (see ``harness/spans.py``)."""

    def read_samples(self, run):
        """Turn the launch samples into (bound ms, kernel ms) pairs."""

    def keep(self, when: str) -> bool:
        """Copy what the check needs of the program's state ``when``
        ("before" or "after") the next or last call; True where it did."""
        return False

    def finish(self):
        """Keep what the check needs from the program, free the rest."""

    def notes(self, run) -> list:
        return []

    def sample_draw(self, lo: int, span: int, n: int) -> list:
        """``n`` distinct call indices in [lo, lo + span) drawn from the
        seed."""
        rng = np.random.default_rng(self.seed)
        return sorted(int(x) for x in
                      lo + rng.choice(span, size=min(n, span), replace=False))


def rel_gap(a, b, base) -> float:
    """||a - b|| / ||b - base||: the gap between two answers as a share of
    the reference's own change from the common start."""
    num = torch.linalg.vector_norm((a.double() - b.double()).reshape(-1))
    den = torch.linalg.vector_norm((b.double() - base.double()).reshape(-1))
    if not torch.isfinite(num):
        return float("inf")
    return float(num / den.clamp_min(1e-30))


def rel_err(a, b) -> float:
    """||a - b|| / ||b||."""
    num = torch.linalg.vector_norm((a.double() - b.double()).reshape(-1))
    den = torch.linalg.vector_norm(b.double().reshape(-1))
    if not torch.isfinite(num):
        return float("inf")
    return float(num / den.clamp_min(1e-30))


def count_model(spans, net_cls, H: int, W: int, factor: float = 1.0):
    """Wrap the network's entries so that the counters hold the model
    FLOPs of every call (``flops.py``), times ``factor`` (3 where a
    backward follows: twice the forward)."""
    h, w = H // 8, W // 8
    enc_f, enc_c = flops.encoder(H, W, 128), flops.encoder(H, W, 256)
    spans.wrap(net_cls, "features", "features", lambda a, k, o: {
        "flops": factor * enc_f * a[1].shape[0]})
    spans.wrap(net_cls, "context", "context", lambda a, k, o: {
        "flops": factor * enc_c * a[1].shape[0]})
    spans.wrap(net_cls, "build_corr", "build_corr", lambda a, k, o: {
        "flops": factor * flops.build_corr(h, w) * a[1].shape[0]})
    if hasattr(net_cls, "alt_corr"):
        spans.wrap(net_cls, "alt_corr", "alt_corr", lambda a, k, o: {
            "flops": factor * flops.alt_corr(h, w) * a[2].shape[0]})

    def update(a, k, o):
        net = a[1]
        edges = net.shape[0] * net.shape[1]
        frames = a[6] if len(a) > 6 else k.get("num_frames")
        f = flops.update_edge(h, w) * edges
        if frames:
            f += flops.update_frame(h, w) * frames * net.shape[0]
        return {"flops": factor * f}

    spans.wrap(net_cls, "update_step", "update_step", update)


def count_dba(spans, module):
    """Wrap ``module.dba_step`` as the span "dba", counting its FLOPs."""
    def dba(a, k, o):
        disps, target, plan = a[1], a[4], a[7]
        iters = a[8] if len(a) > 8 else k.get("iters", 2)
        h, w = disps.shape[1:]
        return {"flops": iters * flops.dba_iteration(
            h, w, target.shape[0], plan.kf_ids.shape[0],
            plan.rows_of_slot.shape[1], plan.P)}

    spans.wrap(module, "dba_step", "dba", dba)


K1_KERNEL = "masked_corr_"  # masked_corr_tc_kernel, masked_corr_tf32_kernel
K2_KERNEL = "pyramid_lookup_kernel"


def sample_kernels(spans, corr_module, limit: int = 17):
    """While the device is profiled, keep what the bounds need: every K1
    launch's shapes, and the first ``limit`` K2 launches' level 1,
    coordinates and offsets (each launch is one kernel, so the n-th kept
    launch is the n-th K2 kernel of the trace)."""
    def k1(call, a, k):
        out = call()
        if spans.profiling:
            E, H, W, C = a[0].shape
            spans.samples["k1"].append((E, H, W, C, a[0].element_size(),
                                        out.element_size()))
        return out

    def k2(call, a, k):
        out = call()
        if spans.profiling:
            kept = spans.samples["k2"]
            levels, cflat, off0, off1, H, W = a[:6]
            kept.append(None if len(kept) >= limit else (
                levels[1].clone(), cflat.clone(), off0.clone(),
                off1.clone(), H, W, levels[1].element_size()))
        return out

    if hasattr(corr_module, "masked_corr_level0"):
        spans.wrap(corr_module, "masked_corr_level0", "k1", around=k1)
    if hasattr(corr_module, "fused_pyramid_lookup"):
        spans.wrap(corr_module, "fused_pyramid_lookup", "k2", around=k2)


def read_kernel_samples(run):
    """run.samples -> {"k1": [(bound ms, kernel ms)], "k2": [...]}, the
    kernel times from the trace, matched to the launches in order."""
    from perfbench.harness import roofline
    kernels = run.trace.kernels if run.trace else []
    k1_ms = [1e-6 * (e - s) for name, s, e in kernels if K1_KERNEL in name]
    k2_ms = [1e-6 * (e - s) for name, s, e in kernels if K2_KERNEL in name]
    out = {"k1": [], "k2": []}
    k1 = run.samples.get("k1", [])
    if len(k1) == len(k1_ms):
        out["k1"] = [(roofline.k1_bound_ms(*shape), ms)
                     for shape, ms in zip(k1, k1_ms)]
    k2 = run.samples.get("k2", [])
    if len(k2) == len(k2_ms):
        out["k2"] = [(roofline.k2_bound_ms(*kept), ms)
                     for kept, ms in zip(k2, k2_ms) if kept is not None]
    run.samples = out
