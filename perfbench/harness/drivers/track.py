"""Closed-loop tracking: ``LGUSlam.track`` over the frames of a closed
camera loop, played cyclically, one camera.

Set-up renders the loop's frames and depths on the device from the seed
(then hands them to ``track`` as host arrays, as a camera would), makes the
weights, and tracks ``setup_frames`` frames: the frontend's initialisation
and a full window.  Each call of the window tracks the next frame.  Should
the keyframe counter reach the buffer, a new session starts on a fresh
system, inside the window.

The check follows the program step by step from its own state: before and
after each sampled call (the initialising call and calls drawn from the
seed) the driver keeps the program's state, between the timed calls; once
the window has closed the reference loads the state from before, works out
every keyframe's features again from the frames, tracks the same frame, and
the afters are compared.  It does so twice: in float32 (the reference) and
at the precision the configuration states.  A state in which a weakly
observed keyframe's disparities, and the poses with them, turn on the last
bits (the stated-precision reference then lands as far from the float32 one
as the program does) would make any plain gap swing from seed to seed; so
the poses' and the disparities' gaps to the float32 reference, each a share
of the reference's own change, are compared in units of the stated-precision
reference's gap to it (never under ``unit_floor``), the widest over the
sampled window calls.  The initialising call starts from identity poses and
plans its proximity edges halfway, from its own estimates: there the
reference plans from the program's estimates of that moment, and the two
plans have to agree exactly; its ratios swing with any rounding (a lower
precision may read as little), so they are readings only.  The new
keyframe's stored features are compared by themselves at every sampled
call.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import roofline
from perfbench.harness.drivers import (
    Base,
    count_dba,
    count_model,
    read_kernel_samples,
    rel_err,
    rel_gap,
    sample_kernels,
)
from perfbench.harness.scene import Scene, loop_poses, pinhole
from perfbench.harness.weights import make_state_dict


def slam_config(cls, cfg: dict, **over):
    d = {**cfg, **over}
    d["image_size"] = tuple(d["image_size"])
    return cls(**d)


def render_loop(traffic: dict, H: int, W: int, seed: int, device):
    """The loop's frames: (images [L, H, W, 3] uint8, depths [L, H, W]
    float32, intrinsics [4], poses [L, 7]), the frames as host arrays.  The
    textures come from the seed; the billboards' placement too, unless the
    mix fixes it by its own ``layout_seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    layout = None
    if "layout_seed" in traffic:  # the same placement for every seed
        layout = torch.Generator().manual_seed(traffic["layout_seed"])
    scene = Scene(gen, device, n_planes=traffic["planes"], layout=layout)
    poses = loop_poses(**traffic["loop"])
    intr = pinhole(H, W, traffic["focal"])
    imgs, depths = [], []
    for lo in range(0, poses.shape[0], 16):
        i, d = scene.render(poses[lo:lo + 16], intr, H, W)
        imgs.append(i.cpu())
        depths.append(d.cpu())
    return (torch.cat(imgs).numpy(), torch.cat(depths).numpy(), intr,
            poses)


class Driver(Base):
    def __init__(self, cell, seed, device, impl):
        super().__init__(cell, seed, device, impl)
        self.cfg = cell.config["slam"]
        self.H, self.W = self.cfg["image_size"]
        compute = self.cfg["compute_dtype"]
        self.peak_flops = roofline.peak_flops(compute)

    # -- the system under test ------------------------------------------

    def _system(self):
        if self.impl == "program":
            from lgu_slam_tpu_torch.slam.system import LGUSlam
            from lgu_slam_tpu_torch.utils.config import SLAMConfig
            return LGUSlam(self.weights, slam_config(SLAMConfig, self.cfg),
                           device=self.device)
        from perfbench.reference.config import SLAMConfig
        from perfbench.reference.system import RefSlam
        return RefSlam(self.weights, slam_config(
            SLAMConfig, self.cfg, **self.limits["control"]), self.device)

    def setup(self):
        self.images, self.depths, self.intr, _ = render_loop(
            self.traffic, self.H, self.W, self.seed, self.device)
        self.weights = make_state_dict(self.seed, self.device)
        self.system = self._system()
        self.slots = []  # frame index of each keyframe slot of the session
        self.k = 0
        self.sessions = 1
        n_setup = self.traffic["setup_frames"]
        self.sampled = set(self.sample_draw(
            n_setup, self.traffic["sample_span"],
            self.limits["sampled_calls"]))
        self.init_call = self.cfg["warmup"] - 1  # the frontend initialises
        self.sampled.add(self.init_call)
        self.pairs = []
        self.edges = []  # active frontend edges after each call
        self.before = None
        for _ in range(n_setup):
            self.keep("before")
            self.call()
            self.keep("after")

    def keep(self, when: str) -> bool:
        if when == "before":
            if self.k not in self.sampled or self._full():
                return False
            self.before = self._state()
            if self.k == self.init_call:  # in set-up, so untimed
                self._record_plan()
            return True
        if self.before is None:
            return False
        self.system.frontend.graph.__dict__.pop("add_proximity_factors",
                                                None)
        k = self.k - 1
        self.pairs.append((k, self.before, self._after(self.before["n"])))
        self.before = None
        return True

    def _record_plan(self):
        """Keep what the proximity plan made inside the initialising call
        (between its two runs of iterations, from its own estimates)
        starts from and chooses: the keyframes' poses and disparities and
        the edges it adds.  A window call plans first, from the state the
        check loads, and needs none of this."""
        g, v = self.system.frontend.graph, self.system.video
        plan = g.add_proximity_factors

        def recorded(*a, **kw):
            n0 = g.n_edges
            kept = dict(poses=v.poses.clone(), disps=v.disps.clone())
            plan(*a, **kw)
            self.before["plan"] = dict(kept, ii=g.ii[n0:].copy(),
                                       jj=g.jj[n0:].copy())

        g.add_proximity_factors = recorded

    def _full(self) -> bool:
        return self.system.video.counter >= self.system.cfg.buffer - 2

    def call(self) -> float:
        if self._full():  # a new session, inside the window
            del self.system
            self.system = self._system()
            self.slots = []
            self.sessions += 1
        s = self.system
        i = self.k % len(self.images)
        n = s.video.counter
        s.track(float(self.k), self.images[i], self.depths[i], self.intr)
        if s.video.counter > n:
            self.slots.append(i)
        self.edges.append(s.frontend.graph.n_edges)
        self.k += 1
        return 1.0

    def _state(self) -> dict:
        s = self.system
        v, g, fe = s.video, s.frontend.graph, s.frontend
        n = v.counter
        return dict(
            n=n, slots=list(self.slots),
            poses=v.poses[:n + 1].clone(), disps=v.disps[:n + 1].clone(),
            damping=v.damping[:n + 1].clone(),
            edges={a: getattr(g, a).copy() for a in
                   ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad",
                    "jj_bad")},
            edge_state={a: getattr(g, a).float().clone() for a in
                        ("target", "weight", "hidden", "target_inac",
                         "weight_inac")},
            frontend=dict(t0=fe.t0, t1=fe.t1, count=fe.count,
                          is_initialized=fe.is_initialized),
            filter_count=s.filter.count)

    def _after(self, n: int) -> dict:
        v = self.system.video
        g = self.system.frontend.graph
        m = v.counter
        return dict(n=m, poses=v.poses[:m].clone(), disps=v.disps[:m].clone(),
                    edges=(g.ii.copy(), g.jj.copy()),
                    feats=(v.fmaps[n, 0].float().clone(),
                           v.nets[n].float().clone(),
                           v.inps[n].float().clone()) if m > n else None)

    def finish(self):
        del self.system
        self.system = None

    # -- tracing ----------------------------------------------------------

    def instrument(self, spans):
        import sys
        s = self.system
        spans.wrap(type(s.filter), "track", "filter")
        spans.wrap(type(s.frontend), "__call__", "frontend")
        count_model(spans, type(s.net), self.H, self.W)
        count_dba(spans, sys.modules[type(s.frontend.graph).__module__])
        package = type(s.net).__module__.rsplit(".", 1)[0]
        sample_kernels(spans, sys.modules[package + ".corr"])

    def read_samples(self, run):
        read_kernel_samples(run)

    def notes(self, run) -> list:
        edges = self.edges[self.traffic["setup_frames"]:]
        return [f"frames in the window: {len(run.calls)}; sessions "
                f"{self.sessions}; latency samples {len(run.calls)}; "
                f"active edges after a call: mean "
                f"{np.mean(edges) if edges else 0:.1f}, min "
                f"{min(edges, default=0)}, max {max(edges, default=0)}",
                *self.readings]

    # -- the check --------------------------------------------------------

    def _replay(self, k: int, before: dict, dtypes: dict):
        """The reference at ``dtypes``, loaded with the program's state from
        before call ``k`` (every keyframe's features worked out again from
        the frames), after tracking call ``k``'s frame."""
        from perfbench.reference.config import SLAMConfig
        from perfbench.reference.slam.motion_filter import subsample_depth
        from perfbench.reference.models.net import normalize_images
        from perfbench.reference.precision import rnd
        from perfbench.reference.system import RefSlam

        n = before["n"]
        cfg = slam_config(SLAMConfig, self.cfg, buffer=n + 2, **dtypes)
        ref = RefSlam(self.weights, cfg, self.device)
        v, g, fe = ref.video, ref.frontend.graph, ref.frontend
        frames = before["slots"]
        dev = self.device
        v.counter = n
        if n:
            v.images[:n] = torch.as_tensor(self.images[frames], device=dev)
            v.intrinsics[:n] = torch.as_tensor(self.intr / 8.0, device=dev)
            v.disps_sens[:n] = torch.as_tensor(np.stack(
                [subsample_depth(self.depths[f]) for f in frames]),
                device=dev)
            v.tstamp[:n] = torch.arange(n, device=dev, dtype=torch.float32)
        v.poses[:n + 1] = before["poses"]
        v.disps[:n + 1] = before["disps"]
        v.damping[:n + 1] = before["damping"]
        ed = before["edges"]
        ids = np.concatenate([ed["ii"], ed["jj"],
                              [n - self.traffic["encode_window"]]])
        lo = max(0, int(ids.min()))
        with torch.no_grad():
            for a in range(lo, n, 8):
                b = min(a + 8, n)
                x = normalize_images(v.images[a:b])
                fmap = ref.net.features(x)
                net, inp = ref.net.context(x)
                v.fmaps[a:b, 0] = rnd(fmap, cfg.feat_dtype)
                v.nets[a:b] = rnd(net, cfg.feat_dtype)
                v.inps[a:b] = rnd(inp, cfg.feat_dtype)
                if b == n:
                    ref.filter.fmap = fmap[-1]
                    ref.filter.hidden, ref.filter.inp = net[-1], inp[-1]
        ref.filter.count = before["filter_count"]
        for a, x in before["frontend"].items():
            setattr(fe, a, x)
        for a, x in ed.items():
            setattr(g, a, x.copy())
        for a, x in before["edge_state"].items():
            setattr(g, a, x.clone())
        g._pyr_dirty = True
        if "plan" in before:
            _follow_plan(ref, before["plan"])
        i = k % len(self.images)
        ref.track(float(k), self.images[i], self.depths[i], self.intr)
        return ref

    def check(self) -> dict:
        unit = self.limits["unit_floor"]
        stated = {key: self.cfg[key] for key in self.limits["reference"]}
        pose, disp, feat = [], [], []
        self.readings = []
        for k, before, after in self.pairs:
            n, m = before["n"], after["n"]
            ref = self._replay(k, before, self.limits["reference"])
            wit = self._replay(k, before, stated)
            v, w = ref.video, wit.video
            if getattr(ref, "plan_agrees", True) is False:
                pose.append(float("inf"))
                disp.append(float("inf"))
                self.readings.append(f"call {k}: the reference plans other "
                                     "edges from the program's estimates")
                continue
            if v.counter != m or w.counter != m:
                pose.append(float("inf"))
                disp.append(float("inf"))
                self.readings.append(
                    f"call {k}: {v.counter} / {w.counter} keyframes in the "
                    f"reference / at the stated precision, {m} in the "
                    "program")
                continue
            base_p = v.poses[:m].clone()
            base_p[:n + 1] = before["poses"][:m]
            base_d = v.disps[:m].clone()
            base_d[:n + 1] = before["disps"][:m]
            if m > n:  # RGB-D: the new keyframe adopts its sensed disparity
                sens = v.disps_sens[n]
                base_d[n] = torch.where(sens > 0, sens, base_d[n])
            gaps = {}
            for name, a, r, x, base in (
                    ("pose", after["poses"], v.poses[:m], w.poses[:m],
                     base_p),
                    ("disp", after["disps"], v.disps[:m], w.disps[:m],
                     base_d)):
                gaps[name] = (rel_gap(a, r, base), rel_gap(x, r, base))
            ratios = [gaps[q][0] / max(gaps[q][1], unit)
                      for q in ("pose", "disp")]
            if k != self.init_call:  # see the module's docstring
                pose.append(ratios[0])
                disp.append(ratios[1])
            if after["feats"] is not None and m > n:
                feat.append(max(rel_err(a, b) for a, b in zip(
                    after["feats"], (v.fmaps[n, 0], v.nets[n], v.inps[n]))))
            self.readings.append(
                f"call {k}: pose {ratios[0]!r} = {gaps['pose'][0]!r} / "
                f"{gaps['pose'][1]!r}; disp {ratios[1]!r} = "
                f"{gaps['disp'][0]!r} / {gaps['disp'][1]!r}; features "
                f"{feat[-1] if feat else None!r}")
            self.readings.append(_diagnosis(after, v, ref.frontend.graph, m,
                                            n, base_d))
            del ref, wit, v, w
        return {"pose_ratio": max(pose, default=float("inf")),
                "disp_ratio": max(disp, default=float("inf")),
                "feature_gap": max(feat, default=float("inf"))}



def _follow_plan(ref, plan: dict):
    """Make ``ref``'s next proximity plan the program's: the reference
    plans from the program's estimates of that moment, which it keeps in
    ``ref.plan_agrees`` (its own estimates differ by rounding, and so
    may the plan); then it goes on from its own estimates with the
    program's edges."""
    g, v = ref.frontend.graph, ref.video
    plan_own = g.add_proximity_factors
    ref.plan_agrees = None

    def follow(*a, **kw):
        B = v.poses.shape[0]
        own = (v.poses.clone(), v.disps.clone())
        edges = {a_: getattr(g, a_) for a_ in
                 ("ii", "jj", "age", "target", "weight", "hidden")}
        v.poses[:] = plan["poses"][:B]
        v.disps[:] = plan["disps"][:B].to(v.disps.dtype)
        n0 = g.n_edges
        plan_own(*a, **kw)
        ref.plan_agrees = (np.array_equal(g.ii[n0:], plan["ii"])
                           and np.array_equal(g.jj[n0:], plan["jj"]))
        for a_, x in edges.items():
            setattr(g, a_, x)
        v.poses[:], v.disps[:] = own
        g.add_factors(plan["ii"], plan["jj"], kw.get("remove", False))
        del g.add_proximity_factors

    g.add_proximity_factors = follow


def _diagnosis(after, v, g, m, n, base_d) -> str:
    """Where a sampled call's disparity gap lies: whether both sides ran the
    same edge list, the gap against the reference's own change, and the
    keyframe whose disparities differ most (as an offset from the new
    one)."""
    pi, pj = after["edges"]
    same = (len(pi) == len(g.ii) and bool((pi == g.ii).all())
            and bool((pj == g.jj).all()))
    dd = (after["disps"].double() - v.disps[:m].double()).reshape(m, -1)
    per = torch.linalg.vector_norm(dd, dim=1)
    change = torch.linalg.vector_norm(
        (v.disps[:m].double() - base_d.double()).reshape(-1))
    worst = int(per.argmax())
    return (f"  edges {len(pi)}, the same on both sides: {same}; disp "
            f"|gap| {float(per.norm())!r}, |change| {float(change)!r}; "
            f"worst keyframe {worst - n:+d} ({float(per[worst])!r})")
