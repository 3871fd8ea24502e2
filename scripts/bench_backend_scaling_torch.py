#!/usr/bin/env python
"""Sharded-backend scaling measurement of the PyTorch port: the
counterpart of ``scripts/bench_backend_scaling.py``.

Runs the backend's global ``update_lowmem`` pass (``--steps`` steps over a
proximity graph of ``--t`` keyframes at 64 x 96) at each world size and
reports the wall time of one pass.  At world size 1 the pass runs in this
process with no process group; at n > 1 the script starts n processes of
its own, one rank each, joined in a ``torch.distributed`` group on a free
local port, and each calls ``update_lowmem(steps=..., group=...)``
(``parallel/backend_shard.py``).

- ``--device cuda`` (the default): NCCL, one rank per card, at the powers
  of two up to ``torch.cuda.device_count()``; more ranks than cards, or no
  CUDA, raise.
- ``--device cpu``: gloo at world sizes 1, 2, 4 and 8, as the JAX script
  runs them on its 8 virtual CPU devices; each rank takes
  ``max(1, cores // n)`` intra-op threads, so that 8 ranks do not
  oversubscribe the host.

The graph is the JAX script's: ``corr_impl="alt"``, ``max_factors`` =
``edge_bucket`` = ``backend_edge_cap`` = 16 t, ``inactive_bucket`` 16,
``backend_chunk`` 32, ``buffer`` t, the video filled with the same numpy
draws in the same order from one ``default_rng(0)`` (the graph of the k-th
world size is the k-th draw; every rank replays the draws), then
``add_proximity_factors(rad=2, nms=2, thresh=1e9)``.  Weights: the port's
``init_state_dict(cfg, seed=0)``.  One pass warms up (it builds the
kernels and lets cuDNN choose); each of ``--reps`` passes is then timed on
rank 0 between a barrier and a device synchronise, and the minimum is
reported.

stderr carries one line per world size; the last stdout line is the JAX
script's JSON, ``{"metric": "backend_lowmem_pass_ms_by_devices", "t",
"steps", "ms": {"1": ..., ...}}``, with ``"device"`` (``cpu``, or the
card's name).

    python scripts/bench_backend_scaling_torch.py [--t 32] [--reps 3]
        [--steps 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from lgu_slam_tpu_torch.lie import se3_exp  # noqa: E402
from lgu_slam_tpu_torch.models.net import LGUNet, init_state_dict  # noqa: E402
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph  # noqa: E402
from lgu_slam_tpu_torch.slam.state import Video  # noqa: E402
from lgu_slam_tpu_torch.utils.config import SLAMConfig  # noqa: E402
from lgu_slam_tpu_torch.utils.device import resolve_device  # noqa: E402

# the world sizes of --device cpu (the JAX script's device counts)
CPU_WORLDS = (1, 2, 4, 8)
WORKER = "_rank"  # argv[0] of a rank process this script starts
RANK_TIMEOUT_S = 1800  # a rank still running then is killed


def config(T: int, **over) -> SLAMConfig:
    """The JAX script's configuration at ``T`` keyframes (``over``: other
    fields, such as the dtypes)."""
    return SLAMConfig(**{**dict(
        image_size=(64, 96), buffer=T, max_factors=16 * T,
        edge_bucket=16 * T, inactive_bucket=16, pose_bucket=T,
        backend_edge_cap=16 * T, backend_chunk=32), **over})


def draw_video(T: int, h: int, w: int, k: int) -> dict:
    """The ``k``-th video the JAX script draws from its ``default_rng(0)``
    (numpy, in its order: fmaps, nets, inps, the pose twists, disparities)."""
    rng = np.random.default_rng(0)
    for _ in range(k + 1):
        d = dict(fmaps=rng.normal(size=(T, 1, h, w, 128)),
                 nets=rng.normal(size=(T, h, w, 128)),
                 inps=rng.normal(size=(T, h, w, 128)),
                 twists=np.cumsum(rng.normal(size=(T, 6)) * 0.01, 0),
                 disps=0.5 + 0.3 * rng.random((T, h, w)))
    return d


def fresh_graph(cfg: SLAMConfig, net: LGUNet, draw: dict,
                device) -> FactorGraph:
    """The JAX script's ``fresh_graph`` on the port: a video of ``draw``
    and its proximity edges."""
    T, h, w = cfg.buffer, cfg.ht8, cfg.wd8
    video = Video(cfg, device)
    video.counter = T
    fd = video.fmaps.dtype
    f32 = dict(dtype=torch.float32, device=device)
    for name in ("fmaps", "nets", "inps"):
        getattr(video, name)[:T] = torch.as_tensor(draw[name], **f32).to(fd)
    video.poses[:T] = se3_exp(torch.as_tensor(draw["twists"], **f32))
    video.disps[:T] = torch.as_tensor(draw["disps"], **f32)
    video.intrinsics[:T] = torch.tensor([w * 4.0, w * 4.0, w / 2, h / 2],
                                        **f32)
    g = FactorGraph(net, video, cfg, corr_impl="alt",
                    max_factors=cfg.max_factors,
                    edge_bucket=cfg.backend_edge_cap, inactive_bucket=16)
    g.add_proximity_factors(rad=2, nms=2, thresh=1e9)
    return g


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def passes(job: dict, group=None) -> dict:
    """One rank's run of ``job``: the graph, a warm-up pass, ``reps`` timed
    passes; the minimum ms (None without reps), the edge count, and the
    video's poses and disparities after the last pass (on the CPU)."""
    device = torch.device(job["device"])
    cfg = config(job["t"], **job["over"])
    net = LGUNet.from_config(cfg, device=device)
    net.load_state_dict(job["state_dict"])
    net.eval()
    g = fresh_graph(cfg, net, draw_video(job["t"], cfg.ht8, cfg.wd8,
                                         job["draw"]), device)
    g.update_lowmem(steps=job["steps"], group=group)
    sync(device)
    times = []
    for _ in range(job["reps"]):
        if group is not None:
            dist.barrier(group)
        t0 = time.perf_counter()
        g.update_lowmem(steps=job["steps"], group=group)
        sync(device)
        times.append(time.perf_counter() - t0)
    T = g.video.counter
    return dict(ms=min(times) * 1e3 if times else None, edges=g.n_edges,
                ii=g.ii.copy(), jj=g.jj.copy(),
                poses=g.video.poses[:T].cpu(), disps=g.video.disps[:T].cpu())


def threads_per_rank(world: int) -> int:
    """Intra-op threads of each of ``world`` CPU ranks: the cores this
    process may run on, shared out."""
    cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else os.cpu_count() or 1
    return max(1, cores // world)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_rank(job_path: str, rank: int) -> None:
    """A rank process: joins the group, runs :func:`passes`; rank 0 saves
    the result beside the job."""
    job = torch.load(job_path, weights_only=False)
    world, device = job["world"], torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        job["device"] = str(device)
    else:
        torch.set_num_threads(job["threads"])
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{job['port']}", world_size=world,
        rank=rank)
    try:
        out = passes(job, dist.group.WORLD)
        if rank == 0:
            torch.save(out, job_path + ".out")
    finally:
        dist.destroy_process_group()


def run_world(world: int, T: int = 32, steps: int = 2, reps: int = 3,
              device="cuda", state_dict=None, draw: int = 0,
              over=None) -> dict:
    """:func:`passes` at ``world`` ranks: in this process with no group at
    1, else in ``world`` processes this function starts (a gloo or NCCL
    group); rank 0's result.  ``state_dict``: the weights (default
    ``init_state_dict(config(T), seed=0)``); ``draw``: which of the JAX
    script's videos; ``over``: :func:`config` fields set otherwise."""
    device = resolve_device(device)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} ranks need {world} cards; this machine "
                           f"has {torch.cuda.device_count()}")
    if state_dict is None:
        state_dict = init_state_dict(config(T), seed=0)
    job = dict(t=T, steps=steps, reps=reps, device=str(device),
               state_dict=state_dict, draw=draw, world=world,
               over=dict(over or {}), threads=threads_per_rank(world))
    if world == 1:
        if device.type == "cpu":
            old = torch.get_num_threads()
            torch.set_num_threads(job["threads"])
            try:
                return passes(job)
            finally:
                torch.set_num_threads(old)
        return passes(job)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job.pt")
        job["port"] = free_port()
        torch.save(job, path)
        env = dict(os.environ, OMP_NUM_THREADS=str(job["threads"]))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), WORKER, path,
             str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                tail = "\n".join(out.splitlines()[-30:])
                raise RuntimeError(f"rank {r} of {world} failed:\n{tail}")
        return torch.load(path + ".out", weights_only=False)


def worlds_for(device: torch.device) -> tuple:
    """The world sizes of a run on ``device``."""
    if device.type == "cpu":
        return CPU_WORLDS
    n = torch.cuda.device_count()
    return tuple(1 << k for k in range(n.bit_length()))


def main(argv=None, worlds=None) -> dict:
    """The command line (module docstring); ``worlds`` cuts the world
    sizes (default: :func:`worlds_for` the device).  Returns the JSON
    object printed last."""
    if argv and argv[0] == WORKER:
        run_rank(argv[1], int(argv[2]))
        return {}
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--t", type=int, default=32, help="keyframes")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu "
                   "(gloo)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    worlds = tuple(worlds or worlds_for(device))
    name = "cpu" if device.type == "cpu" else torch.cuda.get_device_name(
        device)
    state_dict = init_state_dict(config(args.t), seed=0)
    results = {}
    for k, n in enumerate(worlds):
        r = run_world(n, args.t, args.steps, args.reps, device, state_dict,
                      draw=k)
        results[n] = r["ms"]
        print(f"devices={n}: {r['ms']:8.1f} ms / pass ({args.steps} steps, "
              f"{r['edges']} edges, t={args.t}, {name})", file=sys.stderr,
              flush=True)
    out = {"metric": "backend_lowmem_pass_ms_by_devices", "t": args.t,
           "steps": args.steps,
           "ms": {str(k): round(v, 1) for k, v in results.items()},
           "device": name}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
