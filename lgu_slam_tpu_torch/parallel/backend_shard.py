"""The backend's global low-memory pass over a process group (port of the
JAX package's ``parallel/backend_shard.py`` to ``torch.distributed``).

The keyframe axis is sharded: the edges, stably sorted by source frame
``ii``, are split into contiguous frame ranges balanced by edge count (the
partition of ``parallel/dba_shard.py``), and each rank takes the edges of
its frames in chunks of ``cfg.backend_chunk``.  Every step

- runs the rank's chunks in order through the graph's alt-correlation GRU
  update (``FactorGraph.lowmem_chunk_update``; on the card it launches K2
  once per ``backend_sub_chunk`` edges of a chunk).  A frame's edges all
  live on its owner, so its damping (and upsampled disparity) is written
  by one rank only, and one owner-masked ``all_reduce`` rebuilds the whole
  buffer on every rank;
- runs the DBA over all edges with :func:`sharded_dba_iters`.

Each chunk's GraphAgg frame slots are padded to the chunk size with frame
0, as in the one-process path, so frame 0 keeps its damping in a chunk
with padded slots (the JAX package's scatter, which the port follows).
GraphAgg aggregates over the edges within a chunk, so the pass equals the
one-process ``update_lowmem`` only where the chunks coincide: where every
rank's edges fill whole chunks and are already sorted by ``ii`` (at world
size 1 too, since the one-process path chunks in edge order).

Ranks must hold the same video and edges: :func:`broadcast_video` gives
every rank rank 0's video, and the pass checks agreement of its inputs
with one all-reduced checksum and raises where ranks differ.  At the end
every rank holds every edge's new target, weight and hidden state.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from lgu_slam_tpu_torch.parallel.dba_shard import (
    ShardedDbaPlan,
    all_sum,
    check_group,
    sharded_dba_iters,
)


def backend_plan(ii, num_frames: int, n_shards: int) -> ShardedDbaPlan:
    """The DBA's partition (:class:`ShardedDbaPlan`) with each rank's edges
    stably sorted by ``ii``: the order in which the rank sweeps them."""
    ii = np.asarray(ii, np.int64).reshape(-1)
    plan = ShardedDbaPlan.build(ii, None, num_frames, n_shards)
    plan.perm = [p[np.argsort(ii[p], kind="stable")] for p in plan.perm]
    return plan


def chunks(edges: np.ndarray, CH: int) -> list:
    """``edges`` in consecutive chunks of ``CH``."""
    return [edges[lo:lo + CH] for lo in range(0, len(edges), CH)]


def broadcast_video(video, group, src: int = 0):
    """Every rank's video becomes rank ``src``'s: its keyframe counter and
    the live slots of every buffer."""
    dev = video.device
    check_group(group, dev)
    counter = torch.tensor([video.counter], dtype=torch.int64, device=dev)
    dist.broadcast(counter, group_src=src, group=group)
    video.counter = int(counter)
    t = video.counter
    for name in video._FIELDS:  # contiguous buffers: broadcast as bytes
        buf = getattr(video, name)
        live = buf[:t] if buf.shape[0] >= t else buf
        dist.broadcast(live.view(torch.uint8), group_src=src, group=group)
    video.dirty[:t] = True


def check_agreement(graph, group):
    """Raises unless every rank holds the same keyframe count, edge list,
    video state and edge state, by one pair of all-reduced checksums."""
    v, t = graph.video, graph.video.counter
    k = np.arange(graph.n_edges, dtype=np.float64)
    sums = [float(t), float(graph.n_edges), float(np.sum(graph.ii * (k + 1))),
            float(np.sum(graph.jj * (k + 3)))]
    parts = [v.poses[:t], v.disps[:t], v.damping[:t], v.disps_sens[:t],
             v.intrinsics[:t], v.fmaps[:t], v.inps[:t], graph.target,
             graph.weight, graph.hidden]
    x = torch.tensor(sums, dtype=torch.float64, device=v.device)
    x = torch.cat([x, torch.stack([p.double().sum() for p in parts])])
    lo, hi = x.clone(), x.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise RuntimeError(
            "the ranks of the sharded backend pass hold different videos or "
            "edges; give every rank rank 0's video first (broadcast_video)")


def lowmem_steps_sharded(graph, group, plan: ShardedDbaPlan, t0: int,
                         t1: int, steps: int, itrs: int = 2,
                         EP: float = 1e-7):
    """``steps`` x {this rank's chunk sweep (:func:`backend_plan`'s order,
    chunks of ``cfg.backend_chunk``), owner-masked all_reduce of the
    damping (and of ``disps_up`` when upsampling), the sharded DBA}.
    Updates ``graph``'s video and this rank's edges in place."""
    cfg, v = graph.cfg, graph.video
    rank = dist.get_rank(group)
    coords0 = graph.prepare_lowmem()
    mine = plan.perm[rank]
    sweep = [graph.make_chunk(sel, cfg.backend_chunk)
             for sel in chunks(mine, cfg.backend_chunk)]
    mine_t = graph._index(mine)
    own = torch.as_tensor(plan.owned[rank], device=v.device)
    own = own.to(v.damping.dtype)[:, None, None]
    for _ in range(steps):
        for c in sweep:
            graph.lowmem_chunk_update(c, coords0)
        v.damping = all_sum(v.damping * own, group)
        if cfg.upsample:
            v.disps_up = all_sum(v.disps_up * own, group)
        v.poses, v.disps = sharded_dba_iters(
            group, v.poses, v.disps, v.intrinsics[0], v.disps_sens,
            0.2 * v.damping + EP, t0, t1, graph.target[mine_t],
            graph.weight[mine_t], graph.ii[mine], graph.jj[mine],
            iters=itrs, lm=cfg.dba_lm, ep=cfg.dba_ep,
            strict_t0_quirk=cfg.strict_t0_quirk)


def gather_edge_state(graph, group, plan: ShardedDbaPlan):
    """Every rank takes each edge's target, weight and hidden state from
    the edge's owner (one owner-masked all_reduce per buffer)."""
    m = np.zeros(graph.n_edges, np.float32)
    m[plan.perm[dist.get_rank(group)]] = 1.0
    m = torch.as_tensor(m, device=graph.device)[:, None, None, None]
    graph.target = all_sum(graph.target * m, group)
    graph.weight = all_sum(graph.weight * m, group)
    graph.hidden = all_sum(graph.hidden.float() * m, group).to(
        graph.hidden.dtype)


@torch.no_grad()
def update_lowmem_sharded(graph, group, t0=None, t1=None, itrs=2, steps=8,
                          EP=1e-7):
    """``FactorGraph.update_lowmem`` over the ranks of ``group`` (see the
    module docstring)."""
    D = check_group(group, graph.device)
    check_agreement(graph, group)
    v = graph.video
    t = v.counter
    plan = backend_plan(graph.ii, v.poses.shape[0], D)
    lowmem_steps_sharded(graph, group, plan, 1 if t0 is None else t0,
                         t if t1 is None else t1, steps, itrs, EP)
    gather_edge_state(graph, group, plan)
    v.dirty[:t] = True
