"""One rank of a port run over a gloo process group on the CPU (started by
tests/test_torch_parallel.py and tests/test_torch_oracle_pipeline.py, one
process per rank; imports no JAX).

    python torch_dist_worker.py CASE RANK WORLD PORT INPUT OUTPUT

``INPUT`` is a ``torch.save`` file written by the test; rank 0 writes the
case's results to ``OUTPUT``.  Every case also checks that all ranks end
with the same result, and a rank that fails exits non-zero.
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lgu_slam_tpu_torch.models.net import LGUNet  # noqa: E402
from lgu_slam_tpu_torch.parallel.dba_shard import (  # noqa: E402
    check_group,
    dba_step_sharded,
)
from lgu_slam_tpu_torch.parallel.train_dp import (  # noqa: E402
    data_parallel,
    make_optimizer,
    mean_over_ranks,
    shard_batch,
    train_step,
)
from lgu_slam_tpu_torch.slam.backend import Backend  # noqa: E402
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph  # noqa: E402
from lgu_slam_tpu_torch.slam.state import Video  # noqa: E402
from lgu_slam_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_train_state,
    save_train_state,
)
from lgu_slam_tpu_torch.utils.config import (  # noqa: E402
    SLAMConfig,
    TrainConfig,
)


def same_on_all_ranks(x: torch.Tensor):
    lo, hi = x.clone().double(), x.clone().double()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    assert torch.equal(lo, hi), "ranks disagree"


def dba(inp):
    poses, disps = dba_step_sharded(
        dist.group.WORLD, inp["poses"], inp["disps"], inp["intr"],
        inp["sens"], inp["target"], inp["weight"], inp["eta"], inp["ii"],
        inp["jj"], inp["t0"], inp["t1"], iters=2)
    for x in (poses, disps):
        same_on_all_ranks(x)
    return {"poses": poses, "disps": disps}


def video(cfg, fields):
    v = Video(cfg, "cpu")
    for name, a in fields.items():
        getattr(v, name)[:a.shape[0]] = a
    v.counter = int(fields["poses"].shape[0])
    return v


def backend(inp):
    out = {}
    sd = inp["state_dict"]
    for case, kw in inp["cases"].items():
        cfg = SLAMConfig(**kw)
        net = LGUNet.from_config(cfg, device="cpu")
        net.load_state_dict(sd, strict=True)
        net.eval()
        v = video(cfg, inp["videos"][case])
        if case == "entry":
            Backend(net, v, cfg, group=dist.group.WORLD)(steps=2)
            g = None
        else:
            g = FactorGraph(net, v, cfg, corr_impl="alt",
                            max_factors=cfg.max_factors,
                            edge_bucket=cfg.backend_edge_cap,
                            inactive_bucket=8)
            g.add_factors(*inp["edges"][case])
            g.update_lowmem(steps=2, group=dist.group.WORLD)
        T = v.counter
        res = {"poses": v.poses[:T], "disps": v.disps[:T],
               "damping": v.damping[:T], "dirty": torch.from_numpy(
                   v.dirty[:T].copy())}
        if g is not None:
            res.update(target=g.target, weight=g.weight, hidden=g.hidden)
        for x in res.values():
            same_on_all_ranks(x)
        out[case] = res

    # Backend gives every rank rank 0's video before it plans the edges
    cfg = SLAMConfig(**inp["cases"]["entry"])
    net = LGUNet.from_config(cfg, device="cpu")
    net.load_state_dict(sd, strict=True)
    v = video(cfg, inp["videos"]["entry"])
    v.poses[:, :3] += 1e-2 * dist.get_rank()
    Backend(net.eval(), v, cfg, group=dist.group.WORLD)(steps=2)
    same_on_all_ranks(v.poses[:v.counter])
    out["entry_from_rank_0"] = v.poses[:v.counter]

    # ranks whose videos differ are refused, not reduced
    cfg = SLAMConfig(**inp["cases"]["aligned"])
    v = video(cfg, inp["videos"]["aligned"])
    v.poses[3, 0] += 1e-3 * dist.get_rank()
    g = FactorGraph(LGUNet.from_config(cfg, device="cpu").eval(), v, cfg,
                    corr_impl="alt", edge_bucket=cfg.backend_edge_cap)
    g.add_factors(*inp["edges"]["aligned"])
    try:
        g.update_lowmem(steps=1, group=dist.group.WORLD)
        out["refused"] = False
    except RuntimeError as e:
        out["refused"] = "different videos" in str(e)
    # the collective backend follows the device
    try:
        check_group(dist.group.WORLD, "cuda")
        out["nccl_needed"] = False
    except RuntimeError:
        out["nccl_needed"] = True
    return out


def clipped_grads(net, opt):
    """The clipped gradients that AdamW read at its first step: its first
    moment over (1 - beta1)."""
    return {n: opt.adamw.state[p]["exp_avg"] / (1.0 - 0.9)
            for n, p in net.named_parameters()}


def ddp(inp):
    cfg = TrainConfig(**inp["cfg"])
    net = LGUNet(device="cpu")
    # rank 0's weights reach every rank through DDP's broadcast
    if dist.get_rank() == 0:
        net.load_state_dict(inp["state_dict"])
    model = data_parallel(net)
    opt = make_optimizer(model, cfg)
    batch = shard_batch(inp["batch"])
    Gs0, disp0 = shard_batch((inp["Gs0"], inp["disp0"]))
    ii, jj = inp["ii"], inp["jj"]
    metrics, _ = train_step(model, opt, batch, Gs0, disp0, cfg=cfg, ii=ii,
                            jj=jj)
    metrics = mean_over_ranks(metrics)
    out = {"loss": metrics["loss"], "grads": clipped_grads(net, opt),
           "weights": {k: v.clone() for k, v in net.state_dict().items()}}
    for x in (*out["weights"].values(), *out["grads"].values()):
        same_on_all_ranks(x)
    path = inp["ckpt"] + f".{dist.get_rank()}"
    save_train_state(path, model, opt, 1)
    out["ckpt_keys"] = sorted(torch.load(path, weights_only=True)["model"])
    fresh = LGUNet(device="cpu")
    load_train_state(path, fresh, make_optimizer(fresh, cfg))
    out["ckpt_roundtrip"] = all(
        torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                          net.state_dict().values()))
    try:
        shard_batch((torch.zeros(dist.get_world_size() + 1, 1),))
        out["uneven_refused"] = False
    except ValueError:
        out["uneven_refused"] = True
    # DDP's own average would scale the gradients by 1 / world**2
    bare = DistributedDataParallel(LGUNet(device="cpu"))
    try:
        train_step(bare, make_optimizer(bare, cfg), batch, Gs0, disp0,
                   cfg=cfg, ii=ii, jj=jj)
        out["bare_ddp_refused"] = False
    except TypeError:
        out["bare_ddp_refused"] = True
    return out


def oracle(inp):
    """tests/torch_oracle.py's pipeline with the backend sharded over the
    group."""
    import warnings

    from torch_oracle import run_pipeline

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "backend edge budget truncated")
        out = run_pipeline(SLAMConfig(**inp["config"]), inp["T"], "cpu",
                           group=dist.group.WORLD)
    same_on_all_ranks(out["poses"])
    return out


def main():
    case, rank, world, port, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        inp = torch.load(src, weights_only=False)
        out = {"dba": dba, "backend": backend, "ddp": ddp,
               "oracle": oracle}[case](inp)
        if rank == 0:
            torch.save(out, dst)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
