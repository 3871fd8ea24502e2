"""Training: back-to-back ``train_step`` calls over a pool of seeded clips.

Set-up renders the pool on the device (each clip its own billboard scene
and random walk, depths normalised to median 1), builds the network from
the seed's weights and its optimizer, and takes the first
``first_steps`` steps through the window's own call on clips that all
differ.  The window repeats the call on the pool's next batch; the steps
are not synchronised one by one, and the window closes with a synchronise.

The check follows the training bullet of the benchmark's rules: the
reference takes the same first steps from the same weights and clips, and
the two are compared by each step's loss, each leaf's gradient norm after
step 1 as the optimizer holds it (AdamW's first moment over 1 - beta1) and
each leaf's change after the first steps, by the worst leaf, as a share of
the reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench.harness import roofline
from perfbench.harness.drivers import Base, count_model
from perfbench.harness.scene import Scene, pinhole, walk_poses
from perfbench.harness.weights import make_state_dict


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for fp32 matmuls and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def render_pool(traffic: dict, cfg: dict, seed: int, device):
    """``traffic["pool"]`` batches of ``batch`` clips of ``n_frames``:
    [(images [B, N, H, W, 3] float, poses c2w [B, N, 7], disps [B, N, H, W],
    intrinsics [B, N, 4])] on the device."""
    H, W = cfg["image_size"]
    B, N = cfg["batch"], cfg["n_frames"]
    gen = torch.Generator(device=device).manual_seed(seed)
    intr = torch.as_tensor(pinhole(H, W, traffic["focal"]), device=device)
    pool = []
    for _ in range(traffic["pool"]):
        clips = []
        for _ in range(B):
            scene = Scene(gen, device, n_planes=traffic["planes"])
            poses = walk_poses(gen, N, **traffic["walk"]).to(device)
            img, depth = scene.render(poses, intr.tolist(), H, W)
            s = depth[depth > 0.01].median()
            depth = depth / s
            poses[:, :3] = poses[:, :3] / s
            disps = torch.where(depth > 0.01, 1.0 / depth.clamp_min(0.01),
                                torch.zeros_like(depth))
            clips.append((img.float(), poses, disps,
                          intr.expand(N, 4).clone()))
        pool.append(tuple(torch.stack(x) for x in zip(*clips)))
    return pool


class Driver(Base):
    sync_each = False

    def __init__(self, cell, seed, device, impl):
        super().__init__(cell, seed, device, impl)
        self.cfg = cell.config["train"]
        self.H, self.W = self.cfg["image_size"]
        self.peak_flops = roofline.peak_flops(cell.config["compute"])

    def _modules(self, impl: str):
        if impl == "program":
            from lgu_slam_tpu_torch.models.net import LGUNet
            from lgu_slam_tpu_torch.parallel import train_dp
            from lgu_slam_tpu_torch.utils.config import TrainConfig
        else:
            from perfbench.reference import train as train_dp
            from perfbench.reference.config import TrainConfig
            from perfbench.reference.models.net import LGUNet
        return LGUNet, train_dp, TrainConfig

    def _build(self, impl: str):
        LGUNet, train_dp, TrainConfig = self._modules(impl)
        d = dict(self.cfg, image_size=tuple(self.cfg["image_size"]))
        cfg = TrainConfig(**d)
        net = LGUNet(device=self.device)
        net.load_state_dict(self.weights)
        opt = train_dp.make_optimizer(net, cfg)
        N = cfg.n_frames
        ii, jj = (torch.as_tensor(x, device=self.device)
                  for x in train_dp.window_edges(N))
        zeros = (torch.zeros(cfg.batch, N, 7, device=self.device),
                 torch.zeros(cfg.batch, N, self.H // 8, self.W // 8,
                             device=self.device))
        return dict(net=net, opt=opt, cfg=cfg, ii=ii, jj=jj, zeros=zeros,
                    step=train_dp.train_step)

    def _step(self, state, k: int, tf32_on: bool):
        """One train step of ``state`` on the pool's batch ``k``."""
        with tf32(tf32_on):
            metrics, _ = state["step"](
                state["net"], state["opt"], self.pool[k % len(self.pool)],
                *state["zeros"], cfg=state["cfg"], ii=state["ii"],
                jj=state["jj"])
        return metrics

    def _first_steps(self, state, step) -> dict:
        """The first steps, ``step(k)`` each, on the pool's first batches:
        the losses, the gradient after step 1 and the weights after them."""
        losses, grad1 = [], None
        for k in range(self.traffic["first_steps"]):
            losses.append(step(k)["loss"])
            if k == 0:
                grad1 = self._grad_norms(state)
        names = [n for n, _ in state["net"].named_parameters()]
        weights = {n: p.detach().clone()
                   for n, p in state["net"].named_parameters()}
        return dict(losses=[float(x) for x in losses], grad1=grad1,
                    weights=weights, names=names)

    @staticmethod
    def _grad_norms(state) -> dict:
        """Each leaf's gradient as the optimizer got it after one step:
        AdamW's first moment over 1 - beta1."""
        adamw = state["opt"].adamw
        beta1 = adamw.param_groups[0]["betas"][0]
        return {n: float(torch.linalg.vector_norm(
                    adamw.state[p]["exp_avg"]) / (1.0 - beta1))
                for n, p in state["net"].named_parameters()
                if p in adamw.state}

    def setup(self):
        self.weights = make_state_dict(self.seed, self.device)
        self.pool = render_pool(self.traffic, self.cfg, self.seed,
                                self.device)
        self.state = self._build(self.impl)
        self.tf32 = (self.impl == "control"
                     and self.limits["control"].get("tf32", False))
        self.k = 0
        self.first = self._first_steps(self.state, lambda k: self._call())

    def _call(self):
        self.k += 1
        return self._step(self.state, self.k - 1, self.tf32)

    def call(self) -> float:
        self._call()
        return 1.0

    def finish(self):
        del self.state
        self.state = None

    def instrument(self, spans):
        # the backward counts twice the forward
        count_model(spans, type(self.state["net"]), self.H, self.W,
                    factor=3.0)

    def notes(self, run) -> list:
        return [f"steps in the window: {len(run.calls)}", *self.readings]

    def check(self) -> dict:
        ref = self._build("reference")
        r = self._first_steps(ref, lambda k: self._step(ref, k, False))
        del ref
        p = self.first
        loss = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(p["losses"], r["losses"]))
        g_ref = r["grad1"]
        med_g = float(np.median(list(g_ref.values())))
        grad = max(abs(p["grad1"].get(n, 0.0) - g) / max(g, med_g)
                   for n, g in g_ref.items())
        moved = {n: float(torch.linalg.vector_norm(
            r["weights"][n] - self.weights[n])) for n in r["names"]}
        kept = [n for n in r["names"] if g_ref.get(n, 0.0) >= 1e-3 * med_g]
        med_c = float(np.median([moved[n] for n in kept]))
        change = max(abs(float(torch.linalg.vector_norm(
            p["weights"][n] - self.weights[n])) - moved[n])
            / max(moved[n], med_c) for n in kept)
        self.readings = [
            f"losses: program {p['losses']}, reference {r['losses']}",
            f"leaves compared: {len(g_ref)} gradients, {len(kept)} changes"]
        return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
