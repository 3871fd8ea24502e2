"""The port's training loop over several steps on the CPU (the counterparts
of tests/test_train_resume.py and tests/test_training_learns.py):

- killing a run after two steps and resuming it from its checkpoint
  (weights, AdamW moments, schedule position, step, the data RNG)
  reproduces the uninterrupted run exactly;
- three steps on synthetic clips keep every metric and every weight finite
  and move the weights.
"""

import numpy as np
import torch
from torch_port import t, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data.synthetic import SyntheticDataset
from lgu_slam_tpu_torch.models.net import LGUNet, init_state_dict
from lgu_slam_tpu_torch.parallel.train_dp import (
    make_optimizer,
    train_step,
    window_edges,
)
from lgu_slam_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
)
from lgu_slam_tpu_torch.utils.config import SLAMConfig, TrainConfig

H, W, N = 64, 96, 3


def fresh_net() -> LGUNet:
    net = LGUNet(device="cpu")
    net.load_state_dict(init_state_dict(SLAMConfig(), seed=0))
    return net


def batch_of(db, rng, B):
    items = [db[int(i)] for i in rng.integers(0, len(db), size=B)]
    images, poses, depths, intr = (np.stack(x) for x in zip(*items))
    disps = np.where(depths > 0.01, 1.0 / np.maximum(depths, 0.01), 0.0)
    return tuple(t(x.astype(np.float32)) for x in (images, poses, disps,
                                                     intr))


def run(net, opt, db, rng, steps, cfg, ii, jj):
    B = cfg.batch
    losses = []
    for _ in range(steps):
        metrics, _ = train_step(
            net, opt, batch_of(db, rng, B), torch.zeros(B, N, 7),
            torch.zeros(B, N, H // 8, W // 8), cfg=cfg, ii=ii, jj=jj)
        losses.append(float(metrics["loss"]))
    return losses


def test_kill_and_resume_reproduces_run(tmp_path):
    cfg = TrainConfig(batch=1, iters=2, steps=8, lr=1e-3, n_frames=N,
                      image_size=(H, W))
    db = SyntheticDataset(n_scenes=1, frames_per_scene=6, n_frames=N,
                          crop_size=(H, W), seed=0)
    ii, jj = (t(x) for x in window_edges(N))

    net = fresh_net()
    opt = make_optimizer(net, cfg)
    straight = run(net, opt, db, np.random.default_rng(0), 4, cfg, ii, jj)
    w_straight = {k: v.clone() for k, v in net.state_dict().items()}

    net = fresh_net()
    opt = make_optimizer(net, cfg)
    rng = np.random.default_rng(0)
    first = run(net, opt, db, rng, 2, cfg, ii, jj)
    ckpt = tmp_path / "train_state.pt"
    save_train_state(ckpt, net, opt, 2, rng.bit_generator.state)
    del net, opt, rng

    net = fresh_net()
    opt = make_optimizer(net, cfg)
    step, rng_state = load_train_state(ckpt, net, opt)
    assert step == 2 and opt.count == 2
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    resumed = run(net, opt, db, rng, 2, cfg, ii, jj)

    assert first + resumed == straight
    for k, v in net.state_dict().items():
        assert torch.equal(v, w_straight[k]), k


def test_three_steps_finite_and_weights_move():
    """Weights went NaN after the first step in the JAX package before its
    safe norms: hold every metric of several steps and the weights
    themselves."""
    cfg = TrainConfig(batch=2, iters=2, steps=50, lr=4e-4, n_frames=N,
                      image_size=(H, W))
    db = SyntheticDataset(n_scenes=1, frames_per_scene=6, n_frames=N,
                          crop_size=(H, W), seed=0)
    ii, jj = (t(x) for x in window_edges(N))
    net = fresh_net()
    w0 = [p.detach().clone() for p in net.parameters()]
    opt = make_optimizer(net, cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        metrics, carry = train_step(
            net, opt, batch_of(db, rng, cfg.batch),
            torch.zeros(cfg.batch, N, 7),
            torch.zeros(cfg.batch, N, H // 8, W // 8), cfg=cfg, ii=ii, jj=jj)
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
        assert carry[0].shape == (cfg.batch, N, 7)
        assert carry[1].shape == (cfg.batch, N, H // 8, W // 8)
    assert all(bool(torch.isfinite(p).all()) for p in net.parameters())
    moved = sum(float((p.detach() - q).abs().max())
                for p, q in zip(net.parameters(), w0))
    assert moved > 1e-4
    assert all(p.grad is not None for p in net.parameters())
