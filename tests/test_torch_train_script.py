"""The port's training entry point (scripts/train_torch.py) on the CPU: one
train step on a TartanAir fixture at world size 1 under gloo, its
checkpoint and a resume from it; and the script against the JAX package's
scripts/train.py on the same fixture.

Both scripts train at ``TrainConfig()``'s image size; the tests patch each
script's ``TrainConfig`` to 64 x 96, as tests/test_torch_demo.py patches the
demos' ``SLAMConfig``.  The JAX script runs in a process of its own
(``python tests/test_torch_train_script.py DIR``, on one CPU device),
beside the port's in the test's process.
"""

import importlib.util
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port import close, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (64, 96)
# one step on a 3-frame clip of batch 1, 1 iteration; with the data RNG's
# draws for seed 0 a restart probability of 0.5 repeats it three times, each
# repeat from the carry of the call before
ARGS = ["--batch", "1", "--iters", "1", "--n_frames", "3", "--fmin", "0.5",
        "--fmax", "200", "--restart_prob", "0.5", "--steps", "1",
        "--ckpt_every", "1000"]


@pytest.fixture(autouse=True)
def no_tensorflow(monkeypatch):
    """Both scripts' Logger writes TensorBoard events through
    ``torch.utils.tensorboard``; with TensorFlow unimportable it takes
    TensorBoard's own stub, which imports in ~3 s instead of ~16 s."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_script(monkeypatch):
    """scripts/train_torch.py with its TrainConfig at 64 x 96."""
    train = script("train_torch")
    base = train.TrainConfig
    monkeypatch.setattr(train, "TrainConfig",
                        lambda **k: base(**{**k, "image_size": SIZE}))
    return train


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tartan_fixture(root):
    fixtures.write_tartanair_scene(
        str(root / "abandonedfactory/abandonedfactory/Easy/P001"),
        n_frames=8, H=SIZE[0], W=SIZE[1])
    return root


def run_jax_train(root):
    """scripts/train.py on ``root``/tartan (cwd ``root``/jax), with its own
    weights (``init_params`` at seed 0); writes each call of the train step
    (the batch, the carry it starts from, its metrics) to calls.pkl."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.modules["tensorflow"] = None  # as no_tensorflow does
    import lgu_slam_tpu.parallel.train_dp as jtrain
    import lgu_slam_tpu.utils.config as jconfig

    base = jconfig.TrainConfig
    jconfig.TrainConfig = lambda **k: base(**{**k, "image_size": SIZE})
    calls, make = [], jtrain.make_train_step

    def make_train_step(*args, **kw):
        step = make(*args, **kw)

        def recorded(params, opt_state, batch, Gs0, disp0):
            out = step(params, opt_state, batch, Gs0, disp0)
            calls.append(([np.asarray(x) for x in (*batch, Gs0, disp0)],
                          {k: float(v) for k, v in out[2].items()}))
            return out
        return recorded

    jtrain.make_train_step = make_train_step
    os.makedirs(os.path.join(root, "jax"))
    os.chdir(os.path.join(root, "jax"))
    sys.argv = ["train.py", "--datapath", os.path.join(root, "tartan"),
                *ARGS]
    script("train").main()
    with open(os.path.join(root, "calls.pkl"), "wb") as fh:
        pickle.dump(calls, fh)


def test_train_torch_step_at_world_size_1(tmp_path, monkeypatch):
    """One train step on a TartanAir fixture (64 x 96 clips of 3 frames,
    2 iterations), under torchrun's environment at world size 1: gloo,
    the data-parallel step, a checkpoint, and a resume that takes one more
    step from it."""
    root = tartan_fixture(tmp_path / "tartan")
    monkeypatch.chdir(tmp_path)
    for key, value in (("WORLD_SIZE", "1"), ("RANK", "0"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(key, value)
    train = train_script(monkeypatch)
    args = ["--datapath", str(root), "--batch", "1", "--iters", "2",
            "--n_frames", "3", "--fmin", "0.5", "--fmax", "200",
            "--ckpt_every", "1", "--device", "cpu", "--restart_prob", "0"]
    metrics = train.main(args + ["--steps", "1"])
    assert not torch.distributed.is_initialized()
    assert np.isfinite(metrics["loss"]) and metrics["loss"] > 0
    ckpt = tmp_path / "checkpoints" / "lgu_torch_000001.pt"
    assert ckpt.exists()
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 1 and "module." not in next(iter(state["model"]))
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    metrics = train.main(args + ["--steps", "2", "--ckpt", str(ckpt)])
    assert np.isfinite(metrics["loss"])
    assert (tmp_path / "checkpoints" / "lgu_torch_000002.pt").exists()


def test_train_torch_matches_jax_train_script(tmp_path, monkeypatch):
    """scripts/train_torch.py against scripts/train.py on the same TartanAir
    fixture, the port starting from the JAX script's weights (its
    ``init_params`` at seed 0, read through ``load_jax_params``): the same
    number of train-step calls (the clip draws and the restart loop's draws
    of one data RNG), and for every call a bit-identical batch (images,
    poses, disparities from depth, intrinsics).

    The first call starts both from the zero carry (held exact) and is
    held as tests/test_torch_train.py's test_train_steps_match_jax holds a
    train step: every metric within atol 1e-5 and rtol 2e-4, shares of
    pixels or edges within atol 1e-3, and the rotation error (degrees)
    within that test's pose tolerance, 1e-4, read in degrees (its relative
    error passes 2e-4 on this fixture).  After the first update
    the weights differ by up to two learning rates, and on these random
    weights the later calls' carries and metrics then move by tens of
    percent: they are held finite, as tests/test_torch_demo.py holds
    free-running poses."""
    import jax

    from lgu_slam_tpu.slam.system import init_params
    from lgu_slam_tpu.utils.checkpoint import save_params
    from lgu_slam_tpu.utils.config import SLAMConfig as JConfig

    from lgu_slam_tpu_torch.utils.checkpoint import load_jax_params

    tartan_fixture(tmp_path / "tartan")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    ref_run = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        # the JAX script's own weights, made again here
        params = init_params(JConfig(image_size=SIZE, volume_dtype="float32",
                                     compute_dtype="float32",
                                     feat_dtype="float32"), seed=0)[1]
        save_params(str(tmp_path / "params.pkl"), jax.device_get(params))
        train = train_script(monkeypatch)
        monkeypatch.setattr(train, "init_state_dict",
                            lambda cfg, seed=0: load_jax_params(
                                str(tmp_path / "params.pkl")))
        calls, step = [], train.train_step

        def recorded(model, opt, batch, poses, disps, **kw):
            metrics, carry = step(model, opt, batch, poses, disps, **kw)
            calls.append(([x.numpy().copy() for x in (*batch, poses, disps)],
                          {k: float(v) for k, v in metrics.items()}))
            return metrics, carry

        monkeypatch.setattr(train, "train_step", recorded)
        (tmp_path / "port").mkdir()
        monkeypatch.chdir(tmp_path / "port")
        train.main(["--datapath", str(tmp_path / "tartan"), *ARGS,
                    "--device", "cpu"])
        log, _ = ref_run.communicate(timeout=300)
    finally:
        ref_run.kill()
    assert ref_run.returncode == 0, log[-4000:]
    with open(tmp_path / "calls.pkl", "rb") as fh:
        ref = pickle.load(fh)

    # one step and its restarts: every call after the first from a carry
    assert len(calls) == len(ref) > 2
    assert all(got[4].any() for got, _ in calls[1:])
    for k, ((got, m_t), (want, m_j)) in enumerate(zip(calls, ref)):
        for name, a, b in zip(("images", "poses", "disps", "intrinsics"),
                              got, want):
            assert a.shape == b.shape, (k, name)
            np.testing.assert_array_equal(a, b.astype(np.float32),
                                          err_msg=f"call {k} {name}")
        assert set(m_j) <= set(m_t)
        assert all(np.isfinite(a).all() for a in got[4:]), k
        assert all(np.isfinite(v) for v in m_t.values()), k
    (got, m_t), (want, m_j) = calls[0], ref[0]
    assert not got[4].any() and not got[5].any()
    assert not want[4].any() and not want[5].any()
    for name in m_j:
        atol = {"1px": 1e-3, "bad_rot": 1e-3, "bad_tr": 1e-3,
                "rot_error": np.degrees(1e-4)}.get(name, 1e-5)
        close(torch.tensor(m_t[name]), m_j[name], atol=atol, rtol=2e-4,
              msg=name)


if __name__ == "__main__":
    run_jax_train(sys.argv[1])
