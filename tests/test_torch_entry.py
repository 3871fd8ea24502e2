"""The port's weight loading (lgu_slam_tpu_torch/utils/checkpoint.py) and
its entry points (scripts/*_torch.py) on the CPU: both weight forms against
``utils/weights.py`` of the same JAX params (exact), the KAN-grid choice,
the JAX pickle read with JAX unimportable, ``evaluate_tum_torch`` on a TUM
fixture, and what the scripts refuse.  The demo against the JAX demo is
tests/test_torch_demo.py, the training script
tests/test_torch_train_script.py."""

import importlib.util
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_port import tiny_config_kwargs, torch_single_thread  # noqa: F401

from lgu_slam_tpu.data.streams import tum_rgbd_stream as jax_tum_stream
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils.checkpoint import save_params
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.data import fixtures
from lgu_slam_tpu_torch.models.net import LGUNet
from lgu_slam_tpu_torch.utils import checkpoint
from lgu_slam_tpu_torch.utils.weights import state_dict_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's init of the tiny configuration (JAX arrays)."""
    return init_params(JConfig(**tiny_config_kwargs()), seed=0)[1]


@pytest.fixture(scope="module")
def bridged(jax_params):
    return state_dict_from_jax_params(jax.device_get(jax_params))


def _equal(sd, ref):
    assert sd.keys() == ref.keys()
    for k in ref:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k


def _reference_pth(path, sd, rng):
    """``sd`` as a reference checkpoint: ``module.`` prefixes and 3-output
    weight/delta heads (the reference trims them at load time)."""
    ref = {}
    for k, v in sd.items():
        if k.startswith(checkpoint.TRIMMED_HEADS):
            extra = torch.from_numpy(
                rng.normal(size=(1,) + tuple(v.shape[1:])).astype(np.float32))
            v = torch.cat([v, extra])
        ref["module." + k] = v
    torch.save(ref, path)


def test_reference_pth_loads_as_the_bridge(bridged, tmp_path):
    path = str(tmp_path / "ref.pth")
    _reference_pth(path, bridged, np.random.default_rng(0))
    assert torch.load(path)["module.update.delta.2.weight"].shape[0] == 3
    for sd in (checkpoint.load_reference_checkpoint(path),
               checkpoint.load_weights(path)):
        _equal(sd, bridged)
        LGUNet(device="cpu").load_state_dict(sd, strict=True)


def test_port_train_state_loads_its_model(bridged, tmp_path):
    net = LGUNet(device="cpu")
    net.load_state_dict(bridged)
    path = str(tmp_path / "state.pt")
    torch.save({"model": net.state_dict(), "optimizer": {}, "step": 3,
                "rng_state": None}, path)
    _equal(checkpoint.load_weights(path), bridged)


def test_adapted_kan_grid_loads_as_it_is(bridged, tmp_path):
    """The chosen behaviour (README, Status / deviations): an adapted KAN
    grid loads unchanged and the layer evaluates it, where the JAX
    converter refuses it."""
    from lgu_slam_tpu.utils.checkpoint import convert_torch_checkpoint

    sd = dict(bridged)
    key = "update.gru.kanz_glo.grid"
    uniform = sd[key]
    sd[key] = uniform * 1.1 + 0.05
    path = str(tmp_path / "adapted.pth")
    _reference_pth(path, sd, np.random.default_rng(1))
    loaded = checkpoint.load_reference_checkpoint(path)
    assert torch.equal(loaded[key], sd[key])
    net = LGUNet(device="cpu")
    net.load_state_dict(loaded, strict=True)
    kan = net.update.gru.kanz_glo
    assert torch.equal(kan.grid, sd[key])
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (5, kan.grid.shape[0])).astype(np.float32))
    adapted = kan(x)
    kan.grid.copy_(uniform)
    assert (adapted - kan(x)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="adapted"):
        convert_torch_checkpoint(torch.load(path))


def test_jax_pickle_loads_without_jax(jax_params, bridged, tmp_path):
    """The JAX package's save_params pickle (JAX arrays) read in a process
    where jax, flax, the JAX package, the native extension, cv2, PIL,
    imageio and torchvision are unimportable; equal to the bridge of the
    same params.  A pickle naming another global is refused."""
    path = str(tmp_path / "params.pkl")
    save_params(path, jax_params)
    out = str(tmp_path / "sd.pt")
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'lgu_slam_tpu', 'lgu_native', 'cv2', "
        "'PIL', 'imageio', 'torchvision'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from lgu_slam_tpu_torch.utils.checkpoint import load_weights\n"
        f"torch.save(load_weights({path!r}), {out!r})\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    _equal(torch.load(out), bridged)

    bad = str(tmp_path / "bad.pkl")
    with open(bad, "wb") as fh:
        pickle.dump({"params": socket.socket}, fh)
    with pytest.raises(pickle.UnpicklingError, match="refused global"):
        checkpoint.load_jax_params(bad)


def test_evaluate_tum_matches_jax_pose_count(tmp_path):
    """evaluate_sequence at TUM_CONFIG on a 6-frame fr1 fixture, on the CPU
    with random weights: a finite ATE over as many poses as the JAX
    package's stride-1 stream gives frames (its evaluate_sequence returns
    one pose per such frame)."""
    root = fixtures.write_tum_sequence(
        str(tmp_path / "rgbd_dataset_freiburg1_desk"), n_frames=6)
    ev = script("evaluate_tum_torch")
    sd = checkpoint.load_weights(_port_pth(tmp_path))
    rmse, n = ev.evaluate_sequence(root, sd, device="cpu")
    assert np.isfinite(rmse)
    assert n == len(list(jax_tum_stream(root, stride=1))) == 6
    # the command line: a sequence that is not there is skipped
    assert ev.main(["--datapath", str(tmp_path), "--weights",
                    _port_pth(tmp_path), "--sequences", "nope",
                    "--device", "cpu"]) == {}


def _port_pth(tmp_path):
    """The port's random init saved as a reference checkpoint."""
    from lgu_slam_tpu_torch.models.net import init_state_dict
    from lgu_slam_tpu_torch.utils.config import SLAMConfig

    path = str(tmp_path / "init.pth")
    if not os.path.exists(path):
        _reference_pth(path, init_state_dict(SLAMConfig(), seed=0),
                       np.random.default_rng(3))
    return path


def test_scripts_refuse_what_waits(tmp_path, monkeypatch):
    """The demo's --export_every and --viewer wait for the host tools; an
    entry point asked for CUDA where there is none raises."""
    demo = script("demo_torch")
    for extra in (["--viewer"], ["--export_every", "5"]):
        with pytest.raises(SystemExit):
            demo.main(["--imagedir", str(tmp_path), "--calib", "c.txt"]
                      + extra)
    with pytest.raises(SystemExit):
        script("synthetic_demo_torch").main(["--viewer"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script("evaluate_euroc_torch").main(
            ["--datapath", str(tmp_path), "--weights", "w"])


def test_export_poses_matches_jax(tmp_path, monkeypatch):
    """TUM and TartanAir trajectories to 4x4 matrices, as the JAX script
    writes them."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    traj = np.concatenate([np.arange(5.0)[:, None],
                           rng.normal(size=(5, 3)), q], axis=1)
    np.savetxt(tmp_path / "traj.txt", traj)
    np.savetxt(tmp_path / "pose_left.txt", traj[:, 1:])
    port = script("export_poses_torch")
    jax_script = script("export_poses")
    for name, fmt in (("traj.txt", "tum"), ("pose_left.txt", "tartan")):
        src = str(tmp_path / name)
        port.main([src, "--format", fmt, "--out", str(tmp_path / "p.npy"),
                   "--txt", str(tmp_path / "p.txt")])
        monkeypatch.setattr(sys, "argv", [
            "export_poses.py", src, "--format", fmt, "--out",
            str(tmp_path / "j.npy"), "--txt", str(tmp_path / "j.txt")])
        jax_script.main()
        np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                      np.load(tmp_path / "j.npy"))
        assert (tmp_path / "p.txt").read_text() == \
            (tmp_path / "j.txt").read_text()
