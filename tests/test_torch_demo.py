"""The port's demo (scripts/demo_torch.py, on the CPU) against the JAX
package's scripts/demo.py on one PNG directory with the same weights (a
JAX params pickle, which the port reads through its weight loader).

The frames are written at the target size, so the demo's resize is the
identity (``_target_size`` gives ``h0, w0`` when ``target_pixels == h0 *
w0``).  Both demos run the configuration of tests/test_torch_track.py's
free-running comparison (fp32 dtypes, thresholds 0), with the backend's
edge cap cut to 8 so that ``terminate()`` stays short on the CPU; the
demo's command line sets the rest.  They are held as that test holds
free-running tracking: the same keyframes and edge lists, the same
trajectory timestamps, finite poses -- not a pose tolerance (ROADMAP C:
random-weight tracking here moves by more than 1e-2 under last-digit
changes of the weights).

The JAX demo runs in a process of its own (``python
tests/test_torch_demo.py DIR``, on one CPU device as the port's
``LGUSlam`` without a process group), beside the port's demo in the test's
process.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch_port import tiny_config_kwargs, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data.image_io import imwrite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 6


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recording(cls, out):
    """``cls`` with its terminate() recording the keyframes and the
    frontend's edges first (terminate() drops the frontend)."""
    class Recorded(cls):
        def terminate(self, *args, **kw):
            g = self.frontend.graph
            out.append((self.video.counter, [int(i) for i in g.ii],
                        [int(j) for j in g.jj]))
            return super().terminate(*args, **kw)
    return Recorded


def config_kwargs():
    """What the demos' configuration takes from the test's: all but the
    image size, which the demo's probe of the first frame sets."""
    kw = tiny_config_kwargs()
    kw.pop("image_size")
    kw.update(backend_edge_cap=8, backend_chunk=8)
    return kw


def demo_args(root):
    return ["--imagedir", os.path.join(root, "images"),
            "--calib", os.path.join(root, "calib.txt"),
            "--weights", os.path.join(root, "params.pkl"), "--stride", "1",
            "--target_pixels", str(64 * 96), "--buffer", "24",
            "--filter_thresh", "0", "--keyframe_thresh", "0",
            "--warmup", "5", "--frontend_window", "8"]


def run_jax_demo(root):
    """scripts/demo.py on ``root``'s fixture; writes jax.txt and the
    keyframes and edges to jax.json."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import lgu_slam_tpu.slam.system as jsystem
    import lgu_slam_tpu.utils.config as jconfig

    seen = []
    base = jconfig.SLAMConfig
    kw = config_kwargs()
    jconfig.SLAMConfig = lambda **k: base(**{**k, **kw})
    jsystem.LGUSlam = recording(jsystem.LGUSlam, seen)
    sys.argv = ["demo.py", *demo_args(root), "--trajectory_path",
                os.path.join(root, "jax.txt")]
    script("demo").main()
    with open(os.path.join(root, "jax.json"), "w") as fh:
        json.dump(seen[0], fh)


def test_demo_matches_jax_demo(tmp_path, monkeypatch):
    import jax

    from test_slam_e2e import synthetic_stream

    from lgu_slam_tpu.slam.system import init_params
    from lgu_slam_tpu.utils.checkpoint import save_params
    from lgu_slam_tpu.utils.config import SLAMConfig as JConfig

    (tmp_path / "images").mkdir()
    for t, img, _ in synthetic_stream(n_frames=N_FRAMES):
        imwrite(str(tmp_path / "images" / f"{t:04d}.png"), img)
    (tmp_path / "calib.txt").write_text("80.0 80.0 48.0 32.0\n")
    params = init_params(JConfig(**tiny_config_kwargs()), seed=0)[1]
    save_params(str(tmp_path / "params.pkl"), jax.device_get(params))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    ref_run = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        seen = []
        demo = script("demo_torch")
        base, kw = demo.SLAMConfig, config_kwargs()
        monkeypatch.setattr(demo, "SLAMConfig",
                            lambda **k: base(**{**k, **kw}))
        monkeypatch.setattr(demo, "LGUSlam", recording(demo.LGUSlam, seen))
        out = demo.main([*demo_args(str(tmp_path)), "--trajectory_path",
                         str(tmp_path / "torch.txt"), "--reconstruction_path",
                         str(tmp_path / "rec.npz"), "--device", "cpu"])
        log, _ = ref_run.communicate(timeout=300)
    finally:
        ref_run.kill()
    assert ref_run.returncode == 0, log[-4000:]

    n_j, ii_j, jj_j = json.loads((tmp_path / "jax.json").read_text())
    n_t, ii_t, jj_t = seen[0]
    assert n_t == n_j == N_FRAMES
    assert ii_t == ii_j and jj_t == jj_j and len(ii_t) > 0
    ref = np.loadtxt(tmp_path / "jax.txt")
    got = np.loadtxt(tmp_path / "torch.txt")
    assert got.shape == ref.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(out["tstamps"], ref[:, 0])
    assert set(out["phases"]) == {"read", "track", "terminate"}
    rec = np.load(tmp_path / "rec.npz")
    assert set(rec.files) == {"tstamps", "images", "disps", "poses",
                              "intrinsics"}
    assert rec["images"].shape == (N_FRAMES, 64, 96, 3)
    assert torch.isfinite(torch.from_numpy(rec["poses"])).all()


if __name__ == "__main__":
    run_jax_demo(sys.argv[1])
