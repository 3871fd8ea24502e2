"""The port's 3DGS and export entry points against the JAX package's, on
the CPU: ``scripts/gs_slam_torch.py`` beside ``scripts/gs_slam.py`` on one
small reconstruction ``.npz``, and ``scripts/demo_torch.py --export_every``
beside ``scripts/demo.py --export_every`` on one short synthetic sequence.

The demos' export is held with both SLAM systems replaced by the same
recorder, which writes each tracked frame into its package's keyframe
video with a known pose and disparity: random-weight tracking differs
between the packages by more than the export could show (ROADMAP C), and
what is under test here is the export path (its cadence, the dirty-flag
protocol, the filter and the files), not tracking.
"""

import importlib.util
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import read_ply_points, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.data.image_io import imwrite

REPO = Path(__file__).resolve().parent.parent
T, H, W = 3, 32, 48
FX = 24.0


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plane_depth(h, w):
    """Two fronto-parallel planes: z = 2 on the left half, 3 on the
    right."""
    depth = np.full((h, w), 2.0, np.float32)
    depth[:, w // 2:] = 3.0
    return depth


def write_reconstruction(path):
    """A reconstruction .npz as demo_torch writes it with --upsample: BGR
    uint8 images, full-resolution disparities, w2c poses moving along x,
    1/8-scale intrinsics."""
    rng = np.random.default_rng(0)
    poses = np.zeros((T, 7), np.float32)
    poses[:, 0] = -0.05 * np.arange(T)
    poses[:, 6] = 1.0
    intr8 = np.float32([FX, FX, W / 2, H / 2]) / 8.0
    np.savez_compressed(
        path, tstamps=np.arange(T, dtype=np.float32),
        images=rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8),
        disps=np.broadcast_to(1.0 / plane_depth(H, W), (T, H, W)).copy(),
        poses=poses, intrinsics=np.broadcast_to(intr8, (T, 4)).copy())


def ply_counts(path):
    head = open(path, "rb").read(400).split(b"end_header")[0].decode()
    counts = dict(re.findall(r"element (\w+) (\d+)", head))
    return {k: int(v) for k, v in counts.items()}


def test_gs_slam_torch_matches_jax_script(tmp_path, monkeypatch, capsys):
    """Three frames at 32 x 48 (5 mapping iterations each, a capacity of
    8,000, a 0.05 m TSDF): the same Gaussian count after every frame,
    each frame's last loss within 2e-4 of the JAX script's (which prints
    it to 4 decimals), the same alive flags, the scenes' parameters within
    1e-5 (the rotations within Adam's step bound, 2 x 1.01 lr per
    iteration since the last reset of the moments: their gradient is
    noise, tests/test_torch_gs.py), and meshes of the same vertex and
    triangle counts."""
    rec = tmp_path / "rec.npz"
    write_reconstruction(rec)
    args = ["--reconstruction", str(rec), "--mapping_iters", "5",
            "--capacity", "8000", "--voxel", "0.05", "--max_frames", str(T)]
    monkeypatch.setattr("sys.argv", [
        "gs_slam.py", *args, "--out", str(tmp_path / "j.npz"), "--mesh",
        str(tmp_path / "j.ply")])
    script("gs_slam").main()
    log = capsys.readouterr().out
    frames = re.findall(r"frame \d+: (\d+) gaussians, loss ([-\d.]+)", log)
    assert len(frames) == T

    out = script("gs_slam_torch").main(
        args + ["--out", str(tmp_path / "t.npz"), "--mesh",
                str(tmp_path / "t.ply"), "--device", "cpu"])
    gauss = re.findall(r"frame \d+: (\d+) gaussians", capsys.readouterr().out)
    assert gauss == [n for n, _ in frames]
    assert out["gaussians"] == int(frames[-1][0]) > 0
    np.testing.assert_allclose(out["losses"], [float(x) for _, x in frames],
                               atol=2e-4)

    got, ref = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert set(got.files) == set(ref.files)
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["timestep"], ref["timestep"])
    for k in ("means3D", "rgb_colors", "logit_opacities", "log_scales"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["unnorm_rotations"],
                               ref["unnorm_rotations"],
                               atol=2 * 1.01 * 0.001 * 5)

    counts = ply_counts(tmp_path / "t.ply")
    assert counts == ply_counts(tmp_path / "j.ply")
    assert counts["vertex"] > 0 and counts["face"] == counts["vertex"] // 3
    assert (out["mesh_vertices"], out["mesh_triangles"]) == \
        (counts["vertex"], counts["face"])


def test_view_reconstruction_torch_matches_jax_script(tmp_path,
                                                      monkeypatch):
    """The reconstruction of the test above (full-resolution disparities,
    read at 1/8): both scripts write the same filtered cloud, points within
    1e-5 and colours equal."""
    rec = tmp_path / "rec.npz"
    write_reconstruction(rec)
    monkeypatch.setattr("sys.argv", [
        "view_reconstruction.py", "--reconstruction", str(rec), "--out",
        str(tmp_path / "j.ply")])
    script("view_reconstruction").main()
    n = script("view_reconstruction_torch").main(
        ["--reconstruction", str(rec), "--out", str(tmp_path / "t.ply"),
         "--device", "cpu"])
    assert ply_counts(tmp_path / "t.ply") == \
        ply_counts(tmp_path / "j.ply") == {"vertex": n}
    assert n > 0
    (p_t, c_t), (p_j, c_j) = read_ply_points(tmp_path / "t.ply"), \
        read_ply_points(tmp_path / "j.ply")
    np.testing.assert_allclose(p_t, p_j, atol=1e-5)
    np.testing.assert_array_equal(c_t, c_j)


def recorder(video_of, write, sequence):
    """An LGUSlam stand-in for one package: ``video_of(cfg)`` makes its
    keyframe video; ``track`` writes the frame with the sequence's pose and
    disparity through ``write(video, i, image, pose, disp, intr)``;
    ``terminate`` returns the poses of the tracked frames."""
    class Recorder:
        def __init__(self, weights, cfg, **kw):
            self.video = video_of(cfg)
            self.tracked = []

        def track(self, t, image, depth=None, intrinsics=None):
            v = self.video
            pose, disp = sequence[int(t)]
            write(v, v.counter, np.asarray(image), pose, disp,
                  np.asarray(intrinsics) / 8.0)
            v.dirty[v.counter] = True
            v.counter += 1
            self.tracked.append(pose)

        def terminate(self, stream=None):
            self.video.dirty[: self.video.counter] = True
            return np.stack(self.tracked)
    return Recorder


def write_jax(v, i, image, pose, disp, intr):
    s = v.state
    v.state = s._replace(
        images=s.images.at[i].set(jnp.asarray(image)),
        poses=s.poses.at[i].set(jnp.asarray(pose)),
        disps=s.disps.at[i].set(jnp.asarray(disp)),
        intrinsics=s.intrinsics.at[i].set(jnp.asarray(intr, jnp.float32)))


def write_torch(v, i, image, pose, disp, intr):
    v.images[i] = torch.from_numpy(image.copy())
    v.poses[i] = torch.from_numpy(pose)
    v.disps[i] = torch.from_numpy(disp)
    v.intrinsics[i] = torch.from_numpy(np.float32(intr))


def test_demo_export_every_matches_jax_demo(tmp_path, monkeypatch):
    """Seven frames of 64 x 96, --export_every 3: both demos write the
    same snapshot files (after frames 3 and 6, and the final pair), with
    the same point and camera counts, points within 1e-5 and colours
    equal."""
    from lgu_slam_tpu import lie as jlie
    from lgu_slam_tpu.slam import system as jsystem
    from lgu_slam_tpu.slam.state import Video as JVideo
    from lgu_slam_tpu_torch.slam.state import Video

    n, h, w = 7, 64, 96
    rng = np.random.default_rng(1)
    (tmp_path / "images").mkdir()
    for t in range(n):
        imwrite(str(tmp_path / "images" / f"{t:04d}.png"),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    (tmp_path / "calib.txt").write_text(f"80.0 80.0 {w / 2} {h / 2}\n")
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = -0.03 * np.arange(n)
    poses = np.array(jlie.se3_exp(jnp.asarray(xi)))
    disp = (1.0 / plane_depth(h // 8, w // 8)).astype(np.float32)
    sequence = {t: (poses[t], disp) for t in range(n)}

    def argv(tag):
        return ["--imagedir", str(tmp_path / "images"), "--calib",
                str(tmp_path / "calib.txt"), "--stride", "1",
                "--target_pixels", str(h * w), "--buffer", "16",
                "--export_every", "3", "--export_dir",
                str(tmp_path / tag), "--trajectory_path",
                str(tmp_path / f"{tag}.txt")]

    monkeypatch.setattr(jsystem, "LGUSlam",
                        recorder(JVideo, write_jax, sequence))
    monkeypatch.setattr(jsystem, "init_params", lambda cfg: (None, None))
    monkeypatch.setattr("sys.argv", ["demo.py", *argv("jax")])
    script("demo").main()
    demo = script("demo_torch")
    monkeypatch.setattr(demo, "LGUSlam", recorder(
        lambda cfg: Video(cfg, "cpu"), write_torch, sequence))
    monkeypatch.setattr(demo, "init_state_dict", lambda cfg, seed: None)
    demo.main(argv("torch") + ["--device", "cpu"])

    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == [
        f"{kind}_{tag}.ply" for kind in ("cameras", "points")
        for tag in ("00003", "00006", "final")]
    for name in names:
        got, ref = tmp_path / "torch" / name, tmp_path / "jax" / name
        assert ply_counts(got) == ply_counts(ref), name
        if name.startswith("points"):
            (p_t, c_t), (p_j, c_j) = read_ply_points(got), \
                read_ply_points(ref)
            assert len(p_t) > 0
            np.testing.assert_allclose(p_t, p_j, atol=1e-5, err_msg=name)
            np.testing.assert_array_equal(c_t, c_j, err_msg=name)


@pytest.mark.parametrize("name,argv", [
    ("gs_slam_torch", ["--reconstruction", "r.npz"]),
    ("bench_gs_mapping_torch", []),
    ("view_reconstruction_torch", ["--reconstruction", "r.npz"]),
])
def test_gs_entry_points_need_cuda_without_device(name, argv, monkeypatch):
    """With no --device and no CUDA, the stage's entry points raise before
    they read anything; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script(name).main(argv)


def test_gs_classes_need_cuda_without_device(monkeypatch):
    from lgu_slam_tpu_torch.gs.mapping import GaussianMapper, GSConfig
    from lgu_slam_tpu_torch.gs.tsdf import TSDFVolume
    from lgu_slam_tpu_torch.slam.visualization import backproject_points

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GaussianMapper(GSConfig(capacity=16), (8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSDFVolume([0, 0, 0], [1, 1, 1], voxel_size=0.5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backproject_points(np.zeros((2, 7)), np.ones((2, 4, 4)),
                           np.ones(4))
