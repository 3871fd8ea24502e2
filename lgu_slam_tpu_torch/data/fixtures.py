"""On-disk sequences in the layouts of the benchmarks' datasets, rendered by
``data/synthetic.py`` along known trajectories and written with the port's
own PNG encoder: for the tests and ``chip_smoke.py``, which have no dataset
to read (nothing is downloaded).

- :func:`write_tum_sequence`: a TUM RGB-D sequence (``rgb/``, 16-bit
  ``depth/`` in 1/5000 m, ``rgb.txt``, ``depth.txt``, ``groundtruth.txt``);
- :func:`write_euroc_sequence`: a EuRoC MAV stereo sequence (gray
  ``mav0/cam0|cam1/data/<ns>.png`` and the state-estimate ``data.csv``);
- :func:`write_tartanair_scene`: a TartanAir scene (``image_left/``,
  ``depth_left/*.npy``, NED ``pose_left.txt``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lgu_slam_tpu_torch.data.image_io import imwrite
from lgu_slam_tpu_torch.data.synthetic import (
    SyntheticScene,
    _quat_to_mat,
    make_trajectory,
)

TUM_T0 = 1305031102.0
# TUM fr1 intrinsics and EuRoC's left camera: the fixtures are rendered with
# the intrinsics their streams assume (the lenses' distortion is not)
TUM_FR1 = (517.3, 516.5, 318.6, 255.3)
EUROC_CAM = (458.654, 457.296, 367.215, 248.375)
EUROC_BASELINE = 0.11


def render_sequence(seed: int, n_frames: int, H: int, W: int, intrinsics,
                    t_step: float, r_step: float):
    """(images [n, H, W, 3] uint8, depths [n, H, W] m, camera-to-world
    poses [n, 7], the scene) of a random-walk camera in a synthetic
    scene."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(seed=seed)
    poses = make_trajectory(rng, n_frames, t_step, r_step)
    frames = render_all(scene, poses, intrinsics, H, W)
    return (np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
            poses, scene)


def _on_cores(fn, items) -> list:
    """``fn`` of every item on the host's cores (numpy and zlib release the
    GIL in the renderer's and the encoder's array work)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def render_all(scene, poses, intrinsics, H: int, W: int):
    """``scene.render`` of every pose."""
    return _on_cores(lambda p: scene.render(p, intrinsics, H, W), poses)


def _write_pngs(files) -> None:
    """``imwrite`` of every (path, image)."""
    _on_cores(lambda f: imwrite(*f), files)


def _write_list(path, header, rows):
    with open(path, "w") as fh:
        fh.write(header + "\n" + "\n".join(rows) + "\n")


def write_tum_sequence(root, n_frames: int = 40, H: int = 480, W: int = 640,
                       seed: int = 0, rate: float = 30.0) -> str:
    """A TUM RGB-D sequence under ``root`` (name it ``*freiburg1*`` for the
    fr1 calibration, as the benchmark's folders are named): colour at
    ``rate`` Hz, depth 10 ms after each colour frame, ground truth at the
    colour stamps.  Returns ``root``."""
    images, depths, poses, _ = render_sequence(
        seed, n_frames, H, W, TUM_FR1, t_step=0.02, r_step=0.004)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rgb, dep, gt, files = [], [], [], []
    for k in range(n_frames):
        t = TUM_T0 + k / rate
        d = np.clip(np.rint(depths[k] * 5000.0), 0, 65535).astype(np.uint16)
        files += [(os.path.join(root, "rgb", f"{t:.6f}.png"), images[k]),
                  (os.path.join(root, "depth", f"{t + 0.01:.6f}.png"), d)]
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}.png")
        gt.append(f"{t:.6f} " + " ".join(f"{v:.7f}" for v in poses[k]))
    _write_pngs(files)
    _write_list(os.path.join(root, "rgb.txt"), "# color images", rgb)
    _write_list(os.path.join(root, "depth.txt"), "# depth maps", dep)
    _write_list(os.path.join(root, "groundtruth.txt"),
                "# timestamp tx ty tz qx qy qz qw", gt)
    return root


def write_euroc_sequence(root, n_frames: int = 16, seed: int = 0,
                         rate: float = 20.0) -> str:
    """A EuRoC MAV stereo sequence of gray 752 x 480 PNG pairs under
    ``root`` (the right camera 11 cm to the left camera's right) with its
    state-estimate ground truth.  Returns ``root``."""
    H, W = 480, 752
    left, _, poses, scene = render_sequence(
        seed, n_frames, H, W, EUROC_CAM, t_step=0.03, r_step=0.006)
    right_poses = poses.astype(np.float64)
    for p in right_poses:  # the left camera's x axis, scaled by the baseline
        p[:3] += _quat_to_mat(p[3:7])[:, 0] * EUROC_BASELINE
    right = np.stack([f[0] for f in render_all(scene, right_poses,
                                               EUROC_CAM, H, W)])
    cams = [os.path.join(root, "mav0", c, "data") for c in ("cam0", "cam1")]
    for d in cams:
        os.makedirs(d, exist_ok=True)
    rows, files = [], []
    for k in range(n_frames):
        ns = int(1403636579763555584 + k * 1e9 / rate)
        for d, im in zip(cams, (left[k], right[k])):
            gray = np.rint(im.astype(np.float32).mean(-1)).astype(np.uint8)
            files.append((os.path.join(d, f"{ns}.png"), gray))
        p = poses[k]  # t, q(xyzw) -> p, q(wxyz)
        rows.append(",".join([str(ns)] + [f"{v:.7f}" for v in
                                          (*p[:3], p[6], *p[3:6])]))
    _write_pngs(files)
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    _write_list(os.path.join(gt_dir, "data.csv"),
                "#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z", rows)
    return root


# TartanAir's NED pose layout from the camera layout (inverse of
# data/tartan.py's ned_to_xyz permutation)
_XYZ_TO_NED = [2, 0, 1, 5, 3, 4, 6]


def write_tartanair_scene(root, n_frames: int = 12, H: int = 480,
                          W: int = 640, seed: int = 0) -> str:
    """A TartanAir scene directory ``root`` (``image_left/``,
    ``depth_left/``, ``pose_left.txt``) rendered at TartanAir's intrinsics
    scaled to ``W``.  Returns ``root``."""
    f = 320.0 * W / 640
    images, depths, poses, _ = render_sequence(
        seed, n_frames, H, W, (f, f, W / 2, H / 2), t_step=0.08,
        r_step=0.01)
    for sub in ("image_left", "depth_left"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    _write_pngs([(os.path.join(root, "image_left", f"{k:06d}_left.png"),
                  images[k]) for k in range(n_frames)])
    for k in range(n_frames):
        np.save(os.path.join(root, "depth_left", f"{k:06d}_left_depth.npy"),
                depths[k])
    np.savetxt(os.path.join(root, "pose_left.txt"), poses[:, _XYZ_TO_NED],
               delimiter=" ")
    return root
