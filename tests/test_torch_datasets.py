"""The port's dataset loaders (lgu_slam_tpu_torch/data/rgbd_datasets.py,
replica.py, tartan.py, base.py, augmentation.py) on tiny on-disk fixtures:
the nine tests of tests/test_datasets.py on the port's loaders (for the
JPEG fixtures, discovery and poses, then the explicit error on a pixel
read), each loader's poses, intrinsics and frames against the JAX
package's loader (frames exact, poses and intrinsics within 1e-6),
``RGBDAugmentor`` bit-identical for a seed, and TartanAir clips
(``ClipDataset``) with the JAX package's index, frame graph (distances
within 1e-4 relative) and items."""

import json
import os

import cv2
import numpy as np
import pytest
from torch_port import torch_single_thread  # noqa: F401

from lgu_slam_tpu.data import augmentation as jaug
from lgu_slam_tpu.data import replica as jreplica
from lgu_slam_tpu.data import rgbd_datasets as jrgbd
from lgu_slam_tpu.data import tartan as jtartan
from lgu_slam_tpu_torch.data import augmentation as taug
from lgu_slam_tpu_torch.data import fixtures
from lgu_slam_tpu_torch.data import replica as treplica
from lgu_slam_tpu_torch.data import tartan as ttartan
from lgu_slam_tpu_torch.data.rgbd_datasets import (
    ICL,
    TUMRGBD,
    Azure,
    CameraParams,
    NeRFCapture,
    RealSense,
    Record3D,
    ScanNet,
    ScanNetPP,
    load_rgbd_dataset,
    quat_pose_to_matrix,
)
from lgu_slam_tpu_torch.geom.graph_utils import (
    chain_graph,
    graph_to_edge_list,
    keyframe_indicies,
)

H0, W0 = 48, 64
CAM = CameraParams(fx=60.0, fy=60.0, cx=32.0, cy=24.0, height=H0,
                   width=W0, png_depth_scale=1000.0)


def _write_frame(color_path, depth_path, i):
    os.makedirs(os.path.dirname(color_path), exist_ok=True)
    os.makedirs(os.path.dirname(depth_path), exist_ok=True)
    im = np.full((H0, W0, 3), (i * 20) % 255, np.uint8)
    im[::3, ::5] = (7 * i) % 255  # texture, so that a resize shows
    cv2.imwrite(color_path, im)
    d = np.full((H0, W0), 1500 + 10 * i, np.uint16)  # 1.5m+
    cv2.imwrite(depth_path, d)


def _check(ds, n):
    assert len(ds) == n
    im, d, w2c, intr = ds[0]
    assert im.shape == (H0, W0, 3) and 0.0 <= im.min() <= im.max() <= 1.0
    assert d.shape == (H0, W0)
    assert abs(d[0, 0] - 1.5) < 1e-3
    assert w2c.shape == (4, 4)
    np.testing.assert_allclose(intr, [60.0, 60.0, 32.0, 24.0])
    t, bgr, ds_d, _ = next(iter(ds.stream()))
    assert t == 0 and bgr.dtype == np.uint8 and ds_d.shape == (H0, W0)
    return w2c


def _same_as_jax(port, ref, frames=True):
    """The port's loader against the JAX package's: paths and poses, then
    every frame (image, depth, w2c, intrinsics)."""
    assert len(port) == len(ref)
    assert port.color_paths == ref.color_paths
    assert port.depth_paths == ref.depth_paths
    if ref.poses_c2w is None:
        assert port.poses_c2w is None
    else:
        np.testing.assert_allclose(port.poses_c2w, ref.poses_c2w, rtol=0,
                                   atol=1e-6)
    for i in range(len(ref) if frames else 0):
        for a, b in zip(port[i], ref[i]):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _tum(tmp_path, n=4):
    root = tmp_path / "rgbd_dataset_freiburg1_desk"
    rgb_lines, d_lines, gt_lines = [], ["# depth"], ["# gt"]
    for i in range(n):
        t = 100.0 + i * 0.25  # > 1/32 s apart so none are thinned
        _write_frame(str(root / f"rgb/{t:.4f}.png"),
                     str(root / f"depth/{t + 0.01:.4f}.png"), i)
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.png")
        d_lines.append(f"{t + 0.01:.4f} depth/{t + 0.01:.4f}.png")
        gt_lines.append(f"{t + 0.02:.4f} {0.1 * i:.3f} 0 0 0 0 0 1")
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(d_lines))
    (root / "groundtruth.txt").write_text("\n".join(gt_lines))
    return root


def test_tum_association(tmp_path):
    n = 4
    _tum(tmp_path, n)
    ds = TUMRGBD(str(tmp_path), "rgbd_dataset_freiburg1_desk", camera=CAM)
    w2c = _check(ds, n)
    im1 = ds[1]
    assert abs(im1[2][0, 3] + 0.1) < 1e-6
    assert abs(w2c[0, 3]) < 1e-6
    # the JAX loader, at the capture size and resized with the crop edge
    for kw in (dict(camera=CAM), dict(desired=(36, 40))):
        _same_as_jax(
            TUMRGBD(str(tmp_path), "rgbd_dataset_freiburg1_desk", **kw),
            jrgbd.TUMRGBD(str(tmp_path), "rgbd_dataset_freiburg1_desk",
                          **kw))


def test_tum_default_camera_from_sequence_name(tmp_path):
    root = tmp_path / "rgbd_dataset_freiburg2_xyz"
    _write_frame(str(root / "rgb/1.0.png"), str(root / "depth/1.0.png"), 0)
    (root / "rgb.txt").write_text("1.0 rgb/1.0.png")
    (root / "depth.txt").write_text("1.0 depth/1.0.png")
    (root / "groundtruth.txt").write_text("# gt\n1.0 0 0 0 0 0 0 1")
    ds = TUMRGBD(str(tmp_path), "rgbd_dataset_freiburg2_xyz")
    assert ds.camera.fx == 520.9 and ds.camera.png_depth_scale == 5000.0


def test_scannet_and_azure(tmp_path):
    """JPEG colour: discovery, poses and camera as the JAX loader's; a
    pixel read raises the image reader's NotImplementedError."""
    for cls, jcls in ((ScanNet, jrgbd.ScanNet), (Azure, jrgbd.Azure)):
        root = tmp_path / cls.__name__
        n = 3
        for i in range(n):
            _write_frame(str(root / f"color/{i}.jpg"),
                         str(root / f"depth/{i}.png"), i)
        if cls is ScanNet:
            os.makedirs(root / "pose", exist_ok=True)
            for i in range(n):
                T = np.eye(4)
                T[0, 3] = 0.05 * i
                np.savetxt(root / "pose" / f"{i}.txt", T)
        ds = cls(str(tmp_path), cls.__name__, camera=CAM)
        assert len(ds) == n
        _same_as_jax(ds, jcls(str(tmp_path), cls.__name__, camera=CAM),
                     frames=False)
        with pytest.raises(NotImplementedError, match="JPEG"):
            ds[0]
        with pytest.raises(NotImplementedError, match="JPEG"):
            next(iter(ds.stream()))


def test_icl_gt_sim_poses(tmp_path):
    root = tmp_path / "icl_seq"
    n = 3
    for i in range(n):
        _write_frame(str(root / f"rgb/{i}.png"),
                     str(root / f"depth/{i}.png"), i)
    lines = []
    for i in range(n):
        T = np.eye(4)
        T[1, 3] = 0.2 * i
        for r in range(3):
            lines.append(" ".join(f"{v:.6f}" for v in T[r]))
        lines.append("")  # blank separator, as the capture format has
    (root / "livingRoom.gt.sim").write_text("\n".join(lines))
    ds = ICL(str(tmp_path), "icl_seq", camera=CAM)
    _check(ds, n)
    assert abs(ds[2][2][1, 3] + 0.4) < 1e-6  # w2c inverts the +0.4 c2w
    _same_as_jax(ds, jrgbd.ICL(str(tmp_path), "icl_seq", camera=CAM))


def test_record3d_npy_poses_and_factory(tmp_path):
    root = tmp_path / "r3d"
    n = 3
    os.makedirs(root / "poses", exist_ok=True)
    for i in range(n):
        _write_frame(str(root / f"rgb/{i}.png"),
                     str(root / f"depth/{i}.png"), i)
        T = np.eye(4)
        T[2, 3] = 0.1 * i
        np.save(root / "poses" / f"{i}.npy", T)
    ds = load_rgbd_dataset("record3d", str(tmp_path), "r3d", camera=CAM)
    assert isinstance(ds, Record3D)
    _check(ds, n)
    _same_as_jax(ds, jrgbd.load_rgbd_dataset("record3d", str(tmp_path),
                                             "r3d", camera=CAM))


def test_nerfcapture_transforms_json(tmp_path):
    root = tmp_path / "capture"
    n = 2
    frames = []
    for i in range(n):
        _write_frame(str(root / f"rgb/{i}.png"),
                     str(root / f"depth/{i}.png"), i)
        T = np.eye(4)
        T[0, 3] = 0.3 * i
        frames.append({"file_path": f"rgb/{i}.png",
                       "transform_matrix": T.tolist()})
    meta = {"fl_x": 60.0, "fl_y": 60.0, "cx": 32.0, "cy": 24.0,
            "h": H0, "w": W0, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    ds = NeRFCapture(str(tmp_path), "capture")
    ds.camera.png_depth_scale = 1000.0  # fixture depth is mm
    _check(ds, n)
    ref = jrgbd.NeRFCapture(str(tmp_path), "capture")
    ref.camera.png_depth_scale = 1000.0
    _same_as_jax(ds, ref)


def test_realsense_and_scannetpp_match_jax(tmp_path):
    """RealSense (JPEG colour: discovery and OpenGL-conjugated poses, then
    the error on a pixel read) and ScanNet++'s DSLR layout (PNG frames
    named by transforms_undistorted.json, whose camera it takes)."""
    root = tmp_path / "rs"
    os.makedirs(root / "poses", exist_ok=True)
    for i in range(3):
        _write_frame(str(root / f"rgb/{i}.jpg"),
                     str(root / f"depth/{i}.png"), i)
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.02, -0.05 * i]
        np.save(root / "poses" / f"{i}.npy", T)
    ds = RealSense(str(tmp_path), "rs", camera=CAM)
    _same_as_jax(ds, jrgbd.RealSense(str(tmp_path), "rs", camera=CAM),
                 frames=False)
    with pytest.raises(NotImplementedError, match="JPEG"):
        ds[0]

    dslr = tmp_path / "pp" / "dslr"
    frames = []
    for i in range(2):
        _write_frame(str(dslr / f"undistorted_images/DSC{i:05d}.png"),
                     str(dslr / f"render_depth/DSC{i:05d}.png"), i)
        T = np.eye(4)
        T[1, 3] = 0.2 * i
        frames.append({"file_path": f"DSC{i:05d}.png",
                       "transform_matrix": T.tolist()})
    os.makedirs(dslr / "nerfstudio")
    (dslr / "nerfstudio" / "transforms_undistorted.json").write_text(
        json.dumps({"fl_x": 60.0, "fl_y": 60.0, "cx": 32.0, "cy": 24.0,
                    "h": H0, "w": W0, "frames": frames}))
    ds = ScanNetPP(str(tmp_path), "pp")
    _check(ds, 2)
    _same_as_jax(ds, jrgbd.ScanNetPP(str(tmp_path), "pp"))


def test_stride_start_end(tmp_path):
    root = tmp_path / "s"
    for i in range(6):
        _write_frame(str(root / f"color/{i}.jpg"),
                     str(root / f"depth/{i}.png"), i)
    ds = ScanNet(str(tmp_path), "s", camera=CAM, stride=2, start=1, end=6)
    assert len(ds) == 3  # frames 1, 3, 5
    _same_as_jax(ds, jrgbd.ScanNet(str(tmp_path), "s", camera=CAM, stride=2,
                                   start=1, end=6), frames=False)


def test_quat_pose_roundtrip(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    v = np.concatenate([rng.normal(size=3), q])
    T = quat_pose_to_matrix(v)
    R = T[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert abs(np.linalg.det(R) - 1.0) < 1e-12
    np.testing.assert_array_equal(T, jrgbd.quat_pose_to_matrix(v))


def test_unknown_dataset_raises(tmp_path):
    with pytest.raises(KeyError):
        load_rgbd_dataset("nope", str(tmp_path))


def test_replica_discovery_and_poses(tmp_path):
    """Replica: discovery, traj.txt poses and intrinsics as the JAX
    loader's; its colour frames are JPEG, so a pixel read raises."""
    scene = tmp_path / "room0"
    n = 3
    poses = []
    for i in range(n):
        _write_frame(str(scene / f"results/frame{i:06d}.jpg"),
                     str(scene / f"results/depth{i:06d}.png"), i)
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, -0.2 * i, 0.05]
        poses.append(T.reshape(-1))
    np.savetxt(scene / "traj.txt", np.stack(poses))
    ds = load_rgbd_dataset("replica", str(tmp_path), "room0")
    ref = jreplica.ReplicaDataset(str(scene))
    assert isinstance(ds, treplica.ReplicaDataset) and len(ds) == len(ref)
    assert ds.color_paths == ref.color_paths
    assert ds.depth_paths == ref.depth_paths
    np.testing.assert_array_equal(ds.poses_c2w, ref.poses_c2w)
    np.testing.assert_array_equal(ds.intr, ref.intr)
    assert ds.size == ref.size
    with pytest.raises(NotImplementedError, match="JPEG"):
        ds[0]


def test_augmentor_bit_identical(rng):
    """The same seed draws the same jitter, crop and flip: outputs equal
    the JAX package's bit for bit over several calls."""
    images = rng.integers(0, 256, (3, 50, 70, 3)).astype(np.uint8)
    poses = rng.normal(size=(3, 7)).astype(np.float32)
    depths = rng.random((3, 50, 70)).astype(np.float32)
    intr = np.asarray([[40.0, 40.0, 35.0, 25.0]] * 3, np.float32)
    for crop in ((40, 64), (50, 70)):
        port, ref = taug.RGBDAugmentor(crop, seed=3), \
            jaug.RGBDAugmentor(crop, seed=3)
        for _ in range(6):
            for a, b in zip(port(images, poses, depths, intr),
                            ref(images, poses, depths, intr)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_graph_utils_match_jax():
    from lgu_slam_tpu.geom import graph_utils as jg

    graph = chain_graph(6, radius=2)
    assert graph == jg.chain_graph(6, radius=2)
    for a, b in zip(graph_to_edge_list(graph), jg.graph_to_edge_list(graph)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(keyframe_indicies(graph),
                                  jg.keyframe_indicies(graph))


def test_tartanair_clips_match_jax(tmp_path):
    """A TartanAir tree (PNG, .npy depth, NED pose_left.txt) with one
    scene of the test split, which both skip: the same scenes, poses and
    items; the frame graphs with the same neighbours and distances within
    1e-4 relative (frame_distance in each package's float32)."""
    root = tmp_path / "tartan"
    fixtures.write_tartanair_scene(
        str(root / "abandonedfactory/abandonedfactory/Easy/P001"),
        n_frames=10, H=48, W=64)
    fixtures.write_tartanair_scene(
        str(root / "ocean/ocean/Easy/P013"), n_frames=4, H=48, W=64, seed=1)
    kw = dict(n_frames=3, fmin=0.5, fmax=200.0, crop_size=(40, 56))
    port = ttartan.dataset_factory(["tartan"], str(root),
                                   cache_dir=str(tmp_path / "pc"), **kw)
    ref = jtartan.dataset_factory(["tartan"], str(root),
                                  cache_dir=str(tmp_path / "jc"), **kw)
    assert list(port.scene_info) == list(ref.scene_info)
    assert len(port.scene_info) == 1
    (scene, pi), = port.scene_info.items()
    ri = ref.scene_info[scene]
    assert pi["images"] == ri["images"] and pi["depths"] == ri["depths"]
    np.testing.assert_array_equal(pi["poses"], ri["poses"])
    np.testing.assert_array_equal(pi["intrinsics"], ri["intrinsics"])
    assert pi["graph"].keys() == ri["graph"].keys()
    for i, (js, ds) in ri["graph"].items():
        np.testing.assert_array_equal(pi["graph"][i][0], js)
        np.testing.assert_allclose(pi["graph"][i][1], ds, rtol=1e-4)
    assert port.items == ref.items and len(port) > 0
    for index in range(min(len(port), 4)):
        for a, b in zip(port[index], ref[index]):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        ttartan.ned_to_xyz(np.arange(14.0).reshape(2, 7)),
        jtartan.ned_to_xyz(np.arange(14.0).reshape(2, 7)))
