"""RGB-D capture-dataset loaders for the 3DGS mapping stage (port of the
JAX package's ``data/rgbd_datasets.py``): plain-Python folder readers
producing numpy host arrays, on the port's own PNG and JPEG decoders and
resize (``data/image_io.py``, ``data/imgproc.py``) in place of OpenCV.

Every dataset yields, per frame:
  image  [H, W, 3] float32 RGB in [0, 1]   (resized to ``desired`` size)
  depth  [H, W]    float32 metres          (0 where invalid)
  w2c    [4, 4]    float32 world-to-camera (from the capture's GT/ARKit
                                            pose when present, else identity)
  intr   [4]       float32 (fx, fy, cx, cy), rescaled with the resize

plus a ``stream()`` view for feeding the SLAM system directly
((t, bgr uint8, depth, intr) tuples, matching data/streams.py).
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass

import numpy as np

from lgu_slam_tpu_torch.data.image_io import imread
from lgu_slam_tpu_torch.data.imgproc import NEAREST, resize


@dataclass
class CameraParams:
    """Capture intrinsics (reference: configs/data/*.yaml camera_params)."""

    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int
    png_depth_scale: float = 1000.0  # png units per metre
    crop_edge: int = 0


# Well-known capture intrinsics, mirroring the reference's YAML data
# configs (configs/data/{TUM/*.yaml, replica.yaml, scannet.yaml}) and the
# TUM benchmark's published calibrations.
KNOWN_CAMERAS = {
    # TUM yaml configs declare crop_edge=8 (configs/data/TUM/*.yaml); the
    # reference parses it (basedataset.py:166-168) but never applies it —
    # here the crop is applied (SplaTAM order: resize, then crop) so the
    # distorted 8px border never reaches mapping/eval.
    "tum_freiburg1": CameraParams(517.3, 516.5, 318.6, 255.3, 480, 640,
                                  5000.0, crop_edge=8),
    "tum_freiburg2": CameraParams(520.9, 521.0, 325.1, 249.7, 480, 640,
                                  5000.0, crop_edge=8),
    "tum_freiburg3": CameraParams(535.4, 539.2, 320.1, 247.6, 480, 640,
                                  5000.0, crop_edge=8),
    "replica": CameraParams(600.0, 600.0, 599.5, 339.5, 680, 1200, 6553.5),
    "icl": CameraParams(481.2, -480.0, 319.5, 239.5, 480, 640, 5000.0),
    # reference configs/data/scannet.yaml (full-res color)
    "scannet": CameraParams(1169.621094, 1167.105103, 646.295044,
                            489.927032, 968, 1296, 1000.0),
    # 640x480 depth-registered ScanNet export (common preprocessed layout)
    "scannet_640": CameraParams(577.59, 578.73, 318.9, 242.7, 480, 640,
                                1000.0),
    # Azure Kinect NFOV-unbinned depth-registered export; Record3D /
    # RealSense exports carry their own intrinsics files when present —
    # these are fallbacks only.
    "azure": CameraParams(602.0, 602.0, 320.0, 240.0, 480, 640, 1000.0),
}


def _resize_frame(im_rgb, depth, cam: CameraParams, desired):
    """Resize + intrinsics rescale, then edge crop (SplaTAM order:
    basedataset resizes to the configured size and the crop_edge border is
    removed afterwards, shrinking the output by 2*crop_edge per axis and
    shifting cx/cy by crop_edge)."""
    h0, w0 = im_rgb.shape[:2]
    H, W = desired
    im = resize(im_rgb, (W, H)).astype(np.float32)
    d = resize(depth, (W, H), NEAREST)
    sy, sx = H / h0, W / w0
    fx, fy = cam.fx * sx, cam.fy * sy
    cx, cy = cam.cx * sx, cam.cy * sy
    if cam.crop_edge:
        c = cam.crop_edge
        im = im[c:-c, c:-c]
        d = d[c:-c, c:-c]
        cx -= c
        cy -= c
    intr = np.asarray([fx, fy, cx, cy], np.float32)
    return im, d, intr


def quat_pose_to_matrix(pvec: np.ndarray) -> np.ndarray:
    """TUM (tx ty tz qx qy qz qw) 7-vec -> 4x4 c2w matrix."""
    t, (x, y, z, w) = pvec[:3], pvec[3:7]
    n = max(float(x * x + y * y + z * z + w * w), 1e-12)
    s = 2.0 / n
    R = np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
            [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
            [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
        ]
    )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class RGBDFolderDataset:
    """Common machinery for folder-of-frames RGB-D captures.

    Subclasses implement ``_discover() -> (color_paths, depth_paths,
    poses_c2w)`` (poses may be None for pose-free captures).
    """

    def __init__(self, basedir, sequence="", camera: CameraParams = None,
                 desired=None, stride=1, start=0, end=-1):
        self.input_folder = os.path.join(basedir, sequence)
        self.camera = camera or self._default_camera()
        self.desired = tuple(desired) if desired else (
            self.camera.height, self.camera.width)
        colors, depths, poses = self._discover()
        n = min(len(colors), len(depths))
        if poses is not None:
            n = min(n, len(poses))
        if end < 0:
            end = n
        sl = slice(start, end, stride)
        self.color_paths = list(colors[:n])[sl]
        self.depth_paths = list(depths[:n])[sl]
        self.poses_c2w = (
            np.asarray(poses[:n], np.float64)[sl] if poses is not None
            else None
        )

    def _default_camera(self) -> CameraParams:
        raise NotImplementedError

    def _discover(self):
        raise NotImplementedError

    def _read_depth(self, path):
        d = imread(path, anydepth=True)
        return np.asarray(d, np.float32) / self.camera.png_depth_scale

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, i):
        im = imread(self.color_paths[i])[..., ::-1]  # BGR -> RGB
        d = self._read_depth(self.depth_paths[i])
        im, d, intr = _resize_frame(im, d, self.camera, self.desired)
        c2w = (self.poses_c2w[i] if self.poses_c2w is not None
               else np.eye(4))
        w2c = np.linalg.inv(c2w).astype(np.float32)
        return im / 255.0, d, w2c, intr

    def stream(self):
        """SLAM input view: (t, bgr uint8 [H,W,3], depth, intr)."""
        for t in range(len(self)):
            im, d, _, intr = self[t]
            yield t, (im[..., ::-1] * 255).astype(np.uint8), d, intr


class TUMRGBD(RGBDFolderDataset):
    """TUM RGB-D capture (gradslam_datasets/tum.py): associates rgb.txt /
    depth.txt / groundtruth.txt by timestamp (max_dt 0.08) and thins to a
    32 Hz frame budget before striding."""

    FRAME_RATE = 32

    def _default_camera(self):
        for key in ("freiburg1", "freiburg2", "freiburg3"):
            if key in self.input_folder:
                return KNOWN_CAMERAS[f"tum_{key}"]
        return KNOWN_CAMERAS["tum_freiburg3"]

    def _discover(self):
        root = self.input_folder

        def parse(name, skiprows=0):
            return np.loadtxt(os.path.join(root, name), dtype=str,
                              skiprows=skiprows, ndmin=2)

        images = parse("rgb.txt")
        depths = parse("depth.txt")
        pose_file = ("groundtruth.txt"
                     if os.path.isfile(os.path.join(root, "groundtruth.txt"))
                     else "pose.txt")
        have_poses = os.path.isfile(os.path.join(root, pose_file))
        poses = parse(pose_file, skiprows=1) if have_poses else None

        t_im = images[:, 0].astype(np.float64)
        t_d = depths[:, 0].astype(np.float64)
        t_p = poses[:, 0].astype(np.float64) if have_poses else None

        assoc = []
        for i, t in enumerate(t_im):
            j = int(np.argmin(np.abs(t_d - t)))
            if abs(t_d[j] - t) >= 0.08:
                continue
            if t_p is None:
                assoc.append((i, j, -1))
            else:
                k = int(np.argmin(np.abs(t_p - t)))
                if abs(t_p[k] - t) < 0.08:
                    assoc.append((i, j, k))

        keep = [0] if assoc else []
        for n in range(1, len(assoc)):
            if t_im[assoc[n][0]] - t_im[assoc[keep[-1]][0]] > 1.0 / \
                    self.FRAME_RATE:
                keep.append(n)

        colors, dpaths, c2ws = [], [], []
        for n in keep:
            i, j, k = assoc[n]
            colors.append(os.path.join(root, images[i, 1]))
            dpaths.append(os.path.join(root, depths[j, 1]))
            if k >= 0:
                c2ws.append(
                    quat_pose_to_matrix(poses[k, 1:8].astype(np.float64)))
        return colors, dpaths, (c2ws if c2ws else None)


class ScanNet(RGBDFolderDataset):
    """ScanNet export (gradslam_datasets/scannet.py): color/*.jpg,
    depth/*.png (mm), pose/*.txt 4x4 c2w."""

    def _default_camera(self):
        return KNOWN_CAMERAS["scannet"]

    def _discover(self):
        root = self.input_folder
        colors = sorted(glob.glob(os.path.join(root, "color", "*.jpg")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(root, "depth", "*.png")),
                        key=_natkey)
        pose_files = sorted(glob.glob(os.path.join(root, "pose", "*.txt")),
                            key=_natkey)
        poses = [np.loadtxt(p).reshape(4, 4) for p in pose_files] or None
        return colors, depths, poses


class ICL(RGBDFolderDataset):
    """ICL-NUIM (gradslam_datasets/icl.py): rgb/*.png + depth/*.png and a
    ``*.gt.sim`` pose file holding three 3x4 rows per frame."""

    def _default_camera(self):
        return KNOWN_CAMERAS["icl"]

    def _discover(self):
        root = self.input_folder
        colors = sorted(glob.glob(os.path.join(root, "rgb", "*.png")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(root, "depth", "*.png")),
                        key=_natkey)
        sims = glob.glob(os.path.join(root, "*.gt.sim"))
        poses = None
        if sims:
            rows = []
            with open(sims[0]) as f:
                for line in f:
                    vals = line.split()
                    if len(vals) == 4:
                        rows.append([float(v) for v in vals])
            rows = np.asarray(rows)
            poses = []
            for r in range(0, rows.shape[0] - 2, 3):
                T = np.eye(4)
                T[:3, :4] = rows[r:r + 3]
                poses.append(T)
        return colors, depths, poses


class Azure(RGBDFolderDataset):
    """Azure Kinect export (gradslam_datasets/azure.py): color/*.jpg +
    depth/*.png, optional poses_global_dvo.txt (one flat 4x4 per line)."""

    def _default_camera(self):
        return KNOWN_CAMERAS["azure"]

    def _discover(self):
        root = self.input_folder
        colors = sorted(glob.glob(os.path.join(root, "color", "*.jpg")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(root, "depth", "*.png")),
                        key=_natkey)
        poses = None
        pose_path = os.path.join(root, "poses_global_dvo.txt")
        if os.path.isfile(pose_path):
            flat = np.loadtxt(pose_path).reshape(-1, 4, 4)
            poses = list(flat)
        return colors, depths, poses


class Record3D(RGBDFolderDataset):
    """Record3D export (gradslam_datasets/record3d.py): rgb/*.png +
    depth/*.png + poses/*.npy (4x4 OpenGL c2w each, conjugated by
    P=diag(1,-1,-1,1): record3d.py:65)."""

    def _default_camera(self):
        return KNOWN_CAMERAS["azure"]

    def _discover(self):
        root = self.input_folder
        colors = sorted(glob.glob(os.path.join(root, "rgb", "*.png")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(root, "depth", "*.png")),
                        key=_natkey)
        pose_files = sorted(glob.glob(os.path.join(root, "poses", "*.npy")),
                            key=_natkey)
        poses = [_gl_conjugate(np.load(p).reshape(4, 4))
                 for p in pose_files] or None
        return colors, depths, poses


class RealSense(Record3D):
    """RealSense export (gradslam_datasets/realsense.py): rgb/*.jpg +
    depth/*.png + poses/*.npy."""

    def _discover(self):
        root = self.input_folder
        colors = sorted(glob.glob(os.path.join(root, "rgb", "*.jpg")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(root, "depth", "*.png")),
                        key=_natkey)
        pose_files = sorted(glob.glob(os.path.join(root, "poses", "*.npy")),
                            key=_natkey)
        poses = [_gl_conjugate(np.load(p).reshape(4, 4))
                 for p in pose_files] or None
        return colors, depths, poses


_GL_P = np.diag([1.0, -1.0, -1.0, 1.0])


def _gl_conjugate(c2w):
    """OpenGL camera-to-world -> OpenCV convention in *both* frames:
    ``P @ c2w @ P`` with P = diag(1,-1,-1,1) (reference
    gradslam_datasets/{nerfcapture,scannetpp,record3d,realsense}.py —
    ``P @ c2w @ P.T``; P is symmetric)."""
    return _GL_P @ c2w @ _GL_P


class NeRFCapture(RGBDFolderDataset):
    """NeRFCapture / iPhone export (gradslam_datasets/nerfcapture.py):
    rgb/ + depth/ folders plus a transforms.json carrying intrinsics and
    per-frame ``transform_matrix`` c2w poses.  OpenGL c2w matrices are
    conjugated by P = diag(1,-1,-1,1) — ``P @ c2w @ P`` — flipping both the
    camera axes *and* the world frame to OpenCV convention, matching the
    reference world frame exactly (nerfcapture.py:98)."""

    def __init__(self, basedir, sequence="", **kw):
        meta_path = os.path.join(basedir, sequence, "transforms.json")
        with open(meta_path) as f:
            self.meta = json.load(f)
        kw.setdefault("camera", CameraParams(
            fx=float(self.meta["fl_x"]), fy=float(self.meta["fl_y"]),
            cx=float(self.meta["cx"]), cy=float(self.meta["cy"]),
            height=int(self.meta["h"]), width=int(self.meta["w"]),
            png_depth_scale=6553.5,
        ))
        super().__init__(basedir, sequence, **kw)

    def _discover(self):
        root = self.input_folder
        by_name = {
            os.path.basename(fr["file_path"]): fr
            for fr in self.meta["frames"]
        }
        names = sorted(os.listdir(os.path.join(root, "rgb")), key=_natkey)
        colors, depths, poses = [], [], []
        for name in names:
            fr = by_name.get(name)
            if fr is None:
                continue
            colors.append(os.path.join(root, "rgb", name))
            depths.append(os.path.join(
                root, "depth", os.path.splitext(name)[0] + ".png"))
            poses.append(_gl_conjugate(np.asarray(fr["transform_matrix"])))
        return colors, depths, poses


class ScanNetPP(RGBDFolderDataset):
    """ScanNet++ DSLR split (gradslam_datasets/scannetpp.py): undistorted
    images + rendered depth under dslr/, poses from the NeRFStudio
    transforms_undistorted.json (depth in mm)."""

    def __init__(self, basedir, sequence="", **kw):
        seq_root = os.path.join(basedir, sequence)
        meta_path = os.path.join(
            seq_root, "dslr", "nerfstudio", "transforms_undistorted.json")
        with open(meta_path) as f:
            self.meta = json.load(f)
        kw.setdefault("camera", CameraParams(
            fx=float(self.meta["fl_x"]), fy=float(self.meta["fl_y"]),
            cx=float(self.meta["cx"]), cy=float(self.meta["cy"]),
            height=int(self.meta["h"]), width=int(self.meta["w"]),
            png_depth_scale=1000.0,
        ))
        super().__init__(basedir, sequence, **kw)

    def _discover(self):
        base = os.path.join(self.input_folder, "dslr")
        colors, depths, poses = [], [], []
        for fr in self.meta["frames"]:
            name = os.path.basename(fr["file_path"])
            colors.append(
                os.path.join(base, "undistorted_images", name))
            depths.append(os.path.join(
                base, "render_depth", os.path.splitext(name)[0] + ".png"))
            poses.append(_gl_conjugate(np.asarray(fr["transform_matrix"])))
        return colors, depths, poses


def _natkey(path):
    """Natural sort key (digit runs compare numerically), replacing the
    reference's natsort dependency."""
    import re

    return [int(s) if s.isdigit() else s
            for s in re.split(r"(\d+)", os.path.basename(path))]


DATASET_REGISTRY = {
    "tum": TUMRGBD,
    "scannet": ScanNet,
    "scannetpp": ScanNetPP,
    "icl": ICL,
    "azure": Azure,
    "record3d": Record3D,
    "realsense": RealSense,
    "nerfcapture": NeRFCapture,
    "iphone": NeRFCapture,
}


def load_rgbd_dataset(name, basedir, sequence="", **kw):
    """Factory mirroring executeSlam.py's get_dataset dispatch; `replica`
    routes to the dedicated loader in data/replica.py."""
    name = name.lower()
    if name == "replica":
        from lgu_slam_tpu_torch.data.replica import ReplicaDataset

        return ReplicaDataset(os.path.join(basedir, sequence), **kw)
    if name not in DATASET_REGISTRY:
        raise KeyError(
            f"unknown dataset '{name}' (have {sorted(DATASET_REGISTRY)})")
    return DATASET_REGISTRY[name](basedir, sequence, **kw)
