"""On-disk sequences in the layouts of the benchmarks' datasets, rendered by
``data/synthetic.py`` along known trajectories and written with the port's
own PNG and JPEG encoders: for the tests and ``chip_smoke.py``, which have
no dataset to read (nothing is downloaded).

- :func:`write_tum_sequence`: a TUM RGB-D sequence (``rgb/``, 16-bit
  ``depth/`` in 1/5000 m, ``rgb.txt``, ``depth.txt``, ``groundtruth.txt``),
  its frames in a format of :func:`write_frame` (colour PNG, PPM, JPEG,
  WebP, GIF, Sun raster or YCbCr TIFF; depth as 16-bit PNG, PGM or LZW
  TIFF, or float TIFF, PFM or Radiance HDR);
- :func:`write_euroc_sequence`: a EuRoC MAV stereo sequence (gray
  ``mav0/cam0|cam1/data/<ns>.png`` and the state-estimate ``data.csv``);
- :func:`write_tartanair_scene`: a TartanAir scene (``image_left/``,
  ``depth_left/*.npy``, NED ``pose_left.txt``);
- :func:`write_scannet_sequence`: a ScanNet export (JPEG ``color/``, 16-bit
  ``depth/`` in mm, ``pose/*.txt`` camera-to-world matrices);
- :func:`write_replica_scene`: a Replica scene (``results/frame*.jpg``,
  ``results/depth*.png`` in 1/6553.5 m, ``traj.txt``);
- :func:`write_jpeg_imagedir`: a JPEG image directory and its
  ``calib.txt``, as the demo reads them.

The JPEG writers take :func:`image_io.encode_jpeg`'s ``quality``,
``subsampling`` and ``restart_interval`` (defaults: ``cv2.imwrite``'s
quality 95 and 4:2:0).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lgu_slam_tpu_torch.data import (avif, gif, hdr, jp2, pnm, sunras, tiff,
                                     webp)
from lgu_slam_tpu_torch.data.image_io import encode_jpeg, encode_png, imwrite
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
# the 640 x 480 depth-registered ScanNet camera (rgbd_datasets.KNOWN_CAMERAS
# "scannet_640") and Replica's (data/replica.py INTRINSICS)
SCANNET_640 = (577.59, 578.73, 318.9, 242.7)
REPLICA_CAM = (600.0, 600.0, 599.5, 339.5)


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


def _write_jpegs(files, **jpeg) -> None:
    """The JPEG of every (path, image) (``encode_jpeg`` keywords)."""
    def write(f):
        with open(f[0], "wb") as fh:
            fh.write(encode_jpeg(f[1], **jpeg))
    _on_cores(write, files)


def _c2w_matrix(pose) -> np.ndarray:
    """Camera-to-world (t, quaternion xyzw) -> 4 x 4."""
    T = np.eye(4)
    T[:3, :3] = _quat_to_mat(np.asarray(pose[3:7], np.float64))
    T[:3, 3] = pose[:3]
    return T


def _write_list(path, header, rows):
    with open(path, "w") as fh:
        fh.write(header + "\n" + "\n".join(rows) + "\n")


# write_frame's kinds -> file extension
FRAME_EXT = {"png": "png", "ppm": "ppm", "pgm": "pgm", "tiff": "tiff",
             "pfm": "pfm", "jpg": "jpg", "arith-jpg": "jpg", "bigtiff": "tif",
             "webp": "webp", "gif": "gif", "ras": "ras", "hdr": "hdr",
             "rgbe-tiff": "tiff", "ycbcr-tiff": "tif", "ycbcr-png": "png",
             "lzw16-tiff": "tif", "jp2": "jp2", "ht-jp2": "jp2",
             "12bit-tiff": "tif", "12bit-png": "png", "avif": "avif",
             "12bit-avif": "avif", "12bit-avif-png": "png",
             "lossy-avif": "avif", "lossy-avif-png": "png",
             "lr-avif": "avif", "lr-avif-png": "png",
             "grain-avif": "avif", "grain-avif-png": "png",
             "12bit-grain-avif": "avif", "12bit-grain-avif-png": "png",
             "tools-avif": "avif", "tools-avif-png": "png",
             "12bit-frames-avif": "avif", "12bit-frames-avif-png": "png"}
# the writer's lossy AVIF frames (avif.encode_avif's ``lossy``): 4:2:0
# under BT.601, 16 x 16 blocks, deblocking and two CDEF strengths
LOSSY_AVIF = dict(base_q=60, qm=8, block=16, lf=(8, 8, 4, 4), sharpness=0,
                  cdef_damping=4, cdef=[(2, 1, 1, 0), (4, 2, 2, 1)])
# the same with segmentation (a segment of its own quantiser, a lossless
# one, one of other loop filter levels), for frames coded at 8 / 12 of
# their width (superres) in two tile columns where wide enough
TOOLS_AVIF = dict(LOSSY_AVIF, segments=[
    dict(alt_q=20), dict(alt_q=-60), dict(lf_y_v=6, lf_u=-4)])
# the same with loop restoration: Wiener units of 256 x 256 on luma (their
# taps in turn), self-guided units on chroma (two sets, one of radius 2
# and 1, one of radius 1 alone)
LR_AVIF = dict(LOSSY_AVIF, lr=dict(
    types=("wiener", "sgrproj", "sgrproj"), unit_shift=2, units=[
        [("wiener", (3, -7, 15), (3, -7, 15)),
         ("wiener", (-2, 5, 20), (1, -12, 30))],
        [("sgrproj", 4, (-40, 40))], [("sgrproj", 12, (0, 50))]]))


# the film grain of the writer's grain frames (avif.grain_vector): libaom's
# test vector 4 on lossy colour (luma and chroma grain, lag 3, overlap),
# vector 6 with lag 1 on 12-bit depth (luma grain, clipped to 16-235)
GRAIN_AVIF = 4
GRAIN_DEPTH = dict(vector=6, ar_coeff_lag=1)


def ycbcr_samples(bgr: np.ndarray) -> np.ndarray:
    """BGR -> full-range ITU-R BT.601 Y, Cb, Cr samples (JFIF's, TIFF's
    default YCbCrCoefficients and ReferenceBlackWhite), rounded."""
    b, g, r = (bgr[..., k].astype(np.float64) for k in range(3))
    ycc = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                    128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                    128 + 0.5 * r - 0.418688 * g - 0.081312 * b], -1)
    return np.clip(np.rint(ycc), 0, 255).astype(np.uint8)


def lab_samples(bgr: np.ndarray) -> np.ndarray:
    """BGR -> 8-bit CIE L*a*b* samples (L* unsigned, a* and b* signed) that
    libtiff's conversion (the sRGB display of its RGBA interface, D50
    white) takes back to about the same colours: its gamma ramp and
    display matrix inverted, then CIE 1976 L*a*b*, rounded."""
    rgb = bgr[..., ::-1].astype(np.float64) / 255
    luminance = 1 + 99 * rgb ** 2.4
    display = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                        [0.0556, -0.2040, 1.0570]])
    t = luminance @ np.linalg.inv(display).T / np.array([96.425, 100,
                                                         82.468])
    f = np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16 / 116)
    lab = np.stack([(116 * f[..., 1] - 16) * 255 / 100,
                    500 * (f[..., 0] - f[..., 1]),
                    200 * (f[..., 1] - f[..., 2])], -1)
    lab = np.rint(lab)
    lab[..., 0] = np.clip(lab[..., 0], 0, 255)
    lab[..., 1:] = np.clip(lab[..., 1:], -128, 127) % 256
    return lab.astype(np.uint8)


def ycbcr_tiff(bgr: np.ndarray) -> bytes:
    """A colour frame as an uncompressed YCbCr TIFF subsampled 2 x 2 (the
    chroma of each block its mean), strips of 16 rows."""
    return tiff.encode_tiff(ycbcr_samples(bgr), photometric=6,
                            subsampling=(2, 2), rows_per_strip=16)


def gif_cube(bgr: np.ndarray) -> tuple:
    """(indices, RGB palette) of BGR on the 6 x 6 x 6 colour cube: the GIF
    that ``write_frame`` writes of a colour frame."""
    levels = np.arange(6) * 51
    q = (bgr.astype(np.int64) * 5 + 127) // 255  # nearest level per channel
    idx = (q[..., 2] * 36 + q[..., 1] * 6 + q[..., 0]).astype(np.uint8)
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    palette = np.stack([r.ravel(), g.ravel(), b.ravel()], -1)
    return idx, palette.astype(np.uint8)


def write_frame(path, image, kind: str) -> str:
    """Write ``image`` as ``kind`` at ``path`` + its extension
    (:data:`FRAME_EXT`), the way a dataset of that format stores it;
    returns the file's path.  Colour (``uint8 [H, W, 3]``): ``png``,
    ``ppm`` (binary P6), ``jpg`` (baseline Huffman JPEG at cv2.imwrite's
    defaults), ``arith-jpg`` (the same coefficients arithmetic-coded),
    ``webp`` (lossless: ``webp.encode_webp_lossless``), ``gif`` (on the
    colour cube of :func:`gif_cube`) or ``ras`` (24-bit Sun raster); depth
    (``uint16 [H, W]``): ``png``, ``pgm`` (binary 16-bit P5), or the same
    values as ``float32`` in ``tiff`` (Deflate, floating-point predictor)
    or ``pfm``, or as ``float64`` in ``bigtiff`` (a BigTIFF, Deflate,
    floating-point predictor), or as gray Radiance ``hdr`` (run-length
    RGBE, which rounds them to 8-bit mantissas), or ``rgbe-tiff``: the
    values that ``hdr`` file reads back as, in a float32 ``tiff``; colour
    as ``ycbcr-tiff`` (:func:`ycbcr_tiff`) or ``ycbcr-png``, the PNG of
    what that TIFF reads back as; depth as ``lzw16-tiff`` (16-bit, LZW,
    horizontal predictor); colour or depth as ``jp2`` (lossless JPEG 2000:
    ``jp2.encode_jp2``) or ``ht-jp2`` (the same with HTJ2K code blocks,
    lossless: the cleanup pass alone); depth as ``12bit-tiff`` (its top
    12 bits, ``min(d >> 4, 4095)``, as 12-bit TIFF samples) or
    ``12bit-png``, the 16-bit PNG of what that TIFF reads back as (those
    12 bits shifted up by 4); colour as ``avif`` (lossless AVIF:
    ``avif.encode_avif``), depth as ``12bit-avif`` (those top 12 bits as a
    12-bit gray lossless AVIF) or ``12bit-avif-png`` (the same values,
    unshifted, as a 16-bit PNG); colour as ``lossy-avif`` (the writer's
    lossy 4:2:0 AVIF, :data:`LOSSY_AVIF`) or ``lossy-avif-png``, the PNG of
    what that AVIF reads back as; ``lr-avif`` and ``lr-avif-png`` the same
    with loop restoration (:data:`LR_AVIF`); ``grain-avif`` and
    ``grain-avif-png`` the same with film grain (:data:`GRAIN_AVIF`);
    depth as ``12bit-grain-avif`` (``12bit-avif`` with film grain,
    :data:`GRAIN_DEPTH`) or ``12bit-grain-avif-png``, the 16-bit PNG of
    what that AVIF reads back as; colour as ``tools-avif`` (segmentation
    and superres with loop restoration, :data:`TOOLS_AVIF`) or
    ``tools-avif-png``, the PNG of what it reads back as; depth as
    ``12bit-frames-avif`` (an item of three frames: a hidden key frame of
    the 12 bits, a shown intra-only frame of their complement, then
    show_existing_frame of the first) or ``12bit-frames-avif-png``, the
    16-bit PNG of those 12 bits."""
    path = f"{path}.{FRAME_EXT[kind]}" if kind in FRAME_EXT else path
    if kind == "png":
        data = encode_png(image)
    elif kind in ("jpg", "arith-jpg"):
        data = encode_jpeg(image, arithmetic=kind == "arith-jpg")
    elif kind in ("ppm", "pgm"):
        data = pnm.encode_pnm(image)
    elif kind == "tiff":
        data = tiff.encode_tiff(image.astype(np.float32), "deflate", 3)
    elif kind == "bigtiff":
        data = tiff.encode_tiff(image.astype(np.float64), "deflate", 3,
                                bigtiff=True)
    elif kind == "pfm":
        data = pnm.encode_pfm(image.astype(np.float32))
    elif kind == "webp":
        data = webp.encode_webp_lossless(image)
    elif kind == "gif":
        idx, palette = gif_cube(image)
        data = gif.encode_gif([idx], palette=palette)
    elif kind == "ras":
        data = sunras.encode_sunras(image)
    elif kind == "hdr":
        data = hdr.encode_hdr(np.repeat(image.astype(np.float32)[..., None],
                                        3, -1))
    elif kind == "rgbe-tiff":
        data = tiff.encode_tiff(hdr.depth_values(image), "deflate", 3)
    elif kind == "ycbcr-tiff":
        data = ycbcr_tiff(image)
    elif kind == "ycbcr-png":
        data = encode_png(tiff.decode_tiff(ycbcr_tiff(image)))
    elif kind == "lzw16-tiff":
        data = tiff.encode_tiff(image, "lzw", 2)
    elif kind in ("jp2", "ht-jp2"):
        data = jp2.encode_jp2(image, ht=kind == "ht-jp2")
    elif kind in ("12bit-tiff", "12bit-png"):
        top = np.minimum(image >> 4, 4095).astype(np.uint16)
        data = tiff.encode_tiff(top, twelve_bit=True) if kind == \
            "12bit-tiff" else encode_png(top << 4)
    elif kind == "avif":
        data = avif.encode_avif(image)
    elif kind in ("lossy-avif", "lossy-avif-png", "lr-avif", "lr-avif-png",
                  "grain-avif", "grain-avif-png"):
        data = avif.encode_avif(image, lossy=LR_AVIF if kind.startswith(
            "lr") else LOSSY_AVIF, grain=GRAIN_AVIF if kind.startswith(
                "grain") else None)
        if kind.endswith("-png"):
            data = encode_png(avif.decode_avif(data))
    elif kind in ("12bit-avif", "12bit-avif-png"):
        top = np.minimum(image >> 4, 4095).astype(np.uint16)
        data = avif.encode_avif(top, 12) if kind == "12bit-avif" else \
            encode_png(top)
    elif kind in ("tools-avif", "tools-avif-png"):
        W = image.shape[1]
        data = avif.encode_avif(image, lossy=dict(TOOLS_AVIF, lr=LR_AVIF[
            "lr"]), superres=12, tile_cols_log2=int((W * 8 + 6) // 12 > 128))
        if kind.endswith("-png"):
            data = encode_png(avif.decode_avif(data))
    elif kind in ("12bit-frames-avif", "12bit-frames-avif-png"):
        top = np.minimum(image >> 4, 4095).astype(np.uint16)
        hidden = dict(type="key", show=False, showable=True, refresh=1)
        data = avif.encode_avif(top, 12, av1=avif.frames_av1([
            dict(planes=[top], depth=12, frame=hidden),
            dict(planes=[4095 - top], depth=12, seed=1,
                 frame=dict(type="intra", refresh=2)), 0])) if kind == \
            "12bit-frames-avif" else encode_png(top)
    elif kind in ("12bit-grain-avif", "12bit-grain-avif-png"):
        top = np.minimum(image >> 4, 4095).astype(np.uint16)
        data = avif.encode_avif(top, 12, grain=GRAIN_DEPTH)
        if kind.endswith("-png"):
            data = encode_png(avif.decode_avif(data, gray=True))
    else:
        raise ValueError(f"no fixture format {kind!r}")
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _write_tum(root, rgb, depths, poses, rate: float, depth: str = "png"
               ) -> None:
    """The rest of a TUM RGB-D sequence under ``root`` whose colour frames
    the caller has written under ``rgb/`` (``rgb``: their file names, frame
    k stamped ``TUM_T0 + k / rate``): each frame's depth (in 1/5000 m, 10
    ms later, as :func:`write_frame`'s ``depth`` format), its ground truth
    at the colour stamp, and the three lists."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    lines, dep, gt, files = [], [], [], []
    for k, name in enumerate(rgb):
        t = TUM_T0 + k / rate
        d = np.clip(np.rint(depths[k] * 5000.0), 0, 65535).astype(np.uint16)
        files.append((os.path.join(root, "depth", f"{t + 0.01:.6f}"), d,
                      depth))
        lines.append(f"{t:.6f} rgb/{name}")
        dep.append(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}."
                   f"{FRAME_EXT[depth]}")
        gt.append(f"{t:.6f} " + " ".join(f"{v:.7f}" for v in poses[k]))
    _on_cores(lambda f: write_frame(*f), files)
    _write_list(os.path.join(root, "rgb.txt"), "# color images", lines)
    _write_list(os.path.join(root, "depth.txt"), "# depth maps", dep)
    _write_list(os.path.join(root, "groundtruth.txt"),
                "# timestamp tx ty tz qx qy qz qw", gt)


def write_tum_sequence(root, n_frames: int = 40, H: int = 480, W: int = 640,
                       seed: int = 0, rate: float = 30.0, color: str = "png",
                       depth: str = "png") -> str:
    """A TUM RGB-D sequence under ``root`` (name it ``*freiburg1*`` for the
    fr1 calibration, as the benchmark's folders are named): colour at
    ``rate`` Hz, depth (in 1/5000 m) 10 ms after each colour frame, ground
    truth at the colour stamps; frames stored as :func:`write_frame`'s
    ``color`` and ``depth`` formats (TUM's own: 16-bit PNG).  Returns
    ``root``."""
    images, depths, poses, _ = render_sequence(
        seed, n_frames, H, W, TUM_FR1, t_step=0.02, r_step=0.004)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    stamps = [f"{TUM_T0 + k / rate:.6f}" for k in range(n_frames)]
    _on_cores(lambda f: write_frame(*f), [
        (os.path.join(root, "rgb", t), img, color)
        for t, img in zip(stamps, images)])
    _write_tum(root, [f"{t}.{FRAME_EXT[color]}" for t in stamps], depths,
               poses, rate, depth)
    return root


def write_tum_with_colour(root, colour, seed: int, order=None,
                          png: bool = False, rate: float = 30.0) -> str:
    """A TUM RGB-D sequence under ``root`` whose colour frames are encoded
    files given as they are (``colour``: a list of (extension, bytes), such
    as committed layered AVIF items no writer here makes), taken in
    ``order`` (indices into ``colour``; by default each once): the depth
    and ground truth of each are those of the same frame of
    ``render_sequence(seed, len(colour), H, W, TUM_FR1)``, H x W the
    colour's decoded size, as :func:`write_tum_sequence` writes them; with
    ``png`` the colour is stored as the PNG of what each file reads back
    as.  Returns ``root``."""
    from lgu_slam_tpu_torch.data.image_io import imread

    order = list(range(len(colour))) if order is None else list(order)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    first = os.path.join(root, "rgb", "first." + colour[0][0])
    with open(first, "wb") as fh:
        fh.write(colour[0][1])
    H, W = imread(first).shape[:2]
    os.remove(first)
    _, depths, poses, _ = render_sequence(seed, len(colour), H, W, TUM_FR1,
                                          t_step=0.02, r_step=0.004)
    names = []
    for n, k in enumerate(order):
        t = f"{TUM_T0 + n / rate:.6f}"
        ext, data = colour[k]
        path = os.path.join(root, "rgb", f"{t}.{ext}")
        with open(path, "wb") as fh:
            fh.write(data)
        if png:
            img = imread(path)
            os.remove(path)
            ext = "png"
            write_frame(os.path.join(root, "rgb", t), img, "png")
        names.append(f"{t}.{ext}")
    _write_tum(root, names, [depths[k] for k in order],
               [poses[k] for k in order], rate)
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


def write_scannet_sequence(root, n_frames: int = 24, H: int = 480,
                           W: int = 640, seed: int = 0, **jpeg) -> str:
    """A ScanNet export under ``root`` at the 640 x 480 camera
    (``CameraParams`` "scannet_640"): ``color/<k>.jpg``, ``depth/<k>.png``
    (uint16 mm) and ``pose/<k>.txt`` (4 x 4 camera-to-world).  Returns
    ``root``."""
    images, depths, poses, _ = render_sequence(
        seed, n_frames, H, W, SCANNET_640, t_step=0.02, r_step=0.004)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    _write_jpegs([(os.path.join(root, "color", f"{k}.jpg"), images[k])
                  for k in range(n_frames)], **jpeg)
    _write_pngs([(os.path.join(root, "depth", f"{k}.png"),
                  np.clip(np.rint(depths[k] * 1000.0), 0, 65535)
                  .astype(np.uint16)) for k in range(n_frames)])
    for k in range(n_frames):
        np.savetxt(os.path.join(root, "pose", f"{k}.txt"),
                   _c2w_matrix(poses[k]))
    return root


def write_replica_scene(root, n_frames: int = 4, H: int = 680,
                        W: int = 1200, seed: int = 0, **jpeg) -> str:
    """A Replica scene directory ``root`` at Replica's camera:
    ``results/frame%06d.jpg``, ``results/depth%06d.png`` (uint16 in
    1/6553.5 m) and ``traj.txt`` (one row-major 4 x 4 camera-to-world per
    line).  Returns ``root``."""
    images, depths, poses, _ = render_sequence(
        seed, n_frames, H, W, REPLICA_CAM, t_step=0.02, r_step=0.004)
    res = os.path.join(root, "results")
    os.makedirs(res, exist_ok=True)
    _write_jpegs([(os.path.join(res, f"frame{k:06d}.jpg"), images[k])
                  for k in range(n_frames)], **jpeg)
    _write_pngs([(os.path.join(res, f"depth{k:06d}.png"),
                  np.clip(np.rint(depths[k] * 6553.5), 0, 65535)
                  .astype(np.uint16)) for k in range(n_frames)])
    np.savetxt(os.path.join(root, "traj.txt"),
               np.stack([_c2w_matrix(p).reshape(-1) for p in poses]))
    return root


def write_jpeg_imagedir(root, n_frames: int = 16, H: int = 480,
                        W: int = 640, seed: int = 0, **jpeg):
    """JPEG frames ``root/images/<k>.jpg`` along a random walk, and
    ``root/calib.txt`` (``fx fy cx cy``: the TUM fr1 camera scaled to
    ``W`` x ``H``): returns (image directory, calib path)."""
    s = np.asarray([W / 640, H / 480, W / 640, H / 480])
    cam = tuple(np.asarray(TUM_FR1) * s)
    images, _, _, _ = render_sequence(seed, n_frames, H, W, cam,
                                      t_step=0.02, r_step=0.004)
    imagedir = os.path.join(root, "images")
    os.makedirs(imagedir, exist_ok=True)
    _write_jpegs([(os.path.join(imagedir, f"{k:06d}.jpg"), images[k])
                  for k in range(n_frames)], **jpeg)
    calib = os.path.join(root, "calib.txt")
    with open(calib, "w") as fh:
        fh.write(" ".join(f"{v:.6f}" for v in cam) + "\n")
    return imagedir, calib
