"""Shared pieces of the PyTorch port's tests (test_torch_*.py).

Inputs are made with numpy from a seeded generator and handed to both
packages; weights cross from the JAX parameter tree through the port's
weight bridge.  JAX stays on the CPU (tests/conftest.py).  This module
imports no JAX, so the card-only tests can use it where JAX is absent.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """One intra-op thread per xdist worker: the suite runs 6 workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def t(a, dtype=None):
    """numpy/JAX array -> CPU torch tensor (a copy)."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def video_from_jax(jv, cfg, tv=None):
    """A port Video on the CPU (``tv``, else a new one) holding the buffers
    and the counter of the JAX package's Video ``jv`` (read as numpy)."""
    from lgu_slam_tpu_torch.slam.state import Video

    tv = Video(cfg, "cpu") if tv is None else tv
    for name in Video._FIELDS:
        a = np.asarray(getattr(jv.state, name)).astype(np.float32)
        getattr(tv, name).copy_(torch.from_numpy(a))
    tv.counter = jv.counter
    return tv


def close(actual, desired, atol, rtol=0.0, msg=""):
    """Compare a torch tensor with a JAX/numpy array."""
    a = actual.detach().cpu().float().numpy() \
        if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(a, np.asarray(desired, dtype=a.dtype),
                               atol=atol, rtol=rtol, err_msg=msg)


def tiny_config_kwargs():
    """The tiny configuration of tests/test_slam_e2e.py with fp32 dtypes,
    as keyword arguments that both packages' SLAMConfig take."""
    return dict(
        image_size=(64, 96), buffer=24, warmup=5, filter_thresh=0.0,
        keyframe_thresh=0.0, frontend_window=8, frontend_iters1=2,
        frontend_iters2=1, max_factors=24, edge_bucket=32,
        inactive_bucket=32, pose_bucket=24, backend_edge_cap=64,
        backend_chunk=32, volume_dtype="float32", feat_dtype="float32",
        compute_dtype="float32",
    )


def read_ply_points(path):
    """Vertices (and colours) of a binary PLY written by ``write_ply``."""
    raw = open(path, "rb").read()
    head, body = raw.split(b"end_header\n", 1)
    n = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    dt = [("xyz", "<f4", 3), ("rgb", "u1", 3)] if b"red" in head \
        else [("xyz", "<f4", 3)]
    rec = np.frombuffer(body, dtype=dt, count=n)
    return rec["xyz"], (rec["rgb"] if b"red" in head else None)


def same_as_cv2(path, modes=(False, True)):
    """The port's ``imread(path, anydepth=m)`` equals ``cv2.imread`` (with
    ``IMREAD_ANYDEPTH`` where ``m``) for each ``m`` of ``modes``, in dtype,
    shape and bytes (NaN payloads included), or both refuse: ValueError
    where cv2 returns None or raises."""
    import cv2

    from lgu_slam_tpu_torch.data import image_io

    for anydepth in modes:
        try:
            ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                             else cv2.IMREAD_COLOR)
        except cv2.error:
            ref = None
        if ref is None:
            with pytest.raises(ValueError):
                image_io.imread(str(path), anydepth=anydepth)
            continue
        got = image_io.imread(str(path), anydepth=anydepth)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


def damaged_same_as_cv2(data: bytes, tmp_path, mutations: int = 200,
                        seed: int = 0, name: str = "damaged.img"):
    """:func:`same_as_cv2` on every proper prefix of ``data`` and on
    ``mutations`` copies with 1-3 seeded bytes replaced or bit-flipped."""
    path = tmp_path / name
    rng = np.random.default_rng(seed)
    cases = [data[:k] for k in range(1, len(data))]
    for _ in range(mutations):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(d)))
            d[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else \
                d[i] ^ (1 << int(rng.integers(0, 8)))
        cases.append(bytes(d))
    for case in cases:
        path.write_bytes(case)
        same_as_cv2(path)


# TIFF files that cv2.imread returns None for in both read modes, one of
# each refusal that the port's decoder decides where it parses the file
C2_KINDS = ("predictor_4", "predictor_3_16bit", "mixed_depths",
            "ycbcr_green_0", "short_strip_cut", "jpeg_separate_ycbcr")


def c2_tiff(kind: str, img: np.ndarray) -> bytes:
    """A TIFF of ``img`` (``uint8 [H, W, 3]`` BGR, at least 16 rows) of the
    refused ``kind`` of :data:`C2_KINDS`: a predictor other than 1-3, the
    floating-point predictor of 16-bit integers, BitsPerSample (8, 8, 16),
    YCbCr of a green coefficient 0, one uncompressed strip of 5/8 of its
    bytes that the file cannot fill, JPEG of separate YCbCr planes."""
    from lgu_slam_tpu_torch.data import tiff

    gray = np.ascontiguousarray(img[..., 1])
    if kind == "predictor_4":
        return tiff.encode_tiff(gray, "lzw", tags={317: (3, [4])})
    if kind == "predictor_3_16bit":
        return tiff.encode_tiff(gray.astype(np.uint16) * 257, "lzw",
                                tags={317: (3, [3])})
    if kind == "mixed_depths":
        return tiff.encode_tiff(img, tags={258: (3, [8, 8, 16])})
    if kind == "ycbcr_green_0":
        return tiff.encode_tiff(img, photometric=6, subsampling=(1, 1),
                                tags={529: (5, (0.299, 0, 0.114))})
    if kind == "short_strip_cut":
        raw = np.ascontiguousarray(img[..., ::-1]).tobytes()
        return tiff.encode_tiff(img, chunks=[raw[:len(raw) * 5 // 8]])
    if kind == "jpeg_separate_ycbcr":
        return tiff.encode_tiff(img, "jpeg", planar=2, photometric=6,
                                rows_per_strip=16)
    raise KeyError(kind)
