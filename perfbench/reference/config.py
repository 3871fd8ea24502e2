"""Structured configuration for the SLAM system and training.

The PyTorch port's own copy of the JAX package's ``utils/config.py`` (the port
imports nothing of the JAX package): field names, defaults and presets are
identical, so one config value means the same thing in both packages.  The
port pads nothing to the TPU-only shape buckets (``pose_bucket``,
``frame_bucket``, ``frame_degree_bucket``, ``add_chunk``); ``edge_bucket``
and ``inactive_bucket`` stay capacity limits because they decide which edges
exist, and ``frame_bucket`` decides whether frame 0's damping is written
(``FactorGraph.update_n``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class SLAMConfig:
    # image geometry
    image_size: tuple = (384, 512)  # (H, W); must be multiples of 8
    buffer: int = 512  # keyframe capacity (demo.py:84)
    stereo: bool = False
    upsample: bool = False

    # motion filter (motion_filter.py:15; demo.py:89)
    filter_thresh: float = 2.4

    # frontend (droid_frontend.py:22-33; demo.py:88-96)
    warmup: int = 12
    beta: float = 0.3
    keyframe_thresh: float = 3.5
    frontend_thresh: float = 16.0
    frontend_window: int = 20
    frontend_radius: int = 1
    frontend_nms: int = 1
    max_age: int = 25
    frontend_iters1: int = 8
    frontend_iters2: int = 8
    max_factors: int = 48  # droid_frontend.py:13

    # backend (demo.py:97-99)
    backend_thresh: float = 22.0
    backend_radius: int = 2
    backend_nms: int = 3

    # static shape buckets (TPU: jit once per bucket)
    edge_bucket: int = 64  # active-edge slots in the frontend graph
    inactive_bucket: int = 128  # stored inactive-edge slots
    pose_bucket: int = 40  # frontend BA window bucket
    frame_bucket: int = 48  # active-frame slots for GraphAgg/upsample
    frame_degree_bucket: int = 32  # initial rows-per-frame plan padding
    # global-BA edge budget: 16*t at the reference's buffer=512 scale
    # (droid_backend.py:34); Backend warns when 16*t exceeds it
    backend_edge_cap: int = 8192
    backend_chunk: int = 128  # low-memory update edge chunk
    backend_sub_chunk: int = 8  # volume-corr edge sub-chunk (TPU alt path)
    add_chunk: int = 32  # new-edge batch granularity

    # DBA
    dba_iters: int = 2
    dba_lm: float = 1e-4
    dba_ep: float = 0.1
    # reproduce ba_cuda's back-substitution guard that skips pose t0
    # (droid_kernels.cu:1105-1106) — flip for checkpoint-parity ATE runs
    # (geom/dba.py strict_t0_quirk); off by default: including t0 keeps
    # the depth back-substitution consistent with the pose solve
    strict_t0_quirk: bool = False

    # precision
    volume_dtype: str = "bfloat16"  # corr pyramid storage
    feat_dtype: str = "bfloat16"  # cached fmaps/nets/inps in the video
    compute_dtype: str = "bfloat16"  # update-operator conv compute dtype
    # backend (alt-impl) per-edge GRU hidden storage: bf16 keeps the
    # 16*t-edge global graph inside one chip's HBM (8192 edges x 48x64
    # x 128ch = 6.4 GB vs 12.9 fp32); the reference stores inference
    # state under fp16 autocast (motion_filter.py autocast / droid.py)
    backend_hidden_dtype: str = "bfloat16"

    @property
    def ht8(self):
        return self.image_size[0] // 8

    @property
    def wd8(self):
        return self.image_size[1] // 8

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class TrainConfig:
    """Training schedule (train.py:202-217)."""

    batch: int = 2
    iters: int = 9
    steps: int = 250_000
    lr: float = 1.3e-4
    clip: float = 2.5
    n_frames: int = 4
    w1: float = 10.0  # geodesic
    w2: float = 0.01  # residual
    w3: float = 0.05  # flow
    w_coord: float = 0.08  # Gaussian NLL
    fmin: float = 8.0
    fmax: float = 96.0
    edges: int = 24
    restart_prob: float = 0.2
    weight_decay: float = 1e-5
    pct_start: float = 0.01  # OneCycle warmup fraction
    ckpt_every: int = 1000
    image_size: tuple = (384, 512)


# Benchmark presets (reference eval scripts)
TUM_CONFIG = SLAMConfig(
    buffer=512, filter_thresh=2.25, warmup=12, keyframe_thresh=2.25,
    frontend_thresh=12.0, frontend_window=25, frontend_radius=2,
    frontend_nms=1, backend_thresh=15.0, backend_radius=2, backend_nms=3,
    image_size=(240, 320),
)  # evaluation_scripts/test_tum.py:62-73

EUROC_CONFIG = SLAMConfig(
    buffer=512, filter_thresh=2.4, warmup=15, keyframe_thresh=3.5,
    frontend_thresh=17.5, frontend_window=20, frontend_radius=2,
    frontend_nms=2, backend_thresh=24.0, backend_radius=2, backend_nms=2,
    stereo=True, image_size=(320, 512),
)  # evaluation_scripts/test_euroc.py

ETH3D_CONFIG = SLAMConfig(
    buffer=1024, filter_thresh=2.0, warmup=8, keyframe_thresh=3.5,
    frontend_thresh=16.0, frontend_window=20, frontend_radius=2,
    frontend_nms=1, backend_thresh=22.0, backend_radius=2, backend_nms=3,
)  # evaluation_scripts/test_eth3d.py

TARTANAIR_CONFIG = SLAMConfig(
    buffer=1000, filter_thresh=1.75, warmup=12, keyframe_thresh=3.0,
    frontend_thresh=15.0, frontend_window=20, frontend_radius=1,
    frontend_nms=1, backend_thresh=20.0, backend_radius=2, backend_nms=3,
    image_size=(384, 512),
)  # evaluation_scripts/validate_tartanair.py
