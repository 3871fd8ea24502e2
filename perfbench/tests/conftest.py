"""Tiny cells for the benchmark's CPU tests: the committed cells at sizes a
test run holds (64 x 96 frames, short loops, few iterations), run on the
CPU with the kernels' plain versions."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 11  # above 32 signed bits, as a run's --seed may be

F32 = dict(volume_dtype="float32", feat_dtype="float32",
           compute_dtype="float32", backend_hidden_dtype="float32")
SLAM = dict(image_size=[64, 96], buffer=24, warmup=5, frontend_window=8,
            frontend_iters1=2, frontend_iters2=1, max_factors=24,
            edge_bucket=32, inactive_bucket=32, backend_edge_cap=256,
            backend_chunk=32)
SCALES = {
    "eth3d_rgbd.track": {
        "config": {"slam": SLAM},
        "traffic": {"setup_frames": 7, "sample_span": 4, "encode_window": 12,
                    "trace_calls": 2, "planes": 3},
        "limits": {"sampled_calls": 2}},
    "eth3d_rgbd.global_ba": {
        "config": {"slam": SLAM},
        "traffic": {"loop": {"frames": 8, "laps": 2}, "planes": 3},
        "limits": {"sampled_keyframes": 3}},
    "train_384x512.step": {
        "config": {"train": {"image_size": [64, 96], "iters": 2,
                             "n_frames": 3}},
        "traffic": {"planes": 3, "pool": 4, "trace_calls": 1}},
}


def tiny(cell: str, fp32: bool = False) -> dict:
    """The overrides that make ``cell`` tiny; ``fp32`` also runs the
    program in float32, where it has to agree with the reference to
    rounding."""
    scale = copy.deepcopy(SCALES[cell])
    if fp32 and "slam" in scale["config"]:
        scale["config"]["slam"].update(F32)
    return scale


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda_device():
    """The card, for the tests that need one; skips without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
