"""K1's operands at its call sites under a bf16 configuration.

``FactorGraph._build_pyramid`` hands K1 the bf16 keyframe store as it is,
and ``MotionFilter._flow_probe`` narrows the bf16 encoder's output to bf16;
both must compute what fp32 operands widened from the same values compute,
exactly (the narrowing is lossless, and the plain version widens).  The
recorded operand dtypes show which kernel the card would launch.
"""

import pytest
import torch
from torch_port import tiny_config_kwargs, torch_single_thread  # noqa: F401

from lgu_slam_tpu_torch.models import corr as tcorr_model
from lgu_slam_tpu_torch.models.net import init_state_dict
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.synthetic import shifted_texture_frames


@pytest.fixture(scope="module")
def bf16_slam():
    """A tiny bf16 system (64 x 96; features, convolutions and volumes in
    bf16) on the CPU after 7 frames: initialised, with frontend edges."""
    cfg = SLAMConfig(**dict(tiny_config_kwargs(), volume_dtype="bfloat16",
                            feat_dtype="bfloat16",
                            compute_dtype="bfloat16"))
    slam = LGUSlam(init_state_dict(cfg, 0), cfg, device="cpu")
    for t, img, intr in shifted_texture_frames(7, 64, 96, 3):
        slam.track(float(t), img, intrinsics=intr)
    assert slam.frontend.is_initialized and slam.frontend.graph.n_edges > 0
    return slam


@pytest.fixture
def k1_operands(monkeypatch):
    """Records the operand dtypes of every K1 call of the volume path."""
    seen = []
    k1 = tcorr_model.masked_corr_level0

    def recording(f1, f2, *a, **kw):
        seen.append((f1.dtype, f2.dtype))
        return k1(f1, f2, *a, **kw)

    monkeypatch.setattr(tcorr_model, "masked_corr_level0", recording)
    return seen


def test_build_pyramid_passes_the_bf16_store(bf16_slam, k1_operands):
    g = bf16_slam.frontend.graph
    fmaps = g.video.fmaps
    assert fmaps.dtype == torch.bfloat16
    g._build_pyramid()
    assert k1_operands == [(torch.bfloat16, torch.bfloat16)]
    ii, jj = g._index(g.ii), g._index(g.jj)
    widened = g.net.build_corr(fmaps[ii, 0].float(), fmaps[jj, 0].float())
    assert k1_operands[-1] == (torch.float32, torch.float32)
    for new, old in zip(g.pyramid.levels, widened.levels):
        assert new.dtype == torch.bfloat16 and torch.equal(new, old)
    for new, old in zip(g.pyramid.offsets, widened.offsets):
        assert torch.equal(new, old)


def test_flow_probe_narrows_the_bf16_encoder_output(bf16_slam, k1_operands):
    f = bf16_slam.filter
    assert f.corr_dtype == torch.bfloat16
    _, img, _ = next(iter(shifted_texture_frames(9, 64, 96, 3)))
    gmap = f._encode(torch.as_tensor(img))
    # the encoder computes in bf16: its fp32 output holds bf16 values
    assert gmap.dtype == torch.float32
    assert torch.equal(gmap.to(torch.bfloat16).float(), gmap)
    new = f._flow_probe(gmap)
    f.corr_dtype = torch.float32
    try:
        old = f._flow_probe(gmap)
    finally:
        f.corr_dtype = torch.bfloat16
    assert k1_operands == [(torch.bfloat16, torch.bfloat16),
                           (torch.float32, torch.float32)]
    assert torch.isfinite(new) and torch.equal(new, old)


def test_fp32_configuration_keeps_fp32_operands():
    """With fp32 features and convolutions both call sites pass fp32."""
    cfg = SLAMConfig(**tiny_config_kwargs())
    slam = LGUSlam(init_state_dict(cfg, 0), cfg, device="cpu")
    assert slam.filter.corr_dtype == torch.float32
    assert slam.video.fmaps.dtype == torch.float32
