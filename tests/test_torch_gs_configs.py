"""The port's GS presets (lgu_slam_tpu_torch/gs/configs.py): the JAX
package's tests/test_gs_configs.py run against the port, and every preset
field by field against the JAX package's."""

import dataclasses

import pytest

from lgu_slam_tpu.gs import configs as jconfigs
from lgu_slam_tpu_torch.gs.configs import PRESETS, get_preset
from lgu_slam_tpu_torch.gs.mapping import GSConfig


def test_preset_numbers_match_reference():
    # configs/replica/splatam.py:12-16
    r = PRESETS["replica"]
    assert (r.gs.mapping_window_size, r.gs.mapping_iters,
            r.tracking_iters) == (24, 60, 40)
    # configs/tum/splatam.py:11-16 (+ scene_radius ratio 2)
    t = PRESETS["tum"]
    assert (t.gs.mapping_window_size, t.gs.mapping_iters,
            t.tracking_iters) == (20, 30, 200)
    assert t.scene_radius_depth_ratio == 2.0
    # configs/scannet/splatam.py:12-17
    s = PRESETS["scannet"]
    assert (s.gs.mapping_window_size, s.gs.mapping_iters,
            s.tracking_iters) == (10, 30, 100)
    # configs/scannetpp/splatam.py:27-31
    spp = PRESETS["scannetpp"]
    assert (spp.gs.mapping_window_size, spp.gs.mapping_iters,
            spp.tracking_iters) == (24, 60, 200)
    # configs/iphone/splatam.py:18-25
    ip = PRESETS["iphone"]
    assert (ip.gs.mapping_window_size, ip.gs.mapping_iters) == (32, 60)
    # all presets share map_every=1, keyframe_every=5
    for p in PRESETS.values():
        assert p.gs.map_every == 1 and p.gs.keyframe_every == 5


def test_get_preset_overrides():
    p = get_preset("replica", mapping_iters=5)
    assert p.gs.mapping_iters == 5
    assert PRESETS["replica"].gs.mapping_iters == 60  # original untouched
    assert p.dataset == "replica"
    assert "room0" in p.scenes


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        get_preset("kitti")


def test_presets_equal_jax_presets():
    """The same preset names, and every field of every preset (its
    GSConfig included) equal to the JAX package's."""
    assert list(PRESETS) == list(jconfigs.PRESETS)
    assert dataclasses.asdict(GSConfig()) == \
        dataclasses.asdict(jconfigs.GSConfig())
    for name, preset in PRESETS.items():
        assert isinstance(preset.gs, GSConfig)
        assert dataclasses.asdict(preset) == \
            dataclasses.asdict(jconfigs.PRESETS[name]), name
