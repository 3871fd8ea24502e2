"""Per-dataset 3DGS mapping presets (port of the JAX package's
``gs/configs.py``: the same presets and numbers).

Reference parity: to3DGS/configs/{replica,replica_v2,tum,scannet,
scannetpp,iphone}/splatam.py — the reference ships one ~140-line Python
config dict per dataset, loaded via SourceFileLoader (executeSlam.py:
726-729).  Here the shared knobs live in the typed ``GSConfig``
(``gs/mapping.py``) and each preset is just the per-dataset deltas, plus
the dataset plumbing (loader name, desired render size, scene lists) the
reference keeps in its ``data=dict(...)`` blocks and configs/data/*.yaml.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from lgu_slam_tpu_torch.gs.mapping import GSConfig


@dataclass
class GSPreset:
    """A GSConfig plus the dataset plumbing the mapping loop needs."""

    name: str
    gs: GSConfig
    dataset: str  # key for data.rgbd_datasets.load_rgbd_dataset
    desired_size: tuple  # (H, W) render/eval resolution
    scenes: tuple = ()
    # reference also runs a camera-refinement ("tracking") phase per frame;
    # iters recorded for parity even though SLAM poses are normally used
    tracking_iters: int = 40
    scene_radius_depth_ratio: float = 3.0


def _mk(name, dataset, desired_size, scenes, *, mapping_window_size,
        mapping_iters, tracking_iters, keyframe_every=5, map_every=1,
        lr_scales=0.001, scene_radius_depth_ratio=3.0):
    gs = GSConfig(
        map_every=map_every,
        keyframe_every=keyframe_every,
        mapping_window_size=mapping_window_size,
        mapping_iters=mapping_iters,
        lr_scales=lr_scales,
        # reference mapping loss: im 0.5 (L1+SSIM inside), depth 1.0
        loss_depth=1.0,
    )
    return GSPreset(
        name=name, gs=gs, dataset=dataset, desired_size=desired_size,
        scenes=tuple(scenes), tracking_iters=tracking_iters,
        scene_radius_depth_ratio=scene_radius_depth_ratio,
    )


REPLICA_SCENES = ("room0", "room1", "room2",
                  "office0", "office1", "office2", "office3", "office4")

TUM_SCENES = ("freiburg1_desk", "freiburg1_desk2", "freiburg1_room",
              "freiburg2_xyz", "freiburg3_long_office_household")

SCANNET_SCENES = ("scene0000_00", "scene0059_00", "scene0106_00",
                  "scene0169_00", "scene0181_00", "scene0207_00")


# configs/replica/splatam.py:12-16 — window 24, 60 mapping / 40 tracking
REPLICA = _mk("replica", "replica", (340, 600), REPLICA_SCENES,
              mapping_window_size=24, mapping_iters=60, tracking_iters=40)

# configs/replica_v2/splatam.py:18-22 — identical schedule, mm depth
REPLICA_V2 = _mk("replica_v2", "replica", (340, 600), REPLICA_SCENES,
                 mapping_window_size=24, mapping_iters=60, tracking_iters=40)

# configs/tum/splatam.py:11-16 — window 20, 30 mapping / 200 tracking,
# scene_radius ratio 2
TUM = _mk("tum", "tum", (480, 640), TUM_SCENES,
          mapping_window_size=20, mapping_iters=30, tracking_iters=200,
          scene_radius_depth_ratio=2.0)

# configs/scannet/splatam.py:12-17 — window 10, 30 mapping / 100 tracking
SCANNET = _mk("scannet", "scannet", (480, 640), SCANNET_SCENES,
              mapping_window_size=10, mapping_iters=30, tracking_iters=100)

# configs/scannetpp/splatam.py:27-31 — window 24, 60 mapping / 200 tracking
SCANNETPP = _mk("scannetpp", "scannetpp", (584, 876), (),
                mapping_window_size=24, mapping_iters=60,
                tracking_iters=200)

# configs/iphone/splatam.py:18-25 — window 32, 60/60
IPHONE = _mk("iphone", "nerfcapture", (480, 640), (),
             mapping_window_size=32, mapping_iters=60, tracking_iters=60)


PRESETS = {p.name: p for p in
           (REPLICA, REPLICA_V2, TUM, SCANNET, SCANNETPP, IPHONE)}


def get_preset(name: str, **overrides) -> GSPreset:
    """Fetch a preset; keyword overrides patch the inner GSConfig."""
    preset = PRESETS[name.lower()]
    if overrides:
        preset = replace(preset, gs=replace(preset.gs, **overrides))
    return preset
