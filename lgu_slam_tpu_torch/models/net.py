"""LGUNet, inference surface (port of the JAX package's ``models/net.py``):
feature/context encoders, Gaussian-uncertainty correlation with deformable
offset heads, and the KAN-biased update operator.  The unrolled training
forward comes with the training slice.

Parameter names follow the reference torch state dict (``fnet.*``,
``GA.*``, ``ofsMap``, ``update.gru.kanz_glo.*``, ...), the layout that
the JAX package's ``utils/checkpoint.py`` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from lgu_slam_tpu_torch.models.conv import Conv
from lgu_slam_tpu_torch.models.corr import (
    CorrPyramid,
    alt_corr_lookup,
    build_corr_pyramid,
    corr_lookup,
)
from lgu_slam_tpu_torch.models.extractor import BasicEncoder
from lgu_slam_tpu_torch.models.gaussian_mask import GaussianMask
from lgu_slam_tpu_torch.models.kan import KANLinear
from lgu_slam_tpu_torch.models.update import UpdateModule
from lgu_slam_tpu_torch.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.device import resolve_device

# BGR input, ImageNet statistics
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """images [..., H, W, 3] BGR uint8/float -> normalised RGB float."""
    rgb = images.flip(-1).float() / 255.0
    mean = torch.tensor(_MEAN, device=images.device)
    std = torch.tensor(_STD, device=images.device)
    return (rgb - mean) / std


class LGUNet(nn.Module):
    """All learned components of the inference path behind one module, on
    ``device`` (CUDA when None; raises when CUDA is absent).
    ``alt_sub_chunk`` is the edge sub-chunk of the backend's chunked-volume
    correlation (per-sub-chunk transient = alt_sub_chunk * P1 * P2 bf16)."""

    def __init__(self, volume_dtype=torch.float32, compute_dtype=None,
                 device=None, alt_sub_chunk: int = 8):
        super().__init__()
        self.volume_dtype = volume_dtype
        self.alt_sub_chunk = alt_sub_chunk
        self.fnet = BasicEncoder(128, "instance", dtype=compute_dtype)
        self.cnet = BasicEncoder(256, "none", dtype=compute_dtype)
        self.GA = GaussianMask()
        self.ofsMap = Conv(256, 98, 3, 1, 1)
        self.ofs_residual = Conv(256, 98, 3, 1, 1)
        self.update = UpdateModule(dtype=compute_dtype)
        self.to(resolve_device(device))

    @classmethod
    def from_config(cls, cfg: SLAMConfig, device=None) -> "LGUNet":
        return cls(volume_dtype=getattr(torch, cfg.volume_dtype),
                   compute_dtype=getattr(torch, cfg.compute_dtype),
                   device=device, alt_sub_chunk=cfg.backend_sub_chunk)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised images [B, H, W, 3] -> fmaps [B, H/8, W/8, 128]."""
        return self.fnet(images)

    def context(self, images: torch.Tensor):
        """-> (net [..., 128] tanh, inp [..., 128] relu)."""
        x = self.cnet(images)
        net, inp = x.split(128, dim=-1)
        return torch.tanh(net), torch.relu(inp)

    def build_corr(self, fmap1, fmap2) -> CorrPyramid:
        """fmap1/2 [E, H, W, 128] -> the edges' correlation pyramid."""
        return build_corr_pyramid(self.GA.predict, self.ofsMap,
                                  self.ofs_residual, fmap1, fmap2,
                                  volume_dtype=self.volume_dtype)

    def lookup(self, pyr: CorrPyramid, coords: torch.Tensor) -> torch.Tensor:
        return corr_lookup(pyr, coords)

    def alt_corr(self, fmap_pyr, ii, jj, coords) -> torch.Tensor:
        """Backend correlation on the fly from the pooled feature pyramid
        (no new parameters: the offset heads are shared)."""
        return alt_corr_lookup(fmap_pyr, ii, jj, coords, self.ofsMap,
                               self.ofs_residual,
                               sub_chunk=self.alt_sub_chunk)

    def update_step(self, net, inp, corr, flow=None, ii=None,
                    num_frames=None):
        return self.update(net, inp, corr, flow, ii, num_frames)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    # lecun-normal as in the JAX package: a normal truncated at +-2 sd and
    # rescaled to variance 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def init_state_dict(cfg: SLAMConfig, seed: int = 0) -> dict:
    """Random LGUNet weights from a ``torch.Generator`` seeded with
    ``seed``, initialised as the JAX package initialises its LGUNet:
    lecun-normal kernels and zero biases, zero ``ofsMap``/``ofs_residual``/
    ``GA.meanMap`` kernels, KAN spline weights ~ N(0, 0.02).  Returns a CPU
    state dict."""
    gen = torch.Generator().manual_seed(seed)
    net = LGUNet.from_config(cfg, device="cpu")
    zero = (net.ofsMap, net.ofs_residual, net.GA.meanMap)
    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            if mod in zero:
                nn.init.zeros_(mod.weight)
            else:
                _lecun_normal_(mod.weight, fan_in, gen)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, KANLinear):
            fan_in = mod.base_weight.shape[1]
            _lecun_normal_(mod.base_weight, fan_in, gen)
            _lecun_normal_(mod.spline_scaler, fan_in, gen)
            with torch.no_grad():
                mod.spline_weight.normal_(0.0, 0.02, generator=gen)
    return net.state_dict()
