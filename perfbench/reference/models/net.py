"""LGUNet, a frozen plain copy of the port's ``models/net.py``:
feature/context encoders, Gaussian-uncertainty correlation with deformable
offset heads, the KAN-biased update operator, and the unrolled training
forward with a differentiable BA per step (:meth:`LGUNet.forward`).

Parameter names follow the original model's torch state dict (``fnet.*``,
``GA.*``, ``ofsMap``, ``update.gru.kanz_glo.*``, ...), so one state dict
loads into the port and into this reference alike.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from perfbench.reference.geom import projective as pops
from perfbench.reference.geom.ba import ba
from perfbench.reference.geom.losses import safe_norm
from perfbench.reference.models.conv import Conv
from perfbench.reference.models.corr import (
    CorrPyramid,
    alt_corr_lookup,
    build_corr_pyramid,
    corr_lookup,
)
from perfbench.reference.models.extractor import BasicEncoder
from perfbench.reference.models.gaussian_mask import GaussianMask
from perfbench.reference.models.update import UpdateModule, upsample_disp
from perfbench.reference.config import SLAMConfig
from perfbench.reference.precision import as_dtype

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
    """All learned components behind one module, on ``device``.  The
    correlation levels are rounded to ``volume_dtype``, the convolutions'
    operands and results to ``compute_dtype`` (None: float32)."""

    def __init__(self, volume_dtype=torch.float32, compute_dtype=None,
                 device="cpu"):
        super().__init__()
        self.volume_dtype = as_dtype(volume_dtype)
        compute_dtype = as_dtype(compute_dtype)
        self.fnet = BasicEncoder(128, "instance", dtype=compute_dtype)
        self.cnet = BasicEncoder(256, "none", dtype=compute_dtype)
        self.GA = GaussianMask()
        self.ofsMap = Conv(256, 98, 3, 1, 1)
        self.ofs_residual = Conv(256, 98, 3, 1, 1)
        self.update = UpdateModule(dtype=compute_dtype)
        self.to(device)

    @classmethod
    def from_config(cls, cfg: SLAMConfig, device="cpu") -> "LGUNet":
        return cls(volume_dtype=cfg.volume_dtype,
                   compute_dtype=cfg.compute_dtype, device=device)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised images [B, H, W, 3] -> fmaps [B, H/8, W/8, 128]."""
        return self.fnet(images)

    def context(self, images: torch.Tensor):
        """-> (net [..., 128] tanh, inp [..., 128] relu)."""
        x = self.cnet(images)
        net, inp = x.split(128, dim=-1)
        return torch.tanh(net), torch.relu(inp)

    def build_corr(self, fmap1, fmap2, differentiable: bool = False,
                   operand_dtype=None) -> CorrPyramid:
        """fmap1/2 [E, H, W, 128] -> the edges' correlation pyramid (with
        ``differentiable``, float32 for the training forward).
        ``operand_dtype`` is accepted for the port's signature: the
        operands' values are taken as they are."""
        return build_corr_pyramid(self.GA.predict, self.ofsMap,
                                  self.ofs_residual, fmap1, fmap2,
                                  volume_dtype=self.volume_dtype,
                                  differentiable=differentiable)

    def lookup(self, pyr: CorrPyramid, coords: torch.Tensor,
               differentiable: bool = False) -> torch.Tensor:
        return corr_lookup(pyr, coords)

    def alt_corr(self, fmap_pyr, ii, jj, coords) -> torch.Tensor:
        """Backend correlation on the fly from the pooled feature pyramid
        (no new parameters: the offset heads are shared)."""
        return alt_corr_lookup(fmap_pyr, ii, jj, coords, self.ofsMap,
                               self.ofs_residual)

    def update_step(self, net, inp, corr, flow=None, ii=None,
                    num_frames=None):
        return self.update(net, inp, corr, flow, ii, num_frames)

    def forward(self, Gs, images, disps, intrinsics, ii, jj,
                num_steps: int = 12, fixedp: int = 2):
        """Unrolled training forward.  Gs [B, N, 7] poses, images
        [B, N, H, W, 3] raw BGR, disps [B, N, H/8, W/8], intrinsics
        [B, N, 4] at 1/8 scale, ii/jj [E] edge lists (long tensors on the
        module's device).  Every step looks up the differentiable pyramid,
        runs the update operator with GraphAgg over the N frames, and two
        BA steps with ``fixedp`` poses fixed; the state entering a step is
        detached.  Returns (poses per step [B, N, 7], upsampled disparities
        per step [B, N, H, W], masked residuals per step [B, E, H/8, W/8, 2],
        the Gaussian NLL summed over the last five steps)."""
        B, N = images.shape[:2]
        E = ii.shape[0]
        imgs = normalize_images(images).reshape((B * N,) + images.shape[2:])
        fmaps = self.features(imgs)
        net_c, inp_c = self.context(imgs)
        h8, w8 = fmaps.shape[1:3]
        fmaps = fmaps.reshape(B, N, h8, w8, 128)
        net = net_c.reshape(B, N, h8, w8, 128)[:, ii]
        inp = inp_c.reshape(B, N, h8, w8, 128)[:, ii]

        # per-edge pyramid, the batch folded into the edge axis
        pyr = self.build_corr(fmaps[:, ii].reshape(B * E, h8, w8, 128),
                              fmaps[:, jj].reshape(B * E, h8, w8, 128),
                              differentiable=True)
        mean_n = pyr.mean.reshape(B, E, h8, w8, 2)
        theta = pyr.theta.reshape(B, E, h8, w8)
        coords0 = pops.coords_grid(h8, w8, device=images.device)

        def reproject(Gs, disps):
            return pops.projective_transform_batch(Gs, disps, intrinsics, ii,
                                                   jj)

        coords1, _ = reproject(Gs, disps)
        target = coords1
        poses_out, disps_out, resid_out, nll = [], [], [], []
        for step in range(num_steps):
            Gs, disps = Gs.detach(), disps.detach()
            coords1, target = coords1.detach(), target.detach()

            resd = target - coords1
            flow = coords1 - coords0
            corr = self.lookup(pyr, coords1.reshape(B * E, h8, w8, 2),
                               differentiable=True).reshape(B, E, h8, w8, -1)
            motion = torch.clamp(torch.cat([flow, resd], dim=-1), -64.0, 64.0)
            net, delta, weight, eta, upmask, _ = self.update_step(
                net, inp, corr, motion, ii, N)

            target = coords1 + delta
            for _ in range(2):
                Gs, disps = ba(target, weight, eta, Gs, disps, intrinsics,
                               ii, jj, fixedp=fixedp)
            coords1, valid = reproject(Gs, disps)
            residual = target - coords1

            if step > num_steps - 6:  # the Gaussian-NLL auxiliary loss
                cn = safe_norm(coords1 * valid)
                mn = safe_norm(mean_n * valid)
                t = torch.clamp(theta, min=1e-6)
                nll.append(torch.mean(torch.abs(cn - mn) / (2 * t)
                                      + torch.log(torch.sqrt(t))))
            poses_out.append(Gs)
            disps_out.append(upsample_disp(
                disps.reshape(B * N, h8, w8),
                upmask.reshape(B * N, h8, w8, -1)).reshape(B, N, 8 * h8,
                                                           8 * w8))
            resid_out.append(valid * residual)

        loss = sum(nll) if nll else torch.zeros((), device=images.device)
        return poses_out, disps_out, resid_out, loss
