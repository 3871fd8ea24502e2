"""Update operator: correlation/flow encoders + KAN-biased ConvGRU +
delta/weight heads + graph aggregation, and convex upsampling (port of
the JAX package's ``models/update.py``).  The ``eta``, ``delta`` and
``weight`` heads pass their gradient through :func:`grad_clip`, as there.

Shapes are edge-batched NHWC: net/inp [B, E, H, W, 128],
corr [B, E, H, W, 196], flow [B, E, H, W, 4].  Module and parameter names
follow the reference torch layout (``corr_encoder.0``, ``weight.2``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.models.clipping import grad_clip
from perfbench.reference.models.conv import Conv
from perfbench.reference.models.gru import KanBiasConvGRU

COR_PLANES = 4 * (2 * 3 + 1) ** 2  # 196


def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling.  data [B, H, W, D]; mask
    [B, H, W, 9*8*8] (softmax over the 9 taps).  Returns [B, 8H, 8W, D]."""
    b, h, w, d = data.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    pad = F.pad(data, (0, 0, 1, 1, 1, 1))
    patches = torch.stack(
        [pad[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)],
        dim=3,
    )  # [B, H, W, 9, D]
    up = torch.einsum("bhwkyx,bhwkd->bhwyxd", mask, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, d)


def upsample_disp(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """disp [B, H, W] + mask [B, H, W, 576] -> [B, 8H, 8W]."""
    return cvx_upsample(disp[..., None], mask)[..., 0]


class GraphAgg(nn.Module):
    """Edge-to-frame aggregation: a scatter-mean of the edge features over
    frame slots (the unique source frames, ``ii`` maps each edge to its
    slot), then per-frame damping ``eta`` and the upsampling mask."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = Conv(128, 128, 3, 1, 1, dtype)
        self.conv2 = Conv(128, 128, 3, 1, 1, dtype)
        self.eta = nn.Sequential(Conv(128, 1, 3, 1, 1, dtype))
        self.upmask = nn.Sequential(Conv(128, 8 * 8 * 9, 1, 1, 0, dtype))

    def forward(self, net, ii, num_frames: int):
        """net [B, E, H, W, 128]; ii [E] slot index in [0, num_frames).
        Returns (eta [B, F, H, W], upmask [B, F, H, W, 576], slot_mask [F]:
        the slots that have an edge)."""
        b, e, h, w, c = net.shape
        x = F.relu(self.conv1(net.reshape(b * e, h, w, c))).reshape(
            b, e, h, w, c)
        num = x.new_zeros(b, num_frames, h, w, c).index_add_(1, ii, x)
        den = x.new_zeros(num_frames).index_add_(0, ii, x.new_ones(e))
        slot_mask = den > 0
        x = num / torch.clamp(den, min=1.0)[None, :, None, None, None]

        x = F.relu(self.conv2(x.reshape(b * num_frames, h, w, c)))
        eta = F.softplus(grad_clip(self.eta(x).float()))
        upmask = self.upmask(x)
        return (
            0.01 * eta.reshape(b, num_frames, h, w),
            upmask.reshape(b, num_frames, h, w, 8 * 8 * 9).float(),
            slot_mask,
        )


class UpdateModule(nn.Module):
    """RAFT-SLAM update operator.  ``dtype`` is the conv compute dtype
    (bf16 on the tracking path); delta, weight, eta and upmask come back
    fp32 for the DBA."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        dt = dtype
        self.corr_encoder = nn.Sequential(
            Conv(COR_PLANES, 128, 1, 1, 0, dt), nn.ReLU(),
            Conv(128, 128, 3, 1, 1, dt), nn.ReLU())
        self.flow_encoder = nn.Sequential(
            Conv(4, 128, 7, 1, 3, dt), nn.ReLU(),
            Conv(128, 64, 3, 1, 1, dt), nn.ReLU())
        self.weight = nn.Sequential(
            Conv(128, 128, 3, 1, 1, dt), nn.ReLU(), Conv(128, 2, 3, 1, 1, dt))
        self.delta = nn.Sequential(
            Conv(128, 128, 3, 1, 1, dt), nn.ReLU(), Conv(128, 2, 3, 1, 1, dt))
        self.gru = KanBiasConvGRU(128, 128 + 128 + 64, dtype=dt)
        self.agg = GraphAgg(dtype=dt)

    def forward(self, net, inp, corr, flow=None, ii=None, num_frames=None):
        b, e, h, w, _ = net.shape
        if flow is None:
            flow = net.new_zeros(b, e, h, w, 4)

        def flat(x):
            return x.reshape((b * e, h, w) + x.shape[4:])

        cor = self.corr_encoder(flat(corr))
        flo = self.flow_encoder(flat(flow))
        h_new = self.gru(flat(net), flat(inp), cor, flo)

        delta = grad_clip(self.delta(h_new).float())
        weight = torch.sigmoid(grad_clip(self.weight(h_new).float()))

        net_out = h_new.reshape(b, e, h, w, 128)
        delta = delta.reshape(b, e, h, w, 2)
        weight = weight.reshape(b, e, h, w, 2)
        if ii is not None:
            eta, upmask, slot_mask = self.agg(net_out, ii, num_frames)
            return net_out, delta, weight, eta, upmask, slot_mask
        return net_out, delta, weight
