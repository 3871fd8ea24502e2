"""ConvGRU update cells (port of the JAX package's ``models/gru.py``).

- :class:`KanBiasConvGRU`: the ConvGRU whose z/r/q gates get a per-channel
  global bias from KAN layers over a gated global pooling (the update
  operator's cell).
- :class:`ConvGRU`: the vanilla DROID ConvGRU with 1x1-conv global biases
  over the spatial mean.

NHWC; hidden state 128 channels."""

from __future__ import annotations

import torch
import torch.nn as nn

from lgu_slam_tpu_torch.models.conv import Conv
from lgu_slam_tpu_torch.models.kan import KANLinear


class KanBiasConvGRU(nn.Module):
    def __init__(self, h_planes: int = 128, i_planes: int = 320,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c = h_planes
        self.convz = Conv(c + i_planes, c, 3, 1, 1, dtype)
        self.convr = Conv(c + i_planes, c, 3, 1, 1, dtype)
        self.convq = Conv(c + i_planes, c, 3, 1, 1, dtype)
        self.w = Conv(c, c, 1, 1, 0, dtype)
        self.kanz_glo = KANLinear(c, c, grid_size=3)
        self.kanr_glo = KANLinear(c, c, grid_size=3)
        self.kanq_glo = KANLinear(c, c, grid_size=3)

    def forward(self, net: torch.Tensor, *inputs: torch.Tensor):
        """net [B,H,W,128]; inputs concatenated along channels."""
        inp = torch.cat(inputs, dim=-1)
        net_inp = torch.cat([net, inp], dim=-1)

        # gated global pooling; the pooled KAN branch is tiny [B, C] and
        # stays fp32 even when the convs run bf16 (spline bases are
        # sensitive to input precision)
        gate = torch.sigmoid(self.w(net))
        glo = torch.mean((gate * net).float(), dim=(1, 2))
        kz = self.kanz_glo(glo)[:, None, None, :]
        kr = self.kanr_glo(glo)[:, None, None, :]
        kq = self.kanq_glo(glo)[:, None, None, :]

        z = torch.sigmoid(self.convz(net_inp) + kz)
        r = torch.sigmoid(self.convr(net_inp) + kr)
        q = torch.tanh(
            self.convq(torch.cat([r * net.to(r.dtype), inp], dim=-1)) + kq)
        return (1.0 - z) * net + z * q


class ConvGRU(nn.Module):
    """The vanilla DROID ConvGRU, as the JAX package's ``ConvGRU``: 3x3
    ``convz`` / ``convr`` / ``convq`` over [net, inputs], each gate biased
    by a 1x1 conv (``convz_glo`` / ``convr_glo`` / ``convq_glo``) of the
    hidden state's spatial mean.  The state-dict keys are the reference's
    (to3DGS/modules/gru.py); its gate conv ``w`` on the pooling is absent,
    as it is in the JAX cell, which pools the plain mean."""

    def __init__(self, h_planes: int = 128, i_planes: int = 320,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c = h_planes
        self.convz = Conv(c + i_planes, c, 3, 1, 1, dtype)
        self.convr = Conv(c + i_planes, c, 3, 1, 1, dtype)
        self.convq = Conv(c + i_planes, c, 3, 1, 1, dtype)
        self.convz_glo = Conv(c, c, 1, 1, 0, dtype)
        self.convr_glo = Conv(c, c, 1, 1, 0, dtype)
        self.convq_glo = Conv(c, c, 1, 1, 0, dtype)

    def forward(self, net: torch.Tensor, *inputs: torch.Tensor):
        """net [B,H,W,128]; inputs concatenated along channels."""
        inp = torch.cat(inputs, dim=-1)
        net_inp = torch.cat([net, inp], dim=-1)
        glo = torch.mean(net, dim=(1, 2), keepdim=True)  # [B, 1, 1, C]
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=-1))
                       + self.convq_glo(glo))
        return (1.0 - z) * net + z * q
