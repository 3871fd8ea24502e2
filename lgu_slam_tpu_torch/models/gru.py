"""ConvGRU with KAN global biases (port of ``KanBiasConvGRU`` in
the JAX package's ``models/gru.py``).  NHWC; hidden state 128 channels."""

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
