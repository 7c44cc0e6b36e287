"""Multi-scale attentional feature fusion (Muti_AFF), NCHW.

Counterpart of ``lednet_tpu/models/aff.py`` (``_Bottleneck1x1`` :26,
``MutiAFF`` :61): ``wei = sigmoid(local + c4 + c8 + c16 + global)`` over
1x1 bottlenecks of ``x + residual`` and of its 4/8/16 adaptive pools
(nearest-upsampled back) and global pool; ``out = 2*x*wei +
2*residual*(1-wei)``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import Norm2d
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d, global_avg_pool
from lednet_tpu_torch.ops.resize import resize_nearest


class _Bottleneck1x1(nn.Module):
    """1x1 conv -> [BN] -> ReLU -> 1x1 conv -> [BN]."""

    def __init__(self, channels: int, inter_channels: int, with_bn: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, inter_channels, 1)
        self.conv2 = nn.Conv2d(inter_channels, channels, 1)
        if with_bn:
            self.norm1 = Norm2d(dict(type='BN'), inter_channels)
            self.norm2 = Norm2d(dict(type='BN'), channels)
        self.with_bn = with_bn

    def forward(self, x):
        x = self.conv1(x)
        if self.with_bn:
            x = self.norm1(x)
        x = self.conv2(F.relu(x))
        return self.norm2(x) if self.with_bn else x


class MutiAFF(nn.Module):
    """Multi-scale attentional fusion used at both LED-Net bilateral fusions."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        inter = channels // r
        self.local_att = _Bottleneck1x1(channels, inter, with_bn=False)
        for size in (4, 8, 16):
            setattr(self, f'context{size}',
                    _Bottleneck1x1(channels, inter, with_bn=False))
        self.global_att = _Bottleneck1x1(channels, inter, with_bn=False)

    def forward(self, x, residual):
        h, w = x.shape[-2:]
        xa = x + residual
        terms = [self.local_att(xa)]
        for size in (4, 8, 16):
            c = getattr(self, f'context{size}')(adaptive_avg_pool2d(xa, size))
            terms.append(resize_nearest(c, (h, w)))
        terms.append(self.global_att(global_avg_pool(xa)))
        wei = torch.sigmoid(sum(terms))
        return 2 * x * wei + 2 * residual * (1 - wei)
