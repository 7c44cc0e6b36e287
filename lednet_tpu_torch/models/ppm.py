"""Deep Aggregation Pyramid Pooling (DAPPM), NCHW.

Counterpart of ``lednet_tpu/models/ppm.py:34``: branch 0 is a 1x1
pre-activation conv of the input; branches 1..n-2 average-pool it (5/2/2,
9/4/4, 17/8/8, zero padding counted in the divisor) before their 1x1 conv;
the last branch pools globally.  Each pooled branch is upsampled bilinearly
(``align_corners=False``) and fused hierarchically,
``feats[i] = process{i-1}(up(branch_i) + feats[i-1])``; the output is
``compression(concat(feats)) + shortcut(x)``.  Every conv runs bias-free in
the order ``('norm', 'act', 'conv')`` with BatchNorm momentum 0.1 and ReLU,
the JAX defaults that every caller keeps.  ``PAPPM`` (:88) is later work
(PIDNet).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import avg_pool2d, global_avg_pool
from lednet_tpu_torch.ops.resize import resize_bilinear

_PRE_ACT = ('norm', 'act', 'conv')
_NORM = dict(type='BN', momentum=0.1)
_ACT = dict(type='ReLU')
_POOLS = ((5, 2, 2), (9, 4, 4), (17, 8, 8))    # (kernel, stride, padding)


class DAPPM(nn.Module):

    def __init__(self, in_channels: int, branch_channels: int,
                 out_channels: int, num_scales: int):
        super().__init__()
        self.num_scales = num_scales

        def conv(cin, cout, k, **kw):
            return ConvModule(cin, cout, k, norm_cfg=_NORM, act_cfg=_ACT,
                              order=_PRE_ACT, bias=False, **kw)
        for i in range(num_scales):
            self.add_module(f'scale{i}', conv(in_channels, branch_channels, 1))
        for i in range(num_scales - 1):
            self.add_module(f'process{i}', conv(branch_channels,
                                                branch_channels, 3, padding=1))
        self.compression = conv(branch_channels * num_scales, out_channels, 1)
        self.shortcut = conv(in_channels, out_channels, 1)

    def forward(self, x, impl: Optional[str] = None):
        """``impl`` is accepted for the backbones' call and unused."""
        size = x.shape[-2:]
        feats = [self.scale0(x)]
        for i in range(1, self.num_scales):
            if i < self.num_scales - 1:
                pooled = avg_pool2d(x, *_POOLS[i - 1])
            else:
                pooled = global_avg_pool(x)
            branch = getattr(self, f'scale{i}')(pooled)
            up = resize_bilinear(branch, size, align_corners=False)
            feats.append(getattr(self, f'process{i - 1}')(up + feats[-1]))
        return self.compression(torch.cat(feats, 1)) + self.shortcut(x)
