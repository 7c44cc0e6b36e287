"""Necks, NCHW: ICNet's ``ICNeck``.

Counterpart of ``lednet_tpu/models/necks.py`` (``_CascadeFeatureFusion``
:59, ``ICNeck`` :83).  A cascade feature fusion resizes the low-resolution
map to the high one's size, runs it through a 3x3 conv dilated by 2
(``conv_low``: norm, no activation) and the high map through a 1x1
(``conv_high``: norm, no activation), and returns ``relu(low + high)`` and
``low``.  ``ICNeck`` fuses sub4 into sub2 (``cff_24``), then that into sub1
(``cff_12``), and returns ``(low_24, low_12, x_12)``: the auxiliary heads
read the first two, the decode head the last.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class _CascadeFeatureFusion(nn.Module):

    def __init__(self, low_channels: int, high_channels: int,
                 out_channels: int, norm_cfg: Optional[Dict] = None,
                 align_corners: bool = False):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.align_corners = align_corners
        self.conv_low = ConvModule(low_channels, out_channels, 3, padding=2,
                                   dilation=2, norm_cfg=norm_cfg, act_cfg=None)
        self.conv_high = ConvModule(high_channels, out_channels, 1,
                                    norm_cfg=norm_cfg, act_cfg=None)

    def forward(self, x_low, x_high):
        x_low = resize_bilinear(x_low, x_high.shape[-2:], self.align_corners)
        low = self.conv_low(x_low)
        return F.relu(low + self.conv_high(x_high)), low


@MODELS.register_module()
class ICNeck(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (64, 256, 256),
                 out_channels: int = 128, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 init_cfg: Optional[Dict] = None):
        """``act_cfg`` is accepted for the configs and, as in the JAX
        package, unused: the fusions end in a ReLU after the sum."""
        super().__init__()
        self.cff_24 = _CascadeFeatureFusion(in_channels[2], in_channels[1],
                                            out_channels, norm_cfg, align_corners)
        self.cff_12 = _CascadeFeatureFusion(out_channels, in_channels[0],
                                            out_channels, norm_cfg, align_corners)

    def forward(self, inputs):
        if len(inputs) != 3:
            raise ValueError(f'ICNeck takes three maps, got {len(inputs)}')
        x_sub1, x_sub2, x_sub4 = inputs
        x_24, low_24 = self.cff_24(x_sub4, x_sub2)
        x_12, low_12 = self.cff_12(x_24, x_sub1)
        return low_24, low_12, x_12
