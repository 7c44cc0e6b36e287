"""BiSeNetV1 backbone (spatial path + ResNet context path), NCHW.

Counterpart of ``lednet_tpu/models/backbones/bisenetv1.py`` (``SpatialPath``
:23, ``AttentionRefinementModule`` :46, ``FeatureFusionModule`` :65,
``BiSeNetV1`` :86): the spatial path (7x7/s2, 3x3/s2 convs, a 1x1 conv) to
1/8; the context path's trunk (built from ``backbone_cfg`` through the
port's ``MODELS``) refined at 1/32 and 1/16 by attention refinement modules
plus a global-pool context, upsampled by nearest neighbour (the legacy
``floor(dst * in / out)`` of ``ops/resize.py``) down the pyramid; a feature
fusion module with channel attention.  Returns ``(fused @ 1/8, context @
1/8, context @ 1/16)`` selected by ``out_indices``.

The refinement, fusion and spatial-path modules use BatchNorm at its
defaults, not the config's ``norm_cfg``, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import global_avg_pool
from lednet_tpu_torch.ops.resize import resize_nearest
from lednet_tpu_torch.registry import MODELS

_BN = dict(type='BN')
_RELU = dict(type='ReLU')


class SpatialPath(nn.Module):

    def __init__(self, in_channels: int = 3,
                 num_channels: Sequence[int] = (64, 64, 64, 128)):
        super().__init__()
        chans = list(num_channels)
        self.num_layers = len(chans)
        self.layer1 = ConvModule(in_channels, chans[0], 7, stride=2, padding=3,
                                 norm_cfg=_BN, act_cfg=_RELU)
        for i in range(1, len(chans) - 1):
            self.add_module(f'layer{i + 1}', ConvModule(
                chans[i - 1], chans[i], 3, stride=2, padding=1, norm_cfg=_BN,
                act_cfg=_RELU))
        self.add_module(f'layer{len(chans)}', ConvModule(
            chans[-2], chans[-1], 1, norm_cfg=_BN, act_cfg=_RELU))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f'layer{i + 1}')(x)
        return x


class AttentionRefinementModule(nn.Module):
    """3x3 conv, then the map times the sigmoid of a 1x1 conv (bias-free,
    BatchNorm) of its global average."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = ConvModule(in_channels, out_channels, 3, padding=1,
                               norm_cfg=_BN, act_cfg=_RELU)
        self.atten = ConvModule(out_channels, out_channels, 1, bias=False,
                                norm_cfg=_BN, act_cfg=None)

    def forward(self, x):
        x = self.conv(x)
        return x * torch.sigmoid(self.atten(global_avg_pool(x)))


class FeatureFusionModule(nn.Module):
    """1x1 conv of the concatenated paths, then ``x * attention + x``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = ConvModule(in_channels, out_channels, 1, norm_cfg=_BN,
                                act_cfg=_RELU)
        self.conv_atten = ConvModule(out_channels, out_channels, 1, bias=False,
                                     norm_cfg=_BN, act_cfg=_RELU)

    def forward(self, x_sp, x_cp):
        x = self.conv1(torch.cat([x_sp, x_cp], 1))
        attn = torch.sigmoid(self.conv_atten(global_avg_pool(x)))
        return x * attn + x


@MODELS.register_module()
class BiSeNetV1(nn.Module):

    def __init__(self, backbone_cfg: Dict, in_channels: int = 3,
                 spatial_channels: Sequence[int] = (64, 64, 64, 128),
                 context_channels: Sequence[int] = (128, 256, 512),
                 out_indices: Sequence[int] = (0, 1, 2),
                 align_corners: bool = False, out_channels: int = 256,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """The trunk is ``self.backbone`` (flax's automatic ``ResNet_0``,
        mapped by :mod:`lednet_tpu_torch.convert`); it must return four
        maps (1/4, 1/8, 1/16, 1/32)."""
        super().__init__()
        cc = list(context_channels)
        norm_cfg = norm_cfg or _BN
        act_cfg = act_cfg or _RELU
        self.out_indices = tuple(out_indices)
        self.backbone = MODELS.build(dict(backbone_cfg))
        self.gap_conv = ConvModule(cc[2], cc[0], 1, norm_cfg=norm_cfg,
                                   act_cfg=act_cfg)
        self.arm32 = AttentionRefinementModule(cc[2], cc[0])
        self.conv_head32 = ConvModule(cc[0], cc[0], 3, padding=1,
                                      norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.arm16 = AttentionRefinementModule(cc[1], cc[0])
        self.conv_head16 = ConvModule(cc[0], cc[0], 3, padding=1,
                                      norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.spatial_path = SpatialPath(in_channels, spatial_channels)
        self.ffm = FeatureFusionModule(cc[1], out_channels)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W).  ``impl`` is accepted for the segmentor's call
        and unused: no kernel runs here."""
        x = x.to(self.gap_conv.conv.weight.dtype)
        _, x_8, x_16, x_32 = self.backbone(x)
        x_gap = self.gap_conv(global_avg_pool(x_32))
        x_32_up = resize_nearest(self.arm32(x_32) + x_gap, x_16.shape[-2:])
        x_32_up = self.conv_head32(x_32_up)
        x_16_up = resize_nearest(self.arm16(x_16) + x_32_up, x_8.shape[-2:])
        x_16_up = self.conv_head16(x_16_up)
        x_fuse = self.ffm(self.spatial_path(x), x_16_up)
        outs = [x_fuse, x_16_up, x_32_up]
        return tuple(outs[i] for i in self.out_indices)
