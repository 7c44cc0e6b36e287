"""ICNet backbone (image cascade network), NCHW.

Counterpart of ``lednet_tpu/models/backbones/icnet.py:26``: three branches
of one image.

- sub1: three 3x3/s2 convs on the full image (1/8);
- sub2: the trunk's stem and stages 1-2 on the image resized by 0.5
  (``scale_factor``: coordinates mapped by the factor), then ``conv_sub2``;
- sub4: the *same* trunk's stages 3-4 on sub2's stage-2 map resized by 0.5,
  a pyramid pool (adaptive average pools at ``pool_scales``, a 1x1
  ``ppm{i}`` each, resized back and concatenated before the map),
  ``psp_bottleneck`` (3x3) and ``conv_sub4``.

The trunk is one ResNet (flax ``ResNet_0``, ``self.backbone`` here) with its
stem pool in ceil mode, entered twice through ``stage_range``: one set of
weights and of BatchNorm running stats, updated twice per train step, in
the order of the two calls.  Only the ResNet family can be entered so; the
JAX package runs any other trunk twice whole, which the port does not
(it raises).  Returns ``(sub1, sub2, sub4)`` for the ``ICNeck``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class ICNet(nn.Module):

    def __init__(self, backbone_cfg: Dict, in_channels: int = 3,
                 layer_channels: Sequence[int] = (512, 2048),
                 light_branch_middle_channels: int = 32,
                 psp_out_channels: int = 512,
                 out_channels: Sequence[int] = (64, 256, 256),
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 align_corners: bool = False, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, init_cfg: Optional[Dict] = None):
        """``layer_channels`` is accepted for the configs; the widths come
        from the trunk, as the JAX package infers them."""
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        mid = light_branch_middle_channels
        bb_cfg = dict(backbone_cfg)
        if 'ResNet' not in str(bb_cfg.get('type', '')):
            raise ValueError(f"ICNet's trunk must be of the ResNet family, "
                             f"got {bb_cfg.get('type')}")
        bb_cfg.setdefault('ceil_maxpool', True)
        self.align_corners = align_corners
        self.pool_scales = tuple(pool_scales)

        def conv(cin, cout, k, **kw):
            return ConvModule(cin, cout, k, norm_cfg=norm_cfg, act_cfg=act_cfg,
                              **kw)
        self.sub1_conv1 = conv(in_channels, mid, 3, stride=2, padding=1)
        self.sub1_conv2 = conv(mid, mid, 3, stride=2, padding=1)
        self.sub1_conv3 = conv(mid, out_channels[0], 3, stride=2, padding=1)
        self.backbone = MODELS.build(bb_cfg)
        mid_ch, deep_ch = (self.backbone.stage_channels[1],
                           self.backbone.stage_channels[3])
        self.conv_sub2 = conv(mid_ch, out_channels[1], 1)
        for i in range(len(self.pool_scales)):
            self.add_module(f'ppm{i}', conv(deep_ch, psp_out_channels, 1))
        self.psp_bottleneck = conv(psp_out_channels * len(self.pool_scales)
                                   + deep_ch, psp_out_channels, 3, padding=1)
        self.conv_sub4 = conv(psp_out_channels, out_channels[2], 1)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W).  ``impl`` is accepted for the segmentor's call
        and unused: no kernel runs here."""
        x = x.to(self.sub1_conv1.conv.weight.dtype)
        sub1 = self.sub1_conv3(self.sub1_conv2(self.sub1_conv1(x)))

        half = resize_bilinear(x, align_corners=self.align_corners,
                               scale_factor=0.5)
        mid_feat = self.backbone(half, stage_range=(0, 2))[-1]
        sub2 = self.conv_sub2(mid_feat)

        quarter = resize_bilinear(mid_feat, align_corners=self.align_corners,
                                  scale_factor=0.5)
        deep = self.backbone(quarter, stage_range=(2, 4))[-1]
        size = deep.shape[-2:]
        psp = [resize_bilinear(getattr(self, f'ppm{i}')(adaptive_avg_pool2d(deep, s)),
                               size, self.align_corners)
               for i, s in enumerate(self.pool_scales)]
        psp = self.psp_bottleneck(torch.cat(psp + [deep], 1))
        return sub1, sub2, self.conv_sub4(psp)
