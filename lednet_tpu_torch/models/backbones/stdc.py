"""STDC backbones (short-term dense concatenate), NCHW.

Counterpart of ``lednet_tpu/models/backbones/stdc.py`` (``STDCModule`` :29,
``STDCNet`` :95, ``_STDCFusion`` :139, ``STDCContextPathNet`` :165):

- ``STDCModule``: a 1x1 conv to out/2 (always ReLU), then ``num_convs - 1``
  3x3 convs halving the width (out/4, out/8, out/8 for four convs).  The
  'cat' fusion concatenates every tap; at stride 2 a depthwise 3x3/s2 conv
  (``downsample``) sits before the second conv and the first tap is the
  first conv's output average-pooled 3x3/s2 (padding counted).  The 'add'
  fusion adds the input (at stride 2 through a depthwise 3x3/s2 and a 1x1,
  ``skip_dw`` / ``skip_pw``) to the concatenated taps, the depthwise
  ``downsample`` then following the first conv;
- ``STDCNet``: two 3x3/s2 convs, then three stages of STDC modules (the
  strides of ``arch_settings``), returning the 1/8, 1/16 and 1/32 maps
  (the last through a 1x1 ``final_conv`` with ``with_final_conv``);
- ``STDCContextPathNet``: BiSeNet's context path over an STDCNet built from
  ``backbone_cfg`` (``self.backbone``): a global-pool context (``conv_avg``)
  and attention refinement modules at 1/32 and 1/16, each upsampled by
  nearest neighbour (the legacy ``floor(dst * in / out)`` index) and a 3x3
  conv; a fusion module (``ffm``: 1x1 conv, then ``x * sigmoid(attn(x)) +
  x`` with a two-conv attention and no norm).  Returns ``(1/8 map, context
  @ 1/16, context @ 1/8, fused)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.backbones.bisenetv1 import AttentionRefinementModule
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import avg_pool2d, global_avg_pool
from lednet_tpu_torch.ops.resize import resize_nearest
from lednet_tpu_torch.registry import MODELS

_RELU = dict(type='ReLU')


class STDCModule(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 num_convs: int = 4, fusion_type: str = 'add'):
        super().__init__()
        if fusion_type not in ('add', 'cat'):
            raise ValueError(f'unknown STDC fusion {fusion_type!r}')
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or _RELU
        oc = out_channels
        self.num_convs = num_convs
        self.fusion_type = fusion_type
        self.down = stride == 2
        self.conv0 = ConvModule(in_channels, oc // 2, 1, norm_cfg=norm_cfg,
                                act_cfg=_RELU)
        for i in range(1, num_convs):
            out_factor = 2 ** (i + 1) if i != num_convs - 1 else 2 ** i
            self.add_module(f'conv{i}', ConvModule(
                oc // 2 ** i, oc // out_factor, 3, padding=1,
                norm_cfg=norm_cfg, act_cfg=act_cfg))
        if self.down:
            self.downsample = ConvModule(oc // 2, oc // 2, 3, stride=2,
                                         padding=1, groups=oc // 2,
                                         norm_cfg=norm_cfg)
            if fusion_type == 'add':
                self.skip_dw = ConvModule(in_channels, in_channels, 3, stride=2,
                                          padding=1, groups=in_channels,
                                          norm_cfg=norm_cfg)
                self.skip_pw = ConvModule(in_channels, oc, 1, norm_cfg=norm_cfg)

    def forward(self, x):
        x0 = self.conv0(x)
        h = x0
        if self.fusion_type == 'add' and self.down:
            h = self.downsample(h)
        taps = [] if self.fusion_type == 'cat' else [h]
        for i in range(1, self.num_convs):
            if i == 1 and self.down and self.fusion_type == 'cat':
                h = self.downsample(h)
            h = getattr(self, f'conv{i}')(h)
            taps.append(h)
        if self.fusion_type == 'cat':
            return torch.cat([avg_pool2d(x0, 3, 2, 1) if self.down else x0]
                             + taps, 1)
        skip = self.skip_pw(self.skip_dw(x)) if self.down else x
        return torch.cat(taps, 1) + skip


@MODELS.register_module()
class STDCNet(nn.Module):
    arch_settings = {
        'STDCNet1': [(2, 1), (2, 1), (2, 1)],
        'STDCNet2': [(2, 1, 1, 1), (2, 1, 1, 1, 1), (2, 1, 1)],
    }

    def __init__(self, stdc_type: str = 'STDCNet1', in_channels: int = 3,
                 channels: Sequence[int] = (32, 64, 256, 512, 1024),
                 bottleneck_type: str = 'cat', norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, num_convs: int = 4,
                 with_final_conv: bool = False, pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None):
        """``pretrained`` and ``init_cfg`` (an ImageNet checkpoint's URL in
        the ``stdc*_in1k-pre`` configs) are read by neither package: weights
        come from ``init_weights`` or a checkpoint given to ``init_model``."""
        super().__init__()
        if stdc_type not in self.arch_settings:
            raise ValueError(f'unknown STDC type {stdc_type!r}')
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or _RELU
        ch = list(channels)
        self.stage0 = ConvModule(in_channels, ch[0], 3, stride=2, padding=1,
                                 norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.stage1 = ConvModule(ch[0], ch[1], 3, stride=2, padding=1,
                                 norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.stages = []
        for s, strides in enumerate(self.arch_settings[stdc_type]):
            names = []
            for j, stride in enumerate(strides):
                names.append(f'stage{s + 2}_{j}')
                self.add_module(names[-1], STDCModule(
                    ch[s + 1] if j == 0 else ch[s + 2], ch[s + 2], stride,
                    norm_cfg, act_cfg, num_convs=num_convs,
                    fusion_type=bottleneck_type))
            self.stages.append(names)
        self.final_conv = (ConvModule(ch[-1], max(1024, ch[-1]), 1,
                                      norm_cfg=norm_cfg, act_cfg=act_cfg)
                           if with_final_conv else None)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W), promoted to the weights' dtype; ``impl`` is
        accepted for the segmentor's call and unused."""
        x = self.stage1(self.stage0(x.to(self.stage0.conv.weight.dtype)))
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        if self.final_conv is not None:
            outs[-1] = self.final_conv(outs[-1])
        return tuple(outs)


class _STDCFusion(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 4, norm_cfg: Optional[Dict] = None):
        super().__init__()
        hidden = out_channels // scale_factor
        self.conv0 = ConvModule(in_channels, out_channels, 1,
                                norm_cfg=norm_cfg or dict(type='BN'),
                                act_cfg=_RELU)
        self.attn1 = ConvModule(out_channels, hidden, 1, bias=False,
                                act_cfg=_RELU)
        self.attn2 = ConvModule(hidden, out_channels, 1, bias=False)

    def forward(self, spatial, context):
        x = self.conv0(torch.cat([spatial, context], 1))
        attn = torch.sigmoid(self.attn2(self.attn1(global_avg_pool(x))))
        return x * attn + x


@MODELS.register_module()
class STDCContextPathNet(nn.Module):

    def __init__(self, backbone_cfg: Dict,
                 last_in_channels: Sequence[int] = (1024, 512),
                 out_channels: int = 128, ffm_cfg: Optional[Dict] = None,
                 upsample_mode: str = 'nearest',
                 align_corners: Optional[bool] = None,
                 norm_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """The STDCNet is ``self.backbone`` (flax's automatic ``STDCNet_0``,
        mapped by :mod:`lednet_tpu_torch.convert`).  The configs upsample by
        nearest neighbour, where ``align_corners`` means nothing; bilinear
        upsampling is later work in the port."""
        super().__init__()
        if upsample_mode != 'nearest':
            raise NotImplementedError(f'upsample_mode={upsample_mode!r} is '
                                      'later work in the port')
        norm_cfg = norm_cfg or dict(type='BN')
        self.num_arms = len(last_in_channels)
        self.backbone = MODELS.build(dict(backbone_cfg))
        self.conv_avg = ConvModule(last_in_channels[0], out_channels, 1,
                                   norm_cfg=norm_cfg, act_cfg=_RELU)
        for i, channels in enumerate(last_in_channels):
            self.add_module(f'arm{i}', AttentionRefinementModule(channels,
                                                                 out_channels))
            self.add_module(f'conv{i}', ConvModule(
                out_channels, out_channels, 3, padding=1, norm_cfg=norm_cfg,
                act_cfg=_RELU))
        self.ffm = _STDCFusion(norm_cfg=norm_cfg, **dict(
            ffm_cfg or dict(in_channels=512, out_channels=256, scale_factor=4)))

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W); ``impl`` is accepted for the segmentor's call and
        unused: no kernel runs here."""
        outs = self.backbone(x)
        feature_up = resize_nearest(self.conv_avg(global_avg_pool(outs[-1])),
                                    outs[-1].shape[-2:])
        arms_out = []
        for i in range(self.num_arms):
            x_arm = getattr(self, f'arm{i}')(outs[-1 - i]) + feature_up
            feature_up = getattr(self, f'conv{i}')(
                resize_nearest(x_arm, outs[-2 - i].shape[-2:]))
            arms_out.append(feature_up)
        return (outs[0], *arms_out, self.ffm(outs[0], arms_out[1]))
