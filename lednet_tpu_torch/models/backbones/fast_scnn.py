"""Fast-SCNN backbone, NCHW.

Counterpart of ``lednet_tpu/models/backbones/fast_scnn.py``
(``InvertedResidual`` :22, ``_PPM`` :54, ``FastSCNN`` :76, ``_StridedSep``
:143):

- learning to downsample: a 3x3/s2 conv (``ltd_conv``) and two stride-2
  separable convs (``ltd_sep{1,2}``, ``_StridedSep``: the depthwise conv
  with BatchNorm and no activation, the pointwise one with ReLU) to 1/8;
- global feature extractor: three stages of three MobileNetV2 inverted
  residuals (``gfe{i}_{j}``, the stride on each stage's first block), a
  pyramid pool (``ppm``: the map and, per scale, an adaptive average pool,
  a 1x1 ``pool{s}`` named by the scale and a resize back, concatenated)
  and a 3x3 conv (``gfe_out``), at 1/32;
- feature fusion: the low map resized to the 1/8 map, a depthwise 3x3
  (``ffm_dw``) and a 1x1 (``ffm_low``), added to a 1x1 of the 1/8 map
  (``ffm_high``), then ReLU.

Returns ``(higher, lower, fusion)`` at 1/8, 1/32 and 1/8, selected by
``out_indices``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class InvertedResidual(nn.Module):
    """MobileNetV2's bottleneck: a 1x1 expansion (skipped at ratio 1), a
    3x3 depthwise conv with the stride, a 1x1 projection without
    activation; the input added back at stride 1 and equal widths.  The
    activation is the caller's (Fast-SCNN passes ReLU), ReLU6 by
    default."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand_ratio: int = 6, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU6')
        mid = in_channels * expand_ratio
        self.residual = stride == 1 and in_channels == out_channels
        self.expand = (ConvModule(in_channels, mid, 1, norm_cfg=norm_cfg,
                                  act_cfg=act_cfg) if expand_ratio != 1 else None)
        self.dw = ConvModule(mid, mid, 3, stride=stride, padding=1, groups=mid,
                             norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.project = ConvModule(mid, out_channels, 1, norm_cfg=norm_cfg,
                                  act_cfg=None)

    def forward(self, x):
        h = self.expand(x) if self.expand is not None else x
        h = self.project(self.dw(h))
        return x + h if self.residual else h


class _PPM(nn.Module):

    def __init__(self, in_channels: int, channels: int,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 align_corners: bool = False, norm_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.pool_scales = tuple(pool_scales)
        self.align_corners = align_corners
        self.out_channels = in_channels + channels * len(self.pool_scales)
        for s in self.pool_scales:
            self.add_module(f'pool{s}', ConvModule(
                in_channels, channels, 1, norm_cfg=norm_cfg,
                act_cfg=dict(type='ReLU')))

    def forward(self, x):
        size = x.shape[-2:]
        return torch.cat([x] + [
            resize_bilinear(getattr(self, f'pool{s}')(adaptive_avg_pool2d(x, s)),
                            size, self.align_corners)
            for s in self.pool_scales], 1)


class _StridedSep(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None,
                 dw_act_cfg: Optional[Dict] = None,
                 pw_act_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.dw = ConvModule(in_channels, in_channels, 3, stride=2, padding=1,
                             groups=in_channels, norm_cfg=norm_cfg,
                             act_cfg=dw_act_cfg)
        self.pw = ConvModule(in_channels, out_channels, 1, norm_cfg=norm_cfg,
                             act_cfg=pw_act_cfg or dict(type='ReLU'))

    def forward(self, x):
        return self.pw(self.dw(x))


@MODELS.register_module()
class FastSCNN(nn.Module):

    def __init__(self, in_channels: int = 3,
                 downsample_dw_channels: Sequence[int] = (32, 48),
                 global_in_channels: int = 64,
                 global_block_channels: Sequence[int] = (64, 96, 128),
                 global_block_strides: Sequence[int] = (2, 2, 1),
                 global_out_channels: int = 128,
                 higher_in_channels: int = 64, lower_in_channels: int = 128,
                 fusion_out_channels: int = 128,
                 out_indices: Sequence[int] = (0, 1, 2),
                 align_corners: bool = False, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None,
                 dw_act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``lower_in_channels`` is accepted for the configs and, as in the
        JAX package, unused."""
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        d1, d2 = downsample_dw_channels
        self.out_indices = tuple(out_indices)
        self.align_corners = align_corners
        self.ltd_conv = ConvModule(in_channels, d1, 3, stride=2, padding=1,
                                   norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.ltd_sep1 = _StridedSep(d1, d2, norm_cfg, dw_act_cfg, act_cfg)
        self.ltd_sep2 = _StridedSep(d2, global_in_channels, norm_cfg,
                                    dw_act_cfg, act_cfg)
        self.gfe = []
        in_ch = global_in_channels
        for i, (ch, stride) in enumerate(zip(global_block_channels,
                                             global_block_strides)):
            for j in range(3):
                self.add_module(f'gfe{i}_{j}', InvertedResidual(
                    in_ch, ch, stride if j == 0 else 1, norm_cfg=norm_cfg,
                    act_cfg=act_cfg))
                self.gfe.append(f'gfe{i}_{j}')
                in_ch = ch
        self.ppm = _PPM(in_ch, in_ch // 4, align_corners=align_corners,
                        norm_cfg=norm_cfg)
        self.gfe_out = ConvModule(self.ppm.out_channels, global_out_channels, 3,
                                  padding=1, norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.ffm_dw = ConvModule(global_out_channels, global_out_channels, 3,
                                 padding=1, groups=global_out_channels,
                                 norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.ffm_low = ConvModule(global_out_channels, fusion_out_channels, 1,
                                  norm_cfg=norm_cfg, act_cfg=None)
        self.ffm_high = ConvModule(higher_in_channels, fusion_out_channels, 1,
                                   norm_cfg=norm_cfg, act_cfg=None)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W).  ``impl`` is accepted for the segmentor's call
        and unused: no kernel runs here."""
        x = x.to(self.ltd_conv.conv.weight.dtype)
        higher = self.ltd_sep2(self.ltd_sep1(self.ltd_conv(x)))
        g = higher
        for name in self.gfe:
            g = getattr(self, name)(g)
        lower = self.gfe_out(self.ppm(g))
        low_up = resize_bilinear(lower, higher.shape[-2:], self.align_corners)
        low_up = self.ffm_low(self.ffm_dw(low_up))
        fusion = F.relu(low_up + self.ffm_high(higher))
        outs = (higher, lower, fusion)
        return tuple(outs[i] for i in self.out_indices)
