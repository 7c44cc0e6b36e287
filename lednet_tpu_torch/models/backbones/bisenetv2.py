"""BiSeNetV2 backbone (detail branch, semantic branch, BGA fusion), NCHW.

Counterpart of ``lednet_tpu/models/backbones/bisenetv2.py`` (``_DWSeparable``
:26, ``StemBlock`` :46, ``GELayer`` :68, ``CEBlock`` :101, ``BiSeNetV2``
:118):

- the detail branch: three stages of a 3x3/s2 conv and one (first stage) or
  two 3x3 convs, to 1/8 (``detail{i}_{j}``);
- the semantic branch: ``StemBlock`` (3x3/s2 conv, then a 1x1 + 3x3/s2 pair
  beside a 3x3/s2 max pool padded with ``-inf``, concatenated and fused by a
  3x3 conv) to 1/4; gather-and-expand layers (``GELayer``: a 3x3 conv, one
  expanded depthwise 3x3 at stride 1 or two at stride 2, a 1x1 back, a
  depthwise-separable shortcut where the stride or the width changes, ReLU
  of the sum), two per stage and four in the last, to 1/32; the context
  block (``CEBlock``: BatchNorm of the global average, a 1x1 conv, added to
  the map, a 3x3 conv);
- the bilateral guided aggregation: the detail map through a depthwise-
  separable conv (its pointwise conv has a bias and no norm) and through a
  3x3/s2 conv + 3x3/s2 average pool (padding counted in the divisor); the
  semantic map through a 3x3 conv, upsampled bilinearly, and a depthwise-
  separable conv; each guided by the other's sigmoid, the coarse product
  upsampled, summed and fused by a 3x3 conv (``bga_conv``).

Returns ``(bga, stem, stage2, stage3, stage4)`` selected by ``out_indices``;
the four semantic taps feed the booster heads.  Every norm is BatchNorm at
its defaults whatever the config's ``norm_cfg``, as in the JAX package;
``norm_cfg``, ``act_cfg`` and ``init_cfg`` are accepted and unused.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import ConvModule, Norm2d
from lednet_tpu_torch.ops.pool import avg_pool2d, global_avg_pool, max_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

_BN = dict(type='BN')
_RELU = dict(type='ReLU')


class _DWSeparable(nn.Module):
    """Depthwise 3x3 (BatchNorm) then pointwise 1x1 (BatchNorm, or a bias
    without ``pw_norm``); no activation."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 pw_norm: bool = True):
        super().__init__()
        self.dw = ConvModule(in_channels, in_channels, 3, stride=stride,
                             padding=1, groups=in_channels, norm_cfg=_BN)
        self.pw = ConvModule(in_channels, out_channels, 1,
                             norm_cfg=_BN if pw_norm else None,
                             bias=not pw_norm)

    def forward(self, x):
        return self.pw(self.dw(x))


class StemBlock(nn.Module):

    def __init__(self, in_channels: int = 3, out_channels: int = 16):
        super().__init__()
        oc = out_channels
        self.conv_first = ConvModule(in_channels, oc, 3, stride=2, padding=1,
                                     norm_cfg=_BN, act_cfg=_RELU)
        self.convs1 = ConvModule(oc, oc // 2, 1, norm_cfg=_BN, act_cfg=_RELU)
        self.convs2 = ConvModule(oc // 2, oc, 3, stride=2, padding=1,
                                 norm_cfg=_BN, act_cfg=_RELU)
        self.fuse_last = ConvModule(2 * oc, oc, 3, padding=1, norm_cfg=_BN,
                                    act_cfg=_RELU)

    def forward(self, x):
        x = self.conv_first(x)
        left = self.convs2(self.convs1(x))
        return self.fuse_last(torch.cat([left, max_pool2d(x, 3, 2, 1)], 1))


class GELayer(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 exp_ratio: int = 6, stride: int = 1):
        super().__init__()
        mid = in_channels * exp_ratio
        self.stride = stride
        self.conv1 = ConvModule(in_channels, in_channels, 3, padding=1,
                                norm_cfg=_BN, act_cfg=_RELU)
        if stride == 1:
            self.dwconv = ConvModule(in_channels, mid, 3, padding=1,
                                     groups=in_channels, norm_cfg=_BN,
                                     act_cfg=_RELU)
        else:
            self.dwconv1 = ConvModule(in_channels, mid, 3, stride=stride,
                                      padding=1, groups=in_channels,
                                      norm_cfg=_BN)
            self.dwconv2 = ConvModule(mid, mid, 3, padding=1, groups=mid,
                                      norm_cfg=_BN, act_cfg=_RELU)
        self.conv2 = ConvModule(mid, out_channels, 1, norm_cfg=_BN)
        self.shortcut = (_DWSeparable(in_channels, out_channels, stride=stride)
                         if stride != 1 or in_channels != out_channels
                         else None)

    def forward(self, x):
        identity = x if self.shortcut is None else self.shortcut(x)
        x = self.conv1(x)
        x = (self.dwconv(x) if self.stride == 1
             else self.dwconv2(self.dwconv1(x)))
        return F.relu(self.conv2(x) + identity)


class CEBlock(nn.Module):
    """Context embedding: BatchNorm (``gap_norm``) of the global average, a
    1x1 conv, broadcast-added to the map, a 3x3 conv."""

    def __init__(self, in_channels: int = 3, out_channels: int = 16):
        super().__init__()
        self.gap_norm = Norm2d(_BN, in_channels)
        self.conv_gap = ConvModule(in_channels, out_channels, 1, norm_cfg=_BN,
                                   act_cfg=_RELU)
        self.conv_last = ConvModule(out_channels, out_channels, 3, padding=1,
                                    norm_cfg=_BN, act_cfg=_RELU)

    def forward(self, x):
        g = self.conv_gap(self.gap_norm(global_avg_pool(x)))
        return self.conv_last(x + g)


@MODELS.register_module()
class BiSeNetV2(nn.Module):

    def __init__(self, in_channels: int = 3,
                 detail_channels: Sequence[int] = (64, 64, 128),
                 semantic_channels: Sequence[int] = (16, 32, 64, 128),
                 semantic_expansion_ratio: int = 6, bga_channels: int = 128,
                 out_indices: Sequence[int] = (0, 1, 2, 3, 4),
                 align_corners: bool = False, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, init_cfg: Optional[Dict] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.align_corners = align_corners
        dc = list(detail_channels)
        self.detail = []
        for i, ch in enumerate(dc):
            in_ch = in_channels if i == 0 else dc[i - 1]
            self.add_module(f'detail{i}_0', ConvModule(
                in_ch, ch, 3, stride=2, padding=1, norm_cfg=_BN, act_cfg=_RELU))
            self.detail.append(f'detail{i}_0')
            for j in range(1 if i == 0 else 2):
                self.add_module(f'detail{i}_{j + 1}', ConvModule(
                    ch, ch, 3, padding=1, norm_cfg=_BN, act_cfg=_RELU))
                self.detail.append(f'detail{i}_{j + 1}')

        sc = list(semantic_channels)
        exp = semantic_expansion_ratio
        self.stage1 = StemBlock(in_channels, sc[0])
        self.stages = []
        for i in range(1, len(sc)):
            names = []
            for j in range(4 if i == len(sc) - 1 else 2):
                name = f'stage{i + 1}_{j}'
                self.add_module(name, GELayer(sc[i - 1] if j == 0 else sc[i],
                                              sc[i], exp, 2 if j == 0 else 1))
                names.append(name)
            self.stages.append(names)
        self.ce_block = CEBlock(sc[-1], sc[-1])

        oc = bga_channels
        self.detail_dwconv = _DWSeparable(oc, oc, pw_norm=False)
        self.detail_down = ConvModule(oc, oc, 3, stride=2, padding=1,
                                      norm_cfg=_BN)
        self.semantic_conv = ConvModule(oc, oc, 3, padding=1, norm_cfg=_BN)
        self.semantic_dwconv = _DWSeparable(oc, oc, pw_norm=False)
        self.bga_conv = ConvModule(oc, oc, 3, padding=1, norm_cfg=_BN,
                                   act_cfg=_RELU)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W); ``impl`` is accepted for the segmentor's call and
        unused; ``x`` is cast to the weights' dtype."""
        x = d = x.to(self.detail0_0.conv.weight.dtype)
        for name in self.detail:
            d = getattr(self, name)(d)

        s = self.stage1(x)
        taps = [s]
        for names in self.stages:
            for name in names:
                s = getattr(self, name)(s)
            taps.append(s)
        s = self.ce_block(s)

        detail_dw = self.detail_dwconv(d)
        detail_down = avg_pool2d(self.detail_down(d), 3, 2, 1)
        semantic_conv = resize_bilinear(self.semantic_conv(s),
                                        detail_dw.shape[-2:],
                                        self.align_corners)
        fuse_1 = detail_dw * torch.sigmoid(semantic_conv)
        fuse_2 = resize_bilinear(
            detail_down * torch.sigmoid(self.semantic_dwconv(s)),
            fuse_1.shape[-2:], self.align_corners)
        outs = [self.bga_conv(fuse_1 + fuse_2)] + taps
        return tuple(outs[i] for i in self.out_indices)
