"""Necks, NCHW: ICNet's ``ICNeck``, the semantic FPN's ``FPN`` and the
ViT adapters ``MultiLevelNeck`` and ``MLANeck``.

Counterpart of ``lednet_tpu/models/necks.py`` (``FPN`` :21,
``_CascadeFeatureFusion`` :59, ``ICNeck`` :83, ``MultiLevelNeck`` :155,
``MLANeck`` :189):

- a cascade feature fusion resizes the low-resolution map to the high
  one's size, runs it through a 3x3 conv dilated by 2 (``conv_low``: norm,
  no activation) and the high map through a 1x1 (``conv_high``: norm, no
  activation), and returns ``relu(low + high)`` and ``low``.  ``ICNeck``
  fuses sub4 into sub2 (``cff_24``), then that into sub1 (``cff_12``), and
  returns ``(low_24, low_12, x_12)``: the auxiliary heads read the first
  two, the decode head the last;
- ``FPN``: a 1x1 ``lateral{i}`` of each used level ``i`` (``start_level``
  up to ``end_level``, -1 meaning the last), named by the level; top-down,
  each lateral plus the one above resized to its size by
  ``upsample_cfg``'s mode (nearest by default, the legacy rounding); a 3x3
  ``fpn{j}`` of each, numbered from 0; the first ``num_outs``.
  ``add_extra_convs`` is accepted and, as in the JAX package, never read;
- ``MultiLevelNeck``: a 1x1 ``lateral{i}`` per input (one input is used
  at every scale), each resized bilinearly to ``int(h * s)`` x ``int(w *
  s)`` for its scale (left as it is at 1), then a 3x3 ``conv{i}``;
- ``MLANeck``: per level a LayerNorm over the channels (``ln{i}``, eps
  1e-6) and a 1x1 ``proj{i}``; a top-down running sum, deepest first; a
  3x3 ``out{i}`` of each sum.  The outputs come deepest first,
  ``(out(p5), out(p5 + p4), ...)``, as the reference's forward gives them
  (its own comment says otherwise).

Without ``norm_cfg`` / ``act_cfg`` a ``ConvModule`` here is a biased
conv with no norm and no activation, as the JAX package builds it (not
mmcv's defaults).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import ConvModule, LayerNorm2d
from lednet_tpu_torch.ops.resize import resize_bilinear, resize_by_mode
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


@MODELS.register_module()
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 num_outs: int, start_level: int = 0, end_level: int = -1,
                 add_extra_convs: bool = False,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None,
                 upsample_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        super().__init__()
        self.n_in = len(in_channels)
        self.used = list(range(start_level, self.n_in if end_level == -1
                               else end_level))
        self.num_outs = num_outs
        self.mode = (upsample_cfg or {}).get('mode', 'nearest')
        for i in self.used:
            self.add_module(f'lateral{i}', ConvModule(
                in_channels[i], out_channels, 1, norm_cfg=norm_cfg,
                act_cfg=act_cfg))
        for j in range(len(self.used)):
            self.add_module(f'fpn{j}', ConvModule(
                out_channels, out_channels, 3, padding=1, norm_cfg=norm_cfg,
                act_cfg=act_cfg))

    def forward(self, inputs):
        if len(inputs) != self.n_in:
            raise ValueError(f'FPN takes {self.n_in} maps, got {len(inputs)}')
        laterals = [getattr(self, f'lateral{i}')(inputs[i]) for i in self.used]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_by_mode(
                laterals[i], laterals[i - 1].shape[-2:], self.mode)
        outs = [getattr(self, f'fpn{j}')(x) for j, x in enumerate(laterals)]
        return tuple(outs[:self.num_outs])


@MODELS.register_module()
class MultiLevelNeck(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (768,),
                 out_channels: int = 256,
                 scales: Sequence[float] = (0.5, 1, 2, 4),
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        super().__init__()
        self.n_in = len(in_channels)
        self.scales = tuple(scales)
        if self.n_in not in (1, len(self.scales)):
            raise ValueError(f'MultiLevelNeck: {self.n_in} inputs for '
                             f'{len(self.scales)} scales')
        for i, c in enumerate(in_channels):
            self.add_module(f'lateral{i}', ConvModule(
                c, out_channels, 1, norm_cfg=norm_cfg, act_cfg=act_cfg))
        for i in range(len(self.scales)):
            self.add_module(f'conv{i}', ConvModule(
                out_channels, out_channels, 3, padding=1, norm_cfg=norm_cfg,
                act_cfg=act_cfg))

    def forward(self, inputs):
        if len(inputs) != self.n_in:
            raise ValueError(f'MultiLevelNeck takes {self.n_in} maps, got '
                             f'{len(inputs)}')
        laterals = [getattr(self, f'lateral{i}')(x) for i, x in enumerate(inputs)]
        if len(laterals) == 1:
            laterals = laterals * len(self.scales)
        outs = []
        for i, s in enumerate(self.scales):
            x = laterals[i]
            if s != 1:
                h, w = x.shape[-2:]
                x = resize_bilinear(x, (int(h * s), int(w * s)), False)
            outs.append(getattr(self, f'conv{i}')(x))
        return tuple(outs)


@MODELS.register_module()
class MLANeck(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (1024, 1024, 1024, 1024),
                 out_channels: int = 256, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        super().__init__()
        self.n_in = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f'ln{i}', LayerNorm2d(c, eps=1e-6))
            self.add_module(f'proj{i}', ConvModule(
                c, out_channels, 1, norm_cfg=norm_cfg, act_cfg=act_cfg))
            self.add_module(f'out{i}', ConvModule(
                out_channels, out_channels, 3, padding=1, norm_cfg=norm_cfg,
                act_cfg=act_cfg))

    def forward(self, inputs):
        if len(inputs) != self.n_in:
            raise ValueError(f'MLANeck takes {self.n_in} maps, got {len(inputs)}')
        feats = [getattr(self, f'proj{i}')(getattr(self, f'ln{i}')(x))
                 for i, x in enumerate(inputs)]
        sums = []
        for feat in feats[::-1]:
            sums.append(feat if not sums else sums[-1] + feat)
        return tuple(getattr(self, f'out{i}')(x) for i, x in enumerate(sums))
