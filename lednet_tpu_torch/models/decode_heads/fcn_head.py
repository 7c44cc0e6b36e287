"""FCN decode head, NCHW: the decode head of BiSeNetV1 and the auxiliary
head of the zoo's configs; and its separable form, Fast-SCNN's decode head.

Counterpart of ``lednet_tpu/models/decode_heads/fcn_head.py:25``: the input
selected by ``in_index`` / ``input_transform`` (``select_inputs``),
``num_convs`` convs (``kernel_size``, ``dilation``) in -> channels, with
``concat_input`` a conv of [input, features] back to ``channels``, then
dropout + the 1x1 classifier.  ``loss_by_feat`` resizes the logits to the
label, weights its pixels by the ``sampler`` if one is configured
(``OHEMPixelSampler``, built once) and runs the configured losses;
``predict_by_feat`` resizes them to ``size``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from lednet_tpu_torch.models.decode_heads.base import (ClsSeg, build_losses,
                                                       default_loss_by_feat,
                                                       resolve_out_channels,
                                                       select_inputs)
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class FCNHead(nn.Module):

    def __init__(self, in_channels: Union[int, Sequence[int]], channels: int,
                 num_classes: int, num_convs: int = 2, kernel_size: int = 3,
                 concat_input: bool = True, dilation: int = 1,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 out_channels: Optional[int] = None,
                 loss_decode: Optional[Dict] = None,
                 sampler: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``in_channels`` is the selected input's width (the sum of the
        widths for ``'resize_concat'``)."""
        super().__init__()
        if input_transform == 'multiple_select':
            raise ValueError("FCNHead convolves one map: input_transform="
                             "'multiple_select' gives it a list")
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        in_ch = sum(in_channels) if isinstance(in_channels, (list, tuple)) \
            else in_channels
        if num_convs == 0 and in_ch != channels:
            raise ValueError(f'num_convs=0 needs in_channels == channels, got '
                             f'{in_ch} and {channels}')
        self.in_index = in_index
        self.input_transform = input_transform
        self.num_convs = num_convs
        self.concat_input = concat_input
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.losses = build_losses(loss_decode)
        self.sampler = (MODELS.build(dict(sampler)) if sampler is not None
                        else None)
        for i in range(num_convs):
            self.add_module(f'conv{i}', self._conv(
                in_ch if i == 0 else channels, channels, kernel_size, dilation,
                norm_cfg, act_cfg))
        if concat_input:
            self.conv_cat = self._conv(in_ch + channels, channels, kernel_size,
                                       1, norm_cfg, act_cfg)
        self.cls = ClsSeg(channels, resolve_out_channels(num_classes,
                                                         out_channels),
                          dropout_ratio)

    @staticmethod
    def _conv(in_channels, out_channels, kernel_size, dilation, norm_cfg,
              act_cfg) -> nn.Module:
        """One of the head's convs (``conv{i}``, ``conv_cat``)."""
        return ConvModule(in_channels, out_channels, kernel_size,
                          padding=(kernel_size // 2) * dilation,
                          dilation=dilation, norm_cfg=norm_cfg, act_cfg=act_cfg)

    def forward(self, inputs, with_aux: bool = True):
        """The logits of the selected input; ``with_aux`` is the segmentor's
        flag and means nothing to a single-output head."""
        x = select_inputs(inputs, self.in_index, self.input_transform,
                          self.align_corners)
        feats = x
        for i in range(self.num_convs):
            feats = getattr(self, f'conv{i}')(feats)
        if self.concat_input:
            feats = self.conv_cat(torch.cat([x, feats], 1))
        return self.cls(feats)

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        return default_loss_by_feat(seg_logits, seg_label, self.losses,
                                    self.align_corners, self.ignore_index,
                                    self.sampler)

    def predict_by_feat(self, seg_logits, size=None):
        if size is None:
            return seg_logits
        return resize_bilinear(seg_logits, size, self.align_corners)


class _SepConv(nn.Module):
    """A depthwise-separable conv (``lednet_tpu/models/decode_heads/
    psp_aspp.py:31``): a depthwise ``kernel_size`` conv (``dw``) and a 1x1
    (``pw``), each with norm and activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dilation: int = 1,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        self.dw = ConvModule(in_channels, in_channels, kernel_size,
                             padding=(kernel_size // 2) * dilation,
                             dilation=dilation, groups=in_channels,
                             norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.pw = ConvModule(in_channels, out_channels, 1, norm_cfg=norm_cfg,
                             act_cfg=act_cfg)

    def forward(self, x):
        return self.pw(self.dw(x))


@MODELS.register_module()
class DepthwiseSeparableFCNHead(FCNHead):
    """Fast-SCNN's decode head (``lednet_tpu/models/decode_heads/
    uper_ocr.py:144``): an ``FCNHead`` whose convs are separable
    (``_SepConv``), undilated.  ``dw_act_cfg`` is accepted for the configs
    and, as in the JAX package, unused: both halves take ``act_cfg``."""

    def __init__(self, *args, dw_act_cfg: Optional[Dict] = None, **kwargs):
        super().__init__(*args, **kwargs)

    @staticmethod
    def _conv(in_channels, out_channels, kernel_size, dilation, norm_cfg,
              act_cfg) -> nn.Module:
        return _SepConv(in_channels, out_channels, kernel_size,
                        norm_cfg=norm_cfg, act_cfg=act_cfg)
