"""PSPNet and DeepLab decode heads, NCHW: ``PSPHead``, ``ASPPHead`` and
DeepLabV3+'s ``DepthwiseSeparableASPPHead``, on the single-logit head
base that ``SCTHead`` shares.

Counterpart of ``lednet_tpu/models/decode_heads/psp_aspp.py`` (``_HeadBase``
:55, ``PSPHead`` :91, ``ASPPHead`` :117, ``DepthwiseSeparableASPPHead``
:172):

- ``PSPHead``: the selected map and its adaptive average pools at
  ``pool_scales`` (torch's floor/ceil bins, overlapping where the map is
  not a multiple of the scale), each through a 1x1 ``ppm{scale}`` and
  resized back, concatenated input first; a 3x3 ``bottleneck``; ``cls``;
- ``ASPPHead``: a global-pool ``image_pool`` branch resized back, then
  ``aspp{i}`` per dilation (a 1x1 at dilation 1, else a dilated 3x3, or a
  separable one, ``_SepConv``, with ``separable``), concatenated in that
  order; a 3x3 ``bottleneck``; when ``c1_in_channels`` and the head gets
  the backbone's whole tuple, a 1x1 ``c1_bottleneck`` of ``inputs[0]``,
  the output resized to its size and concatenated before it, then
  separable ``sep1`` and ``sep2``; ``cls``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from lednet_tpu_torch.models.decode_heads.base import (ClsSeg, build_losses,
                                                       default_loss_by_feat,
                                                       resolve_out_channels,
                                                       select_inputs)
from lednet_tpu_torch.models.decode_heads.fcn_head import _SepConv
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d, global_avg_pool
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class HeadBase(nn.Module):
    """The configuration, classifier, loss and prediction of a head whose
    forward gives one logit map: the selected input's width
    (``in_width``; the sum for ``'resize_concat'``), its norm and
    activation (BatchNorm and ReLU by default), and ``cls``.  A head that
    takes several levels (``takes_list``: UPerHead, SegformerHead,
    MaskFormerHead) selects them with ``'multiple_select'`` and no other
    transform.  A head that classifies otherwise (``classifier`` False:
    K-Net's kernels, MaskFormer's queries) has no ``cls``."""
    takes_list = False
    classifier = True

    def __init__(self, in_channels: Union[int, Sequence[int]], channels: int,
                 num_classes: int, dropout_ratio: float = 0.1,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 out_channels: Optional[int] = None,
                 loss_decode: Optional[Dict] = None,
                 sampler: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        super().__init__()
        if self.takes_list and input_transform != 'multiple_select':
            raise NotImplementedError(
                f'{type(self).__name__} with input_transform='
                f'{input_transform!r}: the port selects its levels with '
                "'multiple_select' only")
        if input_transform == 'multiple_select' and not self.takes_list:
            raise ValueError(f"{type(self).__name__} convolves one map: "
                             "input_transform='multiple_select' gives it a list")
        self.in_channels = in_channels
        self.in_width = sum(in_channels) if isinstance(
            in_channels, (list, tuple)) else in_channels
        self.channels = channels
        self.norm_cfg = norm_cfg or dict(type='BN')
        self.act_cfg = act_cfg or dict(type='ReLU')
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.in_index = in_index
        self.input_transform = input_transform
        self.losses = build_losses(loss_decode)
        self.sampler = (MODELS.build(dict(sampler)) if sampler is not None
                        else None)
        n_out = resolve_out_channels(num_classes, out_channels)
        if self.classifier:
            self.cls = ClsSeg(channels, n_out, dropout_ratio)

    def _conv(self, cin, cout, k, **kw):
        return ConvModule(cin, cout, k, norm_cfg=self.norm_cfg,
                          act_cfg=self.act_cfg, **kw)

    def _select(self, inputs):
        return select_inputs(inputs, self.in_index, self.input_transform,
                             self.align_corners)

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        return default_loss_by_feat(seg_logits, seg_label, self.losses,
                                    self.align_corners, self.ignore_index,
                                    self.sampler)

    def predict_by_feat(self, seg_logits, size=None):
        if size is None:
            return seg_logits
        return resize_bilinear(seg_logits, size, self.align_corners)


@MODELS.register_module()
class PSPHead(HeadBase):

    def __init__(self, *args, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.pool_scales = tuple(pool_scales)
        for scale in self.pool_scales:
            self.add_module(f'ppm{scale}', self._conv(self.in_width,
                                                      self.channels, 1))
        self.bottleneck = self._conv(
            self.in_width + len(self.pool_scales) * self.channels,
            self.channels, 3, padding=1)

    def forward(self, inputs, with_aux: bool = True):
        """The logits of the selected input; ``with_aux`` is the segmentor's
        flag and means nothing to a single-output head."""
        x = self._select(inputs)
        size = x.shape[-2:]
        feats = [x] + [resize_bilinear(
            getattr(self, f'ppm{s}')(adaptive_avg_pool2d(x, s)), size,
            self.align_corners) for s in self.pool_scales]
        return self.cls(self.bottleneck(torch.cat(feats, 1)))


@MODELS.register_module()
class ASPPHead(HeadBase):

    def __init__(self, *args, dilations: Sequence[int] = (1, 12, 24, 36),
                 separable: bool = False, c1_in_channels: int = 0,
                 c1_channels: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.dilations = tuple(dilations)
        self.c1_in_channels = c1_in_channels
        cin, ch = self.in_width, self.channels
        self.image_pool = self._conv(cin, ch, 1)
        for i, d in enumerate(self.dilations):
            if d == 1:
                branch = self._conv(cin, ch, 1)
            elif separable:
                branch = _SepConv(cin, ch, 3, dilation=d, norm_cfg=self.norm_cfg,
                                  act_cfg=self.act_cfg)
            else:
                branch = self._conv(cin, ch, 3, padding=d, dilation=d)
            self.add_module(f'aspp{i}', branch)
        self.bottleneck = self._conv(ch * (len(self.dilations) + 1), ch, 3,
                                     padding=1)
        if c1_in_channels > 0:
            self.c1_bottleneck = self._conv(c1_in_channels, c1_channels, 1)
            self.sep1 = _SepConv(ch + c1_channels, ch, 3,
                                 norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
            self.sep2 = _SepConv(ch, ch, 3, norm_cfg=self.norm_cfg,
                                 act_cfg=self.act_cfg)

    def forward(self, inputs, with_aux: bool = True):
        """The logits of the selected input (and, for DeepLabV3+, of the
        tuple's first map); ``with_aux`` means nothing here."""
        x = self._select(inputs)
        size = x.shape[-2:]
        feats = [resize_bilinear(self.image_pool(global_avg_pool(x)), size,
                                 self.align_corners)]
        feats += [getattr(self, f'aspp{i}')(x)
                  for i in range(len(self.dilations))]
        out = self.bottleneck(torch.cat(feats, 1))
        if self.c1_in_channels > 0 and isinstance(inputs, (list, tuple)):
            c1 = self.c1_bottleneck(inputs[0])
            out = resize_bilinear(out, c1.shape[-2:], self.align_corners)
            out = self.sep2(self.sep1(torch.cat([out, c1], 1)))
        return self.cls(out)


@MODELS.register_module()
class DepthwiseSeparableASPPHead(ASPPHead):
    """DeepLabV3+'s head: separable ASPP and the c1 skip (256 -> 48)."""

    def __init__(self, *args, separable: bool = True, c1_in_channels: int = 256,
                 c1_channels: int = 48, **kwargs):
        super().__init__(*args, separable=separable,
                         c1_in_channels=c1_in_channels,
                         c1_channels=c1_channels, **kwargs)
