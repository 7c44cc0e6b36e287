"""LED-Net decode head, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/led_head.py`` (``_BaseHead``
:33, ``LEDHead`` :72, ``_refine`` :172, ``predict_by_feat`` :203):

- ``head``: pre-act 3x3 ConvModule + BN + ReLU, then ``cls`` on the context
  feature; ``head_x1``/``head_x2``: the same base-head stack mapping the stem
  taps (in_channels/4 channels) straight to class logits at 1/2 and 1/4;
- predict: the progressive pyramid (context logit upsampled to ceil(size/4)
  + head_x2, to ceil(size/2) + head_x1, then to size).

The packed ``_base_head_packed`` of the JAX package is a TPU layout rewrite
and is not carried over; the port runs the plain ``head_x1`` path.  The
training losses (``loss_by_feat``) are later work.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.base import ClsSeg
from lednet_tpu_torch.models.layers import ConvModule, Norm2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class _BaseHead(nn.Module):
    """BN -> ReLU -> 3x3 conv -> BN -> ReLU."""

    def __init__(self, in_channels: int, channels: int,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.conv = ConvModule(in_channels, channels, 3, padding=1,
                               norm_cfg=norm_cfg, act_cfg=dict(type='ReLU'),
                               order=('norm', 'act', 'conv'))
        self.norm = Norm2d(norm_cfg, channels)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@MODELS.register_module()
class LEDHead(nn.Module):

    def __init__(self, in_channels: int, channels: int, num_classes: int,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 align_corners: bool = False,
                 loss_decode: Optional[Sequence[Dict]] = None):
        super().__init__()
        self.align_corners = align_corners
        self.loss_decode = loss_decode      # read by training (later work)
        stem_channels = in_channels // 4    # LEDNet's x1/x2 taps: c of its 4c
        self.head = _BaseHead(in_channels, channels, norm_cfg)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)
        self.head_x1 = _BaseHead(stem_channels, num_classes, norm_cfg)
        self.head_x2 = _BaseHead(stem_channels, num_classes, norm_cfg)
        self.aux_head = _BaseHead(in_channels // 2, channels, norm_cfg)
        self.aux_cls_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs, with_aux: bool = True):
        """inputs = (c3_feat, c5_feat, x1, x2), or (c5_feat, x1, x2)."""
        if len(inputs) == 4:
            c3_feat, c5_feat, x1, x2 = inputs
        else:
            c5_feat, x1, x2 = inputs
            c3_feat = None
        x_c = self.cls(self.head(c5_feat))
        head_x1 = self.head_x1(x1)
        head_x2 = self.head_x2(x2)
        if with_aux and c3_feat is not None:
            x_s = self.aux_cls_seg(self.aux_head(c3_feat))
            return x_c, x_s, head_x1, head_x2
        return x_c, head_x1, head_x2

    def _refine(self, logit, head_x1, head_x2, size):
        """Progressive pyramid: +x2 at 1/4, +x1 at 1/2, upsample to size."""
        logit = head_x2 + resize_bilinear(
            logit, (_ceil_div(size[0], 4), _ceil_div(size[1], 4)),
            self.align_corners)
        logit = head_x1 + resize_bilinear(
            logit, (_ceil_div(size[0], 2), _ceil_div(size[1], 2)),
            self.align_corners)
        return resize_bilinear(logit, size, self.align_corners)

    def predict_by_feat(self, seg_logits, size=None):
        x_c, head_x1, head_x2 = seg_logits
        if size is None:
            size = (head_x1.shape[-2] * 2, head_x1.shape[-1] * 2)
        return self._refine(x_c, head_x1, head_x2, size)
