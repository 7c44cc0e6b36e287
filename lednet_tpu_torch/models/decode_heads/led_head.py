"""LED-Net and DDRNet decode heads, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/led_head.py`` (``_BaseHead``
:33, ``_dual_losses`` :55, ``LEDHead`` :72, ``_refine`` :172,
``loss_by_feat`` :182, ``predict_by_feat`` :203, ``DDRHead`` :217).
``LEDHead``:

- ``head``: pre-act 3x3 ConvModule + BN + ReLU, then ``cls`` on the context
  feature; ``head_x1``/``head_x2``: the same base-head stack mapping the stem
  taps (in_channels/4 channels) straight to class logits at 1/2 and 1/4;
- predict: the progressive pyramid (context logit upsampled to ceil(size/4)
  + head_x2, to ceil(size/2) + head_x1, then to size);
- training (``loss_by_feat``): the same pyramid at the exact ``//`` sizes
  for the context and the spatial logit; ``loss_context`` = losses[0],
  ``loss_spatial`` = losses[1], ``acc_seg`` on the refined context logit.

The packed ``_base_head_packed`` of the JAX package is a TPU layout rewrite
and is not carried over; the port runs the plain ``head_x1`` path.

``DDRHead`` (upstream mmseg's contract, which the JAX package restores):
``head`` + ``cls`` on the final feature; in training also ``aux_head`` +
``aux_cls_seg`` on ``temp_context``; ``loss_context`` (losses[0]) and
``loss_spatial`` (losses[1]) on the logits resized to the label, ``acc_seg``
on the context logit; predict resizes the context logit to ``size``
(8x its own when omitted).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.nn as nn

from lednet_tpu_torch.models.decode_heads.base import (ClsSeg, build_losses,
                                                       resolve_out_channels,
                                                       sem_label)
from lednet_tpu_torch.models.layers import ConvModule, Norm2d, build_activation
from lednet_tpu_torch.models.losses.cross_entropy import accuracy
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class _BaseHead(nn.Module):
    """BN -> act -> 3x3 conv -> BN -> act (ReLU unless ``act_cfg`` says
    otherwise)."""

    def __init__(self, in_channels: int, channels: int,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        self.conv = ConvModule(in_channels, channels, 3, padding=1,
                               norm_cfg=norm_cfg, act_cfg=act_cfg,
                               order=('norm', 'act', 'conv'))
        self.norm = Norm2d(norm_cfg, channels)
        self.act = build_activation(act_cfg)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _dual_losses(loss_decode):
    """The (context, spatial) losses; the config contract's OHEM pair
    (weights 1.0 / 0.4) when unset, one loss used for both."""
    if loss_decode is None:
        loss_decode = [
            dict(type='OhemCrossEntropy', thres=0.9, min_kept=131072,
                 loss_weight=1.0),
            dict(type='OhemCrossEntropy', thres=0.9, min_kept=131072,
                 loss_weight=0.4),
        ]
    losses = build_losses(loss_decode)
    if len(losses) == 1:
        losses = losses * 2
    return losses


@MODELS.register_module()
class LEDHead(nn.Module):

    def __init__(self, in_channels: int, channels: int, num_classes: int,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 align_corners: bool = False, ignore_index: int = 255,
                 loss_decode: Optional[Sequence[Dict]] = None):
        super().__init__()
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.losses = _dual_losses(loss_decode)
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

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        """Training losses of (context, spatial, head_x1, head_x2) logits
        against (B, H, W) labels (or a dict with ``gt_seg_map``)."""
        seg_label = sem_label(seg_label)
        context_logit, spatial_logit, head_x1, head_x2 = seg_logits
        size = tuple(seg_label.shape[-2:])
        # training uses exact // sizes (labels are crops of even size)
        quarter = (size[0] // 4, size[1] // 4)
        half = (size[0] // 2, size[1] // 2)
        refined = []
        for logit in (context_logit, spatial_logit):
            logit = head_x2 + resize_bilinear(logit, quarter, self.align_corners)
            logit = head_x1 + resize_bilinear(logit, half, self.align_corners)
            refined.append(resize_bilinear(logit, size, self.align_corners))
        ctx, spa = refined
        return {
            'loss_context': self.losses[0](ctx, seg_label,
                                           ignore_index=self.ignore_index),
            'loss_spatial': self.losses[1](spa, seg_label,
                                           ignore_index=self.ignore_index),
            'acc_seg': accuracy(ctx, seg_label, self.ignore_index),
        }

    def predict_by_feat(self, seg_logits, size=None):
        x_c, head_x1, head_x2 = seg_logits
        if size is None:
            size = (head_x1.shape[-2] * 2, head_x1.shape[-1] * 2)
        return self._refine(x_c, head_x1, head_x2, size)


@MODELS.register_module()
class DDRHead(nn.Module):

    def __init__(self, in_channels: int, channels: int, num_classes: int,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255, out_channels: Optional[int] = None,
                 loss_decode: Optional[Sequence[Dict]] = None,
                 in_index: int = -1, init_cfg: Optional[Dict] = None):
        super().__init__()
        out_ch = resolve_out_channels(num_classes, out_channels)
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.losses = _dual_losses(loss_decode)
        self.head = _BaseHead(in_channels, channels, norm_cfg)
        self.cls = ClsSeg(channels, out_ch, dropout_ratio)
        self.aux_head = _BaseHead(in_channels // 2, channels, norm_cfg)
        self.aux_cls_seg = nn.Conv2d(channels, out_ch, 1)

    def forward(self, inputs, with_aux: bool = True):
        """inputs = (temp_context, final) or the final feature alone; the
        context logit, with the spatial (aux) logit when ``with_aux`` and
        ``temp_context`` is given."""
        if isinstance(inputs, (tuple, list)):
            c3_feat, c5_feat = inputs[0], inputs[1]
        else:
            c3_feat, c5_feat = None, inputs
        x_c = self.cls(self.head(c5_feat))
        if with_aux and c3_feat is not None:
            return x_c, self.aux_cls_seg(self.aux_head(c3_feat))
        return x_c

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        seg_label = sem_label(seg_label)
        size = tuple(seg_label.shape[-2:])
        ctx, spa = (resize_bilinear(t, size, self.align_corners)
                    for t in seg_logits)
        return {
            'loss_context': self.losses[0](ctx, seg_label,
                                           ignore_index=self.ignore_index),
            'loss_spatial': self.losses[1](spa, seg_label,
                                           ignore_index=self.ignore_index),
            'acc_seg': accuracy(ctx, seg_label, self.ignore_index),
        }

    def predict_by_feat(self, seg_logits, size=None):
        logit = seg_logits[0] if isinstance(seg_logits, (tuple, list)) else seg_logits
        if size is None:
            size = (logit.shape[-2] * 8, logit.shape[-1] * 8)
        return resize_bilinear(logit, size, self.align_corners)
