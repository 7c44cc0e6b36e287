"""PIDNet decode head, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/pid_head.py:27``: three
pre-activation base heads (``_BaseHead``) with 1x1 classifiers, ``i_head``
+ ``cls_seg`` on the fused feature (behind dropout), ``p_head`` +
``p_cls_seg`` on ``temp_p`` and ``d_head`` + ``d_cls_seg`` (one boundary
logit) on ``temp_d``.  Without ``with_aux``, or given the fused feature
alone, it returns the I logit only.

``loss_by_feat`` resizes the three logits to the label (bilinear with the
head's ``align_corners``) and returns ``loss_sem_p`` (losses[0] on P),
``loss_sem_i`` (losses[1] on I) and, given a ``gt_edge_map`` and four
losses, ``loss_bd`` (losses[2], the boundary loss on D) and
``loss_sem_bd`` (losses[3] on I against the label kept where
``sigmoid(d) > 0.8`` and ignored elsewhere, :meth:`PIDHead.boundary_gate`),
with ``acc_seg`` on I.  ``predict_by_feat`` resizes the I logit to ``size``
(8x its own when omitted).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.decode_heads.base import (build_losses,
                                                       resolve_out_channels)
from lednet_tpu_torch.models.decode_heads.led_head import _BaseHead
from lednet_tpu_torch.models.losses.cross_entropy import accuracy
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

BOUNDARY_THRESHOLD = 0.8     # sigmoid(d) above it keeps a pixel's label


@MODELS.register_module()
class PIDHead(nn.Module):

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
        self.losses = build_losses(loss_decode)
        self.i_head = _BaseHead(in_channels, channels, norm_cfg, act_cfg)
        self.dropout = (nn.Dropout(dropout_ratio) if dropout_ratio > 0
                        else nn.Identity())
        self.cls_seg = nn.Conv2d(channels, out_ch, 1)
        self.p_head = _BaseHead(in_channels // 2, channels, norm_cfg, act_cfg)
        self.p_cls_seg = nn.Conv2d(channels, out_ch, 1)
        self.d_head = _BaseHead(in_channels // 2, in_channels // 4, norm_cfg,
                                act_cfg)
        self.d_cls_seg = nn.Conv2d(in_channels // 4, 1, 1)

    def forward(self, inputs, with_aux: bool = True):
        """inputs = (temp_p, fused, temp_d), or the fused feature (alone or
        second of a pair): (p_logit, i_logit, d_logit) with ``with_aux`` and
        all three maps, else the I logit."""
        if isinstance(inputs, (tuple, list)) and len(inputs) == 3:
            x_p, x_i, x_d = inputs
        else:
            x_p = x_d = None
            x_i = inputs[1] if isinstance(inputs, (tuple, list)) else inputs
        i_logit = self.cls_seg(self.dropout(self.i_head(x_i)))
        if not (with_aux and x_p is not None):
            return i_logit
        p_logit = self.p_cls_seg(self.p_head(x_p))
        d_logit = self.d_cls_seg(self.d_head(x_d))
        return p_logit, i_logit, d_logit

    def boundary_gate(self, d_logit: torch.Tensor) -> torch.Tensor:
        """(B, H, W) pixels whose boundary probability passes the gate."""
        return torch.sigmoid(d_logit[:, 0]) > BOUNDARY_THRESHOLD

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        p_logit, i_logit, d_logit = seg_logits
        if isinstance(seg_label, dict):
            sem_label = seg_label['gt_seg_map']
            bd_label = seg_label.get('gt_edge_map')
        else:
            sem_label, bd_label = seg_label, None
        size = sem_label.shape[-2:]
        p_logit, i_logit, d_logit = (resize_bilinear(t, size, self.align_corners)
                                     for t in (p_logit, i_logit, d_logit))
        out = {
            'loss_sem_p': self.losses[0](p_logit, sem_label,
                                         ignore_index=self.ignore_index),
            'loss_sem_i': self.losses[1](i_logit, sem_label),
        }
        if bd_label is not None and len(self.losses) >= 4:
            out['loss_bd'] = self.losses[2](d_logit, bd_label)
            sem_bd_label = torch.where(self.boundary_gate(d_logit), sem_label,
                                       self.ignore_index)
            out['loss_sem_bd'] = self.losses[3](i_logit, sem_bd_label)
        out['acc_seg'] = accuracy(i_logit, sem_label, self.ignore_index)
        return out

    def predict_by_feat(self, seg_logits, size=None):
        if size is None:
            size = (seg_logits.shape[-2] * 8, seg_logits.shape[-1] * 8)
        return resize_bilinear(seg_logits, size, self.align_corners)
