"""Decode-head bricks: ``ClsSeg`` (dropout + 1x1 classifier), the loss
builder, the input and label selectors, and the single-tensor head's loss.

Counterpart of ``lednet_tpu/models/decode_heads/base.py`` (``build_losses``
:26, ``select_inputs`` :36, ``ClsSeg`` :52, ``resolve_out_channels`` :66,
``sem_label`` :81, ``default_loss_by_feat`` :90).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from lednet_tpu_torch.models.losses.cross_entropy import accuracy
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def build_losses(loss_decode) -> List[Any]:
    """Build the (possibly several) loss callables of a config."""
    if loss_decode is None:
        loss_decode = dict(type='CrossEntropyLoss', use_sigmoid=False,
                           loss_weight=1.0)
    if isinstance(loss_decode, (list, tuple)):
        return [MODELS.build(dict(c)) for c in loss_decode]
    return [MODELS.build(dict(loss_decode))]


def select_inputs(inputs, in_index, input_transform: Optional[str],
                  align_corners: bool = False):
    """A head's input from the backbone's outputs: ``inputs[in_index]``, a
    list of them (``'multiple_select'``), or them resized to the first one's
    size and concatenated (``'resize_concat'``)."""
    if input_transform == 'resize_concat':
        idx = in_index if isinstance(in_index, (list, tuple)) else [in_index]
        feats = [inputs[i] for i in idx]
        size = feats[0].shape[-2:]
        return torch.cat([resize_bilinear(f, size, align_corners)
                          for f in feats], 1)
    if input_transform == 'multiple_select':
        return [inputs[i] for i in in_index]
    if isinstance(inputs, (list, tuple)):
        return inputs[in_index]
    return inputs


def resolve_out_channels(num_classes: int, out_channels: Optional[int]) -> int:
    """The classifier's width: ``num_classes`` unless ``out_channels`` says
    otherwise.  The single-logit binary head (``out_channels=1``) is later
    work in the port."""
    if out_channels is None or out_channels == num_classes:
        return num_classes
    if num_classes == 2 and out_channels == 1:
        raise NotImplementedError('the single-logit binary head is later '
                                  'work in the port (ROADMAP Queue 1 item 6)')
    raise ValueError(f'out_channels={out_channels} incompatible with '
                     f'num_classes={num_classes}')


def sem_label(seg_label):
    """Labels may come as a dict that also carries auxiliary maps; the
    semantic map is ``gt_seg_map``."""
    if isinstance(seg_label, dict):
        return seg_label['gt_seg_map']
    return seg_label


class ClsSeg(nn.Module):
    """dropout + 1x1 classifier conv."""

    def __init__(self, channels: int, out_channels: int, dropout_ratio: float = 0.1):
        super().__init__()
        self.dropout = nn.Dropout(dropout_ratio) if dropout_ratio > 0 else nn.Identity()
        self.conv_seg = nn.Conv2d(channels, out_channels, 1)

    def forward(self, x):
        return self.conv_seg(self.dropout(x))


def default_loss_by_feat(seg_logits, seg_label, losses, align_corners: bool,
                         ignore_index: int) -> Dict[str, torch.Tensor]:
    """The loss of a single-tensor head: the logits resized to the label,
    every configured loss (same-named ones summed), ``acc_seg``."""
    seg_label = sem_label(seg_label)
    seg_logits = resize_bilinear(seg_logits, seg_label.shape[-2:], align_corners)
    out: Dict[str, torch.Tensor] = {}
    for loss_fn in losses:
        val = loss_fn(seg_logits, seg_label, ignore_index=ignore_index)
        out[loss_fn.loss_name] = out[loss_fn.loss_name] + val \
            if loss_fn.loss_name in out else val
    out['acc_seg'] = accuracy(seg_logits, seg_label, ignore_index)
    return out
