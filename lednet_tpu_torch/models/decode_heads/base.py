"""Decode-head bricks: ``ClsSeg`` (dropout + 1x1 classifier), the loss
builder and the label selector.

Counterpart of ``lednet_tpu/models/decode_heads/base.py`` (``build_losses``
:26, ``ClsSeg`` :52, ``sem_label`` :81).
"""
from __future__ import annotations

from typing import Any, List

import torch.nn as nn

from lednet_tpu_torch.registry import MODELS


def build_losses(loss_decode) -> List[Any]:
    """Build the (possibly several) loss callables of a config."""
    if loss_decode is None:
        loss_decode = dict(type='CrossEntropyLoss', use_sigmoid=False,
                           loss_weight=1.0)
    if isinstance(loss_decode, (list, tuple)):
        return [MODELS.build(dict(c)) for c in loss_decode]
    return [MODELS.build(dict(loss_decode))]


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
