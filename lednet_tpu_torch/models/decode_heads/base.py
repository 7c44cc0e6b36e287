"""Decode-head bricks: ``ClsSeg`` (dropout + 1x1 classifier).
Counterpart of ``lednet_tpu/models/decode_heads/base.py`` :52."""
from __future__ import annotations

import torch.nn as nn


class ClsSeg(nn.Module):
    """dropout + 1x1 classifier conv."""

    def __init__(self, channels: int, out_channels: int, dropout_ratio: float = 0.1):
        super().__init__()
        self.dropout = nn.Dropout(dropout_ratio) if dropout_ratio > 0 else nn.Identity()
        self.conv_seg = nn.Conv2d(channels, out_channels, 1)

    def forward(self, x):
        return self.conv_seg(self.dropout(x))
