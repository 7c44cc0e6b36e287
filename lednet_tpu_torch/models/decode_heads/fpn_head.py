"""The semantic FPN's decode head, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/fpn_sct_heads.py:47``
(``FPNHead``): per selected level of stride ``s``, ``max(1, log2(s /
base))`` 3x3 ``scale{i}_conv{k}`` (norm, activation), each followed by a
bilinear x2 upsample unless ``s`` is the base (first) stride; the levels
summed, each resized to the first's size; ``cls``.  A
``dropout_ratio`` of 0 or less (PointRend's -1) means no dropout.
"""
from __future__ import annotations

import math
from typing import Sequence

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class FPNHead(HeadBase):
    takes_list = True

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256, 256),
                 channels: int = 128, num_classes: int = 19,
                 feature_strides: Sequence[int] = (4, 8, 16, 32),
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(in_channels, channels, num_classes, in_index=in_index,
                         input_transform=input_transform, **kwargs)
        if len(feature_strides) != len(in_channels):
            raise ValueError(f'FPNHead: {len(feature_strides)} strides for '
                             f'{len(in_channels)} levels')
        self.feature_strides = tuple(feature_strides)
        base = self.feature_strides[0]
        self.lengths = []
        for i, stride in enumerate(self.feature_strides):
            n = max(1, int(math.log2(stride) - math.log2(base)))
            self.lengths.append(n)
            for k in range(n):
                self.add_module(f'scale{i}_conv{k}', self._conv(
                    in_channels[i] if k == 0 else channels, channels, 3,
                    padding=1))

    def forward(self, inputs, with_aux: bool = True):
        """The logits at the first level's size; ``with_aux`` means nothing
        to a single-output head."""
        xs = self._select(inputs)
        base = self.feature_strides[0]
        output = None
        for i, (stride, n) in enumerate(zip(self.feature_strides, self.lengths)):
            t = xs[i]
            for k in range(n):
                t = getattr(self, f'scale{i}_conv{k}')(t)
                if stride != base:
                    t = resize_bilinear(t, (t.shape[-2] * 2, t.shape[-1] * 2),
                                        self.align_corners)
            output = t if output is None else output + resize_bilinear(
                t, output.shape[-2:], self.align_corners)
        return self.cls(output)
