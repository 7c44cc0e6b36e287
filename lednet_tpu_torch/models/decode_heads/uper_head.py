"""UPerHead (a pyramid pooling module on the deepest level and an FPN over
the others), NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/uper_ocr.py:33-80``: the
levels selected by ``in_index`` (``'multiple_select'``); on the deepest,
``ppm{s}`` (a 1x1 ConvModule of its adaptive average pool at each of
``pool_scales``, torch's floor/ceil bins, resized back), concatenated
after the map itself, through the 3x3 ``psp_bottleneck``; ``lateral{i}``
(1x1) of the others; top-down, each lateral plus the one above resized to
its size; ``fpn{i}`` (3x3) of each but the deepest; all resized to the
finest and concatenated, finest first; the 3x3 ``fpn_bottleneck``;
``cls``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class UPerHead(HeadBase):
    takes_list = True

    def __init__(self, *args, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(*args, in_index=in_index,
                         input_transform=input_transform, **kwargs)
        widths, ch = list(self.in_channels), self.channels
        self.pool_scales = tuple(pool_scales)
        self.levels = len(widths)
        for s in self.pool_scales:
            self.add_module(f'ppm{s}', self._conv(widths[-1], ch, 1))
        self.psp_bottleneck = self._conv(
            widths[-1] + len(self.pool_scales) * ch, ch, 3, padding=1)
        for i, w in enumerate(widths[:-1]):
            self.add_module(f'lateral{i}', self._conv(w, ch, 1))
            self.add_module(f'fpn{i}', self._conv(ch, ch, 3, padding=1))
        self.fpn_bottleneck = self._conv(self.levels * ch, ch, 3, padding=1)

    def forward(self, inputs, with_aux: bool = True):
        """The logits at the finest selected level; ``with_aux`` means
        nothing to a single-output head."""
        xs = self._select(inputs)
        deep = xs[-1]
        size = deep.shape[-2:]
        psp = [deep] + [resize_bilinear(
            getattr(self, f'ppm{s}')(adaptive_avg_pool2d(deep, s)), size,
            self.align_corners) for s in self.pool_scales]
        laterals = [getattr(self, f'lateral{i}')(x)
                    for i, x in enumerate(xs[:-1])]
        laterals.append(self.psp_bottleneck(torch.cat(psp, 1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[-2:], self.align_corners)
        outs = [getattr(self, f'fpn{i}')(laterals[i])
                for i in range(len(laterals) - 1)] + [laterals[-1]]
        top = outs[0].shape[-2:]
        outs = [resize_bilinear(o, top, self.align_corners) for o in outs]
        return self.cls(self.fpn_bottleneck(torch.cat(outs, 1)))
