"""SegformerHead (SegFormer's all-MLP decoder), NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/psp_aspp.py:180-205``: the
levels selected by ``in_index`` (``'multiple_select'``), each through a 1x1
ConvModule ``conv{i}`` to ``channels`` and resized (bilinear) to the first
level's size, concatenated in level order, the 1x1 ``fusion_conv``,
``cls``.  ``interpolate_mode`` is accepted and, as in the JAX package,
bilinear is used.
"""
from __future__ import annotations

import torch

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class SegformerHead(HeadBase):
    takes_list = True

    def __init__(self, *args, interpolate_mode: str = 'bilinear',
                 in_index=(0, 1, 2, 3), input_transform: str = 'multiple_select',
                 **kwargs):
        super().__init__(*args, in_index=in_index,
                         input_transform=input_transform, **kwargs)
        widths = list(self.in_channels)
        for i, w in enumerate(widths):
            self.add_module(f'conv{i}', self._conv(w, self.channels, 1))
        self.levels = len(widths)
        self.fusion_conv = self._conv(self.levels * self.channels,
                                      self.channels, 1)

    def forward(self, inputs, with_aux: bool = True):
        """The logits at the first selected level's size; ``with_aux`` means
        nothing to a single-output head."""
        xs = self._select(inputs)
        size = xs[0].shape[-2:]
        outs = [resize_bilinear(getattr(self, f'conv{i}')(x), size,
                                self.align_corners) for i, x in enumerate(xs)]
        return self.cls(self.fusion_conv(torch.cat(outs, 1)))
