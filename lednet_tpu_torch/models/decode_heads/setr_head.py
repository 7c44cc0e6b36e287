"""SETR's decode heads, NCHW: ``SETRUPHead`` (naive and progressive
upsampling) and ``SETRMLAHead`` (multi-level aggregation).

Counterpart of ``lednet_tpu/models/decode_heads/context_heads.py:591``
(``SETRUPHead``) and ``point_setr_heads.py:311`` (``SETRMLAHead``):

- ``SETRUPHead``: the selected ViT grid through a LayerNorm over the
  channels (``ln``, flax's eps 1e-6), then ``num_convs`` stages, each a
  ``conv{i}`` (``kernel_size``, padding ``kernel_size // 2``, norm and
  activation) and a bilinear upsample by ``up_scale``; ``cls``.  SETR's
  naive head is one 1x1 stage at x4, PUP's four 3x3 stages at x2, their
  auxiliary heads one stage at x4;
- ``SETRMLAHead``: per selected level two 3x3 ``ConvModule``s
  (``conv{i}a`` / ``conv{i}b``, to ``mla_channels``) and a bilinear
  upsample by ``up_scale``; the levels concatenated in order; ``cls`` over
  ``len(in_index) * mla_channels`` channels (the JAX head infers that
  width; ``channels`` is not read).  The per-level LayerNorm is
  ``MLANeck``'s.
"""
from __future__ import annotations

from typing import Sequence

import torch

from lednet_tpu_torch.models.decode_heads.base import ClsSeg
from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.layers import LayerNorm2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def upsample(x: torch.Tensor, scale: int, align_corners: bool) -> torch.Tensor:
    """``x`` resized bilinearly to ``scale`` times its height and width."""
    return resize_bilinear(x, (x.shape[-2] * scale, x.shape[-1] * scale),
                           align_corners)


@MODELS.register_module()
class SETRUPHead(HeadBase):

    def __init__(self, *args, num_convs: int = 1, up_scale: int = 4,
                 kernel_size: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_convs = num_convs
        self.up_scale = up_scale
        self.ln = LayerNorm2d(self.in_width, eps=1e-6)
        for i in range(num_convs):
            self.add_module(f'conv{i}', self._conv(
                self.in_width if i == 0 else self.channels, self.channels,
                kernel_size, padding=kernel_size // 2))

    def forward(self, inputs, with_aux: bool = True):
        """The logits at ``up_scale ** num_convs`` times the grid;
        ``with_aux`` means nothing to a single-output head."""
        x = self.ln(self._select(inputs))
        for i in range(self.num_convs):
            x = upsample(getattr(self, f'conv{i}')(x), self.up_scale,
                         self.align_corners)
        return self.cls(x)


@MODELS.register_module()
class SETRMLAHead(HeadBase):
    takes_list = True
    classifier = False

    def __init__(self, *args, mla_channels: int = 128, up_scale: int = 4,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select',
                 dropout_ratio: float = 0.1, **kwargs):
        super().__init__(*args, in_index=in_index,
                         input_transform=input_transform,
                         dropout_ratio=dropout_ratio, **kwargs)
        self.up_scale = up_scale
        for i, w in enumerate(list(self.in_channels)[:len(in_index)]):
            self.add_module(f'conv{i}a', self._conv(w, mla_channels, 3,
                                                    padding=1))
            self.add_module(f'conv{i}b', self._conv(mla_channels, mla_channels,
                                                    3, padding=1))
        self.cls = ClsSeg(len(in_index) * mla_channels, self.n_out,
                          dropout_ratio)

    def forward(self, inputs, with_aux: bool = True):
        """The logits at ``up_scale`` times the selected levels' size."""
        outs = []
        for i, x in enumerate(self._select(inputs)):
            x = getattr(self, f'conv{i}b')(getattr(self, f'conv{i}a')(x))
            outs.append(upsample(x, self.up_scale, self.align_corners))
        return self.cls(torch.cat(outs, 1))
