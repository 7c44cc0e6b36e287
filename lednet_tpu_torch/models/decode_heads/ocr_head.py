"""OCRHead (object-contextual representations, the cascade's second stage),
NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/uper_ocr.py:83-135``,
with the ``SelfAttentionBlock`` of ``self_attention.py`` in the form OCR
uses:

- ``bottleneck``: a 3x3 ConvModule of the selected input to ``channels``;
- the spatial gather: the previous stage's logits (zeros where there is
  none; resized only where their size differs), a softmax over the H*W
  pixels of each class, in float32, weighs the pixel features into K
  region descriptors, laid out (B, C, K, 1) so that the key and value
  ConvModules BatchNorm a K x 1 map;
- ``object_context``: queries from the pixels and keys from the regions
  through ``key_query_num_convs`` normed 1x1 ConvModules each
  (``query_project{i}``, ``key_project{i}``), values through normed
  ``value_project{i}``, the product scaled by ``channels ** -0.5``
  (``matmul_norm``), a float32 softmax over the keys, then the normed
  ``out_project{i}`` (``with_out``);
- ``project``: a 1x1 ConvModule of ``cat([context, bottleneck])``; ``cls``.

``scale != 1``, which no ported config sets, raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.decode_heads.self_attention import (
    SelfAttentionBlock, acc_dtype)
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class OCRHead(HeadBase):

    def __init__(self, *args, num_classes: int, ocr_channels: int = 256,
                 scale: int = 1, **kwargs):
        if scale != 1:
            raise NotImplementedError(f'OCRHead scale={scale} is not ported '
                                      '(the ported configs keep 1)')
        super().__init__(*args, num_classes=num_classes, **kwargs)
        self.num_classes = num_classes
        self.bottleneck = self._conv(self.in_width, self.channels, 3, padding=1)
        self.object_context = SelfAttentionBlock(
            self.channels, self.channels, ocr_channels, self.channels,
            key_query_num_convs=2, key_query_norm=True, value_out_num_convs=1,
            value_out_norm=True, matmul_norm=True, with_out=True,
            norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.project = self._conv(2 * self.channels, self.channels, 1)

    def regions(self, feats: torch.Tensor, prev_output: torch.Tensor):
        """The spatial gather: (B, C, K, 1) region descriptors, each the
        pixels' features weighted by a softmax of one class's logits over
        the pixels."""
        B, C, H, W = feats.shape
        acc = acc_dtype(feats.dtype)
        probs = prev_output.to(acc)
        if tuple(probs.shape[-2:]) != (H, W):
            probs = resize_bilinear(probs, (H, W), self.align_corners)
        weights = torch.softmax(probs.flatten(2), dim=-1)         # (B, K, HW)
        regions = torch.matmul(weights, feats.flatten(2).transpose(1, 2).to(acc))
        return regions.to(feats.dtype).transpose(1, 2).unsqueeze(-1)

    def forward(self, inputs, prev_output=None, with_aux: bool = True):
        """The logits of the selected input given the previous stage's
        logits ``prev_output`` (zeros where None, as in the JAX package)."""
        feats = self.bottleneck(self._select(inputs))
        if prev_output is None:
            prev_output = feats.new_zeros((feats.shape[0], self.num_classes)
                                          + tuple(feats.shape[-2:]))
        ctx = self.object_context(feats, self.regions(feats, prev_output))
        return self.cls(self.project(torch.cat([ctx, feats], 1)))
