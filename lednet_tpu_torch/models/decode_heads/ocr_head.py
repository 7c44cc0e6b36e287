"""OCRHead (object-contextual representations, the cascade's second stage)
and the ``SelfAttentionBlock`` it runs, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/uper_ocr.py:83-135``
(``OCRHead``) and ``lednet_tpu/models/decode_heads/context_heads.py:33-116``
(``SelfAttentionBlock``), in the form OCR uses:

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

Options no ported config sets raise ``NotImplementedError``: the block's
``key_pool_scales``, ``share_key_query`` and plain (un-normed)
projections, and OCRHead's ``scale != 1``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def _acc(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for a float64 map: the attention's sums."""
    return torch.promote_types(dtype, torch.float32)


class SelfAttentionBlock(nn.Module):

    def __init__(self, key_in_channels: int, query_in_channels: int,
                 channels: int, out_channels: int,
                 share_key_query: bool = False, key_query_num_convs: int = 1,
                 key_query_norm: bool = False, value_out_num_convs: int = 1,
                 value_out_norm: bool = False, matmul_norm: bool = False,
                 with_out: bool = False,
                 key_pool_scales: Optional[Sequence[int]] = None,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None):
        super().__init__()
        for name, unported in (('share_key_query', share_key_query),
                               ('key_pool_scales', key_pool_scales is not None),
                               ('key_query_norm=False', not key_query_norm),
                               ('value_out_norm=False', not value_out_norm)):
            if unported:
                raise NotImplementedError(f'SelfAttentionBlock {name} is not '
                                          'ported (OCRHead sets none of it)')
        self.channels = channels
        self.matmul_norm = matmul_norm
        self.with_out = with_out
        self.value_channels = channels if with_out else out_channels

        def project(name, cin, cout, n):
            for i in range(n):
                self.add_module(f'{name}{i}', ConvModule(
                    cin if i == 0 else cout, cout, 1, norm_cfg=norm_cfg,
                    act_cfg=act_cfg))
        self.n_kq, self.n_vo = key_query_num_convs, value_out_num_convs
        project('query_project', query_in_channels, channels,
                key_query_num_convs)
        project('key_project', key_in_channels, channels, key_query_num_convs)
        project('value_project', key_in_channels, self.value_channels,
                value_out_num_convs)
        if with_out:
            project('out_project', self.value_channels, out_channels,
                    value_out_num_convs)

    def _project(self, name, n, x):
        for i in range(n):
            x = getattr(self, f'{name}{i}')(x)
        return x

    def forward(self, query_feats: torch.Tensor,
                key_feats: torch.Tensor) -> torch.Tensor:
        """(B, Cq, H, W) queries, (B, Ck, h, w) keys -> (B, out, H, W)."""
        B, _, H, W = query_feats.shape
        q = self._project('query_project', self.n_kq, query_feats)
        k = self._project('key_project', self.n_kq, key_feats)
        v = self._project('value_project', self.n_vo, key_feats)
        acc = _acc(q.dtype)
        sim = torch.matmul(q.flatten(2).transpose(1, 2).to(acc),
                           k.flatten(2).to(acc))              # (B, HW, hw)
        if self.matmul_norm:
            sim = sim * self.channels ** -0.5
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        ctx = torch.matmul(v.flatten(2), attn.transpose(1, 2))  # (B, Cv, HW)
        ctx = ctx.reshape(B, self.value_channels, H, W)
        if self.with_out:
            ctx = self._project('out_project', self.n_vo, ctx)
        return ctx


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
        acc = _acc(feats.dtype)
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
