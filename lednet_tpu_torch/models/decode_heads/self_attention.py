"""The general ``SelfAttentionBlock`` of the attention heads, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/context_heads.py:33-116``
(mmseg's ``models/utils/self_attention_block.py``):

- queries from ``query_feats`` and keys from ``key_feats`` through
  ``key_query_num_convs`` 1x1 projections each (``query_project{i}``,
  ``key_project{i}``): ConvModules with norm and activation where
  ``key_query_norm``, else plain convs with a bias; with
  ``share_key_query`` the keys go through the query projections and there
  are no ``key_project{i}``;
- values from ``key_feats`` through ``value_out_num_convs`` projections
  (``value_project{i}``, normed where ``value_out_norm``), to ``channels``
  where ``with_out``, else to ``out_channels``;
- with ``key_pool_scales`` (ANN's ``PPMConcat``), the projected keys and
  values are average-pooled to each scale and the pools' positions
  concatenated, row-major, as the key tokens;
- the scores in float32 (float64 for a float64 map), times
  ``channels ** -0.5`` where ``matmul_norm``, a softmax over the keys, the
  probabilities cast to the values' type, the values' weighted sum; then
  the ``out_project{i}`` projections where ``with_out``.

OCR's object context, ANN's fusion and pyramid blocks and ISA's two
relations run it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for a float64 map: the attention's sums."""
    return torch.promote_types(dtype, torch.float32)


def plain_conv(in_channels: int, out_channels: int,
               bias: bool = True) -> nn.Conv2d:
    """A bare 1x1 conv, initialised as flax's ``nn.Conv`` is (LeCun
    normal)."""
    conv = nn.Conv2d(in_channels, out_channels, 1, bias=bias)
    conv.lecun_init = True
    return conv


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
        self.channels = channels
        self.matmul_norm = matmul_norm
        self.with_out = with_out
        self.share_key_query = share_key_query
        self.key_pool_scales = (tuple(key_pool_scales)
                                if key_pool_scales is not None else None)
        self.value_channels = channels if with_out else out_channels

        def project(name, cin, cout, n, normed):
            for i in range(n):
                ic = cin if i == 0 else cout
                self.add_module(f'{name}{i}', ConvModule(
                    ic, cout, 1, norm_cfg=norm_cfg, act_cfg=act_cfg)
                    if normed else plain_conv(ic, cout))
        self.n_kq, self.n_vo = key_query_num_convs, value_out_num_convs
        project('query_project', query_in_channels, channels,
                key_query_num_convs, key_query_norm)
        if not share_key_query:
            project('key_project', key_in_channels, channels,
                    key_query_num_convs, key_query_norm)
        project('value_project', key_in_channels, self.value_channels,
                value_out_num_convs, value_out_norm)
        if with_out:
            project('out_project', self.value_channels, out_channels,
                    value_out_num_convs, value_out_norm)

    def _project(self, name, n, x):
        for i in range(n):
            x = getattr(self, f'{name}{i}')(x)
        return x

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, h, w) -> (B, C, tokens): the positions, or the pools'."""
        if self.key_pool_scales is None:
            return x.flatten(2)
        return torch.cat([adaptive_avg_pool2d(x, s).flatten(2)
                          for s in self.key_pool_scales], 2)

    def forward(self, query_feats: torch.Tensor,
                key_feats: torch.Tensor) -> torch.Tensor:
        """(B, Cq, H, W) queries, (B, Ck, h, w) keys -> (B, out, H, W)."""
        B, _, H, W = query_feats.shape
        q = self._project('query_project', self.n_kq, query_feats)
        k = self._project('query_project' if self.share_key_query
                          else 'key_project', self.n_kq, key_feats)
        v = self._tokens(self._project('value_project', self.n_vo, key_feats))
        acc = acc_dtype(q.dtype)
        sim = torch.matmul(q.flatten(2).transpose(1, 2).to(acc),
                           self._tokens(k).to(acc))          # (B, HW, keys)
        if self.matmul_norm:
            sim = sim * self.channels ** -0.5
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        ctx = torch.matmul(v, attn.transpose(1, 2))          # (B, Cv, HW)
        ctx = ctx.reshape(B, self.value_channels, H, W)
        if self.with_out:
            ctx = self._project('out_project', self.n_vo, ctx)
        return ctx
