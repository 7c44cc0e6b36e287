"""Segmenter's mask transformer head, NCHW in, (B, classes, h, w) masks out.

Counterpart of ``lednet_tpu/models/decode_heads/point_setr_heads.py:454``
(``SegmenterMaskTransformerHead``):

- the selected ViT grid's tokens through ``proj_input`` (a Linear to
  ``embed_dims``), the learned class embeddings ``cls_emb`` (1, classes,
  d) appended after the patch tokens;
- ``num_layers`` pre-LN blocks ``b{i}_*`` built as the ViT's (``norm1``,
  ``attn`` with its attention and projection dropout, a residual,
  ``norm2``, ``fc1``, exact GELU, ``fc2``, a residual; no dropout in the
  MLP), stochastic depth at ``drop_path_rate * i / (num_layers - 1)`` on
  both branches.  The class default ``drop_path_rate`` is 0.1, and the
  shipped config does not set it;
- ``norm_out``; the patch tokens through ``patch_proj`` and the class
  tokens through ``cls_proj`` (no bias), each L2-normalised by
  ``max(norm, 1e-12)``; the masks are their dot products, through
  ``mask_norm`` (a LayerNorm over the classes).

Every LayerNorm is flax's (eps 1e-6).  The masks are the logits: the
head has no ``cls`` (``HeadBase.classifier`` False); ``dropout_ratio`` is
accepted and, as in the JAX head, never read.  Its loss and prediction
are the single-logit head's.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.backbones.mit import LN_EPS
from lednet_tpu_torch.models.backbones.vit import _MHSA, maybe_apply
from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.layers import DropPath, drop_path_rates
from lednet_tpu_torch.registry import MODELS


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(||x||, 1e-12)`` over the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp(min=1e-12)


@MODELS.register_module()
class SegmenterMaskTransformerHead(HeadBase):
    classifier = False

    def __init__(self, *args, num_layers: int = 2, num_heads: int = 6,
                 embed_dims: int = 192, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.1, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, qkv_bias: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        d = embed_dims
        self.num_layers = num_layers
        self.proj_input = nn.Linear(self.in_width, d)
        self.cls_emb = nn.Parameter(torch.zeros(1, self.n_out, d))
        self.raw_init = {'cls_emb': ('truncated_normal', 0.02)}
        for i, rate in enumerate(drop_path_rates(drop_path_rate, [num_layers])):
            pre = f'b{i}_'
            self.add_module(pre + 'norm1', nn.LayerNorm(d, eps=LN_EPS))
            self.add_module(pre + 'attn', _MHSA(d, num_heads, qkv_bias,
                                               attn_drop_rate, drop_rate))
            self.add_module(pre + 'norm2', nn.LayerNorm(d, eps=LN_EPS))
            self.add_module(pre + 'fc1', nn.Linear(d, d * mlp_ratio))
            self.add_module(pre + 'fc2', nn.Linear(d * mlp_ratio, d))
            self.add_module(pre + 'drop_path', DropPath(rate) if rate else None)
        self.norm_out = nn.LayerNorm(d, eps=LN_EPS)
        self.patch_proj = nn.Linear(d, d, bias=False)
        self.cls_proj = nn.Linear(d, d, bias=False)
        self.mask_norm = nn.LayerNorm(self.n_out, eps=LN_EPS)

    def forward(self, inputs, with_aux: bool = True):
        """(B, classes, h, w) masks of the selected grid; ``with_aux`` means
        nothing to a single-output head."""
        x = self._select(inputs)
        if isinstance(x, (list, tuple)):
            x = x[-1]
        B, _, H, W = x.shape
        tokens = self.proj_input(x.flatten(2).transpose(1, 2))
        cls = self.cls_emb.expand(B, -1, -1).to(tokens.dtype)
        h = torch.cat([tokens, cls], 1)
        for i in range(self.num_layers):
            pre = f'b{i}_'
            drop_path = getattr(self, pre + 'drop_path')
            a = getattr(self, pre + 'attn')(getattr(self, pre + 'norm1')(h))
            h = h + maybe_apply(drop_path, a)
            m = getattr(self, pre + 'fc1')(getattr(self, pre + 'norm2')(h))
            m = getattr(self, pre + 'fc2')(F.gelu(m))
            h = h + maybe_apply(drop_path, m)
        h = self.norm_out(h)
        patches = l2_normalize(self.patch_proj(h[:, :H * W]))
        classes = l2_normalize(self.cls_proj(h[:, H * W:]))
        masks = self.mask_norm(torch.matmul(patches, classes.transpose(1, 2)))
        return masks.transpose(1, 2).reshape(B, -1, H, W)
