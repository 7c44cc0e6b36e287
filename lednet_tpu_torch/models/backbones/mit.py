"""MiT (Mix Transformer), SegFormer's backbone, NCHW in and out.

Counterpart of ``lednet_tpu/models/backbones/mit.py`` (``EfficientAttention``
:23-55, ``MixFFN`` :58-67, ``MixVisionTransformer`` :74-123, the ``MIT``
alias :126).  Inside, the tokens lie (B, H, W, C), the JAX package's layout,
so that the ``nn.Linear`` layers and LayerNorms act on the last axis:

- stage i: ``patch_embed{i}``, a conv of ``patch_sizes[i]`` at
  ``strides[i]`` with symmetric ``p // 2`` padding to ``embed_dims *
  num_heads[i]`` channels, then ``embed_norm{i}``; ``num_layers[i]``
  blocks ``s{i}_b{j}``: ``norm1``, ``attn``, a residual with stochastic
  depth, ``norm2``, ``ffn``, a residual with stochastic depth; then
  ``stage_norm{i}``, whose output the stage returns;
- ``EfficientAttention``: ``q`` a Dense; keys and values from the tokens
  reduced by ``sr`` (a conv of kernel = stride = ``sr_ratio``, no padding:
  it truncates the remainder) and ``sr_norm`` where ``sr_ratio > 1``, then
  ``kv``, a Dense to 2C whose first C channels are the keys; heads split
  the channels head-major; a float32 softmax at scale ``head_dim ** -0.5``;
  ``proj``.  Plain matmuls and a softmax, as the JAX package computes it
  outside any Pallas kernel;
- ``MixFFN``: ``fc1``, a 3x3 depthwise conv with a bias (``dw``), exact
  GELU, ``fc2``;
- every LayerNorm is flax's default, eps 1e-6 (torch's default is 1e-5);
- the stochastic-depth rate of block k of all ``sum(num_layers)`` is
  ``drop_path_rate * k / (total - 1)``.

``norm_cfg``, ``act_cfg``, ``pretrained``, ``init_cfg`` and ``with_cp``
are accepted and unused, as in the JAX package; a nonzero ``drop_rate`` or
``attn_drop_rate``, which the JAX package ignores, raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import DropPath, drop_path_rates
from lednet_tpu_torch.registry import MODELS

LN_EPS = 1e-6           # flax nn.LayerNorm's default epsilon


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv of an NHWC map, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _lecun(conv: nn.Conv2d) -> nn.Conv2d:
    """Mark a conv that flax initialises with its default (LeCun normal)."""
    conv.lecun_init = True
    return conv


class EfficientAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, ln_eps: float = LN_EPS):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        if sr_ratio > 1:
            self.sr = _lecun(nn.Conv2d(dim, dim, sr_ratio, sr_ratio))
            self.sr_norm = nn.LayerNorm(dim, eps=ln_eps)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) tokens -> (B, H, W, C)."""
        B, H, W, C = x.shape
        heads, d = self.num_heads, C // self.num_heads
        q = self.q(x).reshape(B, H * W, heads, d).transpose(1, 2)   # (B, h, N, d)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(_conv_nhwc(self.sr, x))
        kv = self.kv(kv_in).reshape(B, -1, 2, heads, d)
        k = kv[:, :, 0].permute(0, 2, 3, 1)                          # (B, h, d, M)
        v = kv[:, :, 1].transpose(1, 2)                              # (B, h, M, d)
        acc = torch.promote_types(x.dtype, torch.float32)
        attn = torch.matmul(q.to(acc), k.to(acc)) * d ** -0.5
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, H, W, C)
        return self.proj(out)


class MixFFN(nn.Module):

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.dw = _lecun(nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1,
                                   groups=hidden_dim))
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(_conv_nhwc(self.dw, self.fc1(x))))


@MODELS.register_module()
class MixVisionTransformer(nn.Module):

    def __init__(self, in_channels: int = 3, embed_dims: int = 64,
                 num_stages: int = 4, num_layers: Sequence[int] = (3, 4, 6, 3),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 patch_sizes: Sequence[int] = (7, 3, 3, 3),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3), mlp_ratio: int = 4,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None, with_cp: bool = False):
        super().__init__()
        for name, rate in (('drop_rate', drop_rate),
                           ('attn_drop_rate', attn_drop_rate)):
            if rate:
                raise NotImplementedError(f'MixVisionTransformer {name}={rate} '
                                          'is not ported (the JAX package '
                                          'ignores it; the configs set 0)')
        self.num_stages = num_stages
        self.num_layers = tuple(num_layers)
        self.out_indices = tuple(out_indices)
        rates = iter(drop_path_rates(drop_path_rate, self.num_layers[:num_stages]))
        self.drop_paths = nn.ModuleList()
        cin = in_channels
        for i in range(num_stages):
            dim, p = embed_dims * num_heads[i], patch_sizes[i]
            self.add_module(f'patch_embed{i}', nn.Conv2d(
                cin, dim, p, strides[i], padding=p // 2))
            self.add_module(f'embed_norm{i}', nn.LayerNorm(dim, eps=LN_EPS))
            for j in range(self.num_layers[i]):
                pre = f's{i}_b{j}_'
                self.add_module(pre + 'norm1', nn.LayerNorm(dim, eps=LN_EPS))
                self.add_module(pre + 'attn', EfficientAttention(
                    dim, num_heads[i], sr_ratios[i], qkv_bias))
                self.add_module(pre + 'norm2', nn.LayerNorm(dim, eps=LN_EPS))
                self.add_module(pre + 'ffn', MixFFN(dim, dim * mlp_ratio))
                self.drop_paths.append(DropPath(next(rates)))
            self.add_module(f'stage_norm{i}', nn.LayerNorm(dim, eps=LN_EPS))
            cin = dim

    def forward(self, x: torch.Tensor, impl: Optional[str] = None):
        """(B, C, H, W) -> the ``out_indices`` stages' (B, C_i, H_i, W_i)
        maps.  ``impl`` means nothing here: no port kernel runs in MiT."""
        x = x.to(self.patch_embed0.weight.dtype)
        outs, block = [], 0
        for i in range(self.num_stages):
            x = getattr(self, f'patch_embed{i}')(x).permute(0, 2, 3, 1)
            x = getattr(self, f'embed_norm{i}')(x)
            for j in range(self.num_layers[i]):
                pre, drop = f's{i}_b{j}_', self.drop_paths[block]
                h = getattr(self, pre + 'attn')(getattr(self, pre + 'norm1')(x))
                x = x + drop(h)
                h = getattr(self, pre + 'ffn')(getattr(self, pre + 'norm2')(x))
                x = x + drop(h)
                block += 1
            x = getattr(self, f'stage_norm{i}')(x).permute(0, 3, 1, 2)
            outs.append(x)
        return tuple(outs[i] for i in self.out_indices)


MODELS.register_module(name='MIT', module=MixVisionTransformer)
