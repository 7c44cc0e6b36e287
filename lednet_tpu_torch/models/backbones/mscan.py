"""MSCAN, SegNeXt's backbone (multi-scale convolutional attention), NCHW.

Counterpart of ``lednet_tpu/models/backbones/mscan.py`` (``MSCAAttention``
:20, ``MSCABlock`` :41, ``MSCAN`` :78):

- the stem: two 3x3/s2 convs with biases, each before a BatchNorm, GELU
  between them (``stem1``, ``stem2``), to 1/4;
- stages 2-4 open with a 3x3/s2 conv with a bias and a BatchNorm
  (``down{i}``, ``down_norm{i}``);
- each stage is ``depths[i]`` MSCA blocks (``s{i}_b{j}``): BatchNorm,
  ``proj_1``, GELU, the attention (a 5x5 depthwise conv, three depthwise
  strip pairs 1x7/7x1, 1x11/11x1, 1x21/21x1 each on the 5x5 output, the sum
  through a 1x1 mix gating the input), ``proj_2``, plus the shortcut of
  the normed input; scaled by ``layer_scale_1`` and stochastic depth on
  the residual; then BatchNorm, the conv MLP (1x1, 3x3 depthwise, GELU,
  1x1), scaled by ``layer_scale_2``, stochastic depth on the residual;
- the stochastic-depth rate of block k of all ``sum(depths)`` is
  ``drop_path_rate * k / (total - 1)``;
- each stage ends in a LayerNorm over the channels, eps 1e-5
  (``stage_norm{i}``).

``drop_rate``, ``norm_cfg``, ``act_cfg``, ``pretrained``, ``init_cfg`` and
the attention kernel options are accepted and unused, as in the JAX
package.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import (ConvModule, DropPath, LayerNorm2d,
                                            Norm2d, drop_path_rates)
from lednet_tpu_torch.registry import MODELS

_BN = dict(type='BN')


class MSCAAttention(nn.Module):
    """``conv_mix(conv0(x) + sum of the strip pairs of conv0(x)) * x``."""

    def __init__(self, dim: int, kernel_sizes: Sequence[int] = (5, 7, 11, 21)):
        super().__init__()
        k0 = kernel_sizes[0]
        self.conv0 = nn.Conv2d(dim, dim, k0, padding=k0 // 2, groups=dim)
        self.n_strips = len(kernel_sizes) - 1
        for i, k in enumerate(kernel_sizes[1:]):
            self.add_module(f'conv{i + 1}_1', nn.Conv2d(
                dim, dim, (1, k), padding=(0, k // 2), groups=dim))
            self.add_module(f'conv{i + 1}_2', nn.Conv2d(
                dim, dim, (k, 1), padding=(k // 2, 0), groups=dim))
        self.conv_mix = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        attn = self.conv0(x)
        total = attn
        for i in range(1, self.n_strips + 1):
            total = total + getattr(self, f'conv{i}_2')(
                getattr(self, f'conv{i}_1')(attn))
        return self.conv_mix(total) * x


class MSCABlock(nn.Module):

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 layer_scale_init: float = 1e-2, drop_path: float = 0.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.norm1 = Norm2d(_BN, dim)
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.attn = MSCAAttention(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)
        self.norm2 = Norm2d(_BN, dim)
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dw = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        hn = self.norm1(x)
        h = self.proj_2(self.attn(F.gelu(self.proj_1(hn)))) + hn
        x = x + self.drop_path(self.layer_scale_1.view(1, -1, 1, 1) * h)
        h = self.fc2(F.gelu(self.dw(self.fc1(self.norm2(x)))))
        return x + self.drop_path(self.layer_scale_2.view(1, -1, 1, 1) * h)


@MODELS.register_module()
class MSCAN(nn.Module):

    def __init__(self, in_channels: int = 3,
                 embed_dims: Sequence[int] = (32, 64, 160, 256),
                 depths: Sequence[int] = (3, 3, 5, 2),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 pretrained: Optional[str] = None, init_cfg: Optional[Dict] = None,
                 attention_kernel_sizes: Sequence = (5, (1, 7), (1, 11), (1, 21)),
                 attention_kernel_paddings: Sequence = (2, (0, 3), (0, 5), (0, 10))):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.depths = tuple(depths)
        dpr = drop_path_rates(drop_path_rate, depths)
        done = 0
        prev = in_channels
        for i, (dim, depth) in enumerate(zip(embed_dims, depths)):
            if i == 0:
                self.stem1 = ConvModule(in_channels, dim // 2, 3, stride=2,
                                        padding=1, bias=True, norm_cfg=_BN,
                                        act_cfg=dict(type='GELU'))
                self.stem2 = ConvModule(dim // 2, dim, 3, stride=2, padding=1,
                                        bias=True, norm_cfg=_BN)
            else:
                self.add_module(f'down{i}', nn.Conv2d(prev, dim, 3, 2, 1))
                self.add_module(f'down_norm{i}', Norm2d(_BN, dim))
            for j in range(depth):
                self.add_module(f's{i}_b{j}', MSCABlock(
                    dim, mlp_ratios[i], drop_path=dpr[done]))
                done += 1
            self.add_module(f'stage_norm{i}', LayerNorm2d(dim, eps=1e-5))
            prev = dim

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W); ``impl`` is accepted for the segmentor's call and
        unused; ``x`` is cast to the weights' dtype."""
        x = x.to(self.stem1.conv.weight.dtype)
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = self.stem2(self.stem1(x))
            else:
                x = getattr(self, f'down_norm{i}')(getattr(self, f'down{i}')(x))
            for j in range(depth):
                x = getattr(self, f's{i}_b{j}')(x)
            x = getattr(self, f'stage_norm{i}')(x)
            outs.append(x)
        return tuple(outs[i] for i in self.out_indices)
