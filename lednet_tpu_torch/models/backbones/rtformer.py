"""RTFormer: a dual-resolution transformer for real-time segmentation, NCHW.

Counterpart of ``lednet_tpu/models/backbones/rtformer.py`` (``_double_norm``
:44, ``ExternalAttention`` :53, ``CrossResolutionAttention`` :78,
``ConvFFN`` :107, ``RTFormerBlock`` :124, ``RTFormer`` :166): a stem to
1/4, BasicBlock stages to 2c at 1/8, a low branch to 4c at 1/16 beside a
high branch of ``high_channels`` at 1/8 (``layer3h_0``, projected only
where 2c differs from it), one bilateral conv fusion (``compression3`` up
into the high branch, ``down3`` into the low one), two ``RTFormerBlock``
(``block4`` takes the low branch to 8c at 1/32, ``block5`` stays there),
and a DAPPM on the low branch resized to 1/8 and concatenated after the
high branch.  Returns ``(x_high after block4, concat(x_high, spp))``.

The double normalization of both attentions takes a softmax over the n
spatial tokens (axis -2 of JAX's (..., n, m) logits), then divides by the
sum over the m keys plus 1e-6.  The port forms the logits transposed,
(..., m, n), so that the softmax runs along contiguous memory and the
products need no copies: ``double_norm_t`` (with torch's softmax over
the strided token axis, RTFormer-Base's 1024x2048 forward took 101.9 ms
on an H100, 11.6 ms this way).  Heads
split the channels head-major (channel h * d + j), so (B, C, H, W) is
(B, heads, d, H*W) as it lies.  ``ExternalAttention``'s token banks ``k`` (heads, d,
m) and ``v`` (heads, m, d) keep the flax layout.  ``CrossResolutionAttention``
takes its queries from the BatchNormed high map, its keys and values from
the un-normalized low map pooled to ``cross_size`` x ``cross_size``
through a bias-free 1x1 ``cross_kv`` to 2C channels (the first C the
keys).  ``drop_path_rate`` is accepted and is the identity, as in the JAX
package.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from lednet_tpu_torch.models.layers import BasicBlock, ConvModule, Norm2d
from lednet_tpu_torch.models.ppm import DAPPM
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

_RELU = dict(type='ReLU')


def double_norm_t(attn_t: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The double norm of transposed logits, (..., m keys, n tokens):
    softmax over the tokens (the last axis), then L1 over the keys."""
    attn_t = torch.softmax(attn_t, dim=-1)
    return attn_t / (attn_t.sum(dim=-2, keepdim=True) + eps)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, heads, C / heads, H*W), channel h * d + j."""
    b, c, h, w = x.shape
    return x.reshape(b, heads, c // heads, h * w)


class ExternalAttention(nn.Module):
    # init_weights: the token banks normal(0.02), as the JAX package draws them
    raw_init = {'k': ('normal', 0.02), 'v': ('normal', 0.02)}

    def __init__(self, channels: int, num_tokens: int = 144,
                 num_heads: int = 8, norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.num_heads = num_heads
        d = channels // num_heads
        self.pre_norm = Norm2d(norm_cfg, channels)
        self.k = nn.Parameter(torch.zeros(num_heads, d, num_tokens))
        self.v = nn.Parameter(torch.zeros(num_heads, num_tokens, d))

    def forward(self, x):
        tokens = _heads(self.pre_norm(x), self.num_heads)      # (b, h, d, n)
        logits_t = torch.matmul(self.k.transpose(1, 2), tokens)   # (b, h, m, n)
        attn_t = double_norm_t(logits_t * tokens.shape[2] ** -0.5)
        out = torch.matmul(self.v.transpose(1, 2), attn_t)       # (b, h, d, n)
        return out.reshape(x.shape)


class CrossResolutionAttention(nn.Module):

    def __init__(self, channels: int, low_channels: int, cross_size: int = 12,
                 num_heads: int = 8, norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.channels, self.cross_size, self.num_heads = (channels, cross_size,
                                                          num_heads)
        self.pre_norm = Norm2d(norm_cfg, channels)
        self.cross_kv = nn.Conv2d(low_channels, 2 * channels, 1, bias=False)
        self.cross_kv.lecun_init = True       # flax's default kernel init

    def forward(self, x_h, x_l):
        q = _heads(self.pre_norm(x_h), self.num_heads)          # (b, h, d, n)
        kv = self.cross_kv(adaptive_avg_pool2d(x_l, self.cross_size))
        k = _heads(kv[:, :self.channels], self.num_heads)       # (b, h, d, m)
        v = _heads(kv[:, self.channels:], self.num_heads)
        logits_t = torch.matmul(k.transpose(2, 3), q)           # (b, h, m, n)
        attn_t = double_norm_t(logits_t * q.shape[2] ** -0.5)
        return torch.matmul(v, attn_t).reshape(x_h.shape)       # (b, h, d, n)


class ConvFFN(nn.Module):
    """BatchNorm, a 3x3 ConvModule (norm, ReLU), a bare bias-free 3x3."""

    def __init__(self, channels: int, norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.pre_norm = Norm2d(norm_cfg, channels)
        self.conv1 = ConvModule(channels, channels, 3, padding=1,
                                norm_cfg=norm_cfg or dict(type='BN'),
                                act_cfg=_RELU)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.conv2.lecun_init = True

    def forward(self, x):
        return self.conv2(self.conv1(self.pre_norm(x)))


class RTFormerBlock(nn.Module):
    """An optional stride-2 ``down`` of the low branch; low external
    attention and FFN; high cross-resolution attention on the attended low
    map and FFN; ``compression`` of the low map up into the high one."""

    def __init__(self, low_in: int, low_out: int, high_channels: int,
                 num_heads: int = 8, num_tokens: int = 144,
                 cross_size: int = 12, stride: int = 2,
                 norm_cfg: Optional[Dict] = None, align_corners: bool = False):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.align_corners = align_corners
        self.down = (ConvModule(low_in, low_out, 3, stride=stride, padding=1,
                                norm_cfg=norm_cfg, act_cfg=_RELU)
                     if stride != 1 or low_in != low_out else None)
        self.low_attn = ExternalAttention(low_out, num_tokens, num_heads,
                                          norm_cfg)
        self.low_ffn = ConvFFN(low_out, norm_cfg)
        self.high_attn = CrossResolutionAttention(high_channels, low_out,
                                                  cross_size, num_heads,
                                                  norm_cfg)
        self.high_ffn = ConvFFN(high_channels, norm_cfg)
        self.compression = ConvModule(low_out, high_channels, 1,
                                      norm_cfg=norm_cfg, act_cfg=None)

    def forward(self, x_h, x_l):
        if self.down is not None:
            x_l = self.down(x_l)
        x_l = x_l + self.low_attn(x_l)
        x_l = x_l + self.low_ffn(x_l)
        x_h = x_h + self.high_attn(x_h, x_l)
        x_h = x_h + self.high_ffn(x_h)
        x_h = x_h + resize_bilinear(self.compression(x_l), x_h.shape[-2:],
                                    self.align_corners)
        return x_h, x_l


@MODELS.register_module()
class RTFormer(nn.Module):
    """RTFormer-Slim: ``base_channels=32``; RTFormer-Base: 64."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 high_channels: int = 128, num_heads: int = 8,
                 num_tokens: int = 144, cross_size: int = 12,
                 ppm_channels: int = 128, drop_path_rate: float = 0.0,
                 norm_cfg: Optional[Dict] = None, align_corners: bool = False,
                 init_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        c, ch = base_channels, high_channels
        self.align_corners = align_corners
        self.stem1 = ConvModule(in_channels, c, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg, act_cfg=_RELU)
        self.stem2 = ConvModule(c, c, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg, act_cfg=_RELU)
        self.layer1_0 = BasicBlock(c, c, norm_cfg=norm_cfg)
        self.layer1_1 = BasicBlock(c, c, norm_cfg=norm_cfg)
        self.layer2_0 = BasicBlock(c, 2 * c, stride=2, downsample=True,
                                   norm_cfg=norm_cfg)
        self.layer2_1 = BasicBlock(2 * c, 2 * c, norm_cfg=norm_cfg)
        self.layer3_0 = BasicBlock(2 * c, 4 * c, stride=2, downsample=True,
                                   norm_cfg=norm_cfg)
        self.layer3_1 = BasicBlock(4 * c, 4 * c, norm_cfg=norm_cfg)
        self.layer3h_0 = BasicBlock(2 * c, ch, downsample=2 * c != ch,
                                    norm_cfg=norm_cfg)
        self.compression3 = ConvModule(4 * c, ch, 1, norm_cfg=norm_cfg,
                                       act_cfg=None)
        self.down3 = ConvModule(ch, 4 * c, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg, act_cfg=None)
        blocks = dict(num_heads=num_heads, num_tokens=num_tokens,
                      cross_size=cross_size, norm_cfg=norm_cfg,
                      align_corners=align_corners)
        self.block4 = RTFormerBlock(4 * c, 8 * c, ch, stride=2, **blocks)
        self.block5 = RTFormerBlock(8 * c, 8 * c, ch, stride=1, **blocks)
        self.spp = DAPPM(8 * c, ppm_channels, ch, num_scales=5,
                         norm_cfg=norm_cfg)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W), promoted to the weights' dtype; ``impl`` is
        accepted for the segmentor's call and unused."""
        x = self.stem2(self.stem1(x.to(self.stem1.conv.weight.dtype)))
        x = self.layer1_1(self.layer1_0(x))
        x = self.layer2_1(self.layer2_0(x))
        x_l = self.layer3_1(self.layer3_0(x))
        x_h = self.layer3h_0(x)
        down3 = self.down3(x_h)
        x_h = x_h + resize_bilinear(self.compression3(x_l), x_h.shape[-2:],
                                    self.align_corners)
        x_l = x_l + down3
        x_h4, x_l = self.block4(x_h, x_l)
        x_h, x_l = self.block5(x_h4, x_l)
        spp = resize_bilinear(self.spp(x_l), x_h.shape[-2:], self.align_corners)
        return x_h4, torch.cat([x_h, spp], 1)
