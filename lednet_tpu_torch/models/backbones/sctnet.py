"""SCTNet backbone (a single-branch CNN with conv-former blocks), NCHW.

Counterpart of ``lednet_tpu/models/backbones/sctnet.py`` (``_SCTBasicBlock``
:31, ``ConvolutionalAttention`` :54, ``CFBlock`` :92, ``SCTNet`` :112): a
stem of two biased 3x3/s2 convs to 1/4, residual stages to 4c at 1/16
(the last block of each stage without its output ReLU), a ``CFBlock`` at
1/16 (``layer3_2``), a 3x3/s2 ``convdown4`` to 8c at 1/32 and two more
``CFBlock`` there (``layer4``, ``layer5``), then a DAPPM of 5 scales with
biased convs (``spp``) to 2c, resized to 1/8 and concatenated after the
stage-2 map.  Returns ``(concat [4c at 1/8], stage2 [2c at 1/8])``.

``ConvolutionalAttention`` BatchNorm-normalizes its input and runs two
strip banks, ``kv`` (7x1, padding (3, 0)) and ``kv3`` (1x7, padding (0,
3)), each a conv to 64 channels, ``act_dn``, then the conv back through
the same bank with its in/out axes swapped; the two are summed.  The
banks are raw parameters in the layout of the forward conv's weight,
(64, in, kh, kw): ``convert.py`` transposes flax's (kh, kw, in, 64) as it
transposes a kernel, and the conv back takes ``weight.transpose(0, 1)``.
``act_dn`` takes a softmax over all H*W positions of each channel, then
divides each head's channels by their sum over the head plus 1e-6, in
float32 (or wider).  ``CFBlock`` adds the attention and then an MLP (BatchNorm eps
1e-6, biased 3x3 conv, exact GELU, biased 3x3 conv), each through
``DropPath(drop_path_rate)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import ConvModule, DropPath, Norm2d
from lednet_tpu_torch.models.ppm import DAPPM
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

_BN = dict(type='BN')
_RELU = dict(type='ReLU')


class _SCTBasicBlock(nn.Module):
    """Two biased 3x3 convs with BatchNorm, a biased 1x1 ``down`` where the
    stride or width changes, the output ReLU unless ``no_relu``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 no_relu: bool = False):
        super().__init__()
        self.no_relu = no_relu
        self.conv1 = ConvModule(in_channels, out_channels, 3, stride=stride,
                                padding=1, bias=True, norm_cfg=_BN,
                                act_cfg=_RELU)
        self.conv2 = ConvModule(out_channels, out_channels, 3, padding=1,
                                bias=True, norm_cfg=_BN, act_cfg=None)
        self.down = (ConvModule(in_channels, out_channels, 1, stride=stride,
                                bias=True, norm_cfg=_BN, act_cfg=None)
                     if stride != 1 or in_channels != out_channels else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        out = out + (x if self.down is None else self.down(x))
        return out if self.no_relu else F.relu(out)


class ConvolutionalAttention(nn.Module):
    # init_weights: both banks truncated normal(0.001) at two deviations
    raw_init = {'kv': ('truncated_normal', 0.001),
                'kv3': ('truncated_normal', 0.001)}

    def __init__(self, in_channels: int, out_channels: int,
                 inter_channels: int = 64, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.norm = Norm2d(_BN, in_channels)
        self.kv = nn.Parameter(torch.zeros(inter_channels, in_channels, 7, 1))
        self.kv3 = nn.Parameter(torch.zeros(inter_channels, in_channels, 1, 7))

    def act_dn(self, h):
        """Softmax over the H*W positions of each channel, then each head's
        channels divided by their sum plus 1e-6; in float32 (float64 for a
        float64 map)."""
        b, c, hh, ww = h.shape
        acc = torch.promote_types(h.dtype, torch.float32)
        flat = h.to(acc).reshape(b, self.num_heads, c // self.num_heads, hh * ww)
        flat = torch.softmax(flat, dim=3)
        flat = flat / (flat.sum(dim=2, keepdim=True) + 1e-6)
        return flat.reshape(b, c, hh, ww).to(h.dtype)

    def forward(self, x):
        x = self.norm(x)
        out = 0
        for bank, pad in ((self.kv, (3, 0)), (self.kv3, (0, 3))):
            w = bank.to(x.dtype)
            h = self.act_dn(F.conv2d(x, w, padding=pad))
            out = out + F.conv2d(h, w.transpose(0, 1), padding=pad)
        return out


class CFBlock(nn.Module):

    def __init__(self, channels: int, num_heads: int = 8, drop_path: float = 0.0):
        super().__init__()
        self.attn = ConvolutionalAttention(channels, channels,
                                           num_heads=num_heads)
        self.drop_path = DropPath(drop_path)
        self.mlp_norm = Norm2d(dict(type='BN', eps=1e-6), channels)
        self.mlp_conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.mlp_conv2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = x + self.drop_path(self.attn(x))
        h = self.mlp_conv2(F.gelu(self.mlp_conv1(self.mlp_norm(x))))
        return x + self.drop_path(h)


@MODELS.register_module()
class SCTNet(nn.Module):

    def __init__(self, layer_nums: Sequence[int] = (2, 2, 2, 2),
                 base_channels: int = 64, spp_channels: int = 128,
                 in_channels: int = 3, num_heads: int = 8,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None):
        """``drop_rate``, ``pretrained`` and ``init_cfg`` are accepted for
        the configs and unread, as in the JAX package; ``layer_nums[3]``
        too (stage 4 is ``convdown4`` and two ``CFBlock``)."""
        super().__init__()
        c = base_channels
        self.layer_nums = tuple(layer_nums)
        self.stem1 = ConvModule(in_channels, c, 3, stride=2, padding=1,
                                bias=True, norm_cfg=_BN, act_cfg=_RELU)
        self.stem2 = ConvModule(c, c, 3, stride=2, padding=1, bias=True,
                                norm_cfg=_BN, act_cfg=_RELU)
        for s, (cin, cout, stride) in enumerate(((c, c, 1), (c, 2 * c, 2),
                                                 (2 * c, 4 * c, 2)), 1):
            n = self.layer_nums[s - 1]
            for i in range(n):
                self.add_module(f'layer{s}_{i}', _SCTBasicBlock(
                    cin if i == 0 else cout, cout, stride if i == 0 else 1,
                    no_relu=i == n - 1))
        self.layer3_2 = CFBlock(4 * c, num_heads, drop_path_rate)
        self.convdown4 = ConvModule(4 * c, 8 * c, 3, stride=2, padding=1,
                                    bias=True, norm_cfg=_BN, act_cfg=_RELU)
        self.layer4 = CFBlock(8 * c, num_heads, drop_path_rate)
        self.layer5 = CFBlock(8 * c, num_heads, drop_path_rate)
        self.spp = DAPPM(8 * c, spp_channels, 2 * c, num_scales=5,
                         conv_bias=True)

    def _stage(self, x, s):
        for i in range(self.layer_nums[s - 1]):
            x = getattr(self, f'layer{s}_{i}')(x)
        return x

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W), promoted to the weights' dtype; ``impl`` is
        accepted for the segmentor's call and unused."""
        h = self.stem2(self.stem1(x.to(self.stem1.conv.weight.dtype)))
        x1 = self._stage(h, 1)                                  # 1/4
        x2 = self._stage(F.relu(x1), 2)                         # 1/8
        x3 = self._stage(F.relu(x2), 3)                         # 1/16
        x3 = self.layer3_2(F.relu(x3))
        x4 = self.layer4(F.relu(self.convdown4(x3)))            # 1/32
        x5 = self.layer5(F.relu(x4))
        x6 = resize_bilinear(self.spp(x5), x2.shape[-2:], False)
        return torch.cat([x2, x6], 1), x2
