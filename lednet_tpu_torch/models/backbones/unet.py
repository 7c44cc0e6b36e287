"""UNet backbone (encoder / decoder with skip connections), NCHW.

Counterpart of ``lednet_tpu/models/backbones/unet.py`` (``BasicConvBlock``
:26, ``DeconvModule`` :53, ``InterpConv`` :80, ``UNet`` :118):

- ``BasicConvBlock``: ``num_convs`` 3x3 ConvModules (``conv{i}``); the first
  carries the stage stride and is never dilated, the later ones carry the
  dilation;
- ``DeconvModule``: a transposed conv (``deconv``, kernel k, stride s,
  padding (k - s) / 2, with a bias) + norm (``norm``) + activation.  The
  flax module is ``nn.ConvTranspose`` with ``transpose_kernel=True`` and
  padding k - 1 - p on the dilated input, which is torch's
  ``ConvTranspose2d`` with padding p: its kernel (k, k, out, in) is the
  forward conv's, and ``convert.py``'s (3, 2, 0, 1) gives
  ``ConvTranspose2d``'s (in, out, k, k), unflipped;
- ``InterpConv``: a bilinear (or nearest) x2 upsample and a ConvModule
  (``conv``), in that order or, with ``conv_first``, the other;
- ``UNet``: stage i (``enc{i}``, ``base_channels * 2**i`` wide) after a 2x2
  max pool where the stage has stride 1 and the stage before it
  downsamples; the decoder walks back up: where the encoder stage below
  downsampled (stride 2 or a pool) an upsampler of ``upsample_cfg``
  (``up{i}``: ``InterpConv`` by default, or ``DeconvModule``), else a 1x1
  ConvModule; then the skip map concatenated before the upsampled one and
  a ``BasicConvBlock`` (``dec{i}``).  Returns the deepest encoder map and
  every decoder map, deepest first.

``SyncBN`` is the port's BatchNorm on one card.  ``norm_eval``,
``with_cp``, ``pretrained`` and ``init_cfg`` are accepted and unused, as in
the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.layers import ConvModule, Norm2d, build_activation
from lednet_tpu_torch.ops.pool import max_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from lednet_tpu_torch.registry import MODELS

_BN = dict(type='BN')
_RELU = dict(type='ReLU')


class BasicConvBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, num_convs: int = 2,
                 stride: int = 1, dilation: int = 1,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            first = i == 0
            self.add_module(f'conv{i}', ConvModule(
                in_channels if first else out_channels, out_channels, 3,
                stride=stride if first else 1,
                padding=1 if first else dilation,
                dilation=1 if first else dilation,
                norm_cfg=norm_cfg or _BN, act_cfg=act_cfg or _RELU))

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f'conv{i}')(x)
        return x


class DeconvModule(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 scale_factor: int = 2, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None):
        super().__init__()
        k, s = kernel_size, scale_factor
        if k < s or (k - s) % 2:
            raise ValueError(f'kernel_size {k} and scale_factor {s}: need '
                             'kernel_size >= scale_factor, of the same parity')
        self.deconv = nn.ConvTranspose2d(in_channels, out_channels, k, s,
                                         padding=(k - s) // 2)
        self.norm = Norm2d(norm_cfg or _BN, out_channels)
        self.act = build_activation(act_cfg or _RELU)

    def forward(self, x):
        return self.act(self.norm(self.deconv(x)))


class InterpConv(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 conv_first: bool = False, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0,
                 upsample_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None):
        super().__init__()
        up = dict(upsample_cfg or dict(scale_factor=2, mode='bilinear',
                                       align_corners=False))
        self.scale = up.get('scale_factor', 2)
        self.mode = up.get('mode', 'bilinear')
        self.align_corners = bool(up.get('align_corners', False))
        self.conv_first = conv_first
        self.conv = ConvModule(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding,
                               norm_cfg=norm_cfg or _BN, act_cfg=act_cfg or _RELU)

    def upsample(self, x):
        size = (x.shape[-2] * self.scale, x.shape[-1] * self.scale)
        if self.mode == 'nearest':
            return resize_nearest(x, size)
        return resize_bilinear(x, size, self.align_corners)

    def forward(self, x):
        if self.conv_first:
            return self.upsample(self.conv(x))
        return self.conv(self.upsample(x))


@MODELS.register_module()
class UNet(nn.Module):

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 num_stages: int = 5, strides: Sequence[int] = (1, 1, 1, 1, 1),
                 enc_num_convs: Sequence[int] = (2, 2, 2, 2, 2),
                 dec_num_convs: Sequence[int] = (2, 2, 2, 2),
                 downsamples: Sequence[bool] = (True, True, True, True),
                 enc_dilations: Sequence[int] = (1, 1, 1, 1, 1),
                 dec_dilations: Sequence[int] = (1, 1, 1, 1),
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 upsample_cfg: Optional[Dict] = None, norm_eval: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None, with_cp: bool = False):
        super().__init__()
        self.num_stages = num_stages
        # a pool before stage i where it has stride 1 and stage i - 1
        # downsamples
        self.pool_before = [i > 0 and strides[i] == 1 and bool(downsamples[i - 1])
                            for i in range(num_stages)]
        up_cfg = dict(upsample_cfg or dict(type='InterpConv'))
        up_type = up_cfg.pop('type', 'InterpConv')
        if up_type not in ('InterpConv', 'DeconvModule'):
            raise ValueError(f'unknown UNet upsample type {up_type!r}')
        in_ch = in_channels
        for i in range(num_stages):
            ch = base_channels * 2 ** i
            self.add_module(f'enc{i}', BasicConvBlock(
                in_ch, ch, enc_num_convs[i], strides[i], enc_dilations[i],
                norm_cfg, act_cfg))
            in_ch = ch
        for i in range(num_stages - 2, -1, -1):
            ch = base_channels * 2 ** i
            if strides[i + 1] != 1 or downsamples[i]:
                cls = DeconvModule if up_type == 'DeconvModule' else InterpConv
                up = cls(in_ch, ch, norm_cfg=norm_cfg, act_cfg=act_cfg, **up_cfg)
            else:
                up = ConvModule(in_ch, ch, 1, norm_cfg=norm_cfg or _BN,
                                act_cfg=act_cfg or _RELU)
            self.add_module(f'up{i}', up)
            self.add_module(f'dec{i}', BasicConvBlock(
                2 * ch, ch, dec_num_convs[i], 1, dec_dilations[i], norm_cfg,
                act_cfg))
            in_ch = ch

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W); ``impl`` is accepted for the segmentor's call and
        unused; ``x`` is cast to the weights' dtype."""
        x = x.to(self.enc0.conv0.conv.weight.dtype)
        enc_outs = []
        for i in range(self.num_stages):
            if self.pool_before[i]:
                x = max_pool2d(x, 2, 2, 0)
            x = getattr(self, f'enc{i}')(x)
            enc_outs.append(x)
        dec_outs = [x]
        for i in range(self.num_stages - 2, -1, -1):
            up = getattr(self, f'up{i}')(x)
            x = getattr(self, f'dec{i}')(torch.cat([enc_outs[i], up], 1))
            dec_outs.append(x)
        return tuple(dec_outs)
