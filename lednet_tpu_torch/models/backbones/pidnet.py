"""PIDNet backbone (proportional / integral / derivative branches), NCHW.

Counterpart of ``lednet_tpu/models/backbones/pidnet.py`` (``PagFM`` :29,
``Bag`` :56, ``LightBag`` :73, ``PIDNet`` :93):

- a stem to 2c at 1/8 (two 3x3/s2 convs, two BasicBlock stages);
- the I branch (4c at 1/16, 8c at 1/32, a Bottleneck stage to 16c at 1/64,
  then PAPPM for PIDNet-S or DAPPM for M/L, resized back to 1/8);
- the P branch at 2c and 1/8, fused with the I branch twice by ``PagFM``
  (pixel attention: ``sigma = sigmoid(sum_c f_p * up(f_i))``, ``out =
  sigma * up(x_i) + (1 - sigma) * x_p``, bilinear with ``align_corners``
  False);
- the D branch at 1/8, fed by 3x3 "diff" convs of the I branch, resized
  with the backbone's ``align_corners``;
- ``Bag`` (M/L: a pre-activation 3x3 conv of ``sigma * x_p + (1 - sigma) *
  x_i``, ``sigma = sigmoid(x_d)``) or ``LightBag`` (S: two 1x1 convs)
  fuses the three.

``num_stem_blocks == 2`` selects PIDNet-S's light D branch, PAPPM and
LightBag.  The 1/8 maps are ceil(in / 8).  It always returns ``(temp_p,
out, temp_d)``: ``out`` for the I head, ``temp_p`` and ``temp_d`` for the
P and D heads in training.  As in the JAX package the stem runs as module
forms (kernels B and C serve LEDNet only).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.backbones.ddrnet import _Stage
from lednet_tpu_torch.models.layers import BasicBlock, Bottleneck, ConvModule
from lednet_tpu_torch.models.ppm import DAPPM, PAPPM
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class PagFM(nn.Module):

    def __init__(self, in_channels: int, channels: int,
                 after_relu: bool = False, with_channel: bool = False,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.after_relu = after_relu
        self.f_i = ConvModule(in_channels, channels, 1, norm_cfg=norm_cfg)
        self.f_p = ConvModule(in_channels, channels, 1, norm_cfg=norm_cfg)
        self.up = (ConvModule(channels, in_channels, 1, norm_cfg=norm_cfg)
                   if with_channel else None)

    def forward(self, x_p, x_i):
        if self.after_relu:
            x_p, x_i = F.relu(x_p), F.relu(x_i)
        size = x_p.shape[-2:]
        f_i = resize_bilinear(self.f_i(x_i), size, align_corners=False)
        f_p = self.f_p(x_p)
        if self.up is not None:
            sigma = torch.sigmoid(self.up(f_p * f_i))
        else:
            sigma = torch.sigmoid((f_p * f_i).sum(1, keepdim=True))
        x_i = resize_bilinear(x_i, size, align_corners=False)
        return sigma * x_i + (1 - sigma) * x_p


class Bag(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None):
        super().__init__()
        self.conv = ConvModule(in_channels, out_channels, 3, padding=1,
                               norm_cfg=norm_cfg or dict(type='BN'),
                               act_cfg=act_cfg or dict(type='ReLU'),
                               order=('norm', 'act', 'conv'))

    def forward(self, x_p, x_i, x_d):
        sigma = torch.sigmoid(x_d)
        return self.conv(sigma * x_p + (1 - sigma) * x_i)


class LightBag(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.f_p = ConvModule(in_channels, out_channels, 1, norm_cfg=norm_cfg,
                              act_cfg=act_cfg)
        self.f_i = ConvModule(in_channels, out_channels, 1, norm_cfg=norm_cfg,
                              act_cfg=act_cfg)

    def forward(self, x_p, x_i, x_d):
        sigma = torch.sigmoid(x_d)
        return self.f_p((1 - sigma) * x_i + x_p) + self.f_i(x_i + sigma * x_p)


@MODELS.register_module()
class PIDNet(nn.Module):

    def __init__(self, in_channels: int = 3, channels: int = 64,
                 ppm_channels: int = 96, num_stem_blocks: int = 2,
                 num_branch_blocks: int = 3, align_corners: bool = False,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``init_cfg`` is read by neither package: weights come from
        ``init_weights`` or a checkpoint given to ``init_model``."""
        super().__init__()
        c = channels
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        self.align_corners = align_corners
        light = num_stem_blocks == 2

        def conv(cin, cout, k, stride=1, act=None):
            return ConvModule(cin, cout, k, stride=stride, padding=k // 2,
                              norm_cfg=norm_cfg, act_cfg=act)

        def stage(block, cin, ch, n, stride=1):
            return _Stage(block, cin, ch, n, stride=stride, norm_cfg=norm_cfg)
        self.stem_conv1 = conv(in_channels, c, 3, 2, act_cfg)
        self.stem_conv2 = conv(c, c, 3, 2, act_cfg)
        self.stem_layer1 = stage(BasicBlock, c, c, num_stem_blocks)
        self.stem_layer2 = stage(BasicBlock, c, 2 * c, num_stem_blocks, 2)
        self.i_layer1 = stage(BasicBlock, 2 * c, 4 * c, num_branch_blocks, 2)
        self.p_layer1 = stage(BasicBlock, 2 * c, 2 * c, num_stem_blocks)
        if light:
            self.d_layer1 = BasicBlock(2 * c, c, downsample=True,
                                       norm_cfg=norm_cfg, act_out=False)
        else:
            self.d_layer1 = BasicBlock(2 * c, 2 * c, norm_cfg=norm_cfg,
                                       act_out=False)
        self.compression_1 = conv(4 * c, 2 * c, 1)
        self.pag_1 = PagFM(2 * c, c)
        self.diff_1 = conv(4 * c, c if light else 2 * c, 3)
        self.i_layer2 = stage(BasicBlock, 4 * c, 8 * c, num_branch_blocks, 2)
        self.p_layer2 = stage(BasicBlock, 2 * c, 2 * c, num_stem_blocks)
        if light:
            self.d_layer2 = stage(Bottleneck, c, c, 1)
        else:
            self.d_layer2 = BasicBlock(2 * c, 2 * c, norm_cfg=norm_cfg,
                                       act_out=False)
        self.compression_2 = conv(8 * c, 2 * c, 1)
        self.pag_2 = PagFM(2 * c, c)
        self.diff_2 = conv(8 * c, 2 * c, 3)
        self.i_layer3 = stage(Bottleneck, 8 * c, 8 * c, 2, 2)
        self.p_layer3 = stage(Bottleneck, 2 * c, 2 * c, 1)
        self.d_layer3 = stage(Bottleneck, 2 * c, 2 * c, 1)
        self.spp = (PAPPM if light else DAPPM)(16 * c, ppm_channels, 4 * c,
                                               num_scales=5)
        self.dfm = (LightBag if light else Bag)(
            4 * c, 4 * c, norm_cfg=norm_cfg, act_cfg=None if light else act_cfg)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W), promoted to the weights' dtype.  ``impl`` is
        accepted for the segmentor's call and unused: no kernel runs here."""
        out_size = (-(-x.shape[-2] // 8), -(-x.shape[-1] // 8))
        h = self.stem_conv2(self.stem_conv1(x.to(self.stem_conv1.conv.weight.dtype)))
        h = F.relu(self.stem_layer1(h))
        stem = F.relu(self.stem_layer2(h))                      # 2c @ 1/8

        x_i = F.relu(self.i_layer1(stem))                       # 4c @ 1/16
        x_p = self.p_layer1(stem)
        x_d = self.d_layer1(stem)
        x_p = self.pag_1(x_p, self.compression_1(x_i))
        x_d = x_d + resize_bilinear(self.diff_1(x_i), out_size,
                                    self.align_corners)
        temp_p = x_p

        x_i = F.relu(self.i_layer2(x_i))                        # 8c @ 1/32
        x_p = self.p_layer2(F.relu(x_p))
        x_d = self.d_layer2(F.relu(x_d))
        x_p = self.pag_2(x_p, self.compression_2(x_i))
        x_d = x_d + resize_bilinear(self.diff_2(x_i), out_size,
                                    self.align_corners)
        temp_d = x_d

        x_i = self.i_layer3(x_i)                                # 16c @ 1/64
        x_p = self.p_layer3(F.relu(x_p))
        x_d = self.d_layer3(F.relu(x_d))
        x_i = resize_bilinear(self.spp(x_i), out_size, self.align_corners)
        return temp_p, self.dfm(x_p, x_i, x_d), temp_d
