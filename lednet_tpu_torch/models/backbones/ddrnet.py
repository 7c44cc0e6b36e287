"""DDRNet backbone (deep dual-resolution network), NCHW.

Counterpart of ``lednet_tpu/models/backbones/ddrnet.py`` (``_Stage`` :27,
``DDRNet`` :54): a stem to 1/8 (two 3x3/s2 convs, two BasicBlock stages to
2c), a context branch (4c at 1/16, 8c at 1/32, a Bottleneck to 16c at 1/64)
beside a spatial branch at 2c and 1/8, two bilateral fusions (a 1x1
compression of the context into the spatial branch, resized bilinearly;
3x3/s2 convs of the spatial branch into the context), and DAPPM on the
context resized back to 1/8.  Output sizes are ceil(in/8).  Returns
``(temp_context, x_s + x_c)``: ``temp_context`` is the spatial feature after
the first fusion, the auxiliary head's input.

The stem computes what LED-Net's stem computes, but it runs as module forms
here, as in the JAX package: kernels B and C serve LEDNet only.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import BasicBlock, Bottleneck, ConvModule
from lednet_tpu_torch.models.ppm import DAPPM
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class _Stage(nn.Module):
    """``num_blocks`` residual blocks ``block0``...; the last has no output
    ReLU, the first of a BasicBlock stage always has one."""

    def __init__(self, block: type, in_channels: int, channels: int,
                 num_blocks: int, stride: int = 1,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        out_channels = channels * block.expansion
        self.num_blocks = num_blocks
        self.block0 = block(in_channels, channels, stride=stride,
                            downsample=stride != 1 or in_channels != out_channels,
                            norm_cfg=norm_cfg, act_out=block is BasicBlock)
        for i in range(1, num_blocks):
            self.add_module(f'block{i}', block(
                out_channels, channels, norm_cfg=norm_cfg,
                act_out=i != num_blocks - 1))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f'block{i}')(x)
        return x


@MODELS.register_module()
class DDRNet(nn.Module):

    def __init__(self, in_channels: int = 3, channels: int = 32,
                 ppm_channels: int = 128, align_corners: bool = False,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``init_cfg`` (a pretrained checkpoint's URL in the DDRNet-23
        config) is read by neither package: weights come from
        ``init_weights`` or a checkpoint given to ``init_model``."""
        super().__init__()
        c = channels
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        self.align_corners = align_corners

        def conv(cin, cout, k, stride=1, act=None):
            return ConvModule(cin, cout, k, stride=stride, padding=k // 2,
                              norm_cfg=norm_cfg, act_cfg=act)

        def stage(block, cin, ch, n, stride=1):
            return _Stage(block, cin, ch, n, stride=stride, norm_cfg=norm_cfg)
        self.stem_conv1 = conv(in_channels, c, 3, 2, act_cfg)
        self.stem_conv2 = conv(c, c, 3, 2, act_cfg)
        self.stem_layer1 = stage(BasicBlock, c, c, 2)
        self.stem_layer2 = stage(BasicBlock, c, 2 * c, 2, stride=2)
        self.context1 = stage(BasicBlock, 2 * c, 4 * c, 2, stride=2)
        self.spatial1 = stage(BasicBlock, 2 * c, 2 * c, 2)
        self.compression_1 = conv(4 * c, 2 * c, 1)
        self.down_1 = conv(2 * c, 4 * c, 3, 2)
        self.context2 = stage(BasicBlock, 4 * c, 8 * c, 2, stride=2)
        self.spatial2 = stage(BasicBlock, 2 * c, 2 * c, 2)
        self.compression_2 = conv(8 * c, 2 * c, 1)
        self.down_2a = conv(2 * c, 4 * c, 3, 2, act_cfg)
        self.down_2b = conv(4 * c, 8 * c, 3, 2)
        self.spatial3 = stage(Bottleneck, 2 * c, 2 * c, 1)
        self.context3 = stage(Bottleneck, 8 * c, 8 * c, 1, stride=2)
        self.spp = DAPPM(16 * c, ppm_channels, 4 * c, num_scales=5)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W), promoted to the weights' dtype.  ``impl`` is
        accepted for the segmentor's call and unused: no kernel runs here."""
        out_size = (-(-x.shape[-2] // 8), -(-x.shape[-1] // 8))
        h = self.stem_conv2(self.stem_conv1(x.to(self.stem_conv1.conv.weight.dtype)))
        h = F.relu(self.stem_layer1(h))
        stem = F.relu(self.stem_layer2(h))                     # 2c @ 1/8

        x_c = self.context1(stem)                               # 4c @ 1/16
        x_s = self.spatial1(stem)
        comp = self.compression_1(F.relu(x_c))
        x_c = x_c + self.down_1(F.relu(x_s))
        x_s = x_s + resize_bilinear(comp, out_size, self.align_corners)
        temp_context = x_s

        x_c = self.context2(F.relu(x_c))                        # 8c @ 1/32
        x_s = self.spatial2(F.relu(x_s))
        comp = self.compression_2(F.relu(x_c))
        x_c = x_c + self.down_2b(self.down_2a(F.relu(x_s)))
        x_s = x_s + resize_bilinear(comp, out_size, self.align_corners)

        x_s = self.spatial3(F.relu(x_s))                        # 4c @ 1/8
        x_c = self.spp(self.context3(F.relu(x_c)))              # 4c @ 1/64
        x_c = resize_bilinear(x_c, out_size, self.align_corners)
        return temp_context, x_s + x_c
