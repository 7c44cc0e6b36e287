"""LED-Net backbone (module form), NCHW.

Counterpart of ``lednet_tpu/models/backbones/lednet.py`` :191-344: a stem to
1/8 with the x1 (1/2) and x2 (1/4) taps, SEAM edge attention, two
dual-branch stages (CESPB context/spatial branches, GETB, Muti_AFF fusion,
SEAM injection), and a final stage with SESP context pooling.  Returns
``(c3_feat, c5_feat, x1, x2)``; ``out_size`` is ceil(in/8) (``lednet.py:199``).

In eval mode on CUDA the stem runs kernel B (stem_conv1, stem_conv2) and
kernel C (stem_block1, stem_block2 and the trailing ReLU) with BatchNorm
folded, and every SESP block runs kernel D.  The TPU reparameterizations of
the JAX package (the space-to-depth stem ``_stem_s2d``, the packed
``_stem_block3_packed``) are not carried over: the port runs the module forms
they rewrite.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.aff import MutiAFF
from lednet_tpu_torch.models.espnet import CESPB, SESP
from lednet_tpu_torch.models.getb import GETBBlock
from lednet_tpu_torch.models.layers import BasicBlock, ConvModule, fold_conv_bn
from lednet_tpu_torch.models.seam import SEAM
from lednet_tpu_torch.ops.kernels import basic_pair, stem_convs
from lednet_tpu_torch.ops.kernels._build import resolve_impl
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class LEDNet(nn.Module):

    def __init__(self, in_channels: int = 3, channels: int = 32,
                 ppm_channels: int = 128, align_corners: bool = False,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        c = channels
        norm_cfg = norm_cfg or dict(type='BN')
        relu = dict(type='ReLU')
        self.align_corners = align_corners
        conv = lambda cin, cout, k, **kw: ConvModule(cin, cout, k, norm_cfg=norm_cfg, **kw)
        self.stem_conv1 = conv(in_channels, c, 3, stride=2, padding=1, act_cfg=relu)
        self.stem_conv2 = conv(c, c, 3, stride=2, padding=1, act_cfg=relu)
        self.stem_block1 = BasicBlock(c, c, norm_cfg=norm_cfg, act_out=True)
        self.stem_block2 = BasicBlock(c, c, norm_cfg=norm_cfg, act_out=False)
        self.stem_block3 = BasicBlock(c, 2 * c, stride=2, downsample=True,
                                      norm_cfg=norm_cfg, act_out=False)
        self.seam = SEAM(2 * c)
        getb = lambda dim: GETBBlock(dim, num_heads=8, window_size=8, mlp_ratio=2.0)
        self.context1 = CESPB(2 * c, 4 * c, stride=2, num_blocks=2, spatial=False)
        self.gltb1 = getb(4 * c)
        self.spatial1 = CESPB(2 * c, 2 * c, num_blocks=2, spatial=True)
        self.compression_aff = conv(4 * c, 2 * c, 1, act_cfg=None)
        self.down_1 = conv(2 * c, 4 * c, 3, stride=2, padding=1, act_cfg=None)
        self.aff1 = MutiAFF(2 * c)
        self.context2 = CESPB(4 * c, 8 * c, stride=2, num_blocks=2, spatial=False)
        self.gltb2 = getb(8 * c)
        self.spatial2 = CESPB(2 * c, 2 * c, num_blocks=2, spatial=True)
        self.compression_2 = conv(8 * c, 2 * c, 1, act_cfg=None)
        self.down_2a = conv(2 * c, 4 * c, 3, stride=2, padding=1, act_cfg=relu)
        self.down_2b = conv(4 * c, 8 * c, 3, stride=2, padding=1, act_cfg=None)
        self.aff2 = MutiAFF(2 * c)
        self.spatial3 = CESPB(2 * c, 4 * c, num_blocks=1, spatial=True)
        self.context3 = CESPB(8 * c, 16 * c, stride=2, num_blocks=1, spatial=False)
        self.spp = SESP(16 * c, ppm_channels, spatial=False)
        self.spp_out = (conv(ppm_channels, 4 * c, 1, act_cfg=None)
                        if ppm_channels != 4 * c else None)
        self.gltb3 = getb(4 * c)

    def module_stem(self, x):
        """The stem's module form: x1 (1/2), x2 (1/4) and the stem blocks'
        output at 1/4 (after the trailing ReLU)."""
        x1 = self.stem_conv1(x.float())
        x2 = self.stem_conv2(x1)
        return x1, x2, F.relu(self.stem_block2(self.stem_block1(x2)))

    def kernel_stem(self, x, impl: Optional[str] = None):
        """Eval stem through kernels B and C with BatchNorm folded (their
        plain versions with ``impl='plain'``): returns x1 (1/2), x2 (1/4)
        and the stem blocks' output at 1/4."""
        w1, b1 = fold_conv_bn(self.stem_conv1.conv, self.stem_conv1.norm)
        w2, b2 = fold_conv_bn(self.stem_conv2.conv, self.stem_conv2.norm)
        x1, x2 = stem_convs(x, w1, b1, w2, b2, impl=impl)
        ws, bs = [], []
        for blk in (self.stem_block1, self.stem_block2):
            for cv in (blk.conv1, blk.conv2):
                w, b = fold_conv_bn(cv.conv, cv.norm)
                ws.append(w)
                bs.append(b)
        return x1, x2, basic_pair(x2, torch.stack(ws), torch.stack(bs),
                                  impl=impl)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W) float32 or bfloat16 (promoted to float32)."""
        in_h, in_w = x.shape[-2:]
        out_size = (-(-in_h // 8), -(-in_w // 8))
        if not self.training and resolve_impl(impl, x) == 'cuda':
            x1, x2, h = self.kernel_stem(x, 'cuda')
        else:
            x1, x2, h = self.module_stem(x)                    # c @ 1/2, 1/4
        stem = F.relu(self.stem_block3(h))                     # 2c @ 1/8
        edge = self.seam(stem)

        x_c = self.gltb1(self.context1(stem, impl))            # 4c @ 1/16
        x_s = self.spatial1(stem, impl)                        # 2c @ 1/8
        comp = self.compression_aff(F.relu(x_c))
        x_c = x_c + self.down_1(F.relu(x_s))
        comp = resize_bilinear(comp, out_size, self.align_corners)
        x_s = self.aff1(x_s, comp)
        c3_feat = x_s

        x_c = self.gltb2(self.context2(F.relu(x_c), impl))     # 8c @ 1/32
        x_s = self.spatial2(F.relu(x_s), impl)
        comp = self.compression_2(F.relu(x_c))
        x_c = x_c + self.down_2b(self.down_2a(F.relu(x_s)))
        comp = resize_bilinear(comp, out_size, self.align_corners)
        x_s = self.aff2(x_s, comp)
        x_s = edge * x_s + x_s                                 # SEAM inject

        x_s = self.spatial3(F.relu(x_s), impl)                 # 4c @ 1/8
        x_c = self.context3(F.relu(x_c), impl)                 # 16c @ 1/64
        x_c = self.spp(x_c, impl)
        if self.spp_out is not None:
            x_c = self.spp_out(x_c)
        x_c = self.gltb3(x_c)
        x_c = resize_bilinear(x_c, out_size, self.align_corners)
        c5_feat = x_s + x_c                                    # 4c @ 1/8
        return c3_feat, c5_feat, x1, x2
