"""CGNet backbone (context guided network), NCHW.

Counterpart of ``lednet_tpu/models/backbones/cgnet.py``
(``GlobalContextExtractor`` :22, ``ContextGuidedBlock`` :36, ``CGNet`` :81):
a stem of three 3x3 convs (the first stride 2) with BatchNorm and
per-channel PReLU; two stages of context guided blocks, each stage's first
block downsampling; the image, average-pooled 3/2/1 (zero padding counted),
concatenated into the stem's and the first stage's outputs; each stage's
output BatchNorm + PReLU (``norm_prelu_{i}`` / ``act_prelu_{i}``).

A context guided block: a 1x1 conv (3x3/s2 when it downsamples) to its
width (``conv1x1``, ``norm1``, ``act1``), a depthwise 3x3 (``f_loc``) beside
a depthwise 3x3 dilated by the stage's rate (``f_sur``), concatenated, then
BatchNorm + PReLU (``bn``, ``act2``), a 1x1 to the output width when it
downsamples (``reduce``), a channel gate from the global average (``f_glo``:
``fc1`` -> ReLU -> ``fc2`` -> sigmoid, ``nn.Linear`` layers, flax
``Dense``), and the input added back when it does not.

Returns the three stage outputs (1/2, 1/4, 1/8).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import Norm2d, PReLU
from lednet_tpu_torch.ops.pool import avg_pool2d, global_avg_pool
from lednet_tpu_torch.registry import MODELS


class GlobalContextExtractor(nn.Module):

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x):
        g = global_avg_pool(x).flatten(1)
        g = torch.sigmoid(self.fc2(F.relu(self.fc1(g))))
        return x * g[:, :, None, None]


class ContextGuidedBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, dilation: int = 2,
                 reduction: int = 16, downsample: bool = False,
                 skip_connect: bool = True, norm_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        channels = out_channels if downsample else out_channels // 2
        k = 3 if downsample else 1
        self.downsample = downsample
        self.skip = skip_connect and not downsample
        self.conv1x1 = nn.Conv2d(in_channels, channels, k, 2 if downsample else 1,
                                 (k - 1) // 2, bias=False)
        self.norm1 = Norm2d(norm_cfg, channels)
        self.act1 = PReLU(channels)
        self.f_loc = nn.Conv2d(channels, channels, 3, padding=1,
                               groups=channels, bias=False)
        self.f_sur = nn.Conv2d(channels, channels, 3, padding=dilation,
                               dilation=dilation, groups=channels, bias=False)
        self.bn = Norm2d(norm_cfg, 2 * channels)
        self.act2 = PReLU(2 * channels)
        self.reduce = (nn.Conv2d(2 * channels, out_channels, 1, bias=False)
                       if downsample else None)
        self.f_glo = GlobalContextExtractor(out_channels, reduction)

    def forward(self, x):
        h = self.act1(self.norm1(self.conv1x1(x)))
        joi = self.act2(self.bn(torch.cat([self.f_loc(h), self.f_sur(h)], 1)))
        if self.reduce is not None:
            joi = self.reduce(joi)
        out = self.f_glo(joi)
        return x + out if self.skip else out


@MODELS.register_module()
class CGNet(nn.Module):

    def __init__(self, in_channels: int = 3,
                 num_channels: Sequence[int] = (32, 64, 128),
                 num_blocks: Sequence[int] = (3, 21),
                 dilations: Sequence[int] = (2, 4),
                 reductions: Sequence[int] = (8, 16),
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``act_cfg`` is accepted for the configs and, as in the JAX
        package, unused: every activation is PReLU."""
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        c0, c1, c2 = num_channels
        cur = in_channels
        for i in range(3):
            self.add_module(f'stem{i}', nn.Conv2d(cur, c0, 3, 2 if i == 0 else 1,
                                                  1, bias=False))
            self.add_module(f'stem_norm{i}', Norm2d(norm_cfg, c0))
            self.add_module(f'stem_act{i}', PReLU(c0))
            cur = c0
        widths = (c0 + in_channels, 2 * c1 + in_channels, 2 * c2)
        for i, w in enumerate(widths):
            self.add_module(f'norm_prelu_{i}', Norm2d(norm_cfg, w))
            self.add_module(f'act_prelu_{i}', PReLU(w))
        self.levels = []
        for lvl, (n, ch, cin) in enumerate(zip(num_blocks, (c1, c2), widths), 1):
            names = [f'level{lvl}_{i}' for i in range(n)]
            for i, name in enumerate(names):
                self.add_module(name, ContextGuidedBlock(
                    cin if i == 0 else ch, ch, dilations[lvl - 1],
                    reductions[lvl - 1], downsample=i == 0, norm_cfg=norm_cfg))
            self.levels.append(names)

    def _stage_out(self, i, feats):
        h = getattr(self, f'norm_prelu_{i}')(torch.cat(feats, 1))
        return getattr(self, f'act_prelu_{i}')(h)

    def _level(self, i, h):
        """Level ``i``'s blocks: (its first block's output, its last's)."""
        first = h = getattr(self, self.levels[i][0])(h)
        for name in self.levels[i][1:]:
            h = getattr(self, name)(h)
        return first, h

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W).  ``impl`` is accepted for the segmentor's call
        and unused: no kernel runs here."""
        x = h = x.to(self.stem0.weight.dtype)
        for i in range(3):
            h = getattr(self, f'stem_act{i}')(getattr(self, f'stem_norm{i}')(
                getattr(self, f'stem{i}')(h)))
        inp_down1 = avg_pool2d(x, 3, 2, 1)
        inp_down2 = avg_pool2d(inp_down1, 3, 2, 1)
        out0 = self._stage_out(0, [h, inp_down1])
        down1, h = self._level(0, out0)
        out1 = self._stage_out(1, [h, down1, inp_down2])
        down2, h = self._level(1, out1)
        return out0, out1, self._stage_out(2, [down2, h])
