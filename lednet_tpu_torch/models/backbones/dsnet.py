"""DSNet, a dual-branch model with its own segment heads, and its MFACB and
SPASPP blocks, NCHW.

Counterpart of ``lednet_tpu/models/backbones/dsnet.py`` (``MFACB`` :37,
``SPASPP`` :66, ``_SegHead`` :97, ``DSNet`` :112):

- ``MFACB`` chains three dilated 3x3 convs (the first with ``stride_1``),
  concatenates their outputs into a 1x1 ``process2`` and adds a 1x1
  ``process1`` of the input;
- ``SPASPP`` chains four 3x3 convs dilated 6/12/18/24, concatenates them
  and a global-pool branch (``pooling``, resized back) into a 1x1
  ``process2``, adds a 1x1 ``process1`` of the input and ends in a 3x3
  ``process3``;
- ``_SegHead`` is a pre-activation ``conv1`` (BatchNorm over the input,
  no activation) applied to ``relu(x)``, a ReLU, and a biased 1x1 ``conv2``;
- ``DSNet`` runs a detail branch of BasicBlocks and a semantic branch of
  MFACBs at 1/8, fused three times through ``MutiAFF`` (``aff1-3``, the
  semantic side through ``compression3-5``), then SPASPP, ``up8`` resized
  2x and concatenated before the ``layer1_a`` tap at 1/4 (taken before the
  ReLU that enters stage 2), and ``lastlayer``.  It returns ``(aux_p,
  main, aux_d)`` at the input size when ``augment``, else ``main``.

As in the JAX package, DSNet is a module and not a segmentor: it has no
``loss`` and no ``predict``, and ``init_model`` and ``Runner`` refuse its
config.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.aff import MutiAFF
from lednet_tpu_torch.models.layers import BasicBlock, Bottleneck, ConvModule
from lednet_tpu_torch.ops.pool import global_avg_pool
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

_BN = dict(type='BN')
_RELU = dict(type='ReLU')


def _conv(cin, cout, k, act=True, **kw):
    return ConvModule(cin, cout, k, norm_cfg=_BN,
                      act_cfg=_RELU if act else None, **kw)


class MFACB(nn.Module):

    def __init__(self, in_planes: int, inter_planes: int, out_planes: int,
                 stride_1: int = 1, dilation: Sequence[int] = (2, 2, 2)):
        super().__init__()
        self.n = len(dilation)
        for i, d in enumerate(dilation):
            self.add_module(f'conv{i}', _conv(
                in_planes if i == 0 else inter_planes, inter_planes, 3,
                stride=stride_1 if i == 0 else 1, padding=d, dilation=d))
        self.process1 = _conv(in_planes, out_planes, 1, stride=stride_1)
        self.process2 = _conv(inter_planes * self.n, out_planes, 1)

    def forward(self, x):
        taps, h = [], x
        for i in range(self.n):
            h = getattr(self, f'conv{i}')(h)
            taps.append(h)
        return self.process2(torch.cat(taps, 1)) + self.process1(x)


class SPASPP(nn.Module):

    def __init__(self, in_planes: int, inter_planes: int, out_planes: int,
                 dilation: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.n = len(dilation)
        for i, d in enumerate(dilation):
            self.add_module(f'conv{i}', _conv(
                in_planes if i == 0 else inter_planes, inter_planes, 3,
                padding=d, dilation=d))
        self.pooling = _conv(in_planes, inter_planes, 1)
        self.process1 = _conv(in_planes, out_planes, 1)
        self.process2 = _conv(inter_planes * (self.n + 1), out_planes, 1)
        self.process3 = _conv(out_planes, out_planes, 3, padding=1)

    def forward(self, x):
        taps, h = [], x
        for i in range(self.n):
            h = getattr(self, f'conv{i}')(h)
            taps.append(h)
        taps.append(resize_bilinear(self.pooling(global_avg_pool(x)),
                                    x.shape[-2:], False))
        out = self.process2(torch.cat(taps, 1)) + self.process1(x)
        return self.process3(out)


class _SegHead(nn.Module):

    def __init__(self, inplanes: int, interplanes: int, outplanes: int):
        super().__init__()
        self.conv1 = ConvModule(inplanes, interplanes, 3, padding=1,
                                norm_cfg=_BN, act_cfg=None,
                                order=('norm', 'act', 'conv'))
        self.conv2 = nn.Conv2d(interplanes, outplanes, 1)
        self.conv2.lecun_init = True          # flax's default kernel init

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x))))


@MODELS.register_module()
class DSNet(nn.Module):

    def __init__(self, m: int = 2, n: int = 3, num_classes: int = 19,
                 planes: int = 64, name_variant: str = 's128',
                 augment: bool = True, init_cfg: Optional[Dict] = None):
        """``name_variant`` and ``init_cfg`` are accepted for the configs
        and unread, as in the JAX package."""
        super().__init__()
        p = planes
        self.m, self.n, self.augment = m, n, augment
        self.conv1a = _conv(3, p, 3, stride=2, padding=1)
        self.conv1b = _conv(p, p, 3, stride=2, padding=1)
        for i in range(m):
            self.add_module(f'layer1_{i}', BasicBlock(p, p, norm_cfg=_BN,
                                                      act_out=i < m - 1))
        self.layer1_a = BasicBlock(p, p, norm_cfg=_BN, act_out=False)
        for i in range(m):
            self.add_module(f'layer2_{i}', BasicBlock(
                p if i == 0 else 2 * p, 2 * p, stride=2 if i == 0 else 1,
                downsample=i == 0, norm_cfg=_BN, act_out=i < m - 1))
        self.layer3_0 = MFACB(2 * p, 2 * p, 4 * p)
        self.layer3_1 = MFACB(4 * p, 4 * p, 4 * p)
        self.layer3_2 = MFACB(4 * p, 4 * p, 4 * p, dilation=(3, 3, 3))
        for i in range(n):
            self.add_module(f'layer3__{i}', BasicBlock(
                2 * p if i == 0 else 4 * p, 4 * p, downsample=i == 0,
                norm_cfg=_BN, act_out=i < n - 1))
        self.compression3 = _conv(4 * p, 4 * p, 1, act=False)
        self.aff1 = MutiAFF(4 * p)
        self.layer4_0 = MFACB(4 * p, 4 * p, 8 * p, dilation=(3, 3, 3))
        self.layer4_1 = MFACB(8 * p, 8 * p, 8 * p, dilation=(5, 5, 5))
        for i in range(n):
            self.add_module(f'layer4__{i}', BasicBlock(
                4 * p, 4 * p, norm_cfg=_BN, act_out=i < n - 1))
        self.compression4 = _conv(8 * p, 4 * p, 1, act=False)
        self.aff2 = MutiAFF(4 * p)
        self.layer5_ = Bottleneck(4 * p, 2 * p, norm_cfg=_BN, act_out=False)
        self.layer5 = Bottleneck(8 * p, 4 * p, norm_cfg=_BN, act_out=False)
        self.compression5 = _conv(8 * p, 4 * p, 1, act=False)
        self.aff3 = MutiAFF(4 * p)
        self.spp = SPASPP(4 * p, 4 * p, 4 * p)
        self.up8 = _conv(4 * p, 4 * p, 3, act=False, padding=1)
        self.lastlayer = _SegHead(5 * p, 4 * p, num_classes)
        if augment:
            self.seghead_p = _SegHead(4 * p, 4 * p, num_classes)
            self.seghead_d = _SegHead(4 * p, p, num_classes)

    def _blocks(self, x, name, count):
        for i in range(count):
            x = getattr(self, f'{name}{i}')(x)
        return x

    def forward(self, x):
        """(B, 3, H, W), promoted to the weights' dtype -> (aux_p, main,
        aux_d) logits at H x W when ``augment``, else ``main``."""
        size = x.shape[-2:]
        x = x.to(self.conv1a.conv.weight.dtype)
        h1 = self._blocks(self.conv1b(self.conv1a(x)), 'layer1_', self.m)
        x_a = self.layer1_a(h1)                                  # 1/4 tap
        h2 = F.relu(self._blocks(F.relu(h1), 'layer2_', self.m))  # 2p, 1/8

        s = self.layer3_2(self.layer3_1(self.layer3_0(h2)))
        d = self._blocks(h2, 'layer3__', self.n)
        d = self.aff1(d, self.compression3(s))
        temp_1 = d

        s = self.layer4_1(self.layer4_0(s))
        d2 = self._blocks(F.relu(d), 'layer4__', self.n)
        d = self.aff2(d2, self.compression4(s))
        temp_2 = d

        d = self.layer5_(F.relu(d))
        s = F.relu(self.layer5(s))
        d = F.relu(self.aff3(d, self.compression5(s)))
        d = self.up8(self.spp(d))
        d = resize_bilinear(d, (d.shape[-2] * 2, d.shape[-1] * 2), False)
        main = self.lastlayer(torch.cat([d, x_a], 1))
        main = resize_bilinear(main, size, False)
        if not self.augment:
            return main
        aux_p = resize_bilinear(self.seghead_p(temp_1), size, False)
        aux_d = resize_bilinear(self.seghead_d(temp_2), size, False)
        return aux_p, main, aux_d
