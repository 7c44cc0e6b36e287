"""HRNet backbone (parallel multi-resolution branches, repeatedly fused),
NCHW.

Counterpart of ``lednet_tpu/models/backbones/hrnet.py`` (``_Fuse`` :21,
``HRNet`` :57):

- a stem of two 3x3/s2 convs (64 channels) to 1/4 (``stem1``, ``stem2``);
- stage 1: expansion-4 bottlenecks with the output ReLU
  (``ResBottleneck``), a 1x1 downsample where the input width is not 4x
  theirs (``layer1_{i}``);
- stages 2-4, each after a transition (``t{s}_{i}``: a 3x3 conv where a
  branch's width changes, a 3x3/s2 conv from the last branch for a new
  one): ``num_modules`` times the branches' BasicBlocks
  (``s{s}_m{m}_b{i}_{b}``) then a fusion (``s{s}_m{m}_fuse``);
- ``_Fuse``: each output branch sums every input branch, a coarser one
  through a 1x1 conv + BatchNorm upsampled bilinearly (``f{i}_{j}``), a
  finer one through a chain of 3x3/s2 convs, the intermediate ones at the
  input's width with a ReLU, the last to the output's width without one
  (``f{i}_{j}_{k}``); ReLU of the sum.

Returns the branches' maps, finest first.  As in the JAX package, the
stages' ``num_branches`` and ``block`` and the keys ``norm_eval``,
``with_cp``, ``frozen_stages``, ``zero_init_residual``,
``multiscale_output``, ``pretrained`` and ``init_cfg`` are accepted and
unused: the branches are ``num_channels``' and the blocks are fixed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import BasicBlock, ConvModule, ResBottleneck
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

_RELU = dict(type='ReLU')


class _Fuse(nn.Module):
    """Cross-resolution fusion of parallel branches of ``channels``."""

    def __init__(self, channels: Sequence[int], norm_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        n = self.n = len(channels)
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f'f{i}_{j}', ConvModule(
                        channels[j], channels[i], 1, norm_cfg=norm_cfg))
                for k in range(i - j):
                    last = k == i - j - 1
                    self.add_module(f'f{i}_{j}_{k}', ConvModule(
                        channels[j], channels[i] if last else channels[j], 3,
                        stride=2, padding=1, norm_cfg=norm_cfg,
                        act_cfg=None if last else _RELU))

    def forward(self, xs: Sequence) -> List:
        outs = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = xs[j]
                if j > i:
                    y = resize_bilinear(getattr(self, f'f{i}_{j}')(y),
                                        xs[i].shape[-2:], False)
                for k in range(i - j):
                    y = getattr(self, f'f{i}_{j}_{k}')(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


@MODELS.register_module()
class HRNet(nn.Module):

    def __init__(self, extra: Dict, in_channels: int = 3,
                 norm_cfg: Optional[Dict] = None, norm_eval: bool = False,
                 with_cp: bool = False, frozen_stages: int = -1,
                 zero_init_residual: bool = False,
                 multiscale_output: bool = True,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.stem1 = ConvModule(in_channels, 64, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg, act_cfg=_RELU)
        self.stem2 = ConvModule(64, 64, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg, act_cfg=_RELU)
        s1 = extra['stage1']
        ch = s1['num_channels'][0]
        in_ch = 64
        self.layer1 = []
        for i in range(s1['num_blocks'][0]):
            self.add_module(f'layer1_{i}', ResBottleneck(
                in_ch, ch, downsample=in_ch != ch * 4, norm_cfg=norm_cfg))
            self.layer1.append(f'layer1_{i}')
            in_ch = ch * 4

        # per stage: (transitions [(conv name or None, input branch)],
        # modules [(each branch's block names, fuse name)])
        self.stages = []
        prev = [in_ch]
        for s in (2, 3, 4):
            if f'stage{s}' not in extra:
                break
            scfg = extra[f'stage{s}']
            chans = list(scfg['num_channels'])
            trans = []
            for i, c in enumerate(chans):
                src = min(i, len(prev) - 1)
                if i < len(prev) and prev[i] == c:
                    trans.append((None, i))
                    continue
                self.add_module(f't{s}_{i}', ConvModule(
                    prev[src], c, 3, stride=1 if i < len(prev) else 2,
                    padding=1, norm_cfg=norm_cfg, act_cfg=_RELU))
                trans.append((f't{s}_{i}', src))
            modules = []
            for m in range(scfg['num_modules']):
                blocks = []
                for i, c in enumerate(chans):
                    names = [f's{s}_m{m}_b{i}_{b}'
                             for b in range(scfg['num_blocks'][i])]
                    for name in names:
                        self.add_module(name, BasicBlock(c, c,
                                                         norm_cfg=norm_cfg))
                    blocks.append(names)
                self.add_module(f's{s}_m{m}_fuse', _Fuse(chans, norm_cfg))
                modules.append((blocks, f's{s}_m{m}_fuse'))
            self.stages.append((trans, modules))
            prev = chans

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W); ``impl`` is accepted for the segmentor's call and
        unused; ``x`` is cast to the weights' dtype."""
        h = self.stem2(self.stem1(x.to(self.stem1.conv.weight.dtype)))
        for name in self.layer1:
            h = getattr(self, name)(h)
        xs = [h]
        for trans, modules in self.stages:
            xs = [xs[src] if name is None else getattr(self, name)(xs[src])
                  for name, src in trans]
            for blocks, fuse in modules:
                outs = []
                for h, names in zip(xs, blocks):
                    for name in names:
                        h = getattr(self, name)(h)
                    outs.append(h)
                xs = getattr(self, fuse)(outs)
        return tuple(xs)
