"""ResNet backbones (ResNet, ResNetV1c), NCHW.

Counterpart of ``lednet_tpu/models/backbones/resnet.py`` (``_ResBasicBlock``
:22, ``_ResBottleneck`` :62, ``ResNet`` :105): depths 18/34 (``BasicBlock``)
and 50/101/152 (``Bottleneck`` of expansion 4 with the output ReLU and the
stride on the 3x3 conv, the ``style='pytorch'`` placement), a 7x7/s2 stem
or the three-conv deep stem (ResNetV1c), a 3x3/s2 max pool padded with
``-inf``, per-stage ``strides`` and ``dilations`` (``contract_dilation``
halves a stage's first dilation), and ``out_indices``.  Blocks are named
``layer{stage}_{block}`` as in the flax tree.

``style``, ``frozen_stages``, ``norm_eval``, ``with_cp``, ``pretrained`` and
``init_cfg`` are accepted for the configs and, as in the JAX package, have no
effect.  ``avg_down`` (ResNetV1d), ``multi_grid``, ICNet's ``ceil_maxpool``
and ``stage_range``, which no config of the port's models sets, are later
work.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.nn as nn

from lednet_tpu_torch.models.layers import BasicBlock, Bottleneck, ConvModule
from lednet_tpu_torch.ops.pool import max_pool2d
from lednet_tpu_torch.registry import MODELS


class _ResBottleneck(Bottleneck):
    """ResNet's bottleneck: expansion 4 and the output ReLU."""
    expansion = 4

    def __init__(self, *args, **kwargs):
        super().__init__(*args, act_out=True, **kwargs)


@MODELS.register_module()
class ResNet(nn.Module):
    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (_ResBottleneck, (3, 4, 6, 3)),
        101: (_ResBottleneck, (3, 4, 23, 3)),
        152: (_ResBottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: int = 64, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 deep_stem: bool = False, contract_dilation: bool = False,
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 frozen_stages: int = -1, norm_eval: bool = False,
                 style: str = 'pytorch', pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None, with_cp: bool = False):
        super().__init__()
        if depth not in self.arch_settings:
            raise ValueError(f'invalid depth {depth} for ResNet')
        norm_cfg = norm_cfg or dict(type='BN')
        relu = dict(type='ReLU')
        block_cls, stage_blocks = self.arch_settings[depth]
        self.deep_stem = deep_stem
        self.out_indices = tuple(out_indices)
        if deep_stem:
            mid = stem_channels // 2
            self.stem1 = ConvModule(in_channels, mid, 3, stride=2, padding=1,
                                    norm_cfg=norm_cfg, act_cfg=relu)
            self.stem2 = ConvModule(mid, mid, 3, padding=1, norm_cfg=norm_cfg,
                                    act_cfg=relu)
            self.stem3 = ConvModule(mid, stem_channels, 3, padding=1,
                                    norm_cfg=norm_cfg, act_cfg=relu)
        else:
            self.stem = ConvModule(in_channels, stem_channels, 7, stride=2,
                                   padding=3, norm_cfg=norm_cfg, act_cfg=relu)
        self.stages = []
        in_ch = stem_channels
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            names = []
            for j in range(stage_blocks[i]):
                d = dilations[i]
                if j == 0 and d > 1 and contract_dilation:
                    d //= 2
                s = strides[i] if j == 0 else 1
                name = f'layer{i + 1}_{j}'
                self.add_module(name, block_cls(
                    in_ch, planes, stride=s, dilation=d,
                    downsample=s != 1 or in_ch != planes * block_cls.expansion,
                    norm_cfg=norm_cfg))
                names.append(name)
                in_ch = planes * block_cls.expansion
            self.stages.append(names)

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W); the outputs of the stages in ``out_indices``.
        ``impl`` is accepted for the segmentor's call and unused."""
        if self.deep_stem:
            x = self.stem3(self.stem2(self.stem1(x)))
        else:
            x = self.stem(x)
        x = max_pool2d(x, 3, 2, 1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs[i] for i in self.out_indices)


@MODELS.register_module()
class ResNetV1c(ResNet):
    """ResNet with the three-conv deep stem."""

    def __init__(self, deep_stem: bool = True, **kwargs):
        super().__init__(deep_stem=deep_stem, **kwargs)
