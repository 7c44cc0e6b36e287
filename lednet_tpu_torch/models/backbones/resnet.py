"""ResNet backbones (ResNet, ResNetV1c), NCHW.

Counterpart of ``lednet_tpu/models/backbones/resnet.py`` (``_ResBasicBlock``
:22, ``_ResBottleneck`` :62, ``ResNet`` :105): depths 18/34 (``BasicBlock``)
and 50/101/152 (``models/layers.py``'s ``ResBottleneck``, expansion 4 with
the output ReLU and the stride on the 3x3 conv, the ``style='pytorch'``
placement), a 7x7/s2 stem or the three-conv deep stem (ResNetV1c), a
3x3/s2 max pool padded with ``-inf``, per-stage ``strides`` and
``dilations`` (``contract_dilation`` halves a stage's first dilation), and
``out_indices``.  Blocks are named
``layer{stage}_{block}`` as in the flax tree.

ICNet's trunk (``lednet_tpu/models/backbones/icnet.py:64-65``) sets
``ceil_maxpool``: the stem's pool runs in ceil mode (the JAX package pads
the bottom and right edge by one where the floor would drop it, :169-176),
and enters the one trunk twice through ``forward``'s ``stage_range``.

``style``, ``frozen_stages``, ``norm_eval``, ``with_cp``, ``pretrained`` and
``init_cfg`` are accepted for the configs and, as in the JAX package, have no
effect.  ``avg_down`` (ResNetV1d) and ``multi_grid``, which no config of the
port's models sets, are later work.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import BasicBlock, ConvModule, ResBottleneck
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class ResNet(nn.Module):
    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (ResBottleneck, (3, 4, 6, 3)),
        101: (ResBottleneck, (3, 4, 23, 3)),
        152: (ResBottleneck, (3, 8, 36, 3)),
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
                 init_cfg: Optional[Dict] = None, with_cp: bool = False,
                 ceil_maxpool: bool = False):
        super().__init__()
        if depth not in self.arch_settings:
            raise ValueError(f'invalid depth {depth} for ResNet')
        norm_cfg = norm_cfg or dict(type='BN')
        relu = dict(type='ReLU')
        block_cls, stage_blocks = self.arch_settings[depth]
        self.deep_stem = deep_stem
        self.ceil_maxpool = ceil_maxpool
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
        self.stage_channels = []        # each stage's output width
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
            self.stage_channels.append(in_ch)

    def forward(self, x, impl: Optional[str] = None, stage_range=None):
        """x: (B, 3, H, W), promoted to the weights' dtype; the outputs of
        the stages in ``out_indices``.  ``stage_range=(lo, hi)`` runs stages ``lo..hi-1`` only, the stem only
        when ``lo == 0`` (else ``x`` is stage ``lo - 1``'s output), and
        returns each of their outputs, unfiltered by ``out_indices``
        (``lednet_tpu/models/backbones/resnet.py:139-182``).  ``impl`` is
        accepted for the segmentor's call and unused."""
        lo, hi = stage_range if stage_range is not None else (0, len(self.stages))
        if lo == 0:
            stem = self.stem1 if self.deep_stem else self.stem
            x = x.to(stem.conv.weight.dtype)
            if self.deep_stem:
                x = self.stem3(self.stem2(self.stem1(x)))
            else:
                x = self.stem(x)
            x = F.max_pool2d(x, 3, 2, 1, ceil_mode=self.ceil_maxpool)
        outs = []
        for names in self.stages[lo:hi]:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        if stage_range is not None:
            return tuple(outs)
        return tuple(outs[i] for i in self.out_indices)


@MODELS.register_module()
class ResNetV1c(ResNet):
    """ResNet with the three-conv deep stem."""

    def __init__(self, deep_stem: bool = True, **kwargs):
        super().__init__(deep_stem=deep_stem, **kwargs)
