"""MobileNetV3 backbone (the dense-prediction form of LR-ASPP), NCHW.

Counterpart of ``lednet_tpu/models/backbones/mobilenet.py``
(``make_divisible`` :87, ``_SEBlock`` :99, ``MobileNetV3`` :117), arch
'large' (the one a config uses; 'small' raises):

- the stem, a 3x3/s2 conv padded as TF's 'SAME' (``stem_conv``: at an even
  size one row and column after, none before; at an odd size one on each
  side), BatchNorm (``stem_norm``) and hard-swish;
- inverted residual blocks ``b{i}``: a 1x1 expansion where the width
  changes (``b{i}_expand``), a depthwise conv (``b{i}_dw``), each followed by
  the block's activation (ReLU or hard-swish), a squeeze-excitation gate
  (``b{i}_se``: global average, 1x1 ``fc1`` with bias to
  ``make_divisible(c // 4, 8)``, ReLU, 1x1 ``fc2`` with bias, the gate
  ``clip(g / 6 + 0.5, 0, 1)``) where the arch has one, and a 1x1
  projection (``b{i}_project``); the input added back where the arch's
  stride is 1 and the width unchanged;
- output stride 8: the two deep stride-2 blocks (6 and 12, 0-based) run
  at stride 1, their residual still off, as it is decided by the arch's
  stride; the depthwise convs dilated by 2 from layer 7 and by 4 from
  layer 13, the stem being layer 0;
- a final 1x1 conv to 960 channels (``final_conv``) and hard-swish.

Returns the maps at ``out_indices`` of [stem, b0, ..., final].
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import ConvModule, Norm2d
from lednet_tpu_torch.ops.pool import global_avg_pool
from lednet_tpu_torch.registry import MODELS


def make_divisible(value, divisor=8, min_value=None, min_ratio=0.9):
    """Round ``value`` to the nearest multiple of ``divisor``, never below
    ``min_ratio`` of it (a copy of the JAX package's, which follows
    ``mmseg/models/utils/make_divisible.py``)."""
    if min_value is None:
        min_value = divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < min_ratio * value:
        new_value += divisor
    return new_value


class _SEBlock(nn.Module):

    def __init__(self, channels: int, ratio: int = 4):
        super().__init__()
        squeeze = make_divisible(channels // ratio, 8)
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x):
        g = self.fc2(F.relu(self.fc1(global_avg_pool(x))))
        return x * (g / 6.0 + 0.5).clamp(0, 1)


def _act(name: str, x):
    """The block activation ``name`` of ``x``, ``F.relu`` looked up at the
    call (a train step's ReLU decisions can be recorded by patching it)."""
    return F.hardswish(x) if name == 'HSwish' else F.relu(x)


@MODELS.register_module()
class MobileNetV3(nn.Module):
    # (kernel, mid, out, SE, act, stride)
    arch_settings = {
        'large': [(3, 16, 16, False, 'ReLU', 1), (3, 64, 24, False, 'ReLU', 2),
                  (3, 72, 24, False, 'ReLU', 1), (5, 72, 40, True, 'ReLU', 2),
                  (5, 120, 40, True, 'ReLU', 1), (5, 120, 40, True, 'ReLU', 1),
                  (3, 240, 80, False, 'HSwish', 2), (3, 200, 80, False, 'HSwish', 1),
                  (3, 184, 80, False, 'HSwish', 1), (3, 184, 80, False, 'HSwish', 1),
                  (3, 480, 112, True, 'HSwish', 1), (3, 672, 112, True, 'HSwish', 1),
                  (5, 672, 160, True, 'HSwish', 2), (5, 960, 160, True, 'HSwish', 1),
                  (5, 960, 160, True, 'HSwish', 1)],
    }

    def __init__(self, arch: str = 'small',
                 out_indices: Sequence[int] = (0, 1, 12),
                 norm_cfg: Optional[Dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None):
        """The JAX package's arch 'small' (its default) and
        ``reduction_factor`` (of the last stages' widths), which no config
        uses, are not ported."""
        super().__init__()
        if arch not in self.arch_settings:
            raise ValueError(f'arch {arch!r} of MobileNetV3 is not ported '
                             f'(only {sorted(self.arch_settings)})')
        norm_cfg = norm_cfg or dict(type='BN')
        # the conversion to output stride 8, by layer (the stem is layer 0)
        dil2_start, dil4_start = 7, 13
        stride_reset = {6, 12}                          # 0-based blocks
        self.out_indices = tuple(out_indices)
        in_ch = 16
        self.stem_conv = nn.Conv2d(3, in_ch, 3, 2, 0, bias=False)
        self.stem_norm = Norm2d(norm_cfg, in_ch)
        self.blocks = []        # (activation, residual) of each block
        for i, (k, mid, out_ch, se, act, stride) in enumerate(
                self.arch_settings[arch]):
            residual = stride == 1 and in_ch == out_ch
            dil = 4 if i + 1 >= dil4_start else 2 if i + 1 >= dil2_start else 1
            if mid != in_ch:
                self.add_module(f'b{i}_expand', ConvModule(in_ch, mid, 1,
                                                           norm_cfg=norm_cfg))
            self.add_module(f'b{i}_dw', ConvModule(
                mid, mid, k, stride=1 if i in stride_reset else stride,
                padding=dil * (k - 1) // 2, dilation=dil, groups=mid,
                norm_cfg=norm_cfg))
            if se:
                self.add_module(f'b{i}_se', _SEBlock(mid))
            self.add_module(f'b{i}_project', ConvModule(mid, out_ch, 1,
                                                        norm_cfg=norm_cfg))
            self.blocks.append((act, residual))
            in_ch = out_ch
        self.final_conv = ConvModule(in_ch, 960, 1, norm_cfg=norm_cfg)

    @staticmethod
    def same_pad(size: int, kernel: int = 3, stride: int = 2):
        """TF 'SAME' padding (before, after) of one axis."""
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        return total // 2, total - total // 2

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W).  ``impl`` is accepted for the segmentor's call
        and unused: no kernel runs here."""
        x = x.to(self.stem_conv.weight.dtype)
        (top, bottom), (left, right) = (self.same_pad(n) for n in x.shape[-2:])
        x = F.hardswish(self.stem_norm(self.stem_conv(
            F.pad(x, (left, right, top, bottom)))))
        outs = [x]
        for i, (act, residual) in enumerate(self.blocks):
            h = x
            if hasattr(self, f'b{i}_expand'):
                h = _act(act, getattr(self, f'b{i}_expand')(h))
            h = _act(act, getattr(self, f'b{i}_dw')(h))
            if hasattr(self, f'b{i}_se'):
                h = getattr(self, f'b{i}_se')(h)
            h = getattr(self, f'b{i}_project')(h)
            x = h + x if residual else h
            outs.append(x)
        outs.append(F.hardswish(self.final_conv(x)))
        return tuple(outs[i] for i in self.out_indices)
