"""DPT's decode head, NCHW: reassemble, fuse, classify.

Counterpart of ``lednet_tpu/models/decode_heads/point_setr_heads.py``
(``_PreActRCU`` :343, ``DPTHead`` :366):

- reassemble, per selected level (a (grid, cls) pair from a ViT with
  ``output_cls_token``, or a grid): with ``readout_type='project'`` the
  cls token broadcast over the grid, concatenated after the channels and
  through ``readout{i}`` (a Linear back to the width) and exact GELU;
  with ``'add'`` the cls token added; ``'ignore'`` drops it.  Then a 1x1
  ``project{i}`` to ``post_process_channels[i]`` (a biased conv, no norm)
  and the level's resample: ``resize0`` / ``resize1`` transposed convs of
  kernel = stride = 4 / 2 (flax's ``ConvTranspose`` with
  ``transpose_kernel=True`` and padding k - 1, which is
  ``nn.ConvTranspose2d`` with padding 0), level 2 as it is, ``resize3`` a
  3x3 stride-2 conv (pad 1);
- ``conv{i}``: 3x3 convs to ``channels`` without bias or norm
  (``expand_channels`` is accepted and, as in the JAX head, changes no
  width: flax infers each conv's input from the map);
- fusion, deepest first: block 0 takes the deepest map, block i the
  previous block's output plus ``fusion{i}_rcu1`` of the next shallower
  map (resized bilinearly to it where their sizes differ); then
  ``fusion{i}_rcu2``, a bilinear x2 upsample with ``align_corners=True``
  and the 1x1 ``fusion{i}_project`` (biased, no norm).  A residual conv
  unit (``_PreActRCU``) is two (activation, 3x3 conv without bias, norm)
  layers plus its input;
- ``project`` (3x3, norm, ReLU), then ``cls``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


class _PreActRCU(nn.Module):

    def __init__(self, channels: int, norm_cfg, act_cfg):
        super().__init__()
        for name in ('conv1', 'conv2'):
            self.add_module(name, ConvModule(
                channels, channels, 3, padding=1, bias=False,
                norm_cfg=norm_cfg, act_cfg=act_cfg,
                order=('act', 'conv', 'norm')))

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


@MODELS.register_module()
class DPTHead(HeadBase):
    takes_list = True

    def __init__(self, *args, embed_dims: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = 'ignore', patch_size: int = 16,
                 expand_channels: bool = False,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(*args, in_index=in_index,
                         input_transform=input_transform, **kwargs)
        if readout_type not in ('ignore', 'add', 'project'):
            raise ValueError(f'DPTHead readout_type={readout_type!r}')
        self.readout_type = readout_type
        widths = list(self.in_channels)
        post = [int(c) for c in post_process_channels]
        self.levels = len(in_index)
        ch = self.channels
        for i in range(self.levels):
            if readout_type == 'project':
                self.add_module(f'readout{i}',
                                nn.Linear(2 * widths[i], widths[i]))
            self.add_module(f'project{i}', ConvModule(widths[i], post[i], 1))
            self.add_module(f'conv{i}', ConvModule(post[i], ch, 3, padding=1,
                                                   bias=False))
        for i, k in ((0, 4), (1, 2)):
            if i < self.levels:
                self.add_module(f'resize{i}',
                                nn.ConvTranspose2d(post[i], post[i], k, k))
        if self.levels > 3:
            self.resize3 = nn.Conv2d(post[3], post[3], 3, 2, 1)
            self.resize3.lecun_init = True           # a bare flax ``nn.Conv``
        for i in range(self.levels):
            if i > 0:
                self.add_module(f'fusion{i}_rcu1', _PreActRCU(
                    ch, self.norm_cfg, self.act_cfg))
            self.add_module(f'fusion{i}_rcu2', _PreActRCU(
                ch, self.norm_cfg, self.act_cfg))
            self.add_module(f'fusion{i}_project', ConvModule(ch, ch, 1))
        self.project = ConvModule(ch, ch, 3, padding=1, norm_cfg=self.norm_cfg,
                                  act_cfg=dict(type='ReLU'))

    def reassemble(self, i: int, item) -> torch.Tensor:
        """Level ``i``'s map: the readout, ``project{i}``, the resample."""
        x, cls_token = item if isinstance(item, (tuple, list)) else (item, None)
        if self.readout_type == 'project':
            if cls_token is None:
                raise ValueError("DPTHead readout 'project' needs the ViT's "
                                 'cls token (output_cls_token=True)')
            readout = cls_token[:, :, None, None].expand_as(x)
            x = torch.cat([x, readout], 1).permute(0, 2, 3, 1)
            x = F.gelu(getattr(self, f'readout{i}')(x)).permute(0, 3, 1, 2)
        elif self.readout_type == 'add' and cls_token is not None:
            x = x + cls_token[:, :, None, None]
        x = getattr(self, f'project{i}')(x)
        resize = self._modules.get(f'resize{i}')
        return x if resize is None else resize(x)

    def forward(self, inputs, with_aux: bool = True):
        """The logits at twice the shallowest fused map; ``with_aux`` means
        nothing to a single-output head."""
        feats = [getattr(self, f'conv{i}')(self.reassemble(i, item))
                 for i, item in enumerate(self._select(inputs))]
        out = None
        for i in range(len(feats)):
            x = feats[-1] if i == 0 else out
            if i > 0:
                res = feats[-(i + 1)]
                if res.shape[-2:] != x.shape[-2:]:
                    res = resize_bilinear(res, x.shape[-2:], False)
                x = x + getattr(self, f'fusion{i}_rcu1')(res)
            x = getattr(self, f'fusion{i}_rcu2')(x)
            x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), True)
            out = getattr(self, f'fusion{i}_project')(x)
        return self.cls(self.project(out))
