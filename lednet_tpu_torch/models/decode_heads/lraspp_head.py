"""Lite R-ASPP decode head (MobileNetV3's), NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/uper_ocr.py:172``: on the
deepest selected map, a 1x1 conv with norm and activation (``aspp_conv``)
times a sigmoid gate (an average pool of kernel ``(min(49, H), min(49,
W))`` and stride (16, 20), no padding, then a bias-free 1x1 conv with a
sigmoid, ``image_pool``, resized bilinearly back); a plain 1x1 conv with
bias (``conv_up_input``); then, from the deepest branch to the shallowest,
the map resized to the branch's input, concatenated with a bias-free plain
1x1 conv of that input (``convs{bi}``, no norm) and fused by a 1x1 conv
with norm and activation (``conv_up{bi}``); dropout + the classifier.  The
pool's kernel is a Python int of the map's static shape: nothing syncs
with the host, and the eval step captures it as a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from lednet_tpu_torch.models.decode_heads.base import (ClsSeg, build_losses,
                                                       default_loss_by_feat,
                                                       resolve_out_channels,
                                                       select_inputs)
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.pool import avg_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class LRASPPHead(nn.Module):

    def __init__(self, in_channels: Sequence[int], channels: int,
                 num_classes: int, branch_channels: Sequence[int] = (32, 64),
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255,
                 in_index: Sequence[int] = (0, 1, 2),
                 input_transform: Optional[str] = 'multiple_select',
                 out_channels: Optional[int] = None,
                 loss_decode: Optional[Dict] = None,
                 sampler: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``in_channels``: the widths of the selected inputs, the deepest
        last.  ``input_transform`` is ``multiple_select`` whatever it says,
        as in the JAX package."""
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        self.in_index = in_index
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.branch_channels = tuple(branch_channels)
        self.losses = build_losses(loss_decode)
        self.sampler = (MODELS.build(dict(sampler)) if sampler is not None
                        else None)
        deep = in_channels[-1]
        self.aspp_conv = ConvModule(deep, channels, 1, bias=False,
                                    norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.image_pool = ConvModule(deep, channels, 1, bias=False,
                                     act_cfg=dict(type='Sigmoid'))
        self.conv_up_input = nn.Conv2d(channels, channels, 1)
        for bi, bc in enumerate(self.branch_channels):
            self.add_module(f'convs{bi}', nn.Conv2d(in_channels[bi], bc, 1,
                                                    bias=False))
            self.add_module(f'conv_up{bi}', ConvModule(
                channels + bc, channels, 1, bias=False, norm_cfg=norm_cfg,
                act_cfg=act_cfg))
        self.cls = ClsSeg(channels, resolve_out_channels(num_classes,
                                                         out_channels),
                          dropout_ratio)

    def forward(self, inputs, with_aux: bool = True):
        """The logits at the shallowest branch's size; ``with_aux`` is the
        segmentor's flag and means nothing to this head."""
        xs = select_inputs(inputs, self.in_index, 'multiple_select',
                           self.align_corners)
        deep = xs[-1]
        H, W = deep.shape[-2:]
        gate = self.image_pool(avg_pool2d(deep, (min(49, H), min(49, W)),
                                          (16, 20)))
        x = self.aspp_conv(deep)
        x = self.conv_up_input(x * resize_bilinear(gate, x.shape[-2:],
                                                   self.align_corners))
        for bi in range(len(self.branch_channels) - 1, -1, -1):
            mid = xs[bi]
            x = resize_bilinear(x, mid.shape[-2:], self.align_corners)
            x = torch.cat([x, getattr(self, f'convs{bi}')(mid)], 1)
            x = getattr(self, f'conv_up{bi}')(x)
        return self.cls(x)

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        return default_loss_by_feat(seg_logits, seg_label, self.losses,
                                    self.align_corners, self.ignore_index,
                                    self.sampler)

    def predict_by_feat(self, seg_logits, size=None):
        if size is None:
            return seg_logits
        return resize_bilinear(seg_logits, size, self.align_corners)
