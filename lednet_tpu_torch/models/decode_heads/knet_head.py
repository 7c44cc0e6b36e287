"""K-Net's iterative kernel-update head, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/knet_head.py``
(``KernelUpdator`` :40, ``KernelUpdateHead`` :68, ``IterativeDecodeHead``
:119), the semantic K-Net with ``conv_kernel_size=1``:

- ``KernelUpdator``: the gated update of N kernels (B, N, C) by the
  features grouped under them: ``dynamic_layer`` of the grouped features
  and ``input_layer`` of the kernels, each split in halves; their first
  halves' product through ``input_gate`` / ``update_gate``, a LayerNorm
  and a sigmoid; the second halves LayerNormed; ``update_gate *
  param_out + input_gate * input_out`` through ``fc_layer``, a LayerNorm
  and a ReLU;
- ``KernelUpdateHead``, one stage: the previous masks' softmax over the
  kernels, ``> hard_mask_thr`` (:meth:`KernelUpdateHead.hard_mask`, the
  stage's discrete decision), the features summed under each hard mask,
  the kernel update, multi-head self-attention over the N kernels
  (post-norm, residual), an FFN (post-norm, residual), ``num_mask_fcs``
  bias-free FCs with LayerNorm and ReLU, ``fc_mask``, and the new masks as
  the kernels' products with the features;
- ``IterativeDecodeHead``: ``num_convs`` 3x3 ``ConvModule``s, dropout in
  training, then ``seg_kernel`` (the (N, C, 1, 1) weight of a 1x1 conv;
  flax's (1, 1, C, N)) and ``seg_bias`` as the stage-0 masks' classifier
  and, transposed, the stage-0 kernels, then ``num_stages`` stages.  In
  training it returns every stage's masks (``num_stages + 1``), in eval
  the last.  ``loss_by_feat`` gives each stage's losses prefixed
  ``s{i}.``; ``predict_by_feat`` takes the last stage.

Every LayerNorm is flax's (eps 1e-6).  Masks are (B, N, H, W) here, (B,
H, W, N) in the JAX package.  The options the JAX head accepts and never
reads (``kernel_generate_head``, ``kernel_update_head``) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.base import default_loss_by_feat
from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.registry import MODELS

LN_EPS = 1e-6      # flax's LayerNorm


def layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=LN_EPS)


class KernelUpdator(nn.Module):

    def __init__(self, in_channels: int = 256, feat_channels: int = 256):
        super().__init__()
        self.feat_channels = feat_channels
        self.dynamic_layer = nn.Linear(in_channels, 2 * feat_channels)
        self.input_layer = nn.Linear(in_channels, 2 * feat_channels)
        self.input_gate = nn.Linear(feat_channels, feat_channels)
        self.update_gate = nn.Linear(feat_channels, feat_channels)
        self.input_norm_in = layer_norm(feat_channels)
        self.norm_in = layer_norm(feat_channels)
        self.norm_out = layer_norm(feat_channels)
        self.input_norm_out = layer_norm(feat_channels)
        self.fc_layer = nn.Linear(feat_channels, in_channels)
        self.fc_norm = layer_norm(in_channels)

    def forward(self, update_feature: torch.Tensor,
                input_feature: torch.Tensor) -> torch.Tensor:
        """(B, N, Cin) grouped features and (B, N, Cin) kernels -> the new
        kernels (B, N, Cin)."""
        param_in, param_out = self.dynamic_layer(update_feature).chunk(2, -1)
        input_in, input_out = self.input_layer(input_feature).chunk(2, -1)
        gate_feats = input_in * param_in
        input_gate = torch.sigmoid(self.input_norm_in(self.input_gate(gate_feats)))
        update_gate = torch.sigmoid(self.norm_in(self.update_gate(gate_feats)))
        feats = (update_gate * self.norm_out(param_out) +
                 input_gate * self.input_norm_out(input_out))
        return F.relu(self.fc_norm(self.fc_layer(feats)))


class KernelUpdateHead(nn.Module):

    def __init__(self, in_channels: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024, num_mask_fcs: int = 1,
                 hard_mask_thr: float = 0.5):
        super().__init__()
        C = in_channels
        self.num_heads = num_heads
        self.num_mask_fcs = num_mask_fcs
        self.hard_mask_thr = hard_mask_thr
        self.kernel_update_conv = KernelUpdator(C, C)
        for name in ('attn_q', 'attn_k', 'attn_v', 'attn_proj'):
            self.add_module(name, nn.Linear(C, C))
        self.attention_norm = layer_norm(C)
        self.ffn_fc1 = nn.Linear(C, feedforward_channels)
        self.ffn_fc2 = nn.Linear(feedforward_channels, C)
        self.ffn_norm = layer_norm(C)
        for i in range(num_mask_fcs):
            self.add_module(f'mask_fc{i}', nn.Linear(C, C, bias=False))
            self.add_module(f'mask_norm{i}', layer_norm(C))
        self.fc_mask = nn.Linear(C, C)

    def hard_mask(self, mask_preds: torch.Tensor) -> torch.Tensor:
        """The pixels (B, N, H, W, bool) each kernel groups: its softmax
        over the kernels above ``hard_mask_thr``."""
        return mask_preds.softmax(1) > self.hard_mask_thr

    def forward(self, x: torch.Tensor, kernels: torch.Tensor,
                mask_preds: torch.Tensor):
        """(B, C, H, W) features, (B, N, C) kernels and (B, N, H, W) masks
        -> (new masks, new kernels)."""
        hard = self.hard_mask(mask_preds).to(x.dtype)
        x_feat = torch.einsum('bnhw,bchw->bnc', hard, x)
        obj = self.kernel_update_conv(x_feat, kernels)

        B, N, C = obj.shape
        hd = C // self.num_heads
        q, k, v = (getattr(self, f'attn_{n}')(obj).view(B, N, self.num_heads, hd)
                   for n in 'qkv')
        attn = (torch.einsum('bqhd,bkhd->bhqk', q, k) * hd ** -0.5).softmax(-1)
        sa = torch.einsum('bhqk,bkhd->bqhd', attn, v).reshape(B, N, C)
        obj = self.attention_norm(obj + self.attn_proj(sa))
        obj = self.ffn_norm(obj + self.ffn_fc2(F.relu(self.ffn_fc1(obj))))

        mask_feat = obj
        for i in range(self.num_mask_fcs):
            mask_feat = F.relu(getattr(self, f'mask_norm{i}')(
                getattr(self, f'mask_fc{i}')(mask_feat)))
        mask_feat = self.fc_mask(mask_feat)
        return torch.einsum('bnc,bchw->bnhw', mask_feat, x), obj


@MODELS.register_module()
class IterativeDecodeHead(HeadBase):
    classifier = False

    def __init__(self, in_channels: Union[int, Sequence[int]], channels: int,
                 num_classes: int, num_stages: int = 3, num_convs: int = 2,
                 num_heads: int = 8, feedforward_channels: int = 1024,
                 num_mask_fcs: int = 1, hard_mask_thr: float = 0.5,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 out_channels: Optional[int] = None,
                 loss_decode: Optional[Dict] = None,
                 kernel_generate_head: Optional[Dict] = None,
                 kernel_update_head: Optional[Sequence[Dict]] = None,
                 init_cfg: Optional[Dict] = None):
        for name, value in (('kernel_generate_head', kernel_generate_head),
                            ('kernel_update_head', kernel_update_head)):
            if value is not None:
                raise NotImplementedError(
                    f'IterativeDecodeHead {name}: the JAX package accepts it '
                    'and never reads it; the stages come from the flat options')
        super().__init__(in_channels, channels, num_classes,
                         dropout_ratio=dropout_ratio, norm_cfg=norm_cfg,
                         act_cfg=act_cfg, align_corners=align_corners,
                         ignore_index=ignore_index, in_index=in_index,
                         input_transform=input_transform,
                         out_channels=out_channels, loss_decode=loss_decode)
        self.num_convs = num_convs
        self.num_stages = num_stages
        for i in range(num_convs):
            self.add_module(f'conv{i}', self._conv(
                self.in_width if i == 0 else channels, channels, 3, padding=1))
        self.dropout = (nn.Dropout(dropout_ratio) if dropout_ratio > 0
                        else nn.Identity())
        self.seg_kernel = nn.Parameter(torch.empty(num_classes, channels, 1, 1))
        self.seg_bias = nn.Parameter(torch.zeros(num_classes))
        self.raw_init = {'seg_bias': ('zeros', 0.0)}
        for s in range(num_stages):
            self.add_module(f'kernel_update_head{s}', KernelUpdateHead(
                channels, num_heads, feedforward_channels, num_mask_fcs,
                hard_mask_thr))

    def forward(self, inputs, with_aux: bool = True):
        """Every stage's (B, N, H, W) masks in training, the last in eval;
        ``with_aux`` means nothing here."""
        feats = self._select(inputs)
        for i in range(self.num_convs):
            feats = getattr(self, f'conv{i}')(feats)
        feats = self.dropout(feats)
        mask = F.conv2d(feats, self.seg_kernel, self.seg_bias)
        kernels = self.seg_kernel[:, :, 0, 0].unsqueeze(0).expand(
            feats.shape[0], -1, -1)
        stage_masks = [mask]
        for s in range(self.num_stages):
            mask, kernels = getattr(self, f'kernel_update_head{s}')(
                feats, kernels, mask)
            stage_masks.append(mask)
        return tuple(stage_masks) if self.training else stage_masks[-1]

    def loss_by_feat(self, seg_logits, seg_label) -> Dict[str, torch.Tensor]:
        """Each stage's losses, keyed ``s{i}.*`` when there are several."""
        stages = seg_logits if isinstance(seg_logits, (tuple, list)) \
            else [seg_logits]
        out: Dict[str, torch.Tensor] = {}
        for i, logits in enumerate(stages):
            for k, v in default_loss_by_feat(logits, seg_label, self.losses,
                                             self.align_corners,
                                             self.ignore_index).items():
                out[f's{i}.{k}' if len(stages) > 1 else k] = v
        return out

    def predict_by_feat(self, seg_logits, size=None):
        if isinstance(seg_logits, (tuple, list)):
            seg_logits = seg_logits[-1]
        return super().predict_by_feat(seg_logits, size)
