"""MaskFormer and Mask2Former decode heads (mask classification), NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/maskformer_head.py``
(``_hungarian`` :37, ``_greedy_assign`` :50, ``assign_queries`` :92,
``_DecoderLayer`` :103, ``MaskFormerHead`` :149, ``Mask2FormerHead``
:344):

- the pixel decoder: with ``pixel_decoder='fpn'`` 1x1 ``lateral{i}``
  (GroupNorm 32 and ReLU by default) of every level, a top-down sum
  (bilinear, coarsest first) through 3x3 ``fpn{i}``, and a 3x3
  ``mask_feat`` at the finest level; the memory of the transformer
  decoder is the coarsest lateral.  ``'msdeform'`` is
  :class:`MSDeformAttnPixelDecoder`, whose memory is its encoded
  coarsest level;
- the transformer decoder: ``query_embed`` (1, Q, D) through
  ``num_transformer_decoder_layers`` pre-norm layers (``_DecoderLayer``:
  cross-attention to the memory's tokens, self-attention, an exact-GELU
  FFN of 4 D), then ``dec_norm``.  With ``masked_attn`` each layer's
  cross-attention sees only the memory pixels where the current queries'
  masks (``interm_embed`` against the mask features, resized to the
  memory's size) have ``sigmoid > 0.5``, a query with no such pixel all
  of them (:meth:`MaskFormerHead.attention_mask`, a discrete decision);
  masked logits are -1e9;
- the outputs: ``cls_embed`` (classes + no-object) and the masks, the
  3-layer mask MLP's embeddings against the mask features: (B, Q, C + 1)
  and (B, Q, h, w);
- ``loss_by_feat``: the one-hot labels resized to the masks' size and
  thresholded at 0.5, the classes present per image; the (B, Q, C) cost
  (``2 x -p_class + 5 x Dice + 5 x BCE``, 1e6 for the absent classes)
  matched on the host by scipy's Hungarian per image
  (:meth:`MaskFormerHead.assign`, a device-to-host sync); CE with the
  matched queries' classes, the others no-object weighted 0.1; the matched
  masks' BCE and Dice over the present classes, dense, or with
  ``num_points`` on uncertainty-sampled points
  (:mod:`lednet_tpu_torch.ops.point_loss`: the candidates and the fresh
  points drawn on the CPU from the head's own ``generator``, seeded with
  0, and moved, so that the card's step and the CPU's see the same points;
  the JAX package draws them from its ``dropout`` key, a stream no torch
  generator reproduces; the candidates kept by
  :meth:`MaskFormerHead.top_uncertain`, PointHead's stable top-k);
- ``predict_by_feat``: the class probabilities but no-object times the
  mask sigmoids, summed over the queries, resized.

The JAX package probes whether its runtime takes host callbacks and falls
back to a greedy assignment on the device; PyTorch always has the host,
so the assignment is the Hungarian.  ``greedy_assign`` is the JAX
package's fallback, kept as a plain function that nothing calls.  Every
LayerNorm is flax's (eps 1e-6).  The options the JAX head accepts and
never reads (``act_cfg``, ``loss_decode``, ``sampler``, an
``input_transform`` other than ``'multiple_select'``) raise
``NotImplementedError``; ``channels`` and ``dropout_ratio`` are accepted
and unused, as there.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.base import sem_label
from lednet_tpu_torch.models.decode_heads.deform_pixel_decoder import \
    MSDeformAttnPixelDecoder
from lednet_tpu_torch.models.decode_heads.knet_head import layer_norm
from lednet_tpu_torch.models.decode_heads.point_head import PointHead
from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.point_loss import (draw_points, point_counts,
                                             sampled_mask_bce_dice,
                                             uncertain_point_coords)
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def hungarian(cost: np.ndarray) -> np.ndarray:
    """(B, Q, C) cost -> (B, C) int32: the query matched to each class,
    scipy's ``linear_sum_assignment`` per image."""
    from scipy.optimize import linear_sum_assignment
    B, Q, C = cost.shape
    out = np.zeros((B, C), np.int32)
    for b in range(B):
        rows, cols = linear_sum_assignment(cost[b])
        out[b, cols] = rows
    return out


def greedy_assign(cost: torch.Tensor) -> torch.Tensor:
    """(B, Q, C) cost -> (B, C): C times, the cheapest (query, class) pair
    left (the first in row-major order on ties), its row and column then
    retired.  The JAX package's assignment where its runtime has no host
    callbacks; nothing in the port calls it."""
    B, Q, C = cost.shape
    cost = cost.clone()
    assign = torch.zeros((B, C), dtype=torch.long, device=cost.device)
    rows = torch.arange(B, device=cost.device)
    for _ in range(C):
        idx = cost.reshape(B, Q * C).argmin(-1)
        q, c = torch.div(idx, C, rounding_mode='floor'), idx % C
        assign[rows, c] = q
        cost[rows, q, :] = 1e9
        cost[rows, :, c] = 1e9
    return assign


class _DecoderLayer(nn.Module):

    def __init__(self, dim: int, num_heads: int = 8, masked_attn: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.masked_attn = masked_attn
        for name in ('norm_cross', 'norm_self', 'norm_ffn'):
            self.add_module(name, layer_norm(dim))
        for name in ('cq', 'ck', 'cv', 'cproj', 'sq', 'sk', 'sv', 'sproj'):
            self.add_module(name, nn.Linear(dim, dim))
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def _attend(self, q, k, v, mask=None):
        B, Q, D = q.shape
        hd = D // self.num_heads
        q = q.view(B, Q, self.num_heads, hd)
        k = k.view(B, -1, self.num_heads, hd)
        v = v.view(B, -1, self.num_heads, hd)
        attn = torch.einsum('bqhd,bnhd->bhqn', q, k) * hd ** -0.5
        if mask is not None:
            attn = attn.masked_fill(~mask[:, None], -1e9)
        out = torch.einsum('bhqn,bnhd->bqhd', attn.softmax(-1), v)
        return out.reshape(B, Q, D)

    def forward(self, queries: torch.Tensor, memory: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Q, D) queries, (B, N, D) memory and (B, Q, N) bool
        ``attn_mask`` (True: attend; read with ``masked_attn`` only)."""
        h = self.norm_cross(queries)
        mask = attn_mask if self.masked_attn else None
        queries = queries + self.cproj(self._attend(
            self.cq(h), self.ck(memory), self.cv(memory), mask))
        h = self.norm_self(queries)
        queries = queries + self.sproj(self._attend(self.sq(h), self.sk(h),
                                                    self.sv(h)))
        h = self.norm_ffn(queries)
        return queries + self.fc2(F.gelu(self.fc1(h)))


@MODELS.register_module()
class MaskFormerHead(HeadBase):
    takes_list = True
    classifier = False
    top_uncertain = PointHead.top_uncertain

    def __init__(self, in_channels: Sequence[int], channels: int,
                 num_classes: int, num_queries: int = 100,
                 num_transformer_decoder_layers: int = 6, num_heads: int = 8,
                 feat_channels: int = 256, masked_attn: bool = False,
                 loss_cls_weight: float = 2.0, loss_mask_weight: float = 5.0,
                 loss_dice_weight: float = 5.0, no_object_weight: float = 0.1,
                 pixel_decoder: str = 'fpn', num_points: int = 0,
                 oversample_ratio: float = 3.0,
                 importance_sample_ratio: float = 0.75,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: Optional[str] = 'multiple_select',
                 out_channels: Optional[int] = None,
                 loss_decode: Optional[Dict] = None,
                 sampler: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        for name, value in (('act_cfg', act_cfg), ('loss_decode', loss_decode),
                            ('sampler', sampler)):
            if value is not None:
                raise NotImplementedError(
                    f'{type(self).__name__} {name}: the JAX package accepts '
                    'it and never reads it')
        if pixel_decoder not in ('fpn', 'msdeform'):
            raise ValueError("pixel_decoder must be 'fpn' or 'msdeform', got "
                             f'{pixel_decoder!r}')
        super().__init__(in_channels, channels, num_classes,
                         norm_cfg=norm_cfg or dict(type='GN', num_groups=32),
                         align_corners=align_corners,
                         ignore_index=ignore_index, in_index=in_index,
                         input_transform=input_transform,
                         out_channels=out_channels)
        D = feat_channels
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.num_layers = num_transformer_decoder_layers
        self.masked_attn = masked_attn
        self.pixel_decoder_kind = pixel_decoder
        self.loss_weights = dict(cls=loss_cls_weight, mask=loss_mask_weight,
                            dice=loss_dice_weight)
        self.no_object_weight = no_object_weight
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        widths = list(in_channels)
        if pixel_decoder == 'msdeform':
            self.pixel_decoder = MSDeformAttnPixelDecoder(widths, D,
                                                          num_heads=num_heads)
        else:
            relu = dict(type='ReLU')
            for i, cin in enumerate(widths):
                self.add_module(f'lateral{i}', ConvModule(
                    cin, D, 1, norm_cfg=self.norm_cfg, act_cfg=relu))
            for i in range(len(widths) - 1):
                self.add_module(f'fpn{i}', ConvModule(
                    D, D, 3, padding=1, norm_cfg=self.norm_cfg, act_cfg=relu))
            self.mask_feat = ConvModule(D, D, 3, padding=1)
        self.query_embed = nn.Parameter(torch.zeros(1, num_queries, D))
        self.raw_init = {'query_embed': ('truncated_normal', 0.02)}
        if masked_attn:
            self.interm_embed = nn.Linear(D, D)
        for li in range(num_transformer_decoder_layers):
            self.add_module(f'dec{li}', _DecoderLayer(D, num_heads, masked_attn))
        self.dec_norm = layer_norm(D)
        self.cls_embed = nn.Linear(D, num_classes + 1)
        self.mask_mlp0 = nn.Linear(D, D)
        self.mask_mlp1 = nn.Linear(D, D)
        self.mask_embed = nn.Linear(D, D)
        self.generator = torch.Generator().manual_seed(0)

    # ---- forward --------------------------------------------------------
    def pixel_features(self, xs):
        """(mask features at the finest level, the decoder's memory)."""
        if self.pixel_decoder_kind == 'msdeform':
            return self.pixel_decoder(xs)
        laterals = [getattr(self, f'lateral{i}')(x) for i, x in enumerate(xs)]
        h = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            h = laterals[i] + resize_bilinear(h, laterals[i].shape[-2:],
                                              self.align_corners)
            h = getattr(self, f'fpn{i}')(h)
        return self.mask_feat(h), laterals[-1]

    def attention_mask(self, interm: torch.Tensor) -> torch.Tensor:
        """(B, Q, N) bool: where each query's mask logits ``interm`` have
        ``sigmoid > 0.5``, a query with none everywhere."""
        keep = torch.sigmoid(interm) > 0.5
        return keep | ~keep.any(-1, keepdim=True)

    def forward(self, inputs, with_aux: bool = True):
        """(class logits (B, Q, C + 1), mask logits (B, Q, h, w)) of the
        selected levels; ``with_aux`` means nothing here."""
        mask_features, memory = self.pixel_features(self._select(inputs))
        B, D, mh, mw = memory.shape
        mem_tokens = memory.flatten(2).transpose(1, 2)
        queries = self.query_embed.expand(B, -1, -1).to(memory.dtype)
        for li in range(self.num_layers):
            attn_mask = None
            if self.masked_attn:
                interm = torch.einsum('bqd,bdhw->bqhw',
                                      self.interm_embed(queries), mask_features)
                interm = resize_bilinear(interm, (mh, mw), self.align_corners)
                attn_mask = self.attention_mask(interm.flatten(2))
            queries = getattr(self, f'dec{li}')(queries, mem_tokens, attn_mask)
        queries = self.dec_norm(queries)
        cls_logits = self.cls_embed(queries)
        m = F.relu(self.mask_mlp1(F.relu(self.mask_mlp0(queries))))
        mask_logits = torch.einsum('bqd,bdhw->bqhw', self.mask_embed(m),
                                   mask_features)
        return cls_logits, mask_logits

    # ---- losses ---------------------------------------------------------
    def assign(self, cost: torch.Tensor) -> torch.Tensor:
        """(B, C) the query matched to each class: :func:`hungarian` of the
        (B, Q, C) ``cost`` on the host, back on its device."""
        out = hungarian(cost.detach().cpu().numpy())
        return torch.from_numpy(out).to(device=cost.device, dtype=torch.long)

    def train_points(self, mask_logit: torch.Tensor) -> torch.Tensor:
        """The (N, num_points, 2) points of the sampled mask losses on (N,
        h, w) ``mask_logit``: candidates and fresh points drawn from
        ``generator`` on the CPU, moved to its device and type, selected
        there by :func:`uncertain_point_coords`."""
        cand, fresh = draw_points(mask_logit.shape[0], self.num_points,
                                  self.oversample_ratio,
                                  self.importance_sample_ratio, self.generator)
        move = dict(device=mask_logit.device, dtype=mask_logit.dtype)
        n_imp = point_counts(self.num_points, self.oversample_ratio,
                             self.importance_sample_ratio)[1]
        return uncertain_point_coords(
            mask_logit, cand.to(**move),
            fresh.to(**move) if fresh is not None else None, n_imp,
            self.top_uncertain)

    def loss_by_feat(self, seg_logits, seg_label) -> Dict[str, torch.Tensor]:
        cls_logits, mask_logits = seg_logits        # (B, Q, C+1), (B, Q, h, w)
        label = sem_label(seg_label)
        B, Q = cls_logits.shape[:2]
        C = self.num_classes
        h, w = mask_logits.shape[-2:]
        dtype = mask_logits.dtype

        valid = label != self.ignore_index
        one_hot = F.one_hot(torch.where(valid, label, 0).long(), C).to(dtype) \
            * valid.unsqueeze(-1)
        gt = resize_bilinear(one_hot.permute(0, 3, 1, 2), (h, w),
                             self.align_corners)
        gt = (gt > 0.5).to(dtype)                                 # (B, C, h, w)
        gt_flat = gt.flatten(2)                                   # (B, C, hw)
        present = (gt_flat > 0.5).any(-1)                         # (B, C)
        sig_flat = torch.sigmoid(mask_logits).flatten(2)          # (B, Q, hw)

        with torch.no_grad():
            probs = cls_logits.softmax(-1)
            sig = sig_flat.detach()
            inter = torch.einsum('bqn,bcn->bqc', sig, gt_flat)
            dice_cost = 1 - (2 * inter + 1) / (
                sig.sum(-1)[..., None] + gt_flat.sum(-1)[:, None] + 1)
            bce_fg = -torch.einsum('bqn,bcn->bqc',
                                   torch.log(sig.clamp(min=1e-6)), gt_flat)
            bce_bg = -torch.einsum('bqn,bcn->bqc',
                                   torch.log((1 - sig).clamp(min=1e-6)),
                                   1 - gt_flat)
            cost = (self.loss_weights['cls'] * -probs[..., :C] +
                    self.loss_weights['dice'] * dice_cost +
                    self.loss_weights['mask'] * (bce_fg + bce_bg) / (h * w))
            cost = torch.where(present[:, None, :], cost,
                               torch.full_like(cost, 1e6))
        assign = self.assign(cost)                                # (B, C)

        # the matched queries take their class, every other no-object
        classes = torch.arange(C, device=label.device).expand(B, C)
        cls_target = torch.full((B, Q), C, dtype=torch.long,
                                device=label.device).scatter(
            1, assign, torch.where(present, classes, C))
        logp = F.log_softmax(cls_logits, -1)
        nll = -logp.gather(-1, cls_target.unsqueeze(-1)).squeeze(-1)
        wts = torch.ones_like(nll).masked_fill(cls_target == C,
                                               self.no_object_weight)
        loss_cls = (nll * wts).sum() / wts.sum().clamp(min=1)

        pm = present.to(dtype)
        n_present = pm.sum().clamp(min=1)
        if self.num_points > 0:
            matched = mask_logits.gather(
                1, assign[:, :, None, None].expand(-1, -1, h, w))
            flat_logit = matched.reshape(B * C, h, w)
            with torch.no_grad():
                coords = self.train_points(flat_logit.detach())
            bce, dice = sampled_mask_bce_dice(flat_logit, gt.reshape(B * C, h, w),
                                              coords)
            bce, dice = bce.view(B, C), dice.view(B, C)
        else:
            matched = sig_flat.gather(1, assign[:, :, None].expand(-1, -1, h * w))
            inter = (matched * gt_flat).sum(-1)
            dice = 1 - (2 * inter + 1) / (matched.sum(-1) + gt_flat.sum(-1) + 1)
            bce = -(gt_flat * torch.log(matched.clamp(min=1e-6)) +
                    (1 - gt_flat) * torch.log((1 - matched).clamp(min=1e-6))
                    ).mean(-1)
        return {'loss_cls': self.loss_weights['cls'] * loss_cls,
                'loss_mask': self.loss_weights['mask'] * (bce * pm).sum() / n_present,
                'loss_dice': self.loss_weights['dice'] * (dice * pm).sum() / n_present}

    def predict_by_feat(self, seg_logits, size=None):
        cls_logits, mask_logits = seg_logits
        probs = cls_logits.softmax(-1)[..., :-1]
        sem = torch.einsum('bqc,bqhw->bchw', probs, torch.sigmoid(mask_logits))
        return super().predict_by_feat(sem, size)


@MODELS.register_module()
class Mask2FormerHead(MaskFormerHead):
    """Masked attention and the mask losses on 12544 sampled points."""

    def __init__(self, *args, masked_attn: bool = True, num_points: int = 12544,
                 **kwargs):
        super().__init__(*args, masked_attn=masked_attn, num_points=num_points,
                         **kwargs)
