"""SAN's decode head: a side adapter network beside the CLIP tower.

Counterpart of ``lednet_tpu/models/decode_heads/san_head.py`` (``_MLP``
:43, ``MLPMaskDecoder`` :55, ``_SANBlock`` :83, ``SideAdapterNetwork``
:107, ``RecWithAttnbias`` :190, ``SideAdapterCLIPHead`` :260):

- ``SideAdapterNetwork``: a stride-``patch_size`` conv over the raw image
  with no padding (the remainder is dropped, unlike the ViT's), the
  ``pos_embed`` grid (40 x 40) resized to the patch grid as
  ``jax.image.resize`` resizes it (anti-aliased Keys cubic,
  :func:`lednet_tpu_torch.ops.resize.resize_jax_bicubic`), ``num_queries``
  learned queries prepended, the query and patch position embeddings
  (``full_pos``) added to the input and again between blocks; the CLIP
  features fused into the patch tokens (``clip_ln{i}`` LayerNorm, 1x1
  ``clip_proj{i}``, bilinear resize to the patch grid) before the first
  block where ``fusion_index`` starts at 0 and after each block it names;
  after each deep-supervision block and the last, ``mask_decoder``
  (``MLPMaskDecoder``) turns the queries and the patch grid into mask
  logits (B, Q, h, w) and attention biases, one (B, heads, Q, h, w) per
  recognition layer;
- ``RecWithAttnbias``: the CLIP tower's cls token copied into
  ``sos_token_num`` tokens, prepended to [cls; patch tokens] of CLIP's
  last feature, through ``num_layers`` blocks ``b{i}_*`` whose attention
  adds the mask (:214-233): the biases max-pooled to CLIP's grid; -100
  where any token reads a sos token but its own (the diagonal, 0); -100
  where a sos token reads cls; a sos token reads the patches through its
  bias.  Then ``ln_post``, ``proj`` (no bias) and L2 normalisation;
- ``SideAdapterCLIPHead``: class logits, the sos embeddings against the
  text encoder's class embeddings (B, Q, C + 1); in training every
  deep-supervision tap's (masks, logits), in eval the last pair;
- ``loss_by_feat``: per tap (``d{i}.`` before the last), the one-hot
  labels picked to the masks' size as ``jax.image.resize`` picks nearest
  (:func:`~lednet_tpu_torch.ops.resize.resize_jax_nearest`; 255 is no
  class), the (B, Q, C) cost ``-p_class + 5 x Dice`` matched on the host
  by scipy's Hungarian (``assign``, as ``MaskFormerHead.assign``); CE with
  the matched queries' classes, the others no-object weighted 0.1; the
  matched masks' BCE and Dice over the present classes on
  ``train_cfg.num_points`` (12,544) uncertainty-sampled points drawn from
  the head's own CPU ``generator`` (``train_points``, as Mask2Former's),
  or dense with ``num_points=0``;
- ``predict_by_feat``: the mask logits resized bilinearly to the output
  size, then the class probabilities but the last times their sigmoids,
  summed over the queries, in that order (as the JAX package).

Every LayerNorm is flax's (eps 1e-6); every attention is a plain matmul
and softmax in float32 or wider.  ``loss_decode``, which the JAX head
accepts and never reads, raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.backbones.mit import LN_EPS
from lednet_tpu_torch.models.decode_heads.base import sem_label
from lednet_tpu_torch.models.decode_heads.maskformer_head import MaskFormerHead
from lednet_tpu_torch.models.decode_heads.point_head import PointHead
from lednet_tpu_torch.models.layers import attention, merge_heads, split_heads
from lednet_tpu_torch.models.text_encoder.clip_text_encoder import (
    _TextBlock, l2_normalize)
from lednet_tpu_torch.ops.point_loss import sampled_mask_bce_dice
from lednet_tpu_torch.ops.resize import (resize_bilinear, resize_jax_bicubic,
                                         resize_jax_nearest)
from lednet_tpu_torch.registry import MODELS


class _MLP(nn.Module):
    """``num_layers`` Linear layers ``fc{i}``, ReLU between them."""

    def __init__(self, in_dims: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'fc{i}', nn.Linear(
                in_dims if i == 0 else hidden,
                out if i == num_layers - 1 else hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f'fc{i}')(x))
        return getattr(self, f'fc{self.num_layers - 1}')(x)


class MLPMaskDecoder(nn.Module):

    def __init__(self, in_channels: int, total_heads: int = 12,
                 total_layers: int = 3, embed_channels: int = 256,
                 mlp_channels: int = 256, mlp_num_layers: int = 3):
        super().__init__()
        self.total_heads = total_heads
        self.total_layers = total_layers
        self.embed_channels = embed_channels
        self.query_mlp = _MLP(in_channels, mlp_channels, embed_channels,
                              mlp_num_layers)
        self.pix_mlp = _MLP(in_channels, mlp_channels, embed_channels,
                            mlp_num_layers)
        self.attn_mlp = _MLP(in_channels, mlp_channels,
                             embed_channels * total_heads * total_layers,
                             mlp_num_layers)

    def forward(self, query: torch.Tensor, x: torch.Tensor):
        """(B, Q, C) queries and the (B, h, w, C) patch grid -> mask logits
        (B, Q, h, w) and ``total_layers`` attention biases (B, heads, Q, h,
        w)."""
        B, h, w, _ = x.shape
        q = self.query_mlp(query)                                  # (B, Q, E)
        pix = self.pix_mlp(x).reshape(B, h * w, -1)                # (B, hw, E)
        mask = torch.matmul(q, pix.transpose(1, 2)).view(B, -1, h, w)
        attn = self.attn_mlp(x).reshape(B, h * w, self.total_layers * self.total_heads,
                                        self.embed_channels)
        # bias[b, l, n, q, hw] = sum_e q[b, q, e] attn[b, hw, (l, n), e]
        bias = torch.matmul(q[:, None], attn.permute(0, 2, 3, 1))
        bias = bias.view(B, self.total_layers, self.total_heads, -1, h, w)
        return mask, list(bias.unbind(1))


class SideAdapterNetwork(nn.Module):

    def __init__(self, in_channels: int = 3, clip_channels: int = 768,
                 embed_dims: int = 240, patch_size: int = 16,
                 num_queries: int = 100, num_encode_layer: int = 8,
                 num_heads: int = 6, mlp_ratio: int = 4,
                 fusion_index: Sequence[int] = (0, 1, 2, 3),
                 decoder_heads: int = 12, decoder_layers: int = 3,
                 decoder_channels: int = 256, pos_embed_size: int = 40):
        super().__init__()
        self.num_encode_layer = num_encode_layer
        self.fusion_index = tuple(fusion_index)
        self.pos_embed_size = pos_embed_size
        self.patch_embed = nn.Conv2d(in_channels, embed_dims, patch_size,
                                     patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_size ** 2, embed_dims))
        self.query_pos_embed = nn.Parameter(torch.zeros(1, num_queries, embed_dims))
        self.query_embed = nn.Parameter(torch.zeros(1, num_queries, embed_dims))
        self.raw_init = {k: ('normal', 0.02) for k in
                         ('pos_embed', 'query_pos_embed', 'query_embed')}
        for i in range(len(self.fusion_index)):
            self.add_module(f'clip_ln{i}', nn.LayerNorm(clip_channels, eps=LN_EPS))
            self.add_module(f'clip_proj{i}', nn.Conv2d(clip_channels, embed_dims, 1))
        for i in range(num_encode_layer):
            self.add_module(f'layer{i}', _TextBlock(embed_dims, num_heads, mlp_ratio))
        self.mask_decoder = MLPMaskDecoder(embed_dims, decoder_heads,
                                           decoder_layers, decoder_channels,
                                           decoder_channels)

    def fuse(self, i: int, x: torch.Tensor, feature, grid) -> torch.Tensor:
        """The patch tokens of ``x`` plus CLIP's feature ``i`` (its grid
        (B, C, H, W), or a (grid, cls) pair), normed, projected to the side
        width and resized to the side ``grid``."""
        feat = feature[0] if isinstance(feature, (tuple, list)) else feature
        f = getattr(self, f'clip_ln{i}')(feat.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        f = resize_bilinear(getattr(self, f'clip_proj{i}')(f), grid, False)
        L = grid[0] * grid[1]
        return torch.cat([x[:, :-L], x[:, -L:] + f.flatten(2).transpose(1, 2)], 1)

    def forward(self, image: torch.Tensor, clip_features,
                deep_supervision_idxs: Sequence[int] = ()):
        """(B, 3, H, W) image and CLIP's features -> the mask logits and
        the attention biases of each supervision tap."""
        x = self.patch_embed(image.to(self.pos_embed.dtype))
        B, D, gh, gw = x.shape
        L = gh * gw
        x = x.flatten(2).transpose(1, 2)
        S = self.pos_embed_size
        pos = self.pos_embed
        if (gh, gw) != (S, S):
            grid = pos.transpose(1, 2).reshape(1, D, S, S)
            pos = resize_jax_bicubic(grid, (gh, gw)).flatten(2).transpose(1, 2)
        full_pos = torch.cat([self.query_pos_embed.expand(B, -1, -1),
                              pos.expand(B, -1, -1)], 1)
        x = torch.cat([self.query_embed.expand(B, -1, -1), x], 1) + full_pos

        fused = 0
        if self.fusion_index[0] == 0:
            x = self.fuse(0, x, clip_features[0], (gh, gw))
            fused = 1
        masks, biases = [], []
        for index in range(1, self.num_encode_layer + 1):
            x = getattr(self, f'layer{index - 1}')(x)
            if fused < len(self.fusion_index) and index == self.fusion_index[fused]:
                x = self.fuse(fused, x, clip_features[fused], (gh, gw))
                fused += 1
            if index in deep_supervision_idxs or index == self.num_encode_layer:
                feat = x[:, -L:].reshape(B, gh, gw, D)
                m, b = self.mask_decoder(x[:, :-L], feat)
                masks.append(m)
                biases.append(b)
            if index < self.num_encode_layer:
                x = x + full_pos
        return masks, biases


class RecWithAttnbias(nn.Module):

    def __init__(self, sos_token_num: int = 100, num_layers: int = 3,
                 embed_dims: int = 768, num_heads: int = 12, mlp_ratio: int = 4,
                 out_dims: int = 512, final_norm: bool = True):
        super().__init__()
        self.sos_token_num = sos_token_num
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.final_norm = final_norm
        D = embed_dims
        for i in range(num_layers):
            pre = f'b{i}_'
            self.add_module(pre + 'ln1', nn.LayerNorm(D, eps=LN_EPS))
            for name in ('q', 'k', 'v', 'proj'):
                self.add_module(pre + name, nn.Linear(D, D))
            self.add_module(pre + 'ln2', nn.LayerNorm(D, eps=LN_EPS))
            self.add_module(pre + 'fc1', nn.Linear(D, mlp_ratio * D))
            self.add_module(pre + 'fc2', nn.Linear(mlp_ratio * D, D))
        self.ln_post = nn.LayerNorm(D, eps=LN_EPS)
        self.proj = nn.Linear(D, out_dims, bias=False)

    def attn_mask(self, bias: torch.Tensor, grid) -> torch.Tensor:
        """The (B, heads, N, N) additive mask of the tokens [sos; cls;
        patches], N = Q + 1 + H x W, from one (B, heads, Q, h, w) bias,
        max-pooled by (h / H, w / W) to CLIP's ``grid`` (H, W), which must
        divide (h, w).  Built on the bias's device, with nothing from the
        host."""
        b, nh, Q, hh, ww = bias.shape
        H, W = grid
        if hh % H or ww % W:
            # the JAX package's reshape raises here too
            raise ValueError(
                f"the side adapter's grid {hh}x{ww} is not a whole multiple "
                f"of CLIP's {H}x{W}: pad the input to a multiple of 32 (in "
                'training, model.data_preprocessor.size)')
        if (hh, ww) != (H, W):
            bias = bias.reshape(b, nh, Q, H, hh // H, W, ww // W).amax((4, 6))
        L = H * W
        N = Q + 1 + L
        # the rows of the other tokens: -100 at every sos column
        rest = bias.new_zeros(N - Q, N)
        rest[:, :Q] = -100.0
        # a sos row: -100 at the other sos and at cls, 0 on the diagonal,
        # the bias over the patches
        sos = bias.new_full((Q, Q + 1), -100.0)
        sos.diagonal().zero_()
        top = torch.cat([sos.expand(b, nh, Q, Q + 1), bias.reshape(b, nh, Q, L)], -1)
        return torch.cat([top, rest.expand(b, nh, N - Q, N)], 2)

    def block(self, i: int, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        pre = f'b{i}_'
        h = getattr(self, pre + 'ln1')(x)
        q, k, v = (split_heads(getattr(self, pre + n)(h), self.num_heads)
                   for n in ('q', 'k', 'v'))
        x = x + getattr(self, pre + 'proj')(merge_heads(attention(q, k, v, mask)))
        h = F.gelu(getattr(self, pre + 'fc1')(getattr(self, pre + 'ln2')(x)))
        return x + getattr(self, pre + 'fc2')(h)

    def forward(self, biases: List[torch.Tensor], feature) -> torch.Tensor:
        """``biases``: one (B, heads, Q, h, w) per layer (or one for all);
        ``feature``: CLIP's last (grid (B, C, H, W), cls (B, C)) ->
        (B, Q, out_dims) sos embeddings."""
        feat, cls = feature
        B, C, H, W = feat.shape
        Q = self.sos_token_num
        x = torch.cat([cls[:, None].expand(B, Q + 1, C),
                       feat.flatten(2).transpose(1, 2)], 1)
        masks = [self.attn_mask(b, (H, W)).to(x.dtype) for b in biases]
        if len(masks) == 1:
            masks = masks * self.num_layers
        for i in range(self.num_layers):
            x = self.block(i, x, masks[i])
        sos = self.proj(self.ln_post(x[:, :Q]))
        return l2_normalize(sos) if self.final_norm else sos


@MODELS.register_module()
class SideAdapterCLIPHead(nn.Module):
    """``forward((image, clip_feats, class_embeds))`` returns every tap's
    ([mask logits], [class logits]) with ``with_aux`` (training), else the
    last pair."""
    top_uncertain = PointHead.top_uncertain
    train_points = MaskFormerHead.train_points
    assign = MaskFormerHead.assign

    def __init__(self, num_classes: int, in_channels: int = 3,
                 clip_channels: int = 768, embed_dims: int = 240,
                 num_queries: int = 100, patch_size: int = 16,
                 num_encode_layer: int = 8, num_san_heads: int = 6,
                 fusion_index: Sequence[int] = (0, 1, 2, 3),
                 rec_num_layers: int = 3, rec_num_heads: int = 12,
                 out_dims: int = 512,
                 deep_supervision_idxs: Sequence[int] = (7,),
                 align_corners: bool = False, ignore_index: int = 255,
                 loss_cls_weight: float = 2.0, loss_mask_weight: float = 5.0,
                 loss_dice_weight: float = 5.0, no_object_weight: float = 0.1,
                 loss_decode: Optional[Dict] = None,
                 train_cfg: Optional[Dict] = None):
        super().__init__()
        if loss_decode is not None:
            raise NotImplementedError('SideAdapterCLIPHead loss_decode: the JAX '
                                      'package accepts it and never reads it')
        self.num_classes = num_classes
        self.fusion_index = tuple(fusion_index)
        self.deep_supervision_idxs = tuple(deep_supervision_idxs)
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.loss_weights = dict(cls=loss_cls_weight, mask=loss_mask_weight,
                                 dice=loss_dice_weight)
        self.no_object_weight = no_object_weight
        cfg = dict(train_cfg or {})
        self.num_points = int(cfg.get('num_points', 12544))
        self.oversample_ratio = float(cfg.get('oversample_ratio', 3.0))
        self.importance_sample_ratio = float(cfg.get('importance_sample_ratio', 0.75))
        self.side_adapter_network = SideAdapterNetwork(
            in_channels, clip_channels, embed_dims, patch_size, num_queries,
            num_encode_layer, num_san_heads, 4, self.fusion_index,
            rec_num_heads, rec_num_layers)
        self.rec_with_attnbias = RecWithAttnbias(
            num_queries, rec_num_layers, clip_channels, rec_num_heads, 4, out_dims)
        self.generator = torch.Generator().manual_seed(0)

    def forward(self, inputs, with_aux: bool = True):
        image, clip_feats, class_embeds = inputs
        taps = self.deep_supervision_idxs if with_aux else ()
        masks, biases = self.side_adapter_network(image, clip_feats, taps)
        logits = [torch.matmul(self.rec_with_attnbias(bias, clip_feats[-1]),
                               class_embeds.t())
                  for bias in biases]
        if with_aux:
            return masks, logits
        return masks[-1], logits[-1]

    # ---- losses ---------------------------------------------------------
    def loss_by_feat(self, outs, seg_label) -> Dict[str, torch.Tensor]:
        all_masks, all_logits = outs
        label = sem_label(seg_label)
        out = {}
        for i, (mask_pred, cls_logit) in enumerate(zip(all_masks, all_logits)):
            prefix = '' if i == len(all_masks) - 1 else f'd{i}.'
            for k, v in self._single_loss(mask_pred, cls_logit, label).items():
                out[prefix + k] = v
        return out

    def _single_loss(self, mask_pred, cls_logit, label) -> Dict[str, torch.Tensor]:
        B, Q, h, w = mask_pred.shape
        C = self.num_classes
        dtype = mask_pred.dtype
        small = resize_jax_nearest(label, (h, w))                  # (B, h, w)
        valid = small != self.ignore_index
        # a label outside 0..C-1 (255 too) has no class
        known = (small >= 0) & (small < C)
        gt = F.one_hot(torch.where(known, small, 0).long(), C).to(dtype) \
            * known.unsqueeze(-1).to(dtype)
        gt = gt.permute(0, 3, 1, 2)                                # (B, C, h, w)
        gt_sum = gt.sum((-2, -1))
        present = gt_sum > 0                                       # (B, C)

        with torch.no_grad():
            probs = torch.sigmoid(mask_pred).flatten(2)            # (B, Q, hw)
            inter = torch.matmul(probs, gt.flatten(2).transpose(1, 2))
            dice_cost = 1 - (2 * inter + 1) / (
                probs.sum(-1)[:, :, None] + gt_sum[:, None] + 1)
            cost = -cls_logit.softmax(-1)[..., :C] + \
                self.loss_weights['dice'] * dice_cost
        assign = self.assign(cost)                                 # (B, C)

        m_logit = mask_pred.gather(1, assign[:, :, None, None].expand(-1, -1, h, w))
        if self.num_points > 0:
            flat = m_logit.reshape(B * C, h, w)
            with torch.no_grad():
                coords = self.train_points(flat.detach())
            bce, dice = sampled_mask_bce_dice(flat, gt.reshape(B * C, h, w), coords)
            bce, dice = bce.view(B, C), dice.view(B, C)
        else:
            bce = -(gt * F.logsigmoid(m_logit) + (1 - gt) * F.logsigmoid(-m_logit))
            bce = (bce * valid[:, None]).mean((-2, -1))
            m_prob = torch.sigmoid(m_logit)
            dice = 1 - (2 * (m_prob * gt).sum((-2, -1)) + 1) / (
                m_prob.sum((-2, -1)) + gt_sum + 1)
        pm = present.to(dtype)
        n_pos = pm.sum().clamp(min=1)

        classes = torch.arange(C, device=label.device).expand(B, C)
        target = torch.full((B, Q), C, dtype=torch.long, device=label.device)
        target = target.scatter(1, assign, torch.where(present, classes, C))
        nll = -F.log_softmax(cls_logit, -1).gather(-1, target[..., None])[..., 0]
        weight = torch.ones_like(nll).masked_fill(target == C, self.no_object_weight)
        return {'loss_cls': self.loss_weights['cls'] * (nll * weight).sum() / weight.sum(),
                'loss_mask': self.loss_weights['mask'] * (bce * pm).sum() / n_pos,
                'loss_dice': self.loss_weights['dice'] * (dice * pm).sum() / n_pos}

    def predict_by_feat(self, outs, size=None) -> torch.Tensor:
        """(B, C, H, W) class scores of the last (mask logits, class
        logits) pair, at ``size``."""
        mask_pred, cls_logit = outs
        if size is not None:
            mask_pred = resize_bilinear(mask_pred, size, self.align_corners)
        probs = cls_logit.softmax(-1)[..., :-1]
        B, Q, H, W = mask_pred.shape
        sem = torch.matmul(probs.transpose(1, 2),
                           torch.sigmoid(mask_pred).reshape(B, Q, H * W))
        return sem.view(B, -1, H, W)
