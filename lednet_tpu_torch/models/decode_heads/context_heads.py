"""The R50-D8 context heads, NCHW: ``GCHead``, ``CCHead``, ``DAHead``,
``EMAHead``, ``ISAHead``, ``APCHead``, ``DMHead``, ``ANNHead``,
``EncHead``, ``NLHead`` and ``DNLHead``.

Counterpart of ``lednet_tpu/models/decode_heads/context_heads.py``
(``_fcn_tail`` :153, ``GCHead`` :174, ``DNLHead`` :220, ``EMAHead`` :269
with ``ema_iterate`` :119, ``ISAHead`` :343, ``APCHead`` :404, ``DMHead``
:459, ``ANNHead`` :513, ``EncHead`` :618, ``DAHead`` :721 with
``cam_attention`` :145, ``CCHead`` :805) and of ``NLHead``
(``lednet_tpu/models/decode_heads/uper_ocr.py:216``), with their flax
names.  Attention scores and softmaxes run in float32 (float64 for a
float64 map), as plain matmuls:

- the FCN tail of GC, CC, NL and DNL (``_FCNTail``): ``conv0`` (3x3), the
  head's block, ``conv1`` (3x3), ``conv_cat`` (3x3) of ``[input,
  output]`` where ``concat_input``, ``cls``;
- ``GCHead``: mmcv's ``ContextBlock``, a softmax over the pixels of a
  1x1 ``conv_mask`` ('att') or the mean ('avg') pools the map; each fusion
  (``transform*`` for 'channel_add', ``mul_transform*`` for
  'channel_mul') is 1x1 -> LayerNorm (flax's, eps 1e-6) -> ReLU -> 1x1,
  added, or through a sigmoid multiplied;
- ``CCHead``: ``recurrence`` passes of one criss-cross attention
  (``cca_q`` / ``cca_k`` / ``cca_v``, Linear layers over the channels, and
  ``cca_gamma``): each pixel's row and column scores through one softmax,
  the column's diagonal at -inf so that the pixel counts once;
- ``DAHead``: position attention (``pam_*``: separate 3x3 in-conv, plain
  1x1 q / k / v, unscaled scores, ``pam_gamma``) and channel attention
  (``cam_*``: the channel Gram matrix subtracted from its row maximum
  through a softmax, ``cam_gamma``), each through its 3x3 out-conv and
  classifier (``pam_cls``, ``cam_cls``), their sum through ``cls``; the
  forward gives ``(logit, pam_logit, cam_logit)``, the loss ``loss_ce``,
  ``pam_loss_ce`` and ``cam_loss_ce``;
- ``EMAHead``: ``ema_in_conv`` (3x3), ``ema_mid_conv`` (1x1 with bias),
  ``num_stages`` EM iterations without gradient from the ``bases`` buffer
  (1, K, C), the reconstruction from the final bases and the last
  iteration's responsibilities, taken before that update; in training the
  buffer moves in place by ``momentum`` toward the batch's mean bases,
  L2-normalised; ReLU, ``ema_out_conv`` (normed 1x1), the residual ReLU,
  ``bottleneck``, ``conv_cat``.  ``ema_mid_conv`` gets no gradient; it
  keeps ``requires_grad`` so that the optimizer gives it a zero gradient
  and decays it, as optax does;
- ``ISAHead``: ``in_conv``, the map zero-padded to the ``down_factor``
  grid (centred), the long-range relation over the strided groups, the
  short-range relation within each block (``*_relation_attn``: a
  ``SelfAttentionBlock`` with two normed query / key convs; ``*_out``),
  ``out_conv`` of ``[output, input]``;
- ``APCHead``: per scale ``s`` an ACM module (``acm{s}_*``): the pooled
  regions, the reduced input plus its global pool, a sigmoid affinity
  (not normalised) of the pixels to the s x s regions, the weighted
  regions, a residual conv and ReLU, ``fusion``; ``bottleneck`` of the
  input and every module's output;
- ``DMHead``: per filter size ``k`` a DCM module (``dcm{k}_*``): depthwise
  k x k filters generated per image by a 1x1 conv of the input pooled to
  k x k, applied to the reduced input as one grouped conv over B x C
  groups, padded (pad + 1, pad) for an even ``k``; norm, ReLU, ``fusion``;
- ``ANNHead``: AFNB (``fusion_q{s}``: queries from the high level, keys
  and values from the low level pooled by ``key_pool_scales``),
  ``fusion_bottleneck`` of ``[context, high]``, dropout, ``bottleneck``
  (3x3), APNB (``context_q{s}``, key and query shared),
  ``context_bottleneck`` of ``[context, output]``;
- ``EncHead``: ``bottleneck`` of the deepest level (``lateral{i}`` and
  ``fusion`` where ``add_lateral``), ``encoding_project``, mmcv's
  ``Encoding`` (``codewords`` (K, C), ``scale`` (K,): a softmax over the
  codes of ``scale * |x - c|^2``, the assigned residuals summed over the
  pixels), ``encoding_bn`` (flax's BatchNorm over the K codes of the (B,
  K, C) encodings: biased batch variance, momentum 0.1), ReLU, the mean
  over the codes, a sigmoid gate ``fc``, and ``se_layer``'s class-presence
  logits; the forward gives ``(logits, se_logit)``, the loss adds
  ``loss_se``.  The squared distance is taken as ``|x|^2 - 2 x.c +
  |c|^2`` and the residual sum as ``A^T X - (sum_n A) c``: the (B, N, K,
  C) difference tensor that the JAX package forms (2.1 GB a Cityscapes
  frame) is never built;
- ``NLHead``: mmcv's ``NonLocal2d`` (embedded Gaussian): Linear ``theta``
  / ``phi`` / ``g`` over the channels, scores times ``inter ** -0.5``, a
  softmax, the normed 1x1 ``conv_out``, a residual;
- ``DNLHead``: the disentangled non-local block: 1x1 ``theta`` / ``phi``
  / ``g`` convs, the whitened (mean-subtracted) pairwise scores over
  ``sqrt(inter)`` and ``temperature``, a unary softmax of ``conv_mask``,
  ``conv_out``, a residual.  NL and DNL take no ``mode``, as the JAX heads
  do not: passing it raises ``TypeError``.

``sampler`` on DA and Enc, whose losses the JAX package computes without
one, raises ``NotImplementedError``, as does a ``loss_se_decode`` other
than the sigmoid cross-entropy that ``loss_se`` computes.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.base import (ClsSeg,
                                                       default_loss_by_feat,
                                                       sem_label)
from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.decode_heads.self_attention import (
    SelfAttentionBlock, acc_dtype, plain_conv)
from lednet_tpu_torch.models.layers import ConvModule, LayerNorm2d, Norm2d
from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def _first_logit(seg_logits):
    return seg_logits[0] if isinstance(seg_logits, tuple) else seg_logits


class _FCNTail(HeadBase):
    """conv0 -> ``block`` -> conv1 -> conv_cat on ``[input, output]`` ->
    cls (the JAX package's ``_fcn_tail``)."""

    def __init__(self, *args, concat_input: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.concat_input = concat_input
        self.conv0 = self._conv(self.in_width, self.channels, 3, padding=1)
        self.conv1 = self._conv(self.channels, self.channels, 3, padding=1)
        if concat_input:
            self.conv_cat = self._conv(self.in_width + self.channels,
                                       self.channels, 3, padding=1)

    def block(self, feats: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, inputs, with_aux: bool = True):
        x = self._select(inputs)
        out = self.conv1(self.block(self.conv0(x)))
        if self.concat_input:
            out = self.conv_cat(torch.cat([x, out], 1))
        return self.cls(out)


@MODELS.register_module()
class GCHead(_FCNTail):

    def __init__(self, *args, ratio: float = 0.25, pooling_type: str = 'att',
                 fusion_types: Sequence[str] = ('channel_add',), **kwargs):
        super().__init__(*args, **kwargs)
        if pooling_type not in ('att', 'avg'):
            raise ValueError(f'GCHead pooling_type {pooling_type!r}')
        self.pooling_type = pooling_type
        self.fusion_types = tuple(fusion_types)
        if set(self.fusion_types) - {'channel_add', 'channel_mul'}:
            raise ValueError(f'GCHead fusion_types {fusion_types!r}')
        C = self.channels
        mid = max(int(C * ratio), 1)
        if pooling_type == 'att':
            self.conv_mask = plain_conv(C, 1)
        for prefix, kind in (('mul_', 'channel_mul'), ('', 'channel_add')):
            if kind in self.fusion_types:
                self.add_module(f'{prefix}transform1', plain_conv(C, mid))
                self.add_module(f'{prefix}transform_ln',
                                LayerNorm2d(mid, eps=1e-6))
                self.add_module(f'{prefix}transform2', plain_conv(mid, C))

    def _transform(self, prefix, ctx):
        t = getattr(self, f'{prefix}transform_ln')(
            getattr(self, f'{prefix}transform1')(ctx))
        return getattr(self, f'{prefix}transform2')(F.relu(t))

    def block(self, feats):
        B, C, H, W = feats.shape
        if self.pooling_type == 'att':
            acc = acc_dtype(feats.dtype)
            attn = torch.softmax(self.conv_mask(feats).flatten(1).to(acc), -1)
            ctx = torch.matmul(feats.flatten(2).to(acc), attn.unsqueeze(-1))
            ctx = ctx.to(feats.dtype).unsqueeze(-1)              # (B, C, 1, 1)
        else:
            ctx = adaptive_avg_pool2d(feats, 1)
        out = feats
        if 'channel_mul' in self.fusion_types:
            out = out * torch.sigmoid(self._transform('mul_', ctx))
        if 'channel_add' in self.fusion_types:
            out = out + self._transform('', ctx)
        return out


@MODELS.register_module()
class CCHead(_FCNTail):

    def __init__(self, *args, recurrence: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.recurrence = recurrence
        C = self.channels
        self.cca_q = nn.Linear(C, C // 8)
        self.cca_k = nn.Linear(C, C // 8)
        self.cca_v = nn.Linear(C, C)
        self.cca_gamma = nn.Parameter(torch.zeros(()))
        self.raw_init = {'cca_gamma': ('zeros', None)}

    def _cca(self, feats):
        """One criss-cross attention pass, the weights shared by all."""
        H, W = feats.shape[-2:]
        x = feats.permute(0, 2, 3, 1)                          # (B, H, W, C)
        acc = acc_dtype(x.dtype)
        q = self.cca_q(x).to(acc)
        k = self.cca_k(x).to(acc)
        v = self.cca_v(x)
        row = torch.matmul(q, k.transpose(-1, -2))             # (B, H, W, W)
        col = torch.matmul(q.transpose(1, 2), k.transpose(1, 2).transpose(-1, -2))
        col = col.transpose(1, 2)                              # (B, H, W, H)
        eye = torch.eye(H, dtype=torch.bool, device=x.device).view(1, H, 1, H)
        col = col.masked_fill(eye, float('-inf'))
        attn = torch.softmax(torch.cat([row, col], -1), -1).to(v.dtype)
        out = torch.matmul(attn[..., :W], v) + torch.matmul(
            attn[..., W:].transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
        return feats + self.cca_gamma.to(v.dtype) * out.permute(0, 3, 1, 2)

    def block(self, feats):
        for _ in range(self.recurrence):
            feats = self._cca(feats)
        return feats


@MODELS.register_module()
class DAHead(HeadBase):

    def __init__(self, *args, pam_channels: int = 64, dropout_ratio: float = 0.1,
                 **kwargs):
        super().__init__(*args, dropout_ratio=dropout_ratio, **kwargs)
        if self.sampler is not None:
            raise NotImplementedError('DAHead with a sampler: the JAX head '
                                      'computes its losses without one')
        C = self.channels
        self.pam_in_conv = self._conv(self.in_width, C, 3, padding=1)
        self.pam_q = plain_conv(C, pam_channels)
        self.pam_k = plain_conv(C, pam_channels)
        self.pam_v = plain_conv(C, C)
        self.pam_gamma = nn.Parameter(torch.zeros(()))
        self.pam_out_conv = self._conv(C, C, 3, padding=1)
        self.cam_in_conv = self._conv(self.in_width, C, 3, padding=1)
        self.cam_gamma = nn.Parameter(torch.zeros(()))
        self.cam_out_conv = self._conv(C, C, 3, padding=1)
        self.pam_cls = ClsSeg(C, self.n_out, dropout_ratio)
        self.cam_cls = ClsSeg(C, self.n_out, dropout_ratio)
        self.raw_init = {'pam_gamma': ('zeros', None),
                         'cam_gamma': ('zeros', None)}

    def forward(self, inputs, with_aux: bool = True):
        """``(logit, pam_logit, cam_logit)`` of the selected input."""
        x = self._select(inputs)
        feat = self.pam_in_conv(x)
        B, C, H, W = feat.shape
        acc = acc_dtype(feat.dtype)
        q = self.pam_q(feat).flatten(2).to(acc)
        k = self.pam_k(feat).flatten(2).to(acc)
        v = self.pam_v(feat).flatten(2)                        # (B, C, N)
        attn = torch.softmax(torch.matmul(q.transpose(1, 2), k), -1).to(v.dtype)
        pam = self.pam_gamma.to(v.dtype) * torch.matmul(v, attn.transpose(1, 2)) \
            + feat.flatten(2)
        pam = self.pam_out_conv(pam.reshape(B, C, H, W))

        cflat = self.cam_in_conv(x).flatten(2)                 # (B, C, N)
        f = cflat.to(acc)
        aff = torch.matmul(f, f.transpose(1, 2))               # (B, C, C)
        aff = torch.softmax(aff.amax(-1, keepdim=True) - aff, -1)
        cam = self.cam_gamma.to(cflat.dtype) * torch.matmul(aff, f).to(
            cflat.dtype) + cflat
        cam = self.cam_out_conv(cam.reshape(B, C, H, W))
        return self.cls(pam + cam), self.pam_cls(pam), self.cam_cls(cam)

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        logit, pam, cam = seg_logits
        out = default_loss_by_feat(logit, seg_label, self.losses,
                                   self.align_corners, self.ignore_index)
        for name, branch in (('pam', pam), ('cam', cam)):
            aux = default_loss_by_feat(branch, seg_label, self.losses,
                                       self.align_corners, self.ignore_index)
            out.update({f'{name}_{k}': v for k, v in aux.items() if 'loss' in k})
        return out

    def predict_by_feat(self, seg_logits, size=None):
        return super().predict_by_feat(_first_logit(seg_logits), size)


def ema_iterate(flat: torch.Tensor, bases: torch.Tensor, num_stages: int):
    """The EM iterations (``context_heads.py:119``): responsibilities by a
    softmax over the bases, L1-normalised over the pixels, the bases
    re-estimated and L2-normalised over the channels.  Returns the final
    bases and the last iteration's responsibilities, computed before that
    update."""
    attn = flat.new_zeros(flat.shape[0], flat.shape[1], bases.shape[1])
    for _ in range(num_stages):
        attn = torch.softmax(torch.matmul(flat, bases.transpose(1, 2)), -1)
        attn_n = attn / attn.abs().sum(1, keepdim=True).clamp_min(1e-12)
        new = torch.matmul(attn_n.transpose(1, 2), flat)       # (B, K, C)
        bases = new / torch.linalg.vector_norm(new, dim=-1,
                                               keepdim=True).clamp_min(1e-12)
    return bases, attn


@MODELS.register_module()
class EMAHead(HeadBase):

    def __init__(self, *args, ema_channels: int = 256, num_bases: int = 64,
                 num_stages: int = 3, momentum: float = 0.1,
                 concat_input: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_stages = num_stages
        self.momentum = momentum
        self.concat_input = concat_input
        E = ema_channels
        self.ema_in_conv = self._conv(self.in_width, E, 3, padding=1)
        self.ema_mid_conv = ConvModule(E, E, 1, norm_cfg=None, act_cfg=None)
        self.register_buffer('bases', torch.zeros(1, num_bases, E))
        self.ema_out_conv = ConvModule(E, E, 1, norm_cfg=self.norm_cfg,
                                       act_cfg=None)
        self.bottleneck = self._conv(E, self.channels, 3, padding=1)
        if concat_input:
            self.conv_cat = self._conv(self.in_width + self.channels,
                                       self.channels, 3, padding=1)

    @torch.no_grad()
    def init_buffers(self, generator: torch.Generator) -> None:
        """The bases as the JAX head seeds them: normal times
        sqrt(2 / K), L2-normalised over the channels."""
        b = torch.randn(self.bases.shape, generator=generator) * \
            (2.0 / self.bases.shape[1]) ** 0.5
        self.bases.copy_(b / torch.linalg.vector_norm(
            b, dim=-1, keepdim=True).clamp_min(1e-12))

    def forward(self, inputs, with_aux: bool = True):
        x = self._select(inputs)
        feats = self.ema_in_conv(x)
        mid = self.ema_mid_conv(feats)
        B, C, H, W = mid.shape
        acc = acc_dtype(mid.dtype)
        with torch.no_grad():
            flat = mid.flatten(2).transpose(1, 2).to(acc)      # (B, N, C)
            bases, attn = ema_iterate(
                flat, self.bases.to(acc).expand(B, -1, -1), self.num_stages)
            recon = torch.matmul(attn, bases).to(feats.dtype)
            if self.training:
                upd = bases.mean(0, keepdim=True)
                upd = upd / torch.linalg.vector_norm(
                    upd, dim=-1, keepdim=True).clamp_min(1e-12)
                self.bases.copy_((1 - self.momentum) * self.bases +
                                 self.momentum * upd.to(self.bases.dtype))
        recon = F.relu(recon.transpose(1, 2).reshape(B, C, H, W))
        out = F.relu(feats + self.ema_out_conv(recon))
        out = self.bottleneck(out)
        if self.concat_input:
            out = self.conv_cat(torch.cat([x, out], 1))
        return self.cls(out)


@MODELS.register_module()
class ISAHead(HeadBase):

    def __init__(self, *args, isa_channels: int = 256,
                 down_factor: Sequence[int] = (8, 8), **kwargs):
        super().__init__(*args, **kwargs)
        self.down_factor = tuple(down_factor)
        C = self.channels
        self.in_conv = self._conv(self.in_width, C, 3, padding=1)
        for name in ('global_relation', 'local_relation'):
            self.add_module(f'{name}_attn', SelfAttentionBlock(
                C, C, isa_channels, C, key_query_num_convs=2,
                key_query_norm=True, value_out_num_convs=1,
                value_out_norm=False, matmul_norm=True, with_out=False,
                norm_cfg=self.norm_cfg, act_cfg=self.act_cfg))
            self.add_module(f'{name}_out', self._conv(C, C, 1))
        self.out_conv = self._conv(2 * C, C, 1)

    def _relation(self, name, x):
        return getattr(self, f'{name}_out')(getattr(self, f'{name}_attn')(x, x))

    def forward(self, inputs, with_aux: bool = True):
        feats = self.in_conv(self._select(inputs))
        B, C, H, W = feats.shape
        lh, lw = self.down_factor
        gh, gw = -(-H // lh), -(-W // lw)
        pad_h, pad_w = gh * lh - H, gw * lw - W
        h0, w0 = pad_h // 2, pad_w // 2
        h = F.pad(feats, (w0, pad_w - w0, h0, pad_h - h0))
        h = h.reshape(B, C, gh, lh, gw, lw)
        # long range: the positions at one offset of every block together
        long_in = h.permute(0, 3, 5, 1, 2, 4).reshape(B * lh * lw, C, gh, gw)
        long_out = self._relation('global_relation', long_in)
        long_out = long_out.reshape(B, lh, lw, C, gh, gw)
        # short range: the positions of one block together
        short_in = long_out.permute(0, 4, 5, 3, 1, 2).reshape(B * gh * gw, C,
                                                               lh, lw)
        short_out = self._relation('local_relation', short_in)
        out = short_out.reshape(B, gh, gw, C, lh, lw).permute(
            0, 3, 1, 4, 2, 5).reshape(B, C, gh * lh, gw * lw)
        out = out[:, :, h0:h0 + H, w0:w0 + W]
        return self.cls(self.out_conv(torch.cat([out, feats], 1)))


@MODELS.register_module()
class APCHead(HeadBase):

    def __init__(self, *args, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 fusion: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.pool_scales = tuple(pool_scales)
        self.fusion = fusion
        C = self.channels
        for s in self.pool_scales:
            self.add_module(f'acm{s}_pooled_redu', self._conv(self.in_width, C, 1))
            self.add_module(f'acm{s}_input_redu', self._conv(self.in_width, C, 1))
            self.add_module(f'acm{s}_global_info', self._conv(C, C, 1))
            self.add_module(f'acm{s}_gla', plain_conv(C, s * s))
            self.add_module(f'acm{s}_residual', self._conv(C, C, 1))
            if fusion:
                self.add_module(f'acm{s}_fusion', self._conv(C, C, 1))
        self.bottleneck = self._conv(self.in_width + len(self.pool_scales) * C,
                                     C, 3, padding=1)

    def _acm(self, s, x):
        def m(name):
            return getattr(self, f'acm{s}_{name}')
        B, _, H, W = x.shape
        pooled = m('pooled_redu')(adaptive_avg_pool2d(x, s))   # (B, C, s, s)
        xr = m('input_redu')(x)
        glob = m('global_info')(adaptive_avg_pool2d(xr, 1))
        gla_in = xr + resize_bilinear(glob, (H, W), self.align_corners)
        acc = acc_dtype(x.dtype)
        affinity = torch.sigmoid(m('gla')(gla_in).flatten(2).to(acc))  # (B, s2, N)
        z = torch.matmul(pooled.flatten(2).to(acc), affinity).to(x.dtype)
        z = m('residual')(z.reshape(B, self.channels, H, W))
        z = F.relu(z + xr)
        return m('fusion')(z) if self.fusion else z

    def forward(self, inputs, with_aux: bool = True):
        x = self._select(inputs)
        outs = [x] + [self._acm(s, x) for s in self.pool_scales]
        return self.cls(self.bottleneck(torch.cat(outs, 1)))


@MODELS.register_module()
class DMHead(HeadBase):

    def __init__(self, *args, filter_sizes: Sequence[int] = (1, 3, 5, 7),
                 fusion: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.filter_sizes = tuple(filter_sizes)
        self.fusion = fusion
        C = self.channels
        for k in self.filter_sizes:
            self.add_module(f'dcm{k}_filter_gen', plain_conv(self.in_width, C))
            self.add_module(f'dcm{k}_input_redu', self._conv(self.in_width, C, 1))
            self.add_module(f'dcm{k}_norm', Norm2d(self.norm_cfg, C))
            if fusion:
                self.add_module(f'dcm{k}_fusion', self._conv(C, C, 1))
        self.bottleneck = self._conv(self.in_width + len(self.filter_sizes) * C,
                                     C, 3, padding=1)

    def _dcm(self, k, x):
        def m(name):
            return getattr(self, f'dcm{k}_{name}')
        kernel = m('filter_gen')(adaptive_avg_pool2d(x, k))    # (B, C, k, k)
        xr = m('input_redu')(x)
        B, C, H, W = xr.shape
        pad = (k - 1) // 2
        lo = pad if (k - 1) % 2 == 0 else pad + 1
        padded = F.pad(xr, (lo, pad, lo, pad))
        # every image's filters at once: one grouped conv over B x C groups
        ctx = F.conv2d(padded.reshape(1, B * C, H + lo + pad, W + lo + pad),
                       kernel.reshape(B * C, 1, k, k), groups=B * C)
        ctx = F.relu(m('norm')(ctx.reshape(B, C, H, W)))
        return m('fusion')(ctx) if self.fusion else ctx

    def forward(self, inputs, with_aux: bool = True):
        x = self._select(inputs)
        outs = [x] + [self._dcm(k, x) for k in self.filter_sizes]
        return self.cls(self.bottleneck(torch.cat(outs, 1)))


@MODELS.register_module()
class ANNHead(HeadBase):
    takes_list = True

    def __init__(self, *args, project_channels: int = 256,
                 query_scales: Sequence[int] = (1,),
                 key_pool_scales: Sequence[int] = (1, 3, 6, 8),
                 in_index: Sequence[int] = (-2, -1),
                 input_transform: Optional[str] = 'multiple_select',
                 dropout_ratio: float = 0.1, **kwargs):
        super().__init__(*args, in_index=in_index,
                         input_transform=input_transform,
                         dropout_ratio=dropout_ratio, **kwargs)
        self.query_scales = tuple(query_scales)
        low, high = self.in_channels[0], self.in_channels[-1]
        C, pc = self.channels, project_channels
        common = dict(key_query_num_convs=1, key_query_norm=True,
                      value_out_num_convs=1, value_out_norm=False,
                      matmul_norm=True, with_out=True,
                      key_pool_scales=key_pool_scales,
                      norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        for qs in self.query_scales:
            self.add_module(f'fusion_q{qs}', SelfAttentionBlock(
                low, high, pc, high, **common))
        self.fusion_bottleneck = ConvModule(2 * high, high, 1,
                                            norm_cfg=self.norm_cfg, act_cfg=None)
        self.dropout = (nn.Dropout(dropout_ratio) if dropout_ratio > 0
                        else nn.Identity())
        self.bottleneck = self._conv(high, C, 3, padding=1)
        for qs in self.query_scales:
            self.add_module(f'context_q{qs}', SelfAttentionBlock(
                C, C, pc, C, share_key_query=True, **common))
        self.context_bottleneck = self._conv(2 * C, C, 1)

    def _attend(self, name, query, key):
        """The sum over the query scales of ``{name}_q{s}``, a query
        max-pooled by s and its output resized back."""
        ctx = 0.
        for qs in self.query_scales:
            q = F.max_pool2d(query, qs, qs) if qs > 1 else query
            a = getattr(self, f'{name}_q{qs}')(q, key)
            if qs > 1:
                a = resize_bilinear(a, query.shape[-2:], False)
            ctx = ctx + a
        return ctx

    def forward(self, inputs, with_aux: bool = True):
        xs = self._select(inputs)
        low, high = xs[0], xs[-1]
        out = self.fusion_bottleneck(torch.cat([self._attend('fusion', high, low),
                                                high], 1))
        out = self.bottleneck(self.dropout(out))
        out = self.context_bottleneck(torch.cat([self._attend('context', out, out),
                                                 out], 1))
        return self.cls(out)


class _CodeBatchNorm(nn.BatchNorm1d):
    """flax's ``nn.BatchNorm`` over the K codes of (B, K, C) encodings: in
    training the batch statistics over (B, C), the running variance
    updated with the biased batch variance (flax's), momentum 0.1 (flax's
    0.9); in eval the running statistics."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean((0, 2))
        var = (x - mean.view(1, -1, 1)).square().mean((0, 2))
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked += 1
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(1, -1, 1)) * scale.view(1, -1, 1) + \
            self.bias.view(1, -1, 1)


@MODELS.register_module()
class EncHead(HeadBase):
    takes_list = True

    def __init__(self, *args, num_classes: int, num_codes: int = 32,
                 use_se_loss: bool = True, add_lateral: bool = False,
                 loss_se_decode: Optional[Dict] = None,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: Optional[str] = 'multiple_select', **kwargs):
        super().__init__(*args, num_classes=num_classes, in_index=in_index,
                         input_transform=input_transform, **kwargs)
        if self.sampler is not None:
            raise NotImplementedError('EncHead with a sampler: the JAX head '
                                      'computes its losses without one')
        se = dict(loss_se_decode or {})
        if se and (se.get('type') != 'CrossEntropyLoss' or
                   not se.get('use_sigmoid')):
            raise NotImplementedError(f'EncHead loss_se_decode {se}: its '
                                      'loss is the sigmoid cross-entropy')
        self.se_weight = se.get('loss_weight', 0.2)
        self.num_classes = num_classes
        self.use_se_loss = use_se_loss
        self.add_lateral = add_lateral
        widths = list(self.in_channels)
        C, K = self.channels, num_codes
        self.bottleneck = self._conv(widths[-1], C, 3, padding=1)
        if add_lateral:
            for i, w in enumerate(widths[:-1]):
                self.add_module(f'lateral{i}', self._conv(w, C, 1))
            self.fusion = self._conv(len(widths) * C, C, 3, padding=1)
        self.encoding_project = self._conv(C, C, 1)
        self.codewords = nn.Parameter(torch.zeros(K, C))
        self.scale = nn.Parameter(torch.zeros(K))
        std = 1.0 / (K * C) ** 0.5
        self.raw_init = {'codewords': ('uniform', (-std, std)),
                         'scale': ('uniform', (-1.0, 0.0))}
        self.encoding_bn = _CodeBatchNorm(K)
        self.fc = nn.Linear(C, C)
        if use_se_loss:
            self.se_layer = nn.Linear(C, num_classes)

    def encoding(self, x: torch.Tensor) -> torch.Tensor:
        """mmcv's ``Encoding`` of a (B, C, H, W) map: (B, K, C)."""
        acc = acc_dtype(x.dtype)
        flat = x.flatten(2).transpose(1, 2).to(acc)            # (B, N, C)
        codes = self.codewords.to(acc)
        dist = flat.square().sum(-1, keepdim=True) - \
            2 * torch.matmul(flat, codes.t()) + codes.square().sum(-1)
        assign = torch.softmax(self.scale.to(acc) * dist, -1)  # (B, N, K)
        return torch.matmul(assign.transpose(1, 2), flat) - \
            assign.sum(1).unsqueeze(-1) * codes

    def forward(self, inputs, with_aux: bool = True):
        """``(logits, se_logit)``, or the logits without ``use_se_loss``."""
        xs = self._select(inputs)
        feat = self.bottleneck(xs[-1])
        if self.add_lateral:
            laterals = [resize_bilinear(getattr(self, f'lateral{i}')(x),
                                        feat.shape[-2:], self.align_corners)
                        for i, x in enumerate(xs[:-1])]
            feat = self.fusion(torch.cat([feat] + laterals, 1))
        enc = F.relu(self.encoding_bn(self.encoding(self.encoding_project(feat))))
        encoding_feat = enc.mean(1).to(feat.dtype)             # (B, C)
        gamma = torch.sigmoid(self.fc(encoding_feat))
        logits = self.cls(F.relu(feat + feat * gamma[:, :, None, None]))
        if self.use_se_loss:
            return logits, self.se_layer(encoding_feat)
        return logits

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        se_logit = None
        if isinstance(seg_logits, tuple):
            seg_logits, se_logit = seg_logits
        out = default_loss_by_feat(seg_logits, seg_label, self.losses,
                                   self.align_corners, self.ignore_index)
        if se_logit is not None:
            label = sem_label(seg_label).flatten(1)
            x = se_logit.to(acc_dtype(se_logit.dtype))
            valid = label != self.ignore_index
            present = x.new_zeros(x.shape).scatter_reduce_(
                1, torch.where(valid, label, 0).long(), valid.to(x.dtype),
                'amax')
            bce = F.relu(x) - x * present + torch.log1p(torch.exp(-x.abs()))
            out['loss_se'] = self.se_weight * bce.mean()
        return out

    def predict_by_feat(self, seg_logits, size=None):
        return super().predict_by_feat(_first_logit(seg_logits), size)


@MODELS.register_module()
class NLHead(_FCNTail):

    def __init__(self, *args, reduction: int = 2, use_scale: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.use_scale = use_scale
        C = self.channels
        self.inter = max(C // reduction, 1)
        self.theta = nn.Linear(C, self.inter)
        self.phi = nn.Linear(C, self.inter)
        self.g = nn.Linear(C, self.inter)
        self.conv_out = ConvModule(self.inter, C, 1, norm_cfg=self.norm_cfg,
                                   act_cfg=None)

    def block(self, feats):
        B, C, H, W = feats.shape
        flat = feats.flatten(2).transpose(1, 2)                # (B, N, C)
        acc = acc_dtype(feats.dtype)
        attn = torch.matmul(self.theta(flat).to(acc),
                            self.phi(flat).to(acc).transpose(1, 2))
        if self.use_scale:
            attn = attn * self.inter ** -0.5
        attn = torch.softmax(attn, -1).to(feats.dtype)
        y = torch.matmul(attn.to(acc), self.g(flat).to(acc)).to(feats.dtype)
        y = y.transpose(1, 2).reshape(B, self.inter, H, W)
        return feats + self.conv_out(y)


@MODELS.register_module()
class DNLHead(_FCNTail):

    def __init__(self, *args, reduction: int = 2, use_scale: bool = True,
                 temperature: float = 0.05, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_scale = use_scale
        self.temperature = temperature
        C = self.channels
        self.inter = max(C // reduction, 1)
        self.theta = plain_conv(C, self.inter)
        self.phi = plain_conv(C, self.inter)
        self.g = plain_conv(C, self.inter)
        self.conv_mask = plain_conv(C, 1)
        self.conv_out = ConvModule(self.inter, C, 1, norm_cfg=self.norm_cfg,
                                   act_cfg=None)

    def block(self, feats):
        B, C, H, W = feats.shape
        acc = acc_dtype(feats.dtype)
        theta = self.theta(feats).flatten(2).to(acc)           # (B, c, N)
        phi = self.phi(feats).flatten(2).to(acc)
        g = self.g(feats).flatten(2)                           # (B, c, N)
        # whitened: each embedding less its mean over the pixels
        theta = theta - theta.mean(2, keepdim=True)
        phi = phi - phi.mean(2, keepdim=True)
        attn = torch.matmul(theta.transpose(1, 2), phi)        # (B, N, N)
        if self.use_scale:
            attn = attn / self.inter ** 0.5
        attn = torch.softmax(attn / self.temperature, -1).to(g.dtype)
        pairwise = torch.matmul(g, attn.transpose(1, 2))       # (B, c, N)
        unary = torch.softmax(self.conv_mask(feats).flatten(1).to(acc),
                              -1).to(g.dtype)                  # (B, N)
        unary_ctx = torch.matmul(g, unary.unsqueeze(-1))       # (B, c, 1)
        y = (pairwise + unary_ctx).reshape(B, self.inter, H, W)
        return feats + self.conv_out(y)
