"""LightHamHead, SegNeXt's Hamburger decode head, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/ham_head.py`` (``_nmf``
:29, ``Hamburger`` :73, ``LightHamHead`` :110): inputs 1-3 of the
backbone (``multiple_select``) resized bilinearly to the finest and
concatenated, ``squeeze`` (1x1, GroupNorm, ReLU) to ``ham_channels``, the
Hamburger (``ham_in``: 1x1 with a bias, ReLU; non-negative matrix
factorization of the (C, H*W) map by multiplicative updates; ``ham_out``:
1x1 with GroupNorm; the residual and a ReLU), ``align`` (1x1, GroupNorm,
ReLU) to ``channels``, dropout and the 1x1 classifier.  The head's norm is
GroupNorm with 32 groups unless ``norm_cfg`` says otherwise.

The NMF's bases start from ones normalized over C, in training as in eval,
as the JAX package's do: its train step passes no ``'nmf'`` RNG, so its
random start is never taken (``ham_head.py:95-96``).  All R bases are then
equal and stay equal through every update.  ``rand_init`` is accepted and
unused.  The products are ``torch.bmm`` in the association that
``jnp.einsum`` picks for each three-operand product: the R x R Gram first.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.base import (ClsSeg, build_losses,
                                                       default_loss_by_feat,
                                                       resolve_out_channels,
                                                       select_inputs)
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

_EPS = 1e-6


def _nmf(x: torch.Tensor, rank: int, steps: int, inv_t: float = 1.0,
         bases0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multiplicative-update NMF of x (B, C, N) >= 0: the reconstruction
    (B, C, N) from ``rank`` bases after ``steps`` updates of both factors
    and a last update of the coefficients.  ``bases0`` (B, C, R) is the
    start; without it, ones normalized over C."""
    B, C, _ = x.shape
    if bases0 is not None:
        bases = bases0
    else:
        bases = torch.ones((B, C, rank), dtype=x.dtype, device=x.device)
        bases = bases / torch.sqrt(bases.square().sum(1, keepdim=True) + 1e-12)
    xt = x.transpose(1, 2)                                    # (B, N, C)
    coef = torch.softmax(inv_t * torch.bmm(xt, bases), dim=-1)   # (B, N, R)

    def update_coef(bases, coef):
        numer = torch.bmm(xt, bases)
        denom = torch.bmm(coef, torch.bmm(bases.transpose(1, 2), bases))
        return coef * numer / (denom + _EPS)

    for _ in range(steps):
        coef = update_coef(bases, coef)
        numer = torch.bmm(x, coef)                            # (B, C, R)
        denom = torch.bmm(bases, torch.bmm(coef.transpose(1, 2), coef))
        bases = bases * numer / (denom + _EPS)
    coef = update_coef(bases, coef)
    return torch.bmm(bases, coef.transpose(1, 2))


class Hamburger(nn.Module):

    def __init__(self, ham_channels: int = 512, md_s: int = 1, md_r: int = 64,
                 train_steps: int = 6, eval_steps: int = 7,
                 rand_init: bool = True, norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.md_s, self.md_r = md_s, md_r
        self.train_steps, self.eval_steps = train_steps, eval_steps
        self.ham_in = nn.Conv2d(ham_channels, ham_channels, 1)
        self.ham_out = ConvModule(ham_channels, ham_channels, 1,
                                  norm_cfg=norm_cfg or dict(type='GN',
                                                            num_groups=32))

    def forward(self, x):
        h = F.relu(self.ham_in(x))
        B, C, H, W = h.shape
        flat = h.reshape(B * self.md_s, C // self.md_s, H * W)
        steps = self.train_steps if self.training else self.eval_steps
        h = _nmf(flat, self.md_r, steps).reshape(B, C, H, W)
        return F.relu(x + self.ham_out(h))


@MODELS.register_module()
class LightHamHead(nn.Module):

    def __init__(self, in_channels: Sequence[int], channels: int,
                 num_classes: int, ham_channels: int = 512,
                 ham_kwargs: Optional[Dict] = None,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255,
                 in_index: Union[int, Sequence[int]] = (1, 2, 3),
                 input_transform: Optional[str] = 'multiple_select',
                 out_channels: Optional[int] = None,
                 loss_decode: Optional[Dict] = None,
                 sampler: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``in_channels``: the widths of the selected inputs.
        ``input_transform`` is ``multiple_select`` whatever it says, as in
        the JAX package."""
        super().__init__()
        norm_cfg = norm_cfg or dict(type='GN', num_groups=32)
        act_cfg = act_cfg or dict(type='ReLU')
        kwargs = dict(ham_kwargs or {})
        self.in_index = in_index
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.losses = build_losses(loss_decode)
        self.sampler = (MODELS.build(dict(sampler)) if sampler is not None
                        else None)
        self.squeeze = ConvModule(sum(in_channels), ham_channels, 1,
                                  norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.hamburger = Hamburger(ham_channels,
                                   md_s=kwargs.get('MD_S', 1),
                                   md_r=kwargs.get('MD_R', 64),
                                   train_steps=kwargs.get('train_steps', 6),
                                   eval_steps=kwargs.get('eval_steps', 7),
                                   rand_init=kwargs.get('rand_init', True),
                                   norm_cfg=norm_cfg)
        self.align = ConvModule(ham_channels, channels, 1, norm_cfg=norm_cfg,
                                act_cfg=act_cfg)
        self.cls = ClsSeg(channels, resolve_out_channels(num_classes,
                                                         out_channels),
                          dropout_ratio)

    def forward(self, inputs, with_aux: bool = True):
        """The logits at the finest selected input's size; ``with_aux`` is
        the segmentor's flag and means nothing to this head."""
        xs = select_inputs(inputs, self.in_index, 'multiple_select',
                           self.align_corners)
        size = xs[0].shape[-2:]
        x = torch.cat([resize_bilinear(x, size, self.align_corners)
                       for x in xs], 1)
        x = self.hamburger(self.squeeze(x))
        return self.cls(self.align(x))

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        return default_loss_by_feat(seg_logits, seg_label, self.losses,
                                    self.align_corners, self.ignore_index,
                                    self.sampler)

    def predict_by_feat(self, seg_logits, size=None):
        if size is None:
            return seg_logits
        return resize_bilinear(seg_logits, size, self.align_corners)
