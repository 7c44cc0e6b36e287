"""The boundary and dice losses of the PIDNet and STDC configs, NCHW.

Counterpart of ``lednet_tpu/models/losses/extra_losses.py`` (``BoundaryLoss``
:20, ``_weight_reduce`` :46, ``DiceLoss`` :63).  The rest of that module's
loss zoo is later work in the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class BoundaryLoss:
    """Class-balanced binary cross-entropy on the one-channel boundary logit:
    boundary pixels (label 1) weighted by the share of non-boundary pixels
    (label 0) and those by the share of boundary ones, both counted over
    the whole batch; any other label (the pad value 255) weighs 0.  The
    mean runs over every pixel."""

    def __init__(self, loss_weight: float = 1.0,
                 loss_name: str = 'loss_boundary'):
        self.loss_weight = loss_weight
        self.loss_name = loss_name

    def __call__(self, bd_pre, bd_gt, **kwargs):
        x = (bd_pre[:, 0] if bd_pre.dim() == 4 else bd_pre).float()
        t = bd_gt.float()
        pos, neg = t == 1, t == 0
        pos_num, neg_num = pos.sum(), neg.sum()
        total = (pos_num + neg_num).clamp_min(1)
        weight = torch.where(pos, neg_num / total,
                             torch.where(neg, pos_num / total, 0.0))
        bce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
        return self.loss_weight * (weight * bce).mean()


def _weight_reduce(loss, weight=None, reduction='mean', avg_factor=None):
    """mmengine ``weight_reduce_loss`` on a per-sample vector."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if reduction == 'mean':
            return loss.mean()
        if reduction == 'sum':
            return loss.sum()
        return loss
    if reduction == 'mean':
        return loss.sum() / avg_factor
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


@MODELS.register_module()
class DiceLoss:
    """Dice loss with the JAX package's (and mmseg's) semantics:

    - a label map becomes a one-hot of ``clamp(label, 0, C)`` over C + 1
      classes with the last column dropped, so a pixel at 255 gets an
      all-zero target while its prediction still counts in the sums
      (``ignore_index`` drops a class channel, which 255 is not);
    - the prediction goes through a sigmoid (``use_sigmoid``) or, with more
      than one channel, a softmax, when ``activate``;
    - dice per sample over its flattened C x H x W values: ``(2 a + eps) /
      (b + c + eps)`` with sums of p, t (``naive_dice``), else ``2 a / ((b +
      eps) + (c + eps))`` with sums of p^2, t^2; the (N,) losses ``1 - d``
      are reduced by ``reduction``.
    """

    def __init__(self, use_sigmoid: bool = True, activate: bool = True,
                 reduction: str = 'mean', naive_dice: bool = False,
                 loss_weight: float = 1.0, ignore_index: int = 255,
                 eps: float = 1e-3, loss_name: str = 'loss_dice'):
        self.use_sigmoid = use_sigmoid
        self.activate = activate
        self.reduction = reduction
        self.naive_dice = naive_dice
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index
        self.eps = eps
        self.loss_name = loss_name

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        reduction = reduction_override or self.reduction
        pred = pred.float()
        num_classes = pred.shape[1]
        one_hot = target
        if pred.shape != target.shape:
            clamped = target.long().clamp(0, num_classes)
            one_hot = F.one_hot(clamped, num_classes + 1)[..., :num_classes]
            one_hot = one_hot.permute(0, 3, 1, 2)
        if self.activate:
            if self.use_sigmoid:
                pred = torch.sigmoid(pred)
            elif num_classes != 1:
                pred = torch.softmax(pred, dim=1)
        if self.ignore_index is not None and self.ignore_index < num_classes:
            keep = [c for c in range(num_classes) if c != self.ignore_index]
            pred, one_hot = pred[:, keep], one_hot[:, keep]
        p = pred.reshape(pred.shape[0], -1)
        t = one_hot.reshape(one_hot.shape[0], -1).to(p.dtype)
        a = (p * t).sum(1)
        if self.naive_dice:
            d = (2 * a + self.eps) / (p.sum(1) + t.sum(1) + self.eps)
        else:
            d = 2 * a / (((p * p).sum(1) + self.eps) + ((t * t).sum(1) + self.eps))
        return self.loss_weight * _weight_reduce(1 - d, weight, reduction,
                                                 avg_factor)
