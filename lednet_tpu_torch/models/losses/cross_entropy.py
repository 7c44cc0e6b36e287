"""Cross-entropy losses (softmax and sigmoid) with ignore-index handling, and
pixel accuracy, NCHW.

Counterpart of ``lednet_tpu/models/losses/cross_entropy.py`` (``take_class``
:19, ``weight_at`` :32, ``pixelwise_cross_entropy`` :39, ``CrossEntropyLoss``
:54, ``_kth_smallest`` :125, ``OhemCrossEntropy`` :150, ``accuracy`` :202).
Logits are ``(B, C, H, W)`` (the JAX package's are NHWC); labels are
``(B, H, W)`` integers with ``ignore_index`` sentinel pixels.  Every
reduction is a masked one over the whole batch, with no host sync, as in the
JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lednet_tpu_torch.registry import MODELS


def take_class(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``values[:, labels]`` per pixel: (B, C, ...) at integer (B, ...) labels
    -> (B, ...).  Labels outside [0, C) select 0."""
    num_classes = values.shape[1]
    inside = (labels >= 0) & (labels < num_classes)
    idx = torch.where(inside, labels, 0).long().unsqueeze(1)
    picked = torch.gather(values, 1, idx).squeeze(1)
    return torch.where(inside, picked, 0.0)


def weight_at(table, labels: torch.Tensor) -> torch.Tensor:
    """Per-class weight lookup ``table[labels]`` (0 outside [0, C))."""
    table = torch.as_tensor(table, dtype=torch.float32, device=labels.device)
    values = table.view(1, -1, *([1] * (labels.dim() - 1)))
    return take_class(values.expand(labels.shape[0], -1, *labels.shape[1:]),
                      labels)


def pixelwise_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_index: int = 255, class_weight=None):
    """Per-pixel CE and validity mask: (loss (B, H, W), valid (B, H, W))."""
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0)
    logp = F.log_softmax(logits.float(), dim=1)
    nll = -take_class(logp, safe_labels)
    if class_weight is not None:
        nll = nll * weight_at(class_weight, safe_labels)
    return torch.where(valid, nll, 0.0), valid


@MODELS.register_module()
class CrossEntropyLoss:
    """Softmax or sigmoid cross-entropy.  With ``class_weight`` the mean
    divides by the sum of the selected class weights, as
    ``F.cross_entropy(weight=...)`` does."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = 'mean',
                 class_weight: Optional[Sequence[float]] = None,
                 loss_weight: float = 1.0, loss_name: str = 'loss_ce',
                 avg_non_ignore: bool = False):
        if use_mask:
            raise NotImplementedError('mask CE is not used by the model zoo')
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.class_weight = class_weight
        self.loss_weight = loss_weight
        self.loss_name = loss_name
        self.avg_non_ignore = avg_non_ignore

    def __call__(self, logits, labels, weight=None, ignore_index: int = 255,
                 avg_factor=None):
        if self.use_sigmoid:
            return self._binary(logits, labels, weight, ignore_index)
        cw = self.class_weight
        pix, valid = pixelwise_cross_entropy(logits, labels, ignore_index, cw)
        if weight is not None:
            pix = pix * weight
        if self.reduction == 'none':
            return self.loss_weight * pix
        if self.reduction == 'sum':
            return self.loss_weight * pix.sum()
        if avg_factor is not None:
            denom = avg_factor
        elif cw is not None:
            safe = torch.where(valid, labels, 0)
            denom = torch.where(valid, weight_at(cw, safe), 0.0).sum()
        elif self.avg_non_ignore:
            denom = valid.sum()
        else:
            # mmseg's avg_non_ignore=False divides by every pixel
            denom = labels.numel()
        return self.loss_weight * pix.sum() / _at_least_1(denom)

    def _binary(self, logits, labels, weight, ignore_index):
        valid = labels != ignore_index
        x = logits.float()
        if logits.dim() == 4 and logits.shape[1] > 1:
            # int labels become a C-channel one-hot target for sigmoid CE
            target = F.one_hot(torch.where(valid, labels, 0).long(),
                               logits.shape[1]).permute(0, 3, 1, 2).float()
            mask = valid.unsqueeze(1)
            n_elems = labels.numel() * logits.shape[1]
        else:
            if logits.dim() == 4:
                x = x[:, 0]
            target = torch.where(valid, labels, 0).float()
            mask = valid
            n_elems = labels.numel()
        # numerically stable BCE with logits
        loss = x.clamp_min(0) - x * target + torch.log1p(torch.exp(-x.abs()))
        loss = torch.where(mask, loss, 0.0)
        if weight is not None:
            loss = loss * weight
        denom = mask.sum() if self.avg_non_ignore else n_elems
        return self.loss_weight * loss.sum() / _at_least_1(denom)


def _at_least_1(denom):
    """``max(denom, 1)`` for a Python number or a tensor."""
    return denom.clamp_min(1) if torch.is_tensor(denom) else max(denom, 1)


_BITS_OF_3 = 0x40400000        # float32 3.0, above every probability and 2.0


def _kth_smallest(p_flat: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th (0-indexed) order statistic of a nonnegative float32 vector,
    ``k`` a 0-d tensor.  The IEEE bit pattern of a nonnegative float is
    monotone in its value, so a 32-step integer bisection with one
    count-<= per step finds it on the device, with no host sync."""
    bits = p_flat.float().contiguous().view(torch.int32)
    lo = torch.zeros((), dtype=torch.int32, device=bits.device)
    hi = torch.full((), _BITS_OF_3, dtype=torch.int32, device=bits.device)
    for _ in range(32):
        mid = lo + torch.div(hi - lo, 2, rounding_mode='floor')
        take_low = (bits <= mid).sum() >= k + 1
        lo, hi = torch.where(take_low, lo, mid + 1), torch.where(take_low, mid, hi)
    return lo.view(torch.float32)


@MODELS.register_module()
class OhemCrossEntropy:
    """Online hard example mining CE: keep valid pixels whose ground-truth
    softmax probability is strictly below ``max(kth_smallest, thres)``, with
    k = ``min(min_kept, n_valid - 1)`` over the whole batch and ignored
    pixels set to 2.0; the loss is the mean CE over the kept set (0 when no
    pixel is valid or kept)."""

    def __init__(self, ignore_label: int = 255, thres: float = 0.7,
                 min_kept: int = 100000, loss_weight: float = 1.0,
                 class_weight: Optional[Sequence[float]] = None,
                 loss_name: str = 'loss_ohem'):
        self.ignore_label = ignore_label
        self.thresh = float(thres)
        self.min_kept = max(1, int(min_kept))
        self.loss_weight = loss_weight
        self.class_weight = class_weight
        self.loss_name = loss_name

    def threshold(self, logits, labels, ignore_index=None):
        """(threshold, valid, p_gt): the probability a kept pixel lies
        strictly below; no gradient flows through it."""
        ignore = self.ignore_label if ignore_index is None else ignore_index
        valid = labels != ignore
        with torch.no_grad():
            probs = F.softmax(logits.detach().float(), dim=1)
            p_gt = take_class(probs, torch.where(valid, labels, 0))
            p_flat = torch.where(valid, p_gt, 2.0).reshape(-1)
            n_valid = valid.sum()
            k = torch.clamp(n_valid - 1, min=0).clamp_max(self.min_kept)
            min_value = _kth_smallest(p_flat, k.clamp_max(p_flat.numel() - 1))
            return min_value.clamp_min(self.thresh), valid, p_gt

    def __call__(self, logits, labels, weight=None, ignore_index=None,
                 avg_factor=None):
        ignore = self.ignore_label if ignore_index is None else ignore_index
        pix, _ = pixelwise_cross_entropy(logits, labels, ignore,
                                         self.class_weight)
        threshold, valid, p_gt = self.threshold(logits, labels, ignore)
        keep = valid & (p_gt < threshold)
        n_kept = keep.sum()
        kept_loss = torch.where(keep, pix, 0.0).sum()
        mean = torch.where(n_kept > 0, kept_loss / n_kept.clamp_min(1), 0.0)
        # no valid pixel at all gives 0
        return self.loss_weight * torch.where(valid.any(), mean, 0.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """Top-1 pixel accuracy in percent over the non-ignored pixels."""
    pred = torch.argmax(logits, dim=1)
    valid = labels != ignore_index
    correct = ((pred == labels) & valid).sum()
    return 100.0 * correct / valid.sum().clamp_min(1)
