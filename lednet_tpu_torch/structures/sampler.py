"""OHEM pixel sampler: a per-pixel weight map that keeps the hardest pixels.

Counterpart of ``lednet_tpu/structures/sampler.py:21``.  ``sample`` takes
(B, C, H, W) logits and (B, H, W) labels and returns (B, H, W) weights, 1
where a pixel is kept and 0 elsewhere (ignored pixels are never kept):

- with ``thresh``: keep the valid pixels whose softmax probability of their
  label lies strictly below ``max(p_k, thresh)``, ``p_k`` the k-th smallest
  (0-indexed) of the valid ones with k = ``min(min_kept * B, n_valid - 1)``;
- without: keep the ``min_kept * B`` valid pixels of the largest
  cross-entropy, ties broken by the lower flat index (the JAX package's
  stable ``argsort``).

Both run on the device with no host sync; no gradient flows through them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lednet_tpu_torch.models.losses.cross_entropy import _kth_smallest, take_class
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class OHEMPixelSampler:

    def __init__(self, context=None, thresh: Optional[float] = None,
                 min_kept: int = 100000, ignore_index: int = 255):
        if min_kept <= 1:
            raise ValueError(f'min_kept must be above 1, got {min_kept}')
        self.thresh = thresh
        self.min_kept = min_kept
        self.ignore_index = ignore_index

    def keep_mask(self, seg_logits: torch.Tensor,
                  seg_label: torch.Tensor) -> torch.Tensor:
        """The kept pixels, a (B, H, W) bool map."""
        batch_kept = self.min_kept * seg_logits.shape[0]
        valid = seg_label != self.ignore_index
        safe = torch.where(valid, seg_label, 0)
        with torch.no_grad():
            logits = seg_logits.detach().float()
            if self.thresh is not None:
                p_gt = take_class(F.softmax(logits, dim=1), safe)
                p_flat = torch.where(valid, p_gt, 2.0).reshape(-1)
                k = (valid.sum() - 1).clamp_min(0).clamp_max(batch_kept)
                p_k = _kth_smallest(p_flat, k.clamp_max(p_flat.numel() - 1))
                return valid & (p_gt < p_k.clamp_min(self.thresh))
            losses = -take_class(F.log_softmax(logits, dim=1), safe)
            l_flat = torch.where(valid, losses, -torch.inf).reshape(-1)
            order = torch.argsort(-l_flat, stable=True)
            ranks = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=order.device))
            return valid & (ranks.view(valid.shape) < batch_kept)

    def sample(self, seg_logits: torch.Tensor,
               seg_label: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) logits, (B, H, W) labels -> (B, H, W) weights of the
        logits' dtype."""
        return self.keep_mask(seg_logits, seg_label).to(seg_logits.dtype)
