"""Test-time-augmentation merge.

Counterpart of ``lednet_tpu/models/segmentors/seg_tta.py`` (``SegTTAModel``
:20, ``merge_tta_probs`` :32): each view's logits, already cropped,
un-flipped and resized to the original frame, become softmax (or, with one
logit channel, sigmoid) probabilities; their mean's argmax (or mean >
``threshold``) is the prediction.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class SegTTAModel:
    """Config marker (``tta_model = dict(type='SegTTAModel')``); the runner
    merges the views with :func:`merge_tta_probs`."""

    def __init__(self, module=None, **kwargs):
        self.module = module


def merge_tta_probs(view_logits: Sequence[torch.Tensor],
                    out_channels: Optional[int] = None,
                    threshold: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """view_logits: (H, W, C) logits per view in the original frame.
    Returns (mean probabilities (H, W, C), prediction (H, W) int32)."""
    probs = []
    for logits in view_logits:
        logits = logits.float()
        if (out_channels or logits.shape[-1]) == 1:
            probs.append(torch.sigmoid(logits))
        else:
            probs.append(torch.softmax(logits, dim=-1))
    mean = sum(probs) / len(probs)
    if (out_channels or mean.shape[-1]) == 1:
        pred = (mean[..., 0] > threshold).to(torch.int32)
    else:
        pred = torch.argmax(mean, dim=-1).to(torch.int32)
    return mean, pred
