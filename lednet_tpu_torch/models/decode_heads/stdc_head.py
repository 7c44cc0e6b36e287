"""STDC detail-guidance head, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/stdc_head.py:25``: an
``FCNHead`` whose loss target is the boundary of the label.  The label,
as float with its 255s, goes through the fixed 3x3 Laplacian at strides
1, 2 and 4 (``models/seam.py::_laplacian_conv``), each clamped at 0; the
stride-1 map is binarized at ``boundary_threshold``, the coarser ones are
upsampled by nearest neighbour first; the three are fused with weights
0.6 / 0.3 / 0.1 and binarized again.  The configured losses (sigmoid
cross-entropy on the two-channel logit and ``DiceLoss``) run on that
0/1 label.
"""
from __future__ import annotations

from typing import Dict

import torch

from lednet_tpu_torch.models.decode_heads.base import default_loss_by_feat, sem_label
from lednet_tpu_torch.models.decode_heads.fcn_head import FCNHead
from lednet_tpu_torch.models.seam import _FUSION, _laplacian_conv
from lednet_tpu_torch.ops.resize import resize_nearest
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class STDCHead(FCNHead):

    def __init__(self, *args, boundary_threshold: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.boundary_threshold = boundary_threshold

    def boundary_label(self, seg_label) -> torch.Tensor:
        """(B, H, W) int64 0/1 boundary of a (B, H, W) label map."""
        label = sem_label(seg_label).float().unsqueeze(1)

        def binarize(t):
            return torch.where(t > self.boundary_threshold, 1.0, 0.0)
        b1 = binarize(_laplacian_conv(label, 1).clamp_min(0))
        size = b1.shape[-2:]
        b2, b4 = (binarize(resize_nearest(_laplacian_conv(label, s).clamp_min(0),
                                          size)) for s in (2, 4))
        fused = binarize(_FUSION[0] * b1 + _FUSION[1] * b2 + _FUSION[2] * b4)
        return fused[:, 0].long()

    def loss_by_feat(self, seg_logits, seg_label) -> Dict:
        return default_loss_by_feat(seg_logits, self.boundary_label(seg_label),
                                    self.losses, self.align_corners,
                                    self.ignore_index)
