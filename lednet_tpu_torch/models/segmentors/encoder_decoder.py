"""EncoderDecoder segmentor (training loss and whole-image inference), NHWC
at the boundary.

Counterpart of ``lednet_tpu/models/segmentors/encoder_decoder.py``
(``extract_feat`` :58, ``loss`` :77, ``predict`` :90, ``postprocess_logits``
:156).  ``loss`` and ``predict`` take (B, H, W, 3) images; ``predict``
returns (B, H, W, C) logits.  Inside, the model runs NCHW (an NHWC view of
channels-first memory goes in and comes out without a copy).  Slide
inference, necks and the single-logit binary head are later work.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class EncoderDecoder(nn.Module):

    def __init__(self, backbone: Dict, decode_head: Dict,
                 auxiliary_head: Optional[Any] = None,
                 train_cfg: Optional[Dict] = None, test_cfg: Optional[Dict] = None,
                 data_preprocessor: Optional[Dict] = None):
        """``data_preprocessor`` is built beside the model by ``init_model``;
        ``auxiliary_head`` is a head config or a list of them."""
        super().__init__()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        if self.test_cfg.get('mode', 'whole') != 'whole':
            raise NotImplementedError('the port runs whole-image inference only')
        self.backbone = MODELS.build(dict(backbone))
        self.decode_head = MODELS.build(dict(decode_head))
        if auxiliary_head is None:
            auxiliary_head = []
        elif not isinstance(auxiliary_head, (list, tuple)):
            auxiliary_head = [auxiliary_head]
        self.aux_heads = nn.ModuleList(MODELS.build(dict(c))
                                       for c in auxiliary_head)

    def extract_feat(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """inputs: (B, 3, H, W)."""
        return self.backbone(inputs, impl)

    def forward(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """'tensor' mode on (B, 3, H, W): the decode head's raw outputs."""
        return self.decode_head(self.extract_feat(inputs, impl))

    def loss(self, inputs: torch.Tensor, seg_label) -> Dict[str, torch.Tensor]:
        """Training losses of (B, H, W, 3) images against (B, H, W) labels (or
        a dict with ``gt_seg_map``), keyed ``decode.*`` and ``aux.*`` (or
        ``aux_{i}.*`` with several auxiliary heads).  It runs in train mode
        only: the module forms, BatchNorm on batch statistics."""
        if not self.training:
            raise RuntimeError('EncoderDecoder.loss needs train mode '
                               '(model.train())')
        feats = self.extract_feat(inputs.permute(0, 3, 1, 2))
        logits = self.decode_head(feats)
        losses = {f'decode.{k}': v for k, v in
                  self.decode_head.loss_by_feat(logits, seg_label).items()}
        for i, head in enumerate(self.aux_heads):
            prefix = f'aux_{i}' if len(self.aux_heads) > 1 else 'aux'
            for k, v in head.loss_by_feat(head(feats), seg_label).items():
                losses[f'{prefix}.{k}'] = v
        return losses

    def predict(self, inputs: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        """Whole-image inference: (B, H, W, 3) -> (B, H, W, C) logits at the
        (padded) input resolution."""
        size = tuple(inputs.shape[1:3])
        feats = self.extract_feat(inputs.permute(0, 3, 1, 2), impl)
        logits = self.decode_head(feats, with_aux=False)
        return self.decode_head.predict_by_feat(logits, size).permute(0, 2, 3, 1)


def postprocess_logits(logits: torch.Tensor, pad: Tuple[int, int],
                       ori_shape: Optional[Tuple[int, int]] = None,
                       align_corners: bool = False):
    """Crop padding, resize to the original shape, then argmax.  (B, H, W, C)
    in; returns (seg_logits, seg_pred)."""
    pad_h, pad_w = pad
    H, W = logits.shape[1] - pad_h, logits.shape[2] - pad_w
    logits = logits[:, :H, :W, :]
    if ori_shape is not None and tuple(ori_shape) != (H, W):
        logits = resize_bilinear(logits.permute(0, 3, 1, 2), ori_shape,
                                 align_corners).permute(0, 2, 3, 1)
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)
