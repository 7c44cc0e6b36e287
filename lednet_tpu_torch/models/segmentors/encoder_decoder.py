"""EncoderDecoder segmentor (whole-image inference), NHWC at the boundary.

Counterpart of ``lednet_tpu/models/segmentors/encoder_decoder.py``
(``extract_feat`` :58, ``predict`` :90, ``postprocess_logits`` :156).
``predict`` takes (B, H, W, 3) images and returns (B, H, W, C) logits;
inside, the model runs NCHW (an NHWC view of channels-first memory goes in
and comes out without a copy).  Slide inference, necks, auxiliary heads,
the single-logit binary head and the training loss are later work.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class EncoderDecoder(nn.Module):

    def __init__(self, backbone: Dict, decode_head: Dict,
                 train_cfg: Optional[Dict] = None, test_cfg: Optional[Dict] = None,
                 data_preprocessor: Optional[Dict] = None):
        """``data_preprocessor`` is built beside the model by ``init_model``;
        ``train_cfg`` is read by training (later work)."""
        super().__init__()
        self.test_cfg = dict(test_cfg or {})
        if self.test_cfg.get('mode', 'whole') != 'whole':
            raise NotImplementedError('the port runs whole-image inference only')
        self.backbone = MODELS.build(dict(backbone))
        self.decode_head = MODELS.build(dict(decode_head))

    def extract_feat(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """inputs: (B, 3, H, W)."""
        return self.backbone(inputs, impl)

    def forward(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """'tensor' mode on (B, 3, H, W): the decode head's raw outputs."""
        return self.decode_head(self.extract_feat(inputs, impl))

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
