"""CascadeEncoderDecoder: chained decode heads (OCRNet, PointRend), NHWC at
the boundary.

Counterpart of ``lednet_tpu/models/segmentors/cascade_encoder_decoder.py``
(:20-67): ``num_stages`` heads built from the list ``decode_head``
(``decode_heads``, flax's ``_heads_{i}``); head 0 takes the features, head
k >= 1 the features and head k-1's output.  ``loss`` keys each head's
losses ``decode_{i}.*``, then the auxiliary heads' ``aux.*`` (or
``aux_{i}.*``); ``predict`` (and ``predict_slide``) take the last head's
``predict_by_feat``.  ``decode_head`` is that last head, so code that reads
``model.decode_head`` finds the head that predicts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from lednet_tpu_torch.models.segmentors.encoder_decoder import EncoderDecoder
from lednet_tpu_torch.registry import MODELS


def predicting_head_cfg(model_cfg) -> Dict:
    """The config of the head a segmentor predicts with: ``decode_head``,
    or its last entry where it is a cascade's list."""
    head = model_cfg.get('decode_head') or {}
    return head[-1] if isinstance(head, (list, tuple)) else head


@MODELS.register_module()
class CascadeEncoderDecoder(EncoderDecoder):

    def __init__(self, backbone: Dict, decode_head: List[Dict],
                 num_stages: int = 2, neck: Optional[Dict] = None,
                 auxiliary_head: Optional[Any] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 data_preprocessor: Optional[Dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None):
        if not isinstance(decode_head, (list, tuple)) or \
                len(decode_head) != num_stages:
            raise ValueError(f'a cascade of {num_stages} stages needs as many '
                             f'decode_head configs, got {decode_head!r}')
        super().__init__(backbone, decode_head, neck, auxiliary_head,
                         train_cfg, test_cfg, data_preprocessor, pretrained,
                         init_cfg)

    def build_decode_head(self, decode_head) -> None:
        self.decode_heads = nn.ModuleList(MODELS.build(dict(c))
                                          for c in decode_head)

    @property
    def decode_head(self) -> nn.Module:
        return self.decode_heads[-1]

    def cascade(self, feats) -> list:
        """Every stage's output: head 0 of ``feats``, head k of ``feats``
        and head k-1's output."""
        out = self.decode_heads[0](feats)
        outs = [out]
        for head in self.decode_heads[1:]:
            out = head(feats, out)
            outs.append(out)
        return outs

    def forward(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """'tensor' mode on (B, 3, H, W): the last head's outputs."""
        return self.decode(self.extract_feat(inputs, impl))

    def decode(self, feats):
        return self.cascade(feats)[-1]

    def loss(self, inputs: torch.Tensor, seg_label) -> Dict[str, torch.Tensor]:
        """Training losses of (B, H, W, 3) images, keyed ``decode_{i}.*``
        per stage, then ``aux.*`` (``aux_{i}.*``); train mode only."""
        if not self.training:
            raise RuntimeError('CascadeEncoderDecoder.loss needs train mode '
                               '(model.train())')
        feats = self.extract_feat(inputs.permute(0, 3, 1, 2))
        losses = {}
        for i, (head, out) in enumerate(zip(self.decode_heads,
                                            self.cascade(feats))):
            for k, v in head.loss_by_feat(out, seg_label).items():
                losses[f'decode_{i}.{k}'] = v
        losses.update(self.aux_losses(feats, seg_label))
        return losses
