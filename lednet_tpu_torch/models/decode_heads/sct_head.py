"""SCTNet's decode head, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/fpn_sct_heads.py:95``
(``SCTHead``): a pre-activation 3x3 ``conv1`` (norm and ReLU on the input
width, then the conv), ``bn2``, a ReLU and ``cls``.
"""
from __future__ import annotations

import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.layers import ConvModule, Norm2d
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class SCTHead(HeadBase):

    def __init__(self, in_channels=256, channels=128, num_classes=19, **kwargs):
        super().__init__(in_channels, channels, num_classes, **kwargs)
        self.conv1 = ConvModule(self.in_width, channels, 3, padding=1,
                                norm_cfg=self.norm_cfg,
                                act_cfg=dict(type='ReLU'),
                                order=('norm', 'act', 'conv'))
        self.bn2 = Norm2d(self.norm_cfg, channels)

    def forward(self, inputs, with_aux: bool = True):
        """The logits of the selected input; ``with_aux`` means nothing
        here."""
        return self.cls(F.relu(self.bn2(self.conv1(self._select(inputs)))))
