"""MultimodalEncoderDecoder: SAN's open-vocabulary segmentor, NHWC at the
boundary.

Counterpart of ``lednet_tpu/models/segmentors/multimodal.py`` (:23-67): an
image encoder (``image_encoder``, CLIP's ViT), a text encoder
(``text_encoder``, the class embeddings of the vocabulary) and a decode
head (``decode_head``, ``SideAdapterCLIPHead``) that takes (image, CLIP
features, class embeddings).  With ``asymetric_input`` and
``encoder_resolution`` the image encoder sees the image bilinearly resized
(``int(H * r)`` x ``int(W * r)`` for a factor ``r``, or a given (h, w)),
the head the image itself.  ``loss`` keys the head's losses ``decode.*``;
``predict`` gives (B, H, W, C) scores at the (padded) input size.  The
signatures are ``EncoderDecoder``'s, so that ``build_segmentor``,
``EvalStep``, ``make_train_step`` and ``Runner`` take it unchanged.

The side adapter fuses one CLIP feature per ``fusion_index`` entry: an
image encoder that gives fewer (``len(out_indices)``, plus one with
``out_origin``) raises ``ValueError`` here, where the JAX package raises
``IndexError`` at its first forward.  ``train_cfg``, ``pretrained`` and
``init_cfg`` are accepted and never read, as in the JAX package: the model
builds on random weights.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


@MODELS.register_module()
class MultimodalEncoderDecoder(nn.Module):

    def __init__(self, image_encoder: Dict, text_encoder: Dict,
                 decode_head: Dict, train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 data_preprocessor: Optional[Dict] = None,
                 asymetric_input: bool = True,
                 encoder_resolution: Optional[Any] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None):
        super().__init__()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.asymetric_input = asymetric_input
        self.encoder_resolution = encoder_resolution
        self.image_encoder = MODELS.build(dict(image_encoder))
        self.text_encoder = MODELS.build(dict(text_encoder))
        self.decode_head = MODELS.build(dict(decode_head))
        n_feats = len(self.image_encoder.out_indices) + bool(
            self.image_encoder.out_origin)
        fusion = tuple(self.decode_head.fusion_index)
        if len(fusion) > n_feats:
            raise ValueError(
                f'the decode head fuses {len(fusion)} CLIP features '
                f'(fusion_index={fusion}), but the image encoder gives '
                f'{n_feats} (out_indices={self.image_encoder.out_indices}, '
                f'out_origin={self.image_encoder.out_origin}); set '
                "model.image_encoder.out_origin=True, as mmsegmentation's SAN "
                'config does')

    def encoder_input(self, inputs: torch.Tensor) -> torch.Tensor:
        """The image encoder's input of (B, 3, H, W) ``inputs``."""
        res = self.encoder_resolution
        if not self.asymetric_input or res is None:
            return inputs
        if isinstance(res, (int, float)) and not isinstance(res, bool):
            size = (int(inputs.shape[-2] * res), int(inputs.shape[-1] * res))
        else:
            size = tuple(res)
        return resize_bilinear(inputs, size, False)

    def extract_feat(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """CLIP's features of (B, 3, H, W) ``inputs``.  ``impl`` means
        nothing here: no port kernel runs inside the model."""
        return self.image_encoder(self.encoder_input(inputs))

    def decode(self, inputs: torch.Tensor, feats, with_aux: bool = False):
        """The head's outputs of the image and its CLIP features: every
        deep-supervision tap's with ``with_aux``, else the last."""
        return self.decode_head((inputs, feats, self.text_encoder()),
                                with_aux=with_aux)

    def forward(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """'tensor' mode on (B, 3, H, W): the last (mask logits, class
        logits)."""
        return self.decode(inputs, self.extract_feat(inputs, impl))

    def loss(self, inputs: torch.Tensor, seg_label) -> Dict[str, torch.Tensor]:
        """Training losses of (B, H, W, 3) images against (B, H, W) labels,
        keyed ``decode.*``; train mode only."""
        if not self.training:
            raise RuntimeError('MultimodalEncoderDecoder.loss needs train mode '
                               '(model.train())')
        x = inputs.permute(0, 3, 1, 2)
        outs = self.decode(x, self.extract_feat(x), with_aux=True)
        return {f'decode.{k}': v for k, v in
                self.decode_head.loss_by_feat(outs, seg_label).items()}

    def predict(self, inputs: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        """Whole-image inference: (B, H, W, 3) -> (B, H, W, C) scores at the
        (padded) input resolution."""
        size = tuple(inputs.shape[1:3])
        x = inputs.permute(0, 3, 1, 2)
        outs = self.forward(x, impl)
        return self.decode_head.predict_by_feat(outs, size).permute(0, 2, 3, 1)
