"""EncoderDecoder segmentor (training loss, whole-image and slide
inference), NHWC at the boundary.

Counterpart of ``lednet_tpu/models/segmentors/encoder_decoder.py``
(``extract_feat`` :58, ``loss`` :77, ``predict`` :90, ``predict_slide``
:101, ``_slide_grid`` :139, ``postprocess_logits`` :156, with its flip and
single-logit threshold).  ``loss``, ``predict`` and ``predict_slide`` take
(B, H, W, 3) images; the predictions are (B, H, W, C) logits.  Inside, the
model runs NCHW (an NHWC view of channels-first memory goes in and comes
out without a copy).

Slide inference, as the JAX package runs it: the crop-origin grid is static
per input shape (``_slide_grid``, clamped to the image), every crop is cut
from the preprocessed image and the crops are stacked on the batch axis for
ONE backbone + decode-head forward; each crop's logits are added into a
(B, C, H, W) buffer in grid order and the sum is divided by the number of
crops that covered each pixel (a constant of the shape, made once per
device).  A crop larger than the image raises, as the JAX package's
``dynamic_slice`` does.  A ``neck`` (ICNet's ``ICNeck``), where the config
has one, is built once and applied to the backbone's outputs in
``extract_feat`` (``:48``, ``:67``), so ``loss``, ``predict``,
``predict_slide`` and the TTA path all run it; flax names it ``_neck``.
The single-logit binary head is later work.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def build_segmentor(model_cfg) -> nn.Module:
    """``MODELS.build`` of a config's ``model``, which must be a segmentor
    (``loss`` and ``predict``).  DSNet's config builds a module with
    neither, which the JAX package's ``init_model`` and ``Runner`` cannot
    run either: it raises ``TypeError`` here."""
    model = MODELS.build(dict(model_cfg))
    missing = [m for m in ('loss', 'predict')
               if not callable(getattr(model, m, None))]
    if missing:
        raise TypeError(f'{type(model).__name__} is not a segmentor: it has '
                        f'no {" and no ".join(missing)}; build it with '
                        'MODELS.build and call it as a module')
    return model


@MODELS.register_module()
class EncoderDecoder(nn.Module):

    def __init__(self, backbone: Dict, decode_head: Dict,
                 neck: Optional[Dict] = None,
                 auxiliary_head: Optional[Any] = None,
                 train_cfg: Optional[Dict] = None, test_cfg: Optional[Dict] = None,
                 data_preprocessor: Optional[Dict] = None):
        """``data_preprocessor`` is built beside the model by ``init_model``;
        ``auxiliary_head`` is a head config or a list of them."""
        super().__init__()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.backbone = MODELS.build(dict(backbone))
        self.neck = MODELS.build(dict(neck)) if neck else None
        self.build_decode_head(decode_head)
        if auxiliary_head is None:
            auxiliary_head = []
        elif not isinstance(auxiliary_head, (list, tuple)):
            auxiliary_head = [auxiliary_head]
        self.aux_heads = nn.ModuleList(MODELS.build(dict(c))
                                       for c in auxiliary_head)

    def build_decode_head(self, decode_head) -> None:
        """``decode_head`` from its config (a cascade builds several)."""
        self.decode_head = MODELS.build(dict(decode_head))

    def extract_feat(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """inputs: (B, 3, H, W)."""
        feats = self.backbone(inputs, impl)
        if self.neck is not None:
            feats = self.neck(feats)
        return feats

    def forward(self, inputs: torch.Tensor, impl: Optional[str] = None):
        """'tensor' mode on (B, 3, H, W): the decode head's raw outputs."""
        return self.decode_head(self.extract_feat(inputs, impl))

    def decode(self, feats):
        """The decode head's outputs of ``feats`` that ``predict_by_feat``
        takes (a cascade runs every stage)."""
        return self.decode_head(feats, with_aux=False)

    def aux_losses(self, feats, seg_label) -> Dict[str, torch.Tensor]:
        """The auxiliary heads' losses, keyed ``aux.*`` (``aux_{i}.*`` with
        several)."""
        losses = {}
        for i, head in enumerate(self.aux_heads):
            prefix = f'aux_{i}' if len(self.aux_heads) > 1 else 'aux'
            for k, v in head.loss_by_feat(head(feats), seg_label).items():
                losses[f'{prefix}.{k}'] = v
        return losses

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
        losses.update(self.aux_losses(feats, seg_label))
        return losses

    def predict(self, inputs: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        """Whole-image inference: (B, H, W, 3) -> (B, H, W, C) logits at the
        (padded) input resolution."""
        size = tuple(inputs.shape[1:3])
        feats = self.extract_feat(inputs.permute(0, 3, 1, 2), impl)
        logits = self.decode(feats)
        return self.decode_head.predict_by_feat(logits, size).permute(0, 2, 3, 1)

    def predict_slide(self, inputs: torch.Tensor,
                      impl: Optional[str] = None) -> torch.Tensor:
        """Slide inference with ``test_cfg``'s ``crop_size`` and ``stride``:
        (B, H, W, 3) -> (B, H, W, C) logits, the crops run as one batch."""
        crop = tuple(self.test_cfg['crop_size'])
        stride = tuple(self.test_cfg['stride'])
        H, W = inputs.shape[1:3]
        starts = _slide_grid(H, W, crop, stride)
        crops = self.slide_crops(inputs.permute(0, 3, 1, 2), starts, crop)
        feats = self.extract_feat(crops, impl)
        logits = self.decode(feats)
        crop_logits = self.decode_head.predict_by_feat(logits, crop)
        out = self.slide_accumulate(crop_logits, starts, (H, W))
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def slide_crops(x: torch.Tensor, starts: List[Tuple[int, int]],
                    crop: Tuple[int, int]) -> torch.Tensor:
        """The crops of (B, C, H, W) ``x`` at ``starts``, stacked crop-major:
        (n_crops * B, C, ch, cw)."""
        (ch, cw), (H, W) = crop, x.shape[-2:]
        if ch > H or cw > W:
            raise ValueError(f'slide crop {ch}x{cw} is larger than the '
                             f'(padded) image {H}x{W}')
        return torch.cat([x[:, :, y:y + ch, x0:x0 + cw] for y, x0 in starts], 0)

    @staticmethod
    def slide_accumulate(crop_logits: torch.Tensor,
                         starts: List[Tuple[int, int]],
                         size: Tuple[int, int]) -> torch.Tensor:
        """(n_crops * B, C, ch, cw) crop logits -> (B, C, H, W): each crop
        added in grid order, then divided by the visit count."""
        n = len(starts)
        ch, cw = crop_logits.shape[-2:]
        parts = crop_logits.unflatten(0, (n, -1))
        accum = crop_logits.new_zeros((parts.shape[1], parts.shape[2]) + tuple(size))
        for i, (y, x) in enumerate(starts):
            accum[:, :, y:y + ch, x:x + cw] += parts[i]
        count = _visit_count(tuple(size), (ch, cw), tuple(starts),
                             crop_logits.dtype, crop_logits.device)
        return accum / count


def _slide_grid(H: int, W: int, crop: Tuple[int, int],
                stride: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The static crop origins (y, x), row-major, the last row and column
    clamped so that their crops end at the image's edge."""
    ch, cw = crop
    sh, sw = stride
    h_grids = max(H - ch + sh - 1, 0) // sh + 1
    w_grids = max(W - cw + sw - 1, 0) // sw + 1
    return [(min(i * sh, max(H - ch, 0)), min(j * sw, max(W - cw, 0)))
            for i in range(h_grids) for j in range(w_grids)]


@functools.lru_cache(maxsize=None)
def _visit_count(size: Tuple[int, int], crop: Tuple[int, int],
                 starts: Tuple[Tuple[int, int], ...], dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(H, W) number of crops covering each pixel, on ``device``: small
    integers, exact in any float type.  Kept, so that a forward after the
    first copies nothing from the host (a CUDA graph cannot capture a copy
    from pageable host memory), and never evicted: a captured graph reads
    it at every replay.  Made outside inference mode."""
    count = np.zeros(size, np.float32)
    for y, x in starts:
        count[y:y + crop[0], x:x + crop[1]] += 1
    with torch.inference_mode(False):
        return torch.from_numpy(count).to(device=device, dtype=dtype)


def postprocess_logits(logits: torch.Tensor, pad: Tuple[int, int],
                       ori_shape: Optional[Tuple[int, int]] = None,
                       flip: bool = False, flip_direction: str = 'horizontal',
                       align_corners: bool = False,
                       out_channels: Optional[int] = None,
                       threshold: float = 0.3):
    """Crop the padding, undo a flip, resize to the original shape, then
    take the argmax (or, with one logit channel, sigmoid > ``threshold``).
    (B, H, W, C) in; returns (seg_logits, seg_pred)."""
    pad_h, pad_w = pad
    H, W = logits.shape[1] - pad_h, logits.shape[2] - pad_w
    logits = logits[:, :H, :W, :]
    if flip:
        logits = logits.flip(2 if flip_direction == 'horizontal' else 1)
    if ori_shape is not None and tuple(ori_shape) != (H, W):
        logits = resize_bilinear(logits.permute(0, 3, 1, 2), ori_shape,
                                 align_corners).permute(0, 2, 3, 1)
    n_ch = out_channels if out_channels is not None else logits.shape[-1]
    if n_ch == 1:
        pred = (torch.sigmoid(logits[..., 0]) > threshold).to(torch.int32)
    else:
        pred = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, pred
