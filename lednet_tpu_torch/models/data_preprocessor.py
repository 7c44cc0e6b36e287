"""On-device batch preprocessing, NHWC at the boundary.

Counterpart of ``lednet_tpu/models/data_preprocessor.py`` (``SegDataPreProcessor``
:21, ``__call__`` :77-125): cast to float32, BGR->RGB flip, mean/std
normalization, then

- eval: rounding to ``out_dtype`` (the config's ``'bfloat16'``); the LED
  configs set no eval pad size, so eval batches are not padded.  On CUDA the
  normalization is kernel A
  (:func:`lednet_tpu_torch.ops.kernels.normalize_image`).
- training: float32, padded bottom/right to ``max(size, (H, W))``; images
  with ``pad_val`` after normalization, labels with ``seg_pad_val`` (the
  ``gt_seg_map`` of a dict of maps; its other maps with 0).  Plain PyTorch,
  as the JAX package's training path is plain jnp.

The output is the normalized NCHW map viewed as NHWC, so the model reads it
without a copy.  ``pack_s2d`` is accepted for config compatibility: the
space-to-depth packing it selects is a TPU layout and the port always emits
the plain map.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lednet_tpu_torch.ops.kernels import normalize_image
from lednet_tpu_torch.registry import MODELS

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


@MODELS.register_module()
class SegDataPreProcessor:

    def __init__(self, mean: Sequence[float], std: Sequence[float],
                 bgr_to_rgb: bool = False, out_dtype: Optional[str] = None,
                 size: Optional[Tuple[int, int]] = None, pad_val: float = 0,
                 seg_pad_val: int = 255, pack_s2d: bool = False,
                 type: Optional[str] = None):
        """``size``/``pad_val``/``seg_pad_val`` pad training batches and are
        not read at eval."""
        if out_dtype is not None and out_dtype not in _DTYPES:
            raise ValueError(f'unsupported out_dtype {out_dtype!r}')
        self.out_dtype = _DTYPES[out_dtype or 'float32']
        self.mean = [float(v) for v in mean]
        self.std = [float(v) for v in std]
        self.channel_flip = bgr_to_rgb
        self.size = tuple(size) if size is not None else None
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def __call__(self, inputs: torch.Tensor, seg_label=None,
                 training: bool = False, impl: Optional[str] = None):
        """inputs: (B, H, W, 3) uint8/float NHWC in file (BGR) order;
        seg_label: (B, H, W) labels or a dict of such maps (training).

        Returns (normalized images as (B, H, W, 3), padded labels or None,
        (pad_h, pad_w)): the JAX preprocessor's (images, labels, pad)
        contract.
        """
        if training:
            return self._train(inputs, seg_label)
        if seg_label is not None:
            raise NotImplementedError('eval batches take no labels in the port')
        x = normalize_image(inputs.float().contiguous(), self.mean, self.std,
                            flip=self.channel_flip, out_dtype=self.out_dtype,
                            impl=impl)                     # NCHW
        return x.permute(0, 2, 3, 1), None, (0, 0)

    def _train(self, inputs: torch.Tensor, seg_label):
        x = inputs.float().permute(0, 3, 1, 2)
        if self.channel_flip:
            x = x.flip(1)
        mean = x.new_tensor(self.mean).view(1, 3, 1, 1)
        std = x.new_tensor(self.std).view(1, 3, 1, 1)
        x = ((x - mean) / std).contiguous()
        h, w = x.shape[-2:]
        th, tw = (h, w) if self.size is None else \
            (max(self.size[0], h), max(self.size[1], w))
        pad_h, pad_w = th - h, tw - w
        if pad_h or pad_w:
            pad = (0, pad_w, 0, pad_h)
            x = F.pad(x, pad, value=self.pad_val)
            if isinstance(seg_label, dict):
                seg_label = {k: F.pad(v, pad, value=self.seg_pad_val
                                      if k == 'gt_seg_map' else 0)
                             for k, v in seg_label.items()}
            elif seg_label is not None:
                seg_label = F.pad(seg_label, pad, value=self.seg_pad_val)
        return x.permute(0, 2, 3, 1), seg_label, (pad_h, pad_w)
