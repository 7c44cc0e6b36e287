"""On-device batch preprocessing (eval path), NHWC at the boundary.

Counterpart of ``lednet_tpu/models/data_preprocessor.py`` (``SegDataPreProcessor``
:21, eval path :77-125): cast to float32, BGR->RGB flip, mean/std
normalization and rounding to ``out_dtype`` (the config's ``'bfloat16'``).
The LED configs set no eval pad size, so eval batches are not padded.  On
CUDA the normalization is kernel A
(:func:`lednet_tpu_torch.ops.kernels.normalize_image`); the output is the
normalized NCHW map viewed as NHWC, so the model reads it without a copy.
``pack_s2d`` is accepted for config compatibility: the space-to-depth packing
it selects is a TPU layout and the port always emits the plain map.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

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
        """``size``/``pad_val``/``seg_pad_val`` pad training batches (later
        work) and are not read at eval."""
        if out_dtype is not None and out_dtype not in _DTYPES:
            raise ValueError(f'unsupported out_dtype {out_dtype!r}')
        self.out_dtype = _DTYPES[out_dtype or 'float32']
        self.mean = [float(v) for v in mean]
        self.std = [float(v) for v in std]
        self.channel_flip = bgr_to_rgb

    def __call__(self, inputs: torch.Tensor, seg_label=None,
                 training: bool = False, impl: Optional[str] = None):
        """inputs: (B, H, W, 3) uint8/float NHWC in file (BGR) order.

        Returns (normalized images as (B, H, W, 3), None, (0, 0)): the
        JAX preprocessor's (images, labels, pad) contract.
        """
        if training or seg_label is not None:
            raise NotImplementedError('the port preprocesses eval batches only '
                                      '(training is later work)')
        x = normalize_image(inputs.float().contiguous(), self.mean, self.std,
                            flip=self.channel_flip, out_dtype=self.out_dtype,
                            impl=impl)                     # NCHW
        return x.permute(0, 2, 3, 1), None, (0, 0)
