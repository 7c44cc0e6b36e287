"""Kernel A: input normalization (BGR->RGB flip, ``(x - mean) / std``,
rounding to the output dtype, NHWC -> NCHW).

Replaces ``lednet_tpu/ops/pallas/s2d_input.py:80`` (``normalize_s2d``).  The
4x4 space-to-depth packing of that kernel exists for 128-lane TPU tiles and
is not carried over: the output is the plain normalized NCHW map that the
stem kernel reads.  CUDA source: ``lednet_tpu_torch/csrc/normalize.cu``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from lednet_tpu_torch.ops.kernels._build import (check, library, require,
                                                 resolve_impl, stream_ptr)


def normalize_image_plain(x: torch.Tensor, mean: Sequence[float],
                          std: Sequence[float], flip: bool,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) float32 -> (B, 3, H, W) ``out_dtype``: the channel flip,
    then ``(x - mean) / std`` in float32, then round to nearest even."""
    if flip:
        x = x.flip(-1)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    y = ((x - m) / s).to(out_dtype)
    return y.permute(0, 3, 1, 2).contiguous()


def normalize_image(x: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float], flip: bool = False,
                    out_dtype: torch.dtype = torch.bfloat16,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Normalize a (B, H, W, 3) float32 image into (B, 3, H, W) ``out_dtype``
    (bfloat16 or float32); ``mean``/``std`` are in output-channel order."""
    if resolve_impl(impl, x) == 'plain':
        return normalize_image_plain(x, mean, std, flip, out_dtype)
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f'expected a (B, H, W, 3) image, got {tuple(x.shape)}')
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'out_dtype must be bfloat16 or float32, got {out_dtype}')
    require(x, 'x', torch.float32)
    B, H, W, _ = x.shape
    out = torch.empty((B, 3, H, W), dtype=out_dtype, device=x.device)
    check(library().lednet_normalize_image(
        x.data_ptr(), out.data_ptr(), B, H, W, *[float(v) for v in mean],
        *[float(v) for v in std], int(flip), int(out_dtype == torch.bfloat16),
        stream_ptr(x)), 'normalize_image')
    normalize_image.launches += 1
    return out


normalize_image.launches = 0
