"""Image resizing with torch ``F.interpolate`` conventions, NCHW.

Counterpart of ``lednet_tpu/ops/resize.py``.  The JAX package reimplements
torch's coordinate math; here torch computes it natively:

- bilinear, ``align_corners=False``: half-pixel centres with the source
  coordinate clamped at 0 (``lednet_tpu/ops/resize.py:40-44``), which is what
  ``F.interpolate(mode='bilinear', align_corners=False)`` does;
- nearest: the legacy asymmetric ``src = floor(dst * in/out)`` with the ratio
  taken in float32, gathered with the same numpy indices as the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Sequence[int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size=(H, W)``."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode='bilinear',
                         align_corners=align_corners)


def _nearest_coords(out_size: int, in_size: int) -> np.ndarray:
    ratio = in_size / out_size
    src = np.floor(np.arange(out_size, dtype=np.float32) * ratio)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor (legacy rounding)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    out_h, out_w = int(size[0]), int(size[1])
    if in_h != out_h:
        idx = torch.from_numpy(_nearest_coords(out_h, in_h)).to(x.device)
        x = x.index_select(-2, idx)
    if in_w != out_w:
        idx = torch.from_numpy(_nearest_coords(out_w, in_w)).to(x.device)
        x = x.index_select(-1, idx)
    return x
