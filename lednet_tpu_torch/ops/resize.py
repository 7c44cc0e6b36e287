"""Image resizing with torch ``F.interpolate`` conventions, NCHW.

Counterpart of ``lednet_tpu/ops/resize.py``.  The JAX package reimplements
torch's coordinate math; here torch computes it natively:

- bilinear, ``align_corners=False``: half-pixel centres with the source
  coordinate clamped at 0 (``lednet_tpu/ops/resize.py:40-44``), which is what
  ``F.interpolate(mode='bilinear', align_corners=False)`` does.  Given a
  ``scale_factor`` instead of a size (``lednet_tpu/ops/resize.py:59-68``),
  the output is ``int(in * f)`` and the source coordinate is mapped by the
  factor, ``(dst + 0.5) / f - 0.5``, not by the size ratio: the two differ
  at odd sizes (7 -> 3 at 0.5).  ``F.interpolate(scale_factor=f)`` does the
  same.  PyTorch's
  CUDA kernel for a channels-first map runs one thread per output pixel,
  each looping over every (image, channel) pair: on a batch of many small
  maps (slide inference's stacked crops: 196 x 1024 channels at 8x8) that
  is a few hundred threads for the whole card, 120 ms of UNet's 167 ms
  slide forward.  There a CUDA map is resized channels-last (one thread
  per output element) and copied back to channels-first;
- nearest: the legacy asymmetric ``src = floor(dst * in/out)`` with the ratio
  taken in float32, gathered with the same numpy indices as the JAX package.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Sequence[int] = None,
                    align_corners: bool = False,
                    scale_factor: float = None) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size=(H, W)``, or by
    ``scale_factor`` (output ``int(in * f)``, coordinates mapped by ``f``)."""
    if size is None:
        size = (int(x.shape[-2] * scale_factor), int(x.shape[-1] * scale_factor))
        geometry = dict(scale_factor=scale_factor)
    else:
        size = (int(size[0]), int(size[1]))
        geometry = dict(size=size)
    if tuple(x.shape[-2:]) == size:
        return x
    if x.is_cuda and size[0] * size[1] < x.shape[0] * x.shape[1]:
        # fewer output pixels than (image, channel) pairs: channels-last
        x = x.contiguous(memory_format=torch.channels_last)
        return F.interpolate(x, mode='bilinear', align_corners=align_corners,
                             **geometry).contiguous()
    return F.interpolate(x, mode='bilinear', align_corners=align_corners,
                         **geometry)


def _nearest_coords(out_size: int, in_size: int) -> np.ndarray:
    ratio = in_size / out_size
    src = np.floor(np.arange(out_size, dtype=np.float32) * ratio)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


@functools.lru_cache(maxsize=None)
def _nearest_index(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    """:func:`_nearest_coords` on ``device``, kept so that a forward after
    the first copies nothing from the host (a CUDA graph cannot capture a
    copy from pageable host memory).  Never evicted: a captured graph reads
    it at every replay.  Made outside inference mode, so that training may
    use it too."""
    with torch.inference_mode(False):
        return torch.from_numpy(_nearest_coords(out_size, in_size)).to(device)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor (legacy rounding)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    out_h, out_w = int(size[0]), int(size[1])
    if in_h != out_h:
        x = x.index_select(-2, _nearest_index(out_h, in_h, x.device))
    if in_w != out_w:
        x = x.index_select(-1, _nearest_index(out_w, in_w, x.device))
    return x
