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

Two calls of the JAX package's SAN head use ``jax.image.resize`` itself,
whose conventions are neither torch's nor the above, and the port
reproduces them:

- :func:`resize_jax_bicubic` (``san_head.py:138-141``, the side adapter's
  position embedding): the Keys cubic kernel with A = -0.5 on half-pixel
  centres, widened by in / out when downsampling (anti-aliased), each
  output's weights normalised to sum 1 and zero where its centre falls
  outside the input, as ``jax.image.scale_and_translate`` computes its
  (in, out) weight matrix; the matrix is built in numpy in float32 once per
  size pair and device, and applied as two matmuls;
- :func:`resize_jax_nearest` (``san_head.py:329-334``, the loss's label
  masks): ``src = floor((dst + 0.5) * in / out)`` in float32, not the
  legacy rounding of :func:`resize_nearest`.
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


def resize_by_mode(x: torch.Tensor, size: Sequence[int], mode: str) -> torch.Tensor:
    """The JAX package's ``resize`` of an NCHW map to ``size`` by ``mode``
    (``lednet_tpu/ops/resize.py:218``, ``align_corners=False``): bilinear,
    bicubic (``F.interpolate``, which the JAX package's torch-parity
    bicubic reproduces) or nearest by the legacy rounding (the ViT's
    position embeddings, FPN's top-down path)."""
    if mode == 'bilinear':
        return resize_bilinear(x, size, False)
    if mode == 'bicubic':
        return F.interpolate(x, size=tuple(size), mode='bicubic',
                             align_corners=False)
    if mode == 'nearest':
        return resize_nearest(x, size)
    raise ValueError(f'Unsupported resize mode: {mode}')


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel (A = -0.5) of |distance| ``x``, float32."""
    one, two = np.float32(1.0), np.float32(2.0)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    out = np.where(x >= one, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + two, out)
    return np.where(x >= two, np.float32(0.0), out).astype(np.float32)


def jax_cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (in, out) float32 weight matrix of an anti-aliased cubic resize
    from ``in_size`` to ``out_size`` samples, as ``jax.image.resize(...,
    'bicubic')`` builds it (``compute_weight_mat`` of
    ``jax.image.scale_and_translate``, scale out / in, no translation)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(0, keepdims=True, dtype=np.float32)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cubic_matrix(in_size: int, out_size: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """:func:`jax_cubic_weights` on ``device``, transposed to (out, in);
    kept for the reasons :func:`_nearest_index` gives."""
    with torch.inference_mode(False):
        w = torch.from_numpy(np.ascontiguousarray(
            jax_cubic_weights(in_size, out_size).T))
        return w.to(device=device, dtype=dtype)


def resize_jax_bicubic(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Anti-aliased Keys-cubic resize of an NCHW tensor to ``size``, as
    ``jax.image.resize(..., 'bicubic')`` resizes the same map NHWC."""
    (in_h, in_w), (out_h, out_w) = x.shape[-2:], (int(size[0]), int(size[1]))
    if in_h != out_h:
        x = torch.matmul(_cubic_matrix(in_h, out_h, x.device, x.dtype), x)
    if in_w != out_w:
        x = torch.matmul(x, _cubic_matrix(in_w, out_w, x.device, x.dtype).T)
    return x


def jax_nearest_coords(out_size: int, in_size: int) -> np.ndarray:
    """``floor((dst + 0.5) * in / out)`` in float32, as
    ``jax.image.resize(..., 'nearest')`` picks its sources."""
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(src).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_nearest_index(out_size: int, in_size: int,
                       device: torch.device) -> torch.Tensor:
    """:func:`jax_nearest_coords` on ``device``, kept as
    :func:`_nearest_index` is."""
    with torch.inference_mode(False):
        return torch.from_numpy(jax_nearest_coords(out_size, in_size)).to(device)


def resize_jax_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of the last two axes of ``x`` to ``size``
    by :func:`jax_nearest_coords` (any dtype: labels too)."""
    (in_h, in_w), (out_h, out_w) = x.shape[-2:], (int(size[0]), int(size[1]))
    if in_h != out_h:
        x = x.index_select(-2, _jax_nearest_index(out_h, in_h, x.device))
    if in_w != out_w:
        x = x.index_select(-1, _jax_nearest_index(out_w, in_w, x.device))
    return x
