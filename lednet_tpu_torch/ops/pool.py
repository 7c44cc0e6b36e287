"""Pooling with torch semantics, NCHW.

Counterpart of ``lednet_tpu/ops/pool.py``: average pooling with
``count_include_pad=True`` (the torch default the JAX package reproduces),
max pooling with ``-inf`` padding, and adaptive average pooling with torch's
floor/ceil bin edges.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

_Size = Union[int, Tuple[int, int]]


def avg_pool2d(x: torch.Tensor, kernel_size: _Size, stride: _Size = None,
               padding: _Size = 0) -> torch.Tensor:
    """Zero-padded average pooling; the divisor counts padded cells."""
    return F.avg_pool2d(x, kernel_size, stride, padding,
                        count_include_pad=True)


def max_pool2d(x: torch.Tensor, kernel_size: _Size, stride: _Size = None,
               padding: _Size = 0) -> torch.Tensor:
    """Max pooling; padded cells are ``-inf`` (never the maximum), as the
    JAX package's ``reduce_window`` with a ``-inf`` init value."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: _Size) -> torch.Tensor:
    """torch AdaptiveAvgPool2d: bin i spans [floor(i*N/out), ceil((i+1)*N/out))."""
    return F.adaptive_avg_pool2d(x, output_size)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)) keeping the spatial dims."""
    return x.mean(dim=(-2, -1), keepdim=True)
