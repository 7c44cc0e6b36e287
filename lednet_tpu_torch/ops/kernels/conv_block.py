"""Kernel C: the stem's two 32-channel BasicBlocks and trailing ReLU at 1/4
scale, as four launches of one tiled 3x3 conv with fused bias, optional
residual and ReLU (BatchNorm folded):

    h = relu(conv(x) + b0);   b1 = relu(conv(h) + b1 + x)
    h = relu(conv(b1) + b2);  out = relu(conv(h) + b3 + b1)

Replaces ``lednet_tpu/ops/pallas/conv_block.py:73`` (``basic_pair_packed``,
reached through ``basic_pair`` :126); its width packing exists for 128-lane
TPU tiles.  CUDA source: ``lednet_tpu_torch/csrc/conv_block.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lednet_tpu_torch.ops.kernels._build import (check, library, require,
                                                 resolve_impl, stream_ptr)


def basic_pair_plain(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) float32; w (4, C, C, 3, 3) folded weights; b (4, C)."""
    conv = lambda v, i: F.conv2d(v, w[i], b[i], padding=1)
    h = F.relu(conv(x, 0))
    b1 = F.relu(conv(h, 1) + x)
    h = F.relu(conv(b1, 2))
    return F.relu(conv(h, 3) + b1)


def basic_pair(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               impl: Optional[str] = None) -> torch.Tensor:
    """The BasicBlock pair + trailing ReLU on a (B, C, H, W) float32 map."""
    if resolve_impl(impl, x) == 'plain':
        return basic_pair_plain(x, w, b)
    require(x, 'x', torch.float32)
    if x.dim() != 4:
        raise ValueError(f'x must be NCHW, got {tuple(x.shape)}')
    B, C, H, W = x.shape
    require(w, 'w', torch.float32, (4, C, C, 3, 3), x.device)
    require(b, 'b', torch.float32, (4, C), x.device)
    lib = library()
    stream = stream_ptr(x)

    def conv(v, i, res):
        out = torch.empty_like(x)
        check(lib.lednet_conv3x3_c32(
            v.data_ptr(), w[i].data_ptr(), b[i].data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(), B, C, H,
            W, stream), 'basic_pair')
        return out

    h = conv(x, 0, None)
    b1 = conv(h, 1, x)
    h = conv(b1, 2, None)
    out = conv(h, 3, b1)
    basic_pair.launches += 1
    return out


basic_pair.launches = 0
