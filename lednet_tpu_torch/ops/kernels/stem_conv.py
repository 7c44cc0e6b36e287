"""Kernel B: the LED-Net stem convs, each 3x3 / stride 2 / pad 1 with the
eval BatchNorm folded, fused bias and ReLU; returns x1 (1/2 scale, which
``head_x1`` reads) and x2 (1/4 scale).

Replaces ``lednet_tpu/ops/pallas/stem_conv.py:57`` (``stem_convs_packed``),
whose space-to-depth packing exists for the TPU's 128-lane tiles.  CUDA
source: ``lednet_tpu_torch/csrc/stem_conv.cu`` (one launch per conv).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lednet_tpu_torch.ops.kernels._build import (check, library, require,
                                                 resolve_impl, stream_ptr)


def stem_convs_plain(x, w1, b1, w2, b2) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, Cin, H, W) float32 or bfloat16 (promoted to float32);
    w1 (C1, Cin, 3, 3), w2 (C2, C1, 3, 3) folded weights, b1/b2 biases."""
    x1 = F.relu(F.conv2d(x.float(), w1, b1, stride=2, padding=1))
    x2 = F.relu(F.conv2d(x1, w2, b2, stride=2, padding=1))
    return x1, x2


def _conv(lib, x, w, b):
    B, Cin, H, W = x.shape
    Cout = w.shape[0]
    require(w, 'w', torch.float32, (Cout, Cin, 3, 3), x.device)
    require(b, 'bias', torch.float32, (Cout,), x.device)
    out = torch.empty((B, Cout, (H + 1) // 2, (W + 1) // 2),
                      dtype=torch.float32, device=x.device)
    check(lib.lednet_stem_conv3x3_s2(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, Cin, H,
        W, Cout, int(x.dtype == torch.bfloat16), stream_ptr(x)),
        'stem_convs')
    return out


def stem_convs(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both stem convs: ``x1 = relu(conv_s2(x, w1) + b1)``,
    ``x2 = relu(conv_s2(x1, w2) + b2)``, float32 out."""
    if resolve_impl(impl, x) == 'plain':
        return stem_convs_plain(x, w1, b1, w2, b2)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f'x must be a float32/bfloat16 NCHW map, got '
                         f'{x.dtype} {tuple(x.shape)}')
    require(x, 'x', x.dtype)
    lib = library()
    x1 = _conv(lib, x, w1, b1)
    x2 = _conv(lib, x1, w2, b2)
    stem_convs.launches += 1
    return x1, x2


stem_convs.launches = 0
