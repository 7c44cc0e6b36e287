"""Kernel B: the LED-Net stem convs, each 3x3 / stride 2 / pad 1 with the
eval BatchNorm folded, fused bias and ReLU; returns x1 (1/2 scale, which
``head_x1`` reads) and x2 (1/4 scale).

Replaces ``lednet_tpu/ops/pallas/stem_conv.py:57`` (``stem_convs_packed``),
whose space-to-depth packing exists for the TPU's 128-lane tiles.  CUDA
source: ``lednet_tpu_torch/csrc/stem_conv.cu``, one launch for both convs on
the tensor cores in 3xTF32 (x1 stays on chip for stem_conv2).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lednet_tpu_torch.ops.kernels._build import (check, library, require,
                                                 resolve_impl, stream_ptr)
from lednet_tpu_torch.ops.kernels.conv3x3 import (check_channels, stem_config,
                                                  stem_fragments)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stem_convs_plain(x, w1, b1, w2, b2) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, Cin, H, W) float32 or bfloat16 (promoted to float32);
    w1 (C1, Cin, 3, 3), w2 (C2, C1, 3, 3) folded weights, b1/b2 biases."""
    x1 = F.relu(F.conv2d(x.float(), w1, b1, stride=2, padding=1))
    x2 = F.relu(F.conv2d(x1, w2, b2, stride=2, padding=1))
    return x1, x2


def stem_convs(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               impl: Optional[str] = None,
               frags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both stem convs: ``x1 = relu(conv_s2(x, w1) + b1)``,
    ``x2 = relu(conv_s2(x1, w2) + b2)``, float32 out.

    ``frags``: the kernel's pre-split weights, ``stem_fragments(w1, w2)``
    (computed here when None; the model caches them with its folded
    weights).  The plain version does not read them."""
    if resolve_impl(impl, x) == 'plain':
        return stem_convs_plain(x, w1, b1, w2, b2)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4 \
            or x.shape[1] != 3:
        raise ValueError(f'x must be a float32/bfloat16 (B, 3, H, W) map, got '
                         f'{x.dtype} {tuple(x.shape)}')
    require(x, 'x', x.dtype)
    B, cin, H, W = x.shape
    C = w1.shape[0]
    check_channels(C)
    require(w1, 'w1', torch.float32, (C, cin, 3, 3), x.device)
    require(b1, 'b1', torch.float32, (C,), x.device)
    require(w2, 'w2', torch.float32, (C, C, 3, 3), x.device)
    require(b2, 'b2', torch.float32, (C,), x.device)
    f1, f2 = stem_fragments(w1, w2) if frags is None else frags
    require(f1, 'frags[0]', torch.float32, (4, C // 8, 32, 4), x.device)
    require(f2, 'frags[1]', torch.float32, (C // 8, 9, C // 8, 32, 4), x.device)
    cfg = stem_config(B, C, H, W, x.dtype == torch.bfloat16,
                      _sm_count(x.device))
    H1, W1 = (H + 1) // 2, (W + 1) // 2
    x1 = torch.empty((B, C, H1, W1), dtype=torch.float32, device=x.device)
    x2 = torch.empty((B, C, (H1 + 1) // 2, (W1 + 1) // 2),
                     dtype=torch.float32, device=x.device)
    check(library().lednet_stem_fused(
        x.data_ptr(), f1.data_ptr(), b1.data_ptr(), f2.data_ptr(),
        b2.data_ptr(), x1.data_ptr(), x2.data_ptr(), B, cin, C, H, W,
        int(x.dtype == torch.bfloat16), cfg.th, cfg.tw, cfg.smem,
        cfg.grid[0], stream_ptr(x)), 'stem_convs')
    stem_convs.launches += 1
    return x1, x2


stem_convs.launches = 0
