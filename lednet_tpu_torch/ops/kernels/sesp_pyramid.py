"""Kernel D: one eval-mode SESP block, as three CUDA launches (reduce;
pyramid + HFF; v2 + BN/PReLU + expand + tail).

Replaces ``lednet_tpu/ops/pallas/sesp_pyramid.py:207`` (``sesp_block``).
Unlike that kernel's VMEM gate (``pyramid_fits`` :285) this one also takes
stride-2 blocks wider than 128 channels (LED-Net's context3 down-sampler).
CUDA source: ``lednet_tpu_torch/csrc/sesp_block.cu``.

:func:`bn_fold` and :func:`dense_grouped` are the host-side helpers that turn
a SESP module's parameters into this kernel's operands
(``sesp_pyramid.py:279`` and :265).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lednet_tpu_torch.ops.kernels._build import (check, library, require,
                                                 resolve_impl, stream_ptr)

TAILS = {'plain': 0, 'act': 1, 'residual': 2}


def bn_fold(scale, bias, mean, var, eps: float = 1e-5):
    """Eval-mode BatchNorm as per-channel (scale, bias)."""
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def dense_grouped(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """A grouped 1x1 conv weight (Co, Ci/g, 1, 1) as a dense block-diagonal
    (Co, Ci) matrix (zeros off the group blocks)."""
    w2 = weight[:, :, 0, 0]
    co, ci_g = w2.shape
    co_g = co // groups
    dense = w2.new_zeros((co, ci_g * groups))
    for g in range(groups):
        dense[g * co_g:(g + 1) * co_g, g * ci_g:(g + 1) * ci_g] = \
            w2[g * co_g:(g + 1) * co_g]
    return dense


def _prelu(x, a):
    return torch.where(x >= 0, x, a.view(1, -1, 1, 1) * x)


def sesp_block_plain(x, wred, bred, a1, dw1, dw2, s2, b2, a2, wexp, bexp, a3,
                     rates: Sequence[int], stride: int = 1,
                     tail: str = 'residual') -> torch.Tensor:
    """The block's function on NCHW float32 operands.

    wred (n, Cin) dense reduce weight, BN folded; bred/a1 (n,).
    dw1/dw2 (k, n, 3, 3) depthwise branch kernels (dw2 may be None).
    s2/b2/a2 (k*n,) BN scale/bias and PReLU alpha after the concat.
    wexp (C, C) dense expand weight (out, in), BN folded; bexp/a3 (C,).
    """
    k, n = dw1.shape[0], dw1.shape[1]
    red = _prelu(torch.einsum('oi,bihw->bohw', wred, x)
                 + bred.view(1, -1, 1, 1), a1)
    branches = []
    for g, d in enumerate(rates):
        br = F.conv2d(red, dw1[g].unsqueeze(1), stride=stride, padding=d,
                      dilation=d, groups=n)
        branches.append(br + branches[-1] if branches else br)
    if dw2 is not None:
        branches = [F.conv2d(br, dw2[g].unsqueeze(1), padding=d + 1,
                             dilation=d + 1, groups=n)
                    for g, (br, d) in enumerate(zip(branches, rates))]
    y = _prelu(torch.cat(branches, 1) * s2.view(1, -1, 1, 1)
               + b2.view(1, -1, 1, 1), a2)
    z = torch.einsum('oi,bihw->bohw', wexp, y) + bexp.view(1, -1, 1, 1)
    if tail == 'residual':
        return _prelu(z + x, a3)
    if tail == 'act':
        return _prelu(z, a3)
    return z


def sesp_block(x, wred, bred, a1, dw1, dw2, s2, b2, a2, wexp, bexp, a3,
               rates: Sequence[int], stride: int = 1, tail: str = 'residual',
               impl: Optional[str] = None) -> torch.Tensor:
    """One eval SESP block on a (B, Cin, H, W) float32 map -> (B, k*n,
    ceil(H/stride), ceil(W/stride)).  Operands as in :func:`sesp_block_plain`."""
    if resolve_impl(impl, x) == 'plain':
        return sesp_block_plain(x, wred, bred, a1, dw1, dw2, s2, b2, a2, wexp,
                                bexp, a3, rates, stride, tail)
    if tail not in TAILS:
        raise ValueError(f'tail must be one of {sorted(TAILS)}, got {tail!r}')
    if stride not in (1, 2):
        raise ValueError(f'stride must be 1 or 2, got {stride}')
    require(x, 'x', torch.float32)
    if x.dim() != 4:
        raise ValueError(f'x must be NCHW, got {tuple(x.shape)}')
    B, Cin, H, W = x.shape
    k, n = dw1.shape[0], dw1.shape[1]
    C = k * n
    if len(rates) != k or not 1 <= k <= 4:
        raise ValueError(f'need 1 to 4 branches with one rate each, got k={k}, '
                         f'rates={tuple(rates)}')
    if tail == 'residual' and (stride != 1 or Cin != C):
        raise ValueError('the residual tail needs stride 1 and Cin == k*n')
    dev = x.device
    f32 = torch.float32
    require(wred, 'wred', f32, (n, Cin), dev)
    for name, t, size in (('bred', bred, n), ('a1', a1, n), ('s2', s2, C),
                          ('b2', b2, C), ('a2', a2, C), ('bexp', bexp, C),
                          ('a3', a3, C)):
        require(t, name, f32, (size,), dev)
    require(dw1, 'dw1', f32, (k, n, 3, 3), dev)
    if dw2 is not None:
        require(dw2, 'dw2', f32, (k, n, 3, 3), dev)
    require(wexp, 'wexp', f32, (C, C), dev)
    r = list(rates) + [1] * (4 - k)
    H2, W2 = -(-H // stride), -(-W // stride)
    lib = library()
    stream = stream_ptr(x)
    red = torch.empty((B, n, H, W), dtype=f32, device=dev)
    check(lib.lednet_sesp_reduce(
        x.data_ptr(), wred.data_ptr(), bred.data_ptr(), a1.data_ptr(),
        red.data_ptr(), B, Cin, H * W, n, stream), 'sesp_block/reduce')
    pyr = torch.empty((B, C, H2, W2), dtype=f32, device=dev)
    check(lib.lednet_sesp_pyramid(
        red.data_ptr(), dw1.data_ptr(), pyr.data_ptr(), B, n, H, W, k, *r,
        stride, stream), 'sesp_block/pyramid')
    out = torch.empty((B, C, H2, W2), dtype=f32, device=dev)
    check(lib.lednet_sesp_merge(
        pyr.data_ptr(), None if dw2 is None else dw2.data_ptr(),
        s2.data_ptr(), b2.data_ptr(), a2.data_ptr(), wexp.data_ptr(),
        bexp.data_ptr(), a3.data_ptr(),
        x.data_ptr() if tail == 'residual' else None, out.data_ptr(), B, C,
        H2, W2, k, *r, TAILS[tail], stream), 'sesp_block/merge')
    sesp_block.launches += 1
    return out


sesp_block.launches = 0
