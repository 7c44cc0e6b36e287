"""ESPNet-family blocks of LED-Net: SESP, the down-sampler and CESPB stages.

Counterpart of ``lednet_tpu/models/espnet.py`` (NCHW here):

- SESP: REDUCE (grouped 1x1 to out/k) -> k depthwise 3x3 branches at the
  dilation schedule with hierarchical feature fusion (branch_i +=
  branch_{i-1}) -> a second depthwise stage at dilation d+1 (SESPV2)
  -> BN + PReLU on the concat -> grouped 1x1 expand + BN -> residual/PReLU
  tail; a stride-2 context block adds an avg-pooled input shortcut.
- In eval mode on CUDA a block runs as kernel D
  (:func:`lednet_tpu_torch.ops.kernels.sesp_block`) with its BatchNorms
  folded; the folded operands are cached on the block until a parameter or
  running stat changes.  ``impl='plain'`` and training run the module form.

The ``tiny_dense`` and ``fuse_branches`` reparameterizations of the JAX
package are TPU layout choices and are not carried over.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import (Norm2d, PReLU, cached_operands,
                                           fold_bn, module_tensors)
from lednet_tpu_torch.ops.kernels._build import resolve_impl
from lednet_tpu_torch.ops.kernels.sesp_pyramid import dense_grouped, sesp_block
from lednet_tpu_torch.ops.pool import avg_pool2d


class _CBR(nn.Module):
    """conv + BN + PReLU (ESPNet's CBR brick)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, dilation: int = 1):
        super().__init__()
        pad = (kernel_size // 2) * dilation
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              pad, dilation, groups, bias=False)
        self.norm = Norm2d(dict(type='BN'), out_channels)
        self.act = PReLU(out_channels)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class _CB(nn.Module):
    """conv + BN (no activation)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              kernel_size // 2, groups=groups, bias=False)
        self.norm = Norm2d(dict(type='BN'), out_channels)

    def forward(self, x):
        return self.norm(self.conv(x))


def _dilation_schedule(k: int, spatial: bool, r_lim: int) -> Tuple[int, ...]:
    """Per-branch dilation rates (``lednet_tpu/models/espnet.py:76``)."""
    if spatial:
        return tuple(1 for _ in range(k))
    rates = []
    for i in range(k):
        ksize = 3 + 2 * i
        ksize = ksize if ksize <= r_lim else 3
        rates.append((ksize - 1) // 2)
    return tuple(sorted(rates))


class SESP(nn.Module):
    """SESP block (LED-Net's core primitive)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 k: int = 4, r_lim: int = 7, down_method: str = 'esp',
                 spatial: bool = True):
        super().__init__()
        n = out_channels // k
        if n * k != out_channels:
            raise ValueError(f'out_channels {out_channels} must divide k={k}')
        self.in_channels, self.out_channels = in_channels, out_channels
        self.stride, self.k, self.n = stride, k, n
        self.rates = _dilation_schedule(k, spatial, r_lim)
        self.proj_1x1 = _CBR(in_channels, n, 1, groups=k)
        for name in ('spp_dw', 'spp_dw_v2_'):     # branch and v2 kernels
            for i in range(k):
                self.register_parameter(f'{name}{i}',
                                        nn.Parameter(torch.zeros(n, 1, 3, 3)))
        self.br_after_cat_norm = Norm2d(dict(type='BN'), out_channels)
        self.br_after_cat_act = PReLU(out_channels)
        self.conv_1x1_exp = _CB(out_channels, out_channels, 1, groups=k)
        # the module form returns before its final PReLU for stride-2
        # down-sampling blocks ('avg' method, or a context block with the
        # avg-pooled shortcut)
        self.avg_shortcut = stride == 2 and not spatial and down_method != 'avg'
        if stride == 2 and (down_method == 'avg' or not spatial):
            self.module_act = None
        else:
            self.module_act = PReLU(out_channels)

    def _dw(self, name: str, i: int) -> torch.Tensor:
        return getattr(self, f'{name}{i}')

    def forward(self, x, impl: Optional[str] = None):
        if self.training or resolve_impl(impl, x) == 'plain':
            return self.module_forward(x)
        return self.kernel_forward(x, 'cuda')

    def module_forward(self, x):
        reduced = self.proj_1x1(x)
        branches = []
        for i, d in enumerate(self.rates):
            b = F.conv2d(reduced, self._dw('spp_dw', i), stride=self.stride,
                         padding=d, dilation=d, groups=self.n)
            branches.append(b + branches[-1] if branches else b)
        branches = [F.conv2d(b, self._dw('spp_dw_v2_', i), padding=d + 1,
                             dilation=d + 1, groups=self.n)
                    for i, (b, d) in enumerate(zip(branches, self.rates))]
        merged = self.br_after_cat_act(self.br_after_cat_norm(
            torch.cat(branches, 1)))
        expanded = self.conv_1x1_exp(merged)
        if self.avg_shortcut:
            return expanded + avg_pool2d(x, 3, 2, 1)
        if self.module_act is None:
            return expanded
        if expanded.shape == x.shape:
            expanded = expanded + x
        return self.module_act(expanded)

    def kernel_forward(self, x, impl: Optional[str] = None):
        """Eval path through kernel D with the BatchNorms folded (the plain
        version of the kernel with ``impl='plain'``)."""
        if self.module_act is None:
            tail = 'plain'
        elif self.stride == 1 and self.in_channels == self.out_channels:
            tail = 'residual'
        else:
            tail = 'act'
        operands = cached_operands(self, module_tensors(self),
                                   self._fold_operands)
        out = sesp_block(x, *operands, rates=self.rates, stride=self.stride,
                         tail=tail, impl=impl)
        if self.avg_shortcut:
            out = out + avg_pool2d(x, 3, 2, 1)
        return out

    def _fold_operands(self):
        """Kernel D's operands: (wred, bred, a1, dw1, dw2, s2, b2, a2, wexp,
        bexp, a3)."""
        s1, b1 = fold_bn(self.proj_1x1.norm.bn)
        wred = dense_grouped(self.proj_1x1.conv.weight, self.k) * s1[:, None]
        s2, b2 = fold_bn(self.br_after_cat_norm.bn)
        s3, b3 = fold_bn(self.conv_1x1_exp.norm.bn)
        wexp = dense_grouped(self.conv_1x1_exp.conv.weight, self.k) * s3[:, None]
        a3 = (torch.zeros_like(b3) if self.module_act is None
              else self.module_act.alpha)
        dw1 = torch.stack([self._dw('spp_dw', i)[:, 0] for i in range(self.k)])
        dw2 = torch.stack([self._dw('spp_dw_v2_', i)[:, 0] for i in range(self.k)])
        return (wred, b1, self.proj_1x1.act.alpha, dw1, dw2, s2, b2,
                self.br_after_cat_act.alpha, wexp, b3, a3)


class ESPDownSampler(nn.Module):
    """concat[avg-pool(x), SESP(x, stride 2, 'avg')] + PReLU."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 4,
                 r_lim: int = 9, spatial: bool = False):
        super().__init__()
        if out_channels <= in_channels:
            raise ValueError('DownSampler expects out > in channels')
        self.eesp = SESP(in_channels, out_channels - in_channels, stride=2, k=k,
                         r_lim=r_lim, down_method='avg', spatial=spatial)
        self.act = PReLU(out_channels)

    def forward(self, x, impl: Optional[str] = None):
        out = torch.cat([avg_pool2d(x, 3, 2, 1), self.eesp(x, impl)], 1)
        return self.act(out)


class CESPB(nn.Module):
    """Cascaded ESP block: one (down-sampling) SESP stage + refinements."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 num_blocks: int = 1, k: int = 4, spatial: bool = True):
        super().__init__()
        if stride == 2:
            self.down = ESPDownSampler(in_channels, out_channels, k=k,
                                       spatial=spatial)
        else:
            self.block0 = SESP(in_channels, out_channels, k=k, spatial=spatial)
        for i in range(1, num_blocks):
            setattr(self, f'block{i}',
                    SESP(out_channels, out_channels, k=k, spatial=spatial))
        self.stride, self.num_blocks = stride, num_blocks

    def forward(self, x, impl: Optional[str] = None):
        x = self.down(x, impl) if self.stride == 2 else self.block0(x, impl)
        for i in range(1, self.num_blocks):
            x = getattr(self, f'block{i}')(x, impl)
        return x
