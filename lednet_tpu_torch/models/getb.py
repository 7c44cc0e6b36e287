"""GETB: Global-Efficient Transformer Block (windowed attention), NCHW.

Counterpart of ``lednet_tpu/models/getb.py`` (``_relative_position_index``
:34, ``_reflect_pad`` :46, ``GlobalLocalAttention`` :53, ``ConvMlp`` :119,
``GETBBlock`` :236): pre-norm residual block ``x + attn(bn(x))``, ``x +
mlp(bn(x))``; window attention over reflect-padded ws x ws windows with a
learned relative-position bias, axial average-pool context paths, and a
separable-conv projection.  Plain PyTorch: the JAX package computes it
outside any Pallas kernel too.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import Norm2d
from lednet_tpu_torch.ops.pool import avg_pool2d


def _relative_position_index(ws: int) -> np.ndarray:
    """Static (ws*ws, ws*ws) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Source rows of ``n`` rows reflect-padded by ``pad`` at the end, as
    numpy's 'reflect' gives them also when ``pad >= n`` (the reflection
    repeats with period 2(n-1)); ``F.pad`` refuses such pads."""
    p = np.arange(n + pad)
    if n == 1:
        return np.zeros_like(p)
    q = p % (2 * (n - 1))
    return np.where(q < n, q, 2 * (n - 1) - q)


@functools.lru_cache(maxsize=None)
def _reflect_device_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """:func:`_reflect_index` on ``device``, kept so that a forward after the
    first copies nothing from the host (a CUDA graph cannot capture a copy
    from pageable host memory).  Never evicted: a captured graph reads it at
    every replay.  Made outside inference mode, so that training may use it
    too."""
    with torch.inference_mode(False):
        return torch.from_numpy(_reflect_index(n, pad)).to(device)


def _reflect_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-pad bottom/right of an NCHW tensor."""
    H, W = x.shape[-2:]
    if pad_h < H and pad_w < W:
        return F.pad(x, (0, pad_w, 0, pad_h), mode='reflect') \
            if pad_h or pad_w else x
    for dim, n, pad in ((-2, H, pad_h), (-1, W, pad_w)):
        x = x.index_select(dim, _reflect_device_index(n, pad, x.device))
    return x


class GlobalLocalAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int = 16, window_size: int = 8,
                 qkv_bias: bool = False, relative_pos_embedding: bool = True):
        super().__init__()
        self.num_heads, self.ws = num_heads, window_size
        ws = window_size
        self.qkv = nn.Conv2d(dim, 3 * dim, 1, bias=qkv_bias)
        if relative_pos_embedding:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * ws - 1) ** 2, num_heads))
            self.register_buffer(
                'relative_position_index',
                torch.from_numpy(_relative_position_index(ws).reshape(-1)
                                 .astype(np.int64)), persistent=False)
        else:
            self.relative_position_bias_table = None
        self.proj_dw = nn.Conv2d(dim, dim, ws, padding=(ws - 1) // 2,
                                 groups=dim, bias=False)
        self.proj_norm = Norm2d(dict(type='BN'), dim)
        self.proj_pw = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x):
        B, C, H, W = x.shape
        ws, heads = self.ws, self.num_heads
        hd = C // heads
        local = x
        xp = _reflect_pad(x, (-H) % ws, (-W) % ws)
        Hp, Wp = xp.shape[-2:]
        nh, nw = Hp // ws, Wp // ws

        qkv = self.qkv(xp).view(B, 3, heads, hd, nh, ws, nw, ws)
        qkv = qkv.permute(1, 0, 4, 6, 2, 5, 7, 3).reshape(
            3, B * nh * nw, heads, ws * ws, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        dots = torch.matmul(q, k.transpose(-2, -1)) * hd ** -0.5
        if self.relative_position_bias_table is not None:
            bias = self.relative_position_bias_table[self.relative_position_index]
            dots = dots + bias.view(ws * ws, ws * ws, heads).permute(2, 0, 1)
        out = torch.matmul(dots.softmax(dim=-1), v)    # (B*nh*nw, heads, ws*ws, hd)
        out = out.view(B, nh, nw, heads, ws, ws, hd)
        out = out.permute(0, 3, 6, 1, 4, 2, 5).reshape(B, C, Hp, Wp)
        out = out[:, :, :H, :W]

        ax = avg_pool2d(_reflect_pad(out, 1, 0), (ws, 1), (1, 1), (ws // 2 - 1, 0))
        ay = avg_pool2d(_reflect_pad(out, 0, 1), (1, ws), (1, 1), (0, ws // 2 - 1))
        out = ax + ay + local

        out = self.proj_dw(_reflect_pad(out, 1, 1))
        out = self.proj_pw(self.proj_norm(out))
        return out[:, :, :H, :W]


class ConvMlp(nn.Module):
    """1x1-conv MLP with ReLU6."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden_dim, 1)
        self.fc2 = nn.Conv2d(hidden_dim, dim, 1)

    def forward(self, x):
        return self.fc2(torch.clamp(self.fc1(x), 0, 6))


class GETBBlock(nn.Module):

    def __init__(self, dim: int, num_heads: int = 16, mlp_ratio: float = 4.0,
                 window_size: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.norm1 = Norm2d(dict(type='BN'), dim)
        self.attn = GlobalLocalAttention(dim, num_heads, window_size, qkv_bias)
        self.norm2 = Norm2d(dict(type='BN'), dim)
        self.mlp = ConvMlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))
