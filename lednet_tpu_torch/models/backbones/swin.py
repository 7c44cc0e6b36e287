"""Swin Transformer backbone, NCHW in and out.

Counterpart of ``SwinTransformer`` in ``lednet_tpu/models/backbones/vit.py``
(:170-236, its block ``_block`` :238-302).  Inside, the tokens lie (B, H,
W, C), the JAX package's layout; the modules are flat, as flax names them:

- ``patch_embed``: a ``patch_size`` conv at stride ``patch_size`` with
  flax's default 'SAME' padding, ``total = max((ceil(n / p) - 1) * p + p -
  n, 0)`` per axis, ``total // 2`` before and the rest after (at a width of
  683 that is (0, 1), at 682 (1, 1), at 681 (1, 2)); then ``patch_norm``;
- stage s: ``depths[s]`` blocks ``s{s}_b{b}``, every second shifted by
  ``window_size // 2``; ``out_norm{s}`` of the stage's tokens is its
  output; between stages, patch merging: odd sizes padded at the bottom
  and right, each 2x2 neighbourhood concatenated in the JAX package's
  reshape order (channel ``(dw * 2 + dh) * C + c``), ``merge_norm{s}``,
  and ``merge{s}``, a bias-free Dense to 2C;
- a block: ``norm1``; the map padded at the bottom and right to window
  multiples FIRST, then rolled by ``-shift``; ``qkv`` (a Dense to 3C,
  queries first, heads head-major); attention within each ws x ws window
  at scale ``head_dim ** -0.5`` plus the relative-position bias gathered
  from ``rel_bias`` ((2 ws - 1)^2, heads) through GETB's
  ``_relative_position_index``; on shifted blocks -100 between tokens of
  different regions of the padded grid (the three-slice ``img_mask``); a
  float32 softmax; the windows put back, rolled by ``+shift``, cropped to
  (H, W); ``proj``; a residual with stochastic depth; ``norm2``, ``fc1``,
  exact GELU, ``fc2``, a residual with stochastic depth;
- every LayerNorm is flax's default, eps 1e-6.

The relative-position index and the shift masks are device constants,
made once per (window, grid, device) outside inference mode and never
evicted, so that a CUDA graph's forward copies nothing from the host.

``pretrain_img_size``, ``strides``, ``act_cfg``, ``norm_cfg``,
``pretrained``, ``init_cfg`` and ``with_cp`` are accepted and unused, as
in the JAX package; ``qk_scale``, ``use_abs_pos_embed``,
``frozen_stages`` and a nonzero ``drop_rate`` or ``attn_drop_rate``,
which it ignores, raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.backbones.mit import LN_EPS
from lednet_tpu_torch.models.getb import _relative_position_index
from lednet_tpu_torch.models.layers import DropPath, drop_path_rates
from lednet_tpu_torch.registry import MODELS


def same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """flax / TF 'SAME' padding of one axis of ``n``: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


@functools.lru_cache(maxsize=None)
def _rel_index(ws: int, device: torch.device) -> torch.Tensor:
    """The (ws*ws * ws*ws,) relative-position index on ``device``; kept and
    never evicted (a captured graph reads it at every replay)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_relative_position_index(ws).reshape(-1)).to(device)


def shift_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) -100 between tokens of a window that come from different
    regions of the rolled (Hp, Wp) grid, 0 elsewhere."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, ws * ws)
    return (wins[:, None, :] != wins[:, :, None]) * -100.0


@functools.lru_cache(maxsize=None)
def _shift_mask(Hp: int, Wp: int, ws: int, shift: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """:func:`shift_mask` on ``device``, kept like :func:`_rel_index`."""
    with torch.inference_mode(False):
        return torch.from_numpy(shift_mask(Hp, Wp, ws, shift)).to(device, dtype)


@MODELS.register_module()
class SwinTransformer(nn.Module):

    def __init__(self, pretrain_img_size: int = 224, in_channels: int = 3,
                 embed_dims: int = 96, patch_size: int = 4,
                 window_size: int = 7, mlp_ratio: int = 4,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 patch_norm: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 use_abs_pos_embed: bool = False,
                 act_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 pretrained: Optional[str] = None, frozen_stages: int = -1,
                 init_cfg: Optional[Dict] = None, with_cp: bool = False):
        super().__init__()
        for name, unported in (('qk_scale', qk_scale is not None),
                               ('use_abs_pos_embed', use_abs_pos_embed),
                               ('frozen_stages', frozen_stages != -1),
                               ('drop_rate', drop_rate),
                               ('attn_drop_rate', attn_drop_rate)):
            if unported:
                raise NotImplementedError(f'SwinTransformer {name} is not '
                                          'ported (the JAX package ignores it)')
        self.patch_size = patch_size
        self.window_size = window_size
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.out_indices = tuple(out_indices)
        self.patch_embed = nn.Conv2d(in_channels, embed_dims, patch_size,
                                     patch_size)
        self.patch_embed.lecun_init = True     # flax's default initialiser
        self.patch_norm = (nn.LayerNorm(embed_dims, eps=LN_EPS) if patch_norm
                           else None)
        # init_weights: the bias tables as the JAX package draws them
        self.raw_init = {}
        rates = iter(drop_path_rates(drop_path_rate, self.depths))
        self.drop_paths = nn.ModuleList()
        dim, table = embed_dims, (2 * window_size - 1) ** 2
        for s, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            for b in range(depth):
                pre = f's{s}_b{b}_'
                self.add_module(pre + 'norm1', nn.LayerNorm(dim, eps=LN_EPS))
                self.add_module(pre + 'qkv', nn.Linear(dim, 3 * dim,
                                                       bias=qkv_bias))
                self.register_parameter(pre + 'rel_bias', nn.Parameter(
                    torch.zeros(table, heads)))
                self.raw_init[pre + 'rel_bias'] = ('truncated_normal', 0.02)
                self.add_module(pre + 'proj', nn.Linear(dim, dim))
                self.add_module(pre + 'norm2', nn.LayerNorm(dim, eps=LN_EPS))
                self.add_module(pre + 'fc1', nn.Linear(dim, dim * mlp_ratio))
                self.add_module(pre + 'fc2', nn.Linear(dim * mlp_ratio, dim))
                self.drop_paths.append(DropPath(next(rates)))
            self.add_module(f'out_norm{s}', nn.LayerNorm(dim, eps=LN_EPS))
            if s < len(self.depths) - 1:
                self.add_module(f'merge_norm{s}', nn.LayerNorm(4 * dim,
                                                               eps=LN_EPS))
                self.add_module(f'merge{s}', nn.Linear(4 * dim, 2 * dim,
                                                       bias=False))
                dim *= 2

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, H / p, W / p, embed_dims) tokens, padded as
        flax's 'SAME' pads."""
        p = self.patch_size
        (top, bottom), (left, right) = (same_pad(n, p, p) for n in x.shape[-2:])
        x = F.pad(x, (left, right, top, bottom))
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        return self.patch_norm(x) if self.patch_norm is not None else x

    def attention(self, pre: str, h: torch.Tensor, heads: int,
                  shift: int) -> torch.Tensor:
        """Windowed attention of the normed, padded, rolled (B, Hp, Wp, C)
        tokens, the windows put back: (B, Hp, Wp, C)."""
        B, Hp, Wp, C = h.shape
        ws, d = self.window_size, C // heads
        nh, nw, n = Hp // ws, Wp // ws, ws * ws
        qkv = getattr(self, pre + 'qkv')(h)
        qkv = qkv.reshape(B, nh, ws, nw, ws, 3, heads, d)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nh * nw, heads,
                                                          n, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
        acc = torch.promote_types(h.dtype, torch.float32)
        attn = torch.matmul(q.to(acc), k.to(acc).transpose(-2, -1)) * d ** -0.5
        table = getattr(self, pre + 'rel_bias')
        bias = table[_rel_index(ws, table.device)].reshape(n, n, heads)
        attn = attn + bias.permute(2, 0, 1).to(acc).unsqueeze(0)
        if shift:
            mask = _shift_mask(Hp, Wp, ws, shift, acc, attn.device)
            attn = (attn.reshape(B, nh * nw, heads, n, n)
                    + mask[None, :, None]).reshape(B * nh * nw, heads, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).reshape(B, nh, nw, heads, ws, ws, d)
        return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, C)

    def block(self, pre: str, x: torch.Tensor, heads: int, shift: int,
              drop: nn.Module) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = self.window_size
        h = getattr(self, pre + 'norm1')(x)
        pad_h, pad_w = (-H) % ws, (-W) % ws
        if pad_h or pad_w:
            h = F.pad(h, (0, 0, 0, pad_w, 0, pad_h))
        if shift:
            h = torch.roll(h, (-shift, -shift), (1, 2))
        out = self.attention(pre, h, heads, shift)
        if shift:
            out = torch.roll(out, (shift, shift), (1, 2))
        out = out[:, :H, :W]
        x = x + drop(getattr(self, pre + 'proj')(out))
        m = getattr(self, pre + 'fc1')(getattr(self, pre + 'norm2')(x))
        m = getattr(self, pre + 'fc2')(F.gelu(m))
        return x + drop(m)

    def merge(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Patch merging: (B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C)."""
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = H + H % 2, W + W % 2
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        return getattr(self, f'merge{s}')(getattr(self, f'merge_norm{s}')(x))

    def forward(self, x: torch.Tensor, impl: Optional[str] = None):
        """(B, C, H, W) -> the ``out_indices`` stages' (B, C_s, H_s, W_s)
        maps.  ``impl`` means nothing here: no port kernel runs in Swin."""
        x = self.embed(x.to(self.patch_embed.weight.dtype))
        outs, block = [], 0
        for s, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            for b in range(depth):
                shift = self.window_size // 2 if b % 2 == 1 else 0
                x = self.block(f's{s}_b{b}_', x, heads, shift,
                               self.drop_paths[block])
                block += 1
            outs.append(getattr(self, f'out_norm{s}')(x).permute(0, 3, 1, 2))
            if s < len(self.depths) - 1:
                x = self.merge(s, x)
        return tuple(outs[i] for i in self.out_indices)
