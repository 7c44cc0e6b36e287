"""Vision Transformer backbone, NCHW in and out.

Counterpart of ``lednet_tpu/models/backbones/vit.py`` (``_MHSA`` :21,
``VisionTransformer`` :49, the ``VIT`` alias :170):

- ``patch_embed``: the input padded at the bottom and right to a multiple
  of the patch (mmcv's ``'corner'`` padding, :96-99), then a conv of
  kernel = stride = ``patch_size`` (no bias unless ``patch_bias``);
- ``pos_embed`` (1, 1 + (img_size / patch)^2, C) always carries the cls
  slot; its grid part is resized by ``interpolate_mode`` (bicubic or
  bilinear as ``F.interpolate`` with ``align_corners=False``, which the JAX
  package's torch-parity resize reproduces; nearest by the legacy
  rounding) where the patch grid differs (:104-119); ``cls_token`` is
  prepended and dropped again without ``with_cls_token``;
- ``pre_ln`` with ``pre_norm``; the token stream itself is an output
  with ``out_origin`` (:135-136); blocks ``b{i}_*``: ``norm1``, ``attn``
  (one ``qkv`` Linear to 3C, heads head-major, a float32 softmax at scale
  ``head_dim ** -0.5``, ``proj``), a residual, ``norm2``, ``fc1``, exact
  GELU, ``fc2``, a residual; with ``final_norm``
  ``final_norm`` is applied to the stream after the last block (:156-160),
  so only an output taken there is normed;
- each output is the (B, C, h, w) grid, or with ``output_cls_token`` the
  pair (grid, (B, C) cls token), SAN's contract.

``norm_cfg`` (every LayerNorm is flax's, eps 1e-6), ``act_cfg``,
``patch_norm``, ``patch_pad``, ``norm_eval``, ``with_cp``,
``frozen_exclude``, ``pretrained`` and ``init_cfg`` are accepted and
unused, as in the JAX package.  A nonzero ``drop_rate``,
``attn_drop_rate`` or ``drop_path_rate``, which no config that the port
builds sets (SETR's and Segmenter's ``_base_`` files do), raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.backbones.mit import LN_EPS
from lednet_tpu_torch.models.layers import attention, merge_heads
from lednet_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from lednet_tpu_torch.registry import MODELS


def resize_grid(x: torch.Tensor, size, mode: str) -> torch.Tensor:
    """The JAX package's ``resize`` of an NCHW map (``align_corners=False``)."""
    if mode == 'bilinear':
        return resize_bilinear(x, size, False)
    if mode == 'bicubic':
        return F.interpolate(x, size=tuple(size), mode='bicubic',
                             align_corners=False)
    if mode == 'nearest':
        return resize_nearest(x, size)
    raise ValueError(f'Unsupported resize mode: {mode}')


class _MHSA(nn.Module):

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).view(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)              # (B, heads, N, d) each
        return self.proj(merge_heads(attention(q, k, v)))


@MODELS.register_module()
class VisionTransformer(nn.Module):

    def __init__(self, img_size: Any = 224, patch_size: int = 16,
                 in_channels: int = 3, embed_dims: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 out_indices: Sequence[int] = (2, 5, 8, 11),
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 with_cls_token: bool = True, output_cls_token: bool = False,
                 final_norm: bool = False, interpolate_mode: str = 'bicubic',
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 patch_norm: bool = False, pre_norm: bool = False,
                 norm_eval: bool = False, with_cp: bool = False,
                 frozen_exclude: Sequence[str] = (),
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Dict] = None, out_origin: bool = False,
                 patch_pad: str = 'corner', patch_bias: bool = False):
        super().__init__()
        for name, rate in (('drop_rate', drop_rate),
                           ('attn_drop_rate', attn_drop_rate),
                           ('drop_path_rate', drop_path_rate)):
            if rate:
                raise NotImplementedError(f'VisionTransformer {name}={rate} is '
                                          'not ported (no config the port '
                                          'builds sets it)')
        if isinstance(out_indices, int):
            out_indices = (out_indices,)
        p = patch_size
        self.patch_size = p
        self.embed_dims = embed_dims
        self.num_layers = num_layers
        self.out_indices = tuple(out_indices)
        self.with_cls_token = with_cls_token
        self.output_cls_token = output_cls_token
        self.interpolate_mode = interpolate_mode
        self.out_origin = out_origin
        self.pre_norm = pre_norm
        self.use_final_norm = final_norm
        h, w = tuple(img_size) if isinstance(img_size, (tuple, list)) \
            else (img_size, img_size)
        self.pos_grid = (h // p, w // p)
        self.patch_embed = nn.Conv2d(in_channels, embed_dims, p, p, bias=patch_bias)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, self.pos_grid[0] * self.pos_grid[1] + 1, embed_dims))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        self.raw_init = {'pos_embed': ('truncated_normal', 0.02),
                         'cls_token': ('zeros', 0.0)}
        if pre_norm:
            self.pre_ln = nn.LayerNorm(embed_dims, eps=LN_EPS)
        hidden = embed_dims * mlp_ratio
        for i in range(num_layers):
            pre = f'b{i}_'
            self.add_module(pre + 'norm1', nn.LayerNorm(embed_dims, eps=LN_EPS))
            self.add_module(pre + 'attn', _MHSA(embed_dims, num_heads, qkv_bias))
            self.add_module(pre + 'norm2', nn.LayerNorm(embed_dims, eps=LN_EPS))
            self.add_module(pre + 'fc1', nn.Linear(embed_dims, hidden))
            self.add_module(pre + 'fc2', nn.Linear(hidden, embed_dims))
        if final_norm:
            self.final_norm = nn.LayerNorm(embed_dims, eps=LN_EPS)

    def _grid_out(self, x: torch.Tensor, gh: int, gw: int):
        """The token stream -> the (B, C, gh, gw) grid, or (grid, cls)."""
        out = x[:, 1:] if self.with_cls_token else x
        grid = out.transpose(1, 2).reshape(x.shape[0], self.embed_dims, gh, gw)
        if self.output_cls_token and self.with_cls_token:
            return grid, x[:, 0]
        return grid

    def position_embedding(self, gh: int, gw: int) -> torch.Tensor:
        """(1, 1 + gh * gw, C): the cls slot and the grid part, resized."""
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != self.pos_grid:
            grid = grid_pos.transpose(1, 2).reshape(1, self.embed_dims,
                                                    *self.pos_grid)
            grid = resize_grid(grid, (gh, gw), self.interpolate_mode)
            grid_pos = grid.flatten(2).transpose(1, 2)
        return torch.cat([cls_pos, grid_pos], 1)

    def forward(self, x: torch.Tensor, impl: Optional[str] = None):
        """(B, C, H, W) -> a tuple of outputs (``out_origin`` first, then
        ``out_indices``).  ``impl`` means nothing here: no port kernel runs
        in the ViT."""
        x = x.to(self.pos_embed.dtype)
        p = self.patch_size
        pad_h, pad_w = (-x.shape[-2]) % p, (-x.shape[-1]) % p
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h))
        x = self.patch_embed(x)
        B, _, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], 1)
        x = x + self.position_embedding(gh, gw)
        if not self.with_cls_token:
            x = x[:, 1:]
        if self.pre_norm:
            x = self.pre_ln(x)
        outs = [self._grid_out(x, gh, gw)] if self.out_origin else []
        for i in range(self.num_layers):
            pre = f'b{i}_'
            x = x + getattr(self, pre + 'attn')(getattr(self, pre + 'norm1')(x))
            h = F.gelu(getattr(self, pre + 'fc1')(getattr(self, pre + 'norm2')(x)))
            x = x + getattr(self, pre + 'fc2')(h)
            if i == self.num_layers - 1 and self.use_final_norm:
                x = self.final_norm(x)
            if i in self.out_indices:
                outs.append(self._grid_out(x, gh, gw))
        return tuple(outs)


MODELS.register_module(name='VIT', module=VisionTransformer)
