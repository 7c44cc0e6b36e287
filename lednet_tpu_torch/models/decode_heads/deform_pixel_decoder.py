"""Mask2Former's multi-scale deformable-attention pixel decoder, the
``pixel_decoder='msdeform'`` option of ``MaskFormerHead``.

Counterpart of ``lednet_tpu/models/decode_heads/deform_pixel_decoder.py``
(``bilinear_sample`` :27, ``MSDeformAttn`` :56, ``_EncoderLayer`` :95,
``MSDeformAttnPixelDecoder`` :113):

- ``bilinear_sample``: (B, H, W, C) values at (B, N, 2) normalized (x, y)
  points, pixel centres at (i + 0.5) / size, each of the four taps outside
  the map counting 0 (``F.grid_sample`` with ``align_corners=False`` and
  ``padding_mode='zeros'``), written as the JAX code's gather (``floor``,
  four masked taps) so that it rounds as the JAX package does;
- ``MSDeformAttn``: per token, head, level and point an offset
  (``sampling_offsets``, zero at initialisation: a fresh decoder samples
  at the reference points) over the level's (width, height) added to the
  token's reference point, and a softmax weight over the levels' points
  (``attention_weights``); each level's values (``value_proj{l}``) are
  sampled there per head and summed with the weights, level by level;
  ``output_proj``.  The heads run as one batch (B x heads) of gathers;
- ``_EncoderLayer``: the attention over the tokens (residual, post-norm
  ``norm1``), a ReLU FFN of ``ffn_ratio`` x width (residual, ``norm2``);
- the decoder: the levels but the finest through a 1x1 ``input_proj{i}``
  and their ``level_embed``, flattened together with each token's centre
  as its reference point, ``num_encoder_layers`` encoder layers, the
  tokens back to maps, a top-down sum (bilinear, coarsest first), then
  the finest level's ``lateral`` (1x1, GroupNorm 32) plus that sum
  resized, and ``mask_feat`` (3x3): (mask features at the finest level,
  the encoded coarsest map).

Every LayerNorm is flax's (eps 1e-6).  On the card the gathers'
backward adds with atomics: a step is not bit-reproducible there.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.knet_head import layer_norm
from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.resize import resize_bilinear


def bilinear_sample(value: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(B, N, C) bilinear samples of (B, H, W, C) ``value`` at (B, N, 2)
    normalized (x, y) ``coords``, zero outside the map."""
    B, H, W, C = value.shape
    x = coords[..., 0] * W - 0.5
    y = coords[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).unsqueeze(-1)
    wy = (y - y0).unsqueeze(-1)
    flat = value.reshape(B, H * W, C)

    def gather(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        out = flat.gather(1, idx.unsqueeze(-1).expand(-1, -1, C))
        return out * inside.unsqueeze(-1)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


class MSDeformAttn(nn.Module):

    def __init__(self, dims: int = 256, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = (num_heads, num_levels,
                                                            num_points)
        n = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(dims, 2 * n)
        self.sampling_offsets.raw_init = {'weight': ('zeros', 0.0)}
        self.attention_weights = nn.Linear(dims, n)
        for lv in range(num_levels):
            self.add_module(f'value_proj{lv}', nn.Linear(dims, dims))
        self.output_proj = nn.Linear(dims, dims)

    def forward(self, query: torch.Tensor, value_maps: List[torch.Tensor],
                ref_points: torch.Tensor) -> torch.Tensor:
        """(B, Nq, D) queries, per level (B, Hl, Wl, D) values and (B, Nq, 2)
        normalized (x, y) reference points -> (B, Nq, D)."""
        B, Nq, D = query.shape
        Hh, L, P = self.num_heads, self.num_levels, self.num_points
        hd = D // Hh
        offsets = self.sampling_offsets(query).view(B, Nq, Hh, L, P, 2)
        attn = self.attention_weights(query).view(B, Nq, Hh, L * P).softmax(-1)
        attn = attn.view(B, Nq, Hh, L, P).permute(0, 2, 1, 3, 4)  # B Hh Nq L P
        ref = ref_points[:, :, None, None]                        # B Nq 1 1 2
        out = query.new_zeros(B, Hh, Nq, hd)
        for lv, vmap in enumerate(value_maps):
            Hl, Wl = vmap.shape[1], vmap.shape[2]
            v = getattr(self, f'value_proj{lv}')(vmap).view(B, Hl, Wl, Hh, hd)
            v = v.permute(0, 3, 1, 2, 4).reshape(B * Hh, Hl, Wl, hd)
            off = offsets[:, :, :, lv]                            # B Nq Hh P 2
            coords = ref + torch.stack([off[..., 0] / Wl, off[..., 1] / Hl], -1)
            coords = coords.permute(0, 2, 1, 3, 4).reshape(B * Hh, Nq * P, 2)
            sampled = bilinear_sample(v, coords).view(B, Hh, Nq, P, hd)
            out = out + (sampled * attn[:, :, :, lv, :, None]).sum(3)
        return self.output_proj(out.permute(0, 2, 1, 3).reshape(B, Nq, D))


class _EncoderLayer(nn.Module):

    def __init__(self, dims: int, num_heads: int, num_levels: int,
                 num_points: int, ffn_ratio: int = 4):
        super().__init__()
        self.attn = MSDeformAttn(dims, num_heads, num_levels, num_points)
        self.norm1 = layer_norm(dims)
        self.fc1 = nn.Linear(dims, ffn_ratio * dims)
        self.fc2 = nn.Linear(ffn_ratio * dims, dims)
        self.norm2 = layer_norm(dims)

    def forward(self, tokens, value_maps, ref_points):
        tokens = self.norm1(tokens + self.attn(tokens, value_maps, ref_points))
        return self.norm2(tokens + self.fc2(F.relu(self.fc1(tokens))))


class MSDeformAttnPixelDecoder(nn.Module):

    def __init__(self, in_channels: Sequence[int], feat_channels: int = 256,
                 num_encoder_layers: int = 6, num_heads: int = 8,
                 num_points: int = 4):
        """``in_channels``: the levels' widths, finest first."""
        super().__init__()
        D = feat_channels
        L = len(in_channels) - 1
        self.num_encoder_layers = num_encoder_layers
        for i, cin in enumerate(in_channels[1:]):
            proj = nn.Conv2d(cin, D, 1)
            proj.lecun_init = True            # a bare flax nn.Conv
            self.add_module(f'input_proj{i}', proj)
        self.level_embed = nn.Parameter(torch.zeros(L, D))
        self.raw_init = {'level_embed': ('normal', 1.0)}
        for li in range(num_encoder_layers):
            self.add_module(f'enc{li}', _EncoderLayer(D, num_heads, L, num_points))
        self.lateral = ConvModule(in_channels[0], D, 1,
                                  norm_cfg=dict(type='GN', num_groups=32))
        self.mask_feat = ConvModule(D, D, 3, padding=1)

    def forward(self, xs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C_i, H_i, W_i) levels, finest first -> ((B, D, H_0, W_0) mask
        features, (B, D, H, W) the encoded coarsest level)."""
        proj = [getattr(self, f'input_proj{i}')(x) for i, x in enumerate(xs[1:])]
        B, D = proj[0].shape[:2]
        shapes = [tuple(p.shape[-2:]) for p in proj]
        tokens, refs = [], []
        for i, p in enumerate(proj):
            Hl, Wl = shapes[i]
            tokens.append(p.flatten(2).transpose(1, 2) + self.level_embed[i])
            ys = (torch.arange(Hl, device=p.device, dtype=p.dtype) + 0.5) / Hl
            xc = (torch.arange(Wl, device=p.device, dtype=p.dtype) + 0.5) / Wl
            refs.append(torch.stack([xc.expand(Hl, Wl),
                                     ys[:, None].expand(Hl, Wl)], -1)
                        .reshape(Hl * Wl, 2))
        flat = torch.cat(tokens, 1)
        ref_points = torch.cat(refs, 0).unsqueeze(0).expand(B, -1, -1)

        def split(t):
            outs, start = [], 0
            for Hl, Wl in shapes:
                outs.append(t[:, start:start + Hl * Wl].reshape(B, Hl, Wl, D))
                start += Hl * Wl
            return outs

        for li in range(self.num_encoder_layers):
            flat = getattr(self, f'enc{li}')(flat, split(flat), ref_points)
        maps = [m.permute(0, 3, 1, 2) for m in split(flat)]
        h = maps[-1]
        for i in range(len(maps) - 2, -1, -1):
            h = maps[i] + resize_bilinear(h, maps[i].shape[-2:], False)
        lateral = self.lateral(xs[0])
        h = lateral + resize_bilinear(h, lateral.shape[-2:], False)
        return self.mask_feat(h), maps[-1]
