"""Host side of the 3xTF32 conv core shared by kernels B and C
(``csrc/conv3x3_core.cuh``): the TF32 split of the folded weights, their
permutation into mma B-fragment order, and each launch's geometry.

The weights are split and permuted once per weight version, on the host, and
cached with the stem's folded operands (``LEDNet._fold_stem``).

Fragment order (``mma.m16n8k8`` TF32, lane = 4 g + t, b0 = B[k=t][n=g],
b1 = B[k=t+4][n=g]), one float4 ``{b0_hi, b1_hi, b0_lo, b1_lo}`` per lane:

- a C -> C 3x3 conv (``conv_fragments``): ``[C/8 chunks q][9 taps][C/8
  n-tiles][32 lanes][4]`` with k = input channel 8 q + k, n = output channel;
- stem_conv1, 3 -> C (``conv1_fragments``): K = cin * 9 + tap (27, padded
  with zeros to 32), ``[4 k-steps][C/8 n-tiles][32 lanes][4]``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

THREADS = 256                   # every launch of B and C
SMEM_BYTES = 232448             # H100: shared memory one CTA may use
SMS = 132                       # H100 streaming multiprocessors
CHANNELS = (16, 32)             # widths the kernels are compiled for
PAIR_TILE = (16, 32)            # kernel C's output tile
STEM_TILE = (8, 16)             # kernel B's x2 tile


# ---------------------------------------------------------------- the split
def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 mantissa bits become zero."""
    bits = t.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(t)`` and ``lo = tf32(t - hi)``."""
    hi = tf32_round(t)
    return hi, tf32_round(t.detach().float() - hi)


def _interleave(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(..., 2) hi and lo pairs -> (..., 4) ``{hi0, hi1, lo0, lo1}``."""
    return torch.cat([hi, lo], -1).contiguous()


def conv_fragments(w: torch.Tensor) -> torch.Tensor:
    """A folded (C, C, 3, 3) weight in B-fragment order:
    (C/8, 9, C/8, 32, 4) float32."""
    co, ci = w.shape[:2]
    if co != ci or co % 8 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f'need a (C, C, 3, 3) weight with C % 8 == 0, got '
                         f'{tuple(w.shape)}')
    ch = co // 8

    def order(v):     # [n, g, q, j, t, tap] -> [q, tap, n, g, t, j]
        v = v.reshape(ch, 8, ch, 2, 4, 9).permute(2, 5, 0, 1, 4, 3)
        return v.reshape(ch, 9, ch, 32, 2)
    hi, lo = tf32_split(w)
    return _interleave(order(hi), order(lo))


def conv1_fragments(w1: torch.Tensor) -> torch.Tensor:
    """stem_conv1's folded (C, 3, 3, 3) weight in B-fragment order:
    (4, C/8, 32, 4) float32."""
    co = w1.shape[0]
    if co % 8 or tuple(w1.shape[1:]) != (3, 3, 3):
        raise ValueError(f'need a (C, 3, 3, 3) weight with C % 8 == 0, got '
                         f'{tuple(w1.shape)}')

    def order(v):     # [n, g, ks, j, t] -> [ks, n, g, t, j]
        v = torch.nn.functional.pad(v.reshape(co, 27), (0, 5))
        v = v.reshape(co // 8, 8, 4, 2, 4).permute(2, 0, 1, 4, 3)
        return v.reshape(4, co // 8, 32, 2)
    hi, lo = tf32_split(w1)
    return _interleave(order(hi), order(lo))


def unpack_conv_fragments(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`conv_fragments`: the (hi, lo) weights (C, C, 3, 3)."""
    ch = f.shape[0]

    def back(v):
        v = v.reshape(ch, 9, ch, 8, 4, 2).permute(2, 3, 0, 5, 4, 1)
        return v.reshape(8 * ch, 8 * ch, 3, 3)
    return back(f[..., :2]), back(f[..., 2:])


def unpack_conv1_fragments(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`conv1_fragments`: the (hi, lo) weights (C, 3, 3, 3)."""
    nt = f.shape[1]

    def back(v):
        v = v.reshape(4, nt, 8, 4, 2).permute(1, 2, 0, 4, 3)
        return v.reshape(8 * nt, 32)[:, :27].reshape(8 * nt, 3, 3, 3)
    return back(f[..., :2]), back(f[..., 2:])


def stem_fragments(w1, w2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's pre-split weights: (conv1_fragments(w1), conv_fragments(w2))."""
    return conv1_fragments(w1), conv_fragments(w2)


def pair_fragments(ws: torch.Tensor) -> torch.Tensor:
    """Kernel C's pre-split weights for its four convs (4, C, C, 3, 3):
    (4, C/8, 9, C/8, 32, 4)."""
    return torch.stack([conv_fragments(w) for w in ws])


# ---------------------------------------------------------------- geometry
def pad_cs(area: int) -> int:
    """The smallest channel stride >= area that is 8 or 24 (mod 32), so that
    an A-fragment load is free of bank conflicts (``pad_cs`` in the core)."""
    while area % 32 not in (8, 24):
        area += 1
    return area


def chunk_frags(C: int) -> int:
    """float4s of one chunk's B fragments (9 taps x C/8 n-tiles x 32 lanes)."""
    return 9 * (C // 8) * 32


class LaunchConfig(NamedTuple):
    th: int            # output tile (rows, columns)
    tw: int
    threads: int
    smem: int          # bytes of dynamic shared memory per CTA
    grid: Tuple[int, int, int]
    tiles: int         # output tiles (a persistent CTA walks several)


def _cdiv(a, b):
    return -(-a // b)


def check_channels(C: int) -> None:
    if C not in CHANNELS:
        raise ValueError(f'the conv kernels are compiled for C in {CHANNELS}, '
                         f'got C={C}')


def block_config(B: int, C: int, H: int, W: int) -> LaunchConfig:
    """One launch of kernel C, one BasicBlock (``Block<C>`` in
    ``csrc/conv_block.cu``): a ring of two weight chunks, the block's input
    with a 2-pixel halo (rows spanning whole float4s from column ow0 - 4)
    and h with a 1-pixel halo."""
    check_channels(C)
    th, tw = PAIR_TILE
    x_rw = -(-(tw + 6) // 4) * 4
    bufs = C * (pad_cs((th + 4) * x_rw) + pad_cs((th + 2) * (tw + 2)))
    smem = 2 * chunk_frags(C) * 16 + bufs * 4
    grid = (_cdiv(W, tw), _cdiv(H, th), B)
    return LaunchConfig(th, tw, THREADS, smem, grid, grid[0] * grid[1] * B)


def stem_config(B: int, C: int, H: int, W: int, bf16: bool = True,
                sms: int = SMS) -> LaunchConfig:
    """Kernel B's launch (``Stem<Tin, C>`` in ``csrc/stem_conv.cu``) for a
    (B, 3, H, W) bfloat16 (or float32) image: one persistent CTA per SM (at
    most one per tile), each holding conv2's and conv1's fragments, the x1
    region of its tile (even and odd columns apart), two image-region
    buffers (bf16 column pairs, or float32 even | odd columns) and both
    biases."""
    check_channels(C)
    th, tw = STEM_TILE
    xh, xw = 2 * th + 1, 2 * tw + 1
    xcs = pad_cs(xh * 2 * (tw + 1))
    ih, iw = 2 * xh + 1, 2 * xw + 1
    # words per image row: bf16 pairs in 16-byte spans from 5 columns
    # before the region, or float32 even | odd columns
    img = 3 * ih * ((iw + 5 + 7) // 8 * 4 if bf16 else 2 * ((iw + 1) // 2))
    w1f, w2f = 4 * (C // 8) * 32, (C // 8) * chunk_frags(C)
    smem = (w2f + w1f) * 16 + (C * xcs + 2 * img + 2 * C) * 4
    h2, w2 = _cdiv(_cdiv(H, 2), 2), _cdiv(_cdiv(W, 2), 2)
    tiles = _cdiv(w2, tw) * _cdiv(h2, th) * B
    return LaunchConfig(th, tw, THREADS, smem, (min(tiles, sms), 1, 1), tiles)
