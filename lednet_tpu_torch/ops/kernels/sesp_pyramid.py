"""Kernels D and E: one eval-mode SESP block (``sesp_block``) and the SESP
branch pyramid on its own (``sesp_pyramid``).

- E replaces ``lednet_tpu/ops/pallas/sesp_pyramid.py:79`` (``sesp_pyramid``);
  CUDA source ``lednet_tpu_torch/csrc/sesp_pyramid.cu``, one launch of
  persistent CTAs that walk (plane, output tile) items through a ring of
  red boxes fed by TMA.
- D replaces ``sesp_pyramid.py:207`` (``sesp_block``); CUDA source
  ``lednet_tpu_torch/csrc/sesp_block.cu``, two launches: a register-tiled
  reduce, then one fused launch of pyramid, BatchNorm + PReLU, expand and
  tail that keeps the pyramid map and ``y`` on chip.  Unlike the TPU
  kernel's VMEM gate (``pyramid_fits`` :285) it also takes stride-2 blocks
  wider than 128 channels (LED-Net's context3 down-sampler).  Its pyramid
  device code is ``csrc/sesp_common.cuh``.

Tiles, channel splits, chunk sizes and ring depths are chosen here
(:func:`fused_config`, :func:`reduce_config`, :func:`pyramid_geometry`),
so the CPU tests reach them.

:func:`bn_fold` and :func:`dense_grouped` are the host-side helpers that turn
a SESP module's parameters into kernel D's operands
(``sesp_pyramid.py:279`` and :265).
"""
from __future__ import annotations

import functools
import math
import weakref
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from lednet_tpu_torch.ops.kernels._build import (check, library, ptr, require,
                                                 resolve_impl, stream_ptr)

TAILS = {'plain': 0, 'act': 1, 'residual': 2}
THREADS = 256                   # every launch of D and E
SMEM_BYTES = 232448             # H100: shared memory one CTA may use
SMS = 132                       # H100 streaming multiprocessors


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


# ------------------------------------------------------------ plain versions
def sesp_pyramid_plain(red, dw1, dw2, rates: Sequence[int],
                       stride: int = 1) -> torch.Tensor:
    """The pyramid on a (B, n, H, W) float32 map: k depthwise 3x3 branches
    at dilations ``rates`` and ``stride``, the HFF running sum, and the v2
    stage at dilations ``rates + 1`` unless ``dw2`` is None; dw1/dw2
    (k, n, 3, 3).  Returns the concat (B, k*n, ceil(H/s), ceil(W/s))."""
    n = dw1.shape[1]
    branches = []
    for g, d in enumerate(rates):
        br = F.conv2d(red, dw1[g].unsqueeze(1), stride=stride, padding=d,
                      dilation=d, groups=n)
        branches.append(br + branches[-1] if branches else br)
    if dw2 is not None:
        branches = [F.conv2d(br, dw2[g].unsqueeze(1), padding=d + 1,
                             dilation=d + 1, groups=n)
                    for g, (br, d) in enumerate(zip(branches, rates))]
    return torch.cat(branches, 1)


def sesp_block_plain(x, wred, bred, a1, dw1, dw2, s2, b2, a2, wexp, bexp, a3,
                     rates: Sequence[int], stride: int = 1,
                     tail: str = 'residual') -> torch.Tensor:
    """The block's function on NCHW float32 operands.

    wred (n, Cin) dense reduce weight, BN folded; bred/a1 (n,).
    dw1/dw2 (k, n, 3, 3) depthwise branch kernels (dw2 may be None).
    s2/b2/a2 (k*n,) BN scale/bias and PReLU alpha after the concat.
    wexp (C, C) dense expand weight (out, in), BN folded; bexp/a3 (C,).
    """
    red = _prelu(torch.einsum('oi,bihw->bohw', wred, x)
                 + bred.view(1, -1, 1, 1), a1)
    pyr = sesp_pyramid_plain(red, dw1, dw2, rates, stride)
    y = _prelu(pyr * s2.view(1, -1, 1, 1) + b2.view(1, -1, 1, 1), a2)
    z = torch.einsum('oi,bihw->bohw', wexp, y) + bexp.view(1, -1, 1, 1)
    if tail == 'residual':
        return _prelu(z + x, a3)
    if tail == 'act':
        return _prelu(z, a3)
    return z


# ------------------------------------------------------------ launch configs
class FusedConfig(NamedTuple):
    """One fused launch of kernel D: an output tile th x tw, oc output
    channels per tile, red channels in chunks of jc, split over a cluster of
    cs CTAs, ppt pixels x 4 output channels per thread."""
    th: int
    tw: int
    oc: int
    jc: int
    cs: int
    ppt: int
    ctas: int
    smem: int          # bytes of shared memory per CTA


def _tile_floats(H, W, rates, stride, v2, th, tw):
    """Floats of one channel's red tile and grown HFF-sum tile
    (``PyrTile`` in ``csrc/sesp_common.cuh``)."""
    rmax = max(rates)
    m2 = rmax + 1 if v2 else 0
    eh, ew = th + 2 * m2, tw + 2 * m2
    rh = (eh - 1) * stride + 1 + 2 * rmax
    rw = (ew - 1) * stride + 1 + 2 * rmax
    return rh * rw, eh * ew


def _r4(v):
    return -(-v // 4) * 4


def fused_smem(H, W, n, k, rates, stride, v2, th, tw, oc, jc, cs=1) -> int:
    """Shared memory of one fused CTA in bytes (``fused_smem_floats`` in
    ``csrc/sesp_block.cu``): y, two staging buffers (red tile, dw1/dw2
    taps), the HFF sums, the BatchNorm vectors and, in a cluster, the
    partial expand."""
    red, grown = _tile_floats(H, W, rates, stride, v2, th, tw)
    stage = _r4(jc * red) + 2 * _r4(k * jc * 9)
    return 4 * (_r4(k * jc * th * tw) + 2 * stage + _r4(k * jc * grown)
                + _r4(3 * k * n) + (oc * th * tw if cs > 1 else 0))


def fused_candidates(B: int, H: int, W: int, n: int, k: int,
                     rates: Sequence[int], stride: int, v2: bool):
    """Every fused launch geometry the kernel takes for this block, each as
    (estimated ms, :class:`FusedConfig`): tile, output channels per tile
    and cluster size, with the largest chunk (up to 8 channels) that leaves
    room for two CTAs per SM.

    The estimate is a linear model of one CTA's time, fitted to the times of
    candidates at the flagship's SESP call sites on an H100: 0.91 ns per
    depthwise element and branch of the CTA's grown tiles, 0.004 ns per
    expand FMA, 0.39 ns per staged float of red and, in a cluster, 1.67 ns
    per partial sum exchanged, times the waves of CTAs at most two CTAs per
    SM (the register cap of the kernel).  ``python3
    tools/torch_port_profile.py --sesp-sweep`` times every candidate on the
    card and shows the chosen one beside the fastest."""
    C = k * n
    H2, W2 = -(-H // stride), -(-W // stride)
    if C % 4:
        return
    for ppt in (4, 2):
        for toc in (1, 2, 4, 8, 16, 32):
            oc, tp = toc * 4, THREADS // toc * ppt
            if oc >= 2 * C and oc > 8:
                continue
            for tw in (4, 8, 16, 32, 64):
                th = tp // tw
                if th < 4 or th * tw != tp or tw % ppt or th > 4 * tw \
                        or tw > 4 * th or th > 2 * H2 or tw > 2 * W2:
                    continue
                red, grown = _tile_floats(H, W, rates, stride, v2, th, tw)
                tiles = -(-H2 // th) * -(-W2 // tw) * -(-C // oc) * B
                # the largest chunk, up to 8, that leaves room for two CTAs
                # per SM
                jc = next((j for j in (8, 4, 2, 1) if j <= max(n, 1) and
                           fused_smem(H, W, n, k, rates, stride, v2, th, tw,
                                      oc, j, 2) <= SMEM_BYTES // 2), None)
                for cs in (1, 2, 4, 8) if jc else ():
                    chunks = -(-n // jc)
                    if cs > chunks or oc % cs:
                        continue
                    mine = -(-chunks // cs)
                    smem = fused_smem(H, W, n, k, rates, stride, v2, th, tw,
                                      oc, jc, cs)
                    cta_ns = (0.91 * mine * jc * k * grown
                              + 0.004 * tp * oc * C / cs
                              + 0.39 * mine * jc * red
                              + (1.67 * tp * oc if cs > 1 else 0))
                    ctas = tiles * cs
                    per_sm = max(1, min(2, SMEM_BYTES // (smem + 1024),
                                        -(-ctas // SMS)))
                    waves = -(-ctas // (SMS * per_sm))
                    yield (waves * per_sm * cta_ns * 1e-6,
                           FusedConfig(th, tw, oc, jc, cs, ppt, ctas, smem))


@functools.lru_cache(maxsize=None)
def fused_config(B: int, H: int, W: int, n: int, k: int,
                 rates: tuple, stride: int, v2: bool) -> FusedConfig:
    """The fused launch's geometry: the candidate of least estimated cost
    (:func:`fused_candidates`); on a tie, the least shared memory (more CTAs
    resident per SM), then the wider tile."""
    best = min(fused_candidates(B, H, W, n, k, rates, stride, v2),
               key=lambda c: (c[0], c[1].smem, -c[1].tw), default=None)
    if best is None:
        raise ValueError(f'no fused SESP launch fits: H={H} W={W} n={n} '
                         f'k={k} rates={tuple(rates)} stride={stride} (the '
                         'kernel needs k*n divisible by 4)')
    return best[1]


@functools.lru_cache(maxsize=None)
def reduce_config(B: int, HW: int, n: int):
    """(ppt, opt) of the reduce launch: 16*opt output channels per CTA (all
    of them for n <= 64, so x is read once), and 64-pixel CTAs unless that
    leaves the card's SMs mostly idle, then 16-pixel CTAs."""
    opt = 1 if n <= 16 else 2 if n <= 32 else 4
    ctas = math.ceil(HW / 64) * math.ceil(n / (16 * opt)) * B
    return (4 if ctas >= SMS else 1), opt


# kernel E (csrc/sesp_pyramid.cu): 256 threads in 8-wide register strips,
# at most two CTAs per SM (``__launch_bounds__(256, 2)``)
E_CTAS_PER_SM = 2
E_HEAD_BYTES = 896      # mbarriers (128 B) + two buffers of 4 x 24 taps
TMA_BOX_MAX = 256       # a TMA box side, in elements
E_MIN_ITEMS = 128       # items of a launch: one per SM on all but 4 SMs


class PyramidGeometry(NamedTuple):
    """One launch of kernel E (``Ring`` in ``csrc/sesp_pyramid.cu``, which
    takes every field from here and refuses a layout its reads and writes
    cannot use).

    Output tiles th x tw; the HFF sums over the tile grown by m2 = max rate
    + 1 rows on each side (v2 only) and ca = m2 rounded up to 4 columns
    (sh x su); their shared-memory pitch sp; the red box rh x rw that one
    load brings in (TMA, or cp.async when ``tma`` is False), ``box`` floats
    a stage in a ring of ``stages``; ``items`` = planes x tiles, walked by
    ``grid`` persistent CTAs, ``ctas_per_sm`` of them resident on one SM."""
    th: int
    tw: int
    stages: int
    tma: bool
    m2: int
    ca: int
    sh: int
    su: int
    sp: int
    rh: int
    rw: int
    box: int
    smem: int          # bytes of shared memory per CTA
    ctas_per_sm: int
    items: int
    grid: int


def pyramid_tile(B: int, H: int, W: int, n: int, rates: Sequence[int],
                 stride: int, v2: bool, th: int, tw: int, stages: int,
                 tma: bool) -> PyramidGeometry:
    """Kernel E's launch at output tile th x tw with a ring of ``stages``
    boxes.  Stage 1 reads red through aligned float4 windows 4 columns
    beyond the largest rate, so a box row holds stride * su + 8 columns,
    padded to 4 mod 8 floats (no bank conflict between two rows' windows);
    each box is rounded to 128 bytes (TMA's alignment).  Shared memory: the
    head (mbarriers, taps), the ring and, with v2, the k HFF sums over the
    grown tile at a pitch of su + 4 (4 mod 8 floats)."""
    k, rmax = len(rates), max(rates)
    m2 = rmax + 1 if v2 else 0
    ca = _r4(m2)
    sh, su = th + 2 * m2, tw + 2 * ca
    rh = (sh - 1) * stride + 1 + 2 * rmax
    rw = stride * su + 8
    rw += 4 if rw % 8 == 0 else 0
    box = -(-rh * rw // 32) * 32
    smem = E_HEAD_BYTES + 4 * (stages * box + (k * sh * (su + 4) if v2 else 0))
    per_sm = min(E_CTAS_PER_SM, SMEM_BYTES // (smem + 1024))
    H2, W2 = -(-H // stride), -(-W // stride)
    items = B * n * -(-H2 // th) * -(-W2 // tw)
    return PyramidGeometry(th, tw, stages, tma, m2, ca, sh, su, su + 4, rh,
                           rw, box, smem, per_sm, items,
                           min(items, SMS * per_sm))


@functools.lru_cache(maxsize=None)
def pyramid_geometry(B: int, H: int, W: int, n: int, k: int, rates: tuple,
                     stride: int, v2: bool, aligned: bool = True
                     ) -> PyramidGeometry:
    """Kernel E's launch for this shape.  Tiles are 32 columns wide (16 on
    maps at most 16 wide) and of the largest height, from 64 rows down to 8,
    that fits two CTAs per SM (with a ring of 3 boxes, else 2) and still
    gives at least E_MIN_ITEMS items.  A larger tile recomputes less of the
    v2 halo and pays the per-item waits fewer times; below about one item
    per SM the card idles (``tools/torch_port_profile.py --pyramid-sweep``
    times every tile).  The red box comes by TMA where W is a multiple of 4
    and ``red`` is 16-byte aligned (``aligned``; TMA needs 16-byte row
    strides), else by 4-byte cp.async copies."""
    H2, W2 = -(-H // stride), -(-W // stride)
    tw = 16 if W2 <= 16 else 32
    tma = W % 4 == 0 and aligned
    best = None
    for th in (64, 32, 16, 8):
        if th > 8 and th // 2 >= H2:
            continue
        for stages in (3, 2):
            geo = pyramid_tile(B, H, W, n, rates[:k], stride, v2, th, tw,
                               stages, tma)
            if (geo.ctas_per_sm == E_CTAS_PER_SM
                    and max(geo.rh, geo.rw) <= TMA_BOX_MAX):
                best = geo
                break
        if best is not None and best.items >= E_MIN_ITEMS:
            break
    if best is None:
        raise ValueError(f'no kernel E launch fits: H={H} W={W} '
                         f'rates={tuple(rates)} stride={stride}')
    return best


def launch_pyramid(red, dw1, dw2, out, rates: Sequence[int], stride: int,
                   geo: PyramidGeometry) -> None:
    """Launch kernel E with the layout ``geo`` on red's stream; raises on
    a launch the kernel refuses."""
    B, n, H, W = red.shape
    k = len(rates)
    check(library().lednet_sesp_pyramid(
        red.data_ptr(), dw1.data_ptr(), ptr(dw2), out.data_ptr(), B, n, H, W,
        k, *(list(rates) + [1] * (4 - k)), stride, geo.th, geo.tw, geo.stages,
        geo.m2, geo.ca, geo.sh, geo.su, geo.sp, geo.rh, geo.rw, geo.box,
        geo.smem, geo.grid, int(geo.tma), stream_ptr(red)), 'sesp_pyramid')


# ------------------------------------------------------------ the ops
# id(w) -> (weakref to w, (w._version, w.data_ptr()), w.t().contiguous())
_TRANSPOSED = {}


def _transposed(w: torch.Tensor) -> torch.Tensor:
    """``w.t().contiguous()``, kept until ``w`` changes or is freed, so that
    the eval path (whose weights are cached on the module) transposes each
    expand weight once.  An inference tensor has no version to key on and
    is transposed on every call."""
    if w.is_inference():
        return w.t().contiguous()
    key = (w._version, w.data_ptr())
    hit = _TRANSPOSED.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == key:
        return hit[2]
    for dead in [i for i, v in _TRANSPOSED.items() if v[0]() is None]:
        del _TRANSPOSED[dead]
    wt = w.detach().t().contiguous()
    _TRANSPOSED[id(w)] = (weakref.ref(w), key, wt)
    return wt


def _check_pyramid(red_like, dw1, dw2, rates, stride):
    if stride not in (1, 2):
        raise ValueError(f'stride must be 1 or 2, got {stride}')
    k, n = dw1.shape[0], dw1.shape[1]
    if len(rates) != k or not 1 <= k <= 4:
        raise ValueError(f'need 1 to 4 branches with one rate each, got k={k}, '
                         f'rates={tuple(rates)}')
    dev = red_like.device
    require(dw1, 'dw1', torch.float32, (k, n, 3, 3), dev)
    if dw2 is not None:
        require(dw2, 'dw2', torch.float32, (k, n, 3, 3), dev)
    return k, n, list(rates) + [1] * (4 - k)


def sesp_pyramid(red: torch.Tensor, dw1: torch.Tensor,
                 dw2: Optional[torch.Tensor], rates: Sequence[int],
                 stride: int = 1, impl: Optional[str] = None) -> torch.Tensor:
    """Kernel E: the SESP pyramid on a (B, n, H, W) float32 map -> (B, k*n,
    ceil(H/stride), ceil(W/stride)).  Operands as in
    :func:`sesp_pyramid_plain`."""
    if resolve_impl(impl, red) == 'plain':
        return sesp_pyramid_plain(red, dw1, dw2, rates, stride)
    require(red, 'red', torch.float32)
    if red.dim() != 4:
        raise ValueError(f'red must be NCHW, got {tuple(red.shape)}')
    k, n, _ = _check_pyramid(red, dw1, dw2, rates, stride)
    B, n_red, H, W = red.shape
    if n_red != n:
        raise ValueError(f'red has {n_red} channels, dw1 {n}')
    geo = pyramid_geometry(B, H, W, n, k, tuple(rates), stride,
                           dw2 is not None, red.data_ptr() % 16 == 0)
    out = torch.empty((B, k * n, -(-H // stride), -(-W // stride)),
                      dtype=torch.float32, device=red.device)
    launch_pyramid(red, dw1, dw2, out, rates, stride, geo)
    sesp_pyramid.launches += 1
    return out


sesp_pyramid.launches = 0


def sesp_block(x, wred, bred, a1, dw1, dw2, s2, b2, a2, wexp, bexp, a3,
               rates: Sequence[int], stride: int = 1, tail: str = 'residual',
               impl: Optional[str] = None) -> torch.Tensor:
    """Kernel D: one eval SESP block on a (B, Cin, H, W) float32 map ->
    (B, k*n, ceil(H/stride), ceil(W/stride)).  Operands as in
    :func:`sesp_block_plain`."""
    if resolve_impl(impl, x) == 'plain':
        return sesp_block_plain(x, wred, bred, a1, dw1, dw2, s2, b2, a2, wexp,
                                bexp, a3, rates, stride, tail)
    if tail not in TAILS:
        raise ValueError(f'tail must be one of {sorted(TAILS)}, got {tail!r}')
    require(x, 'x', torch.float32)
    if x.dim() != 4:
        raise ValueError(f'x must be NCHW, got {tuple(x.shape)}')
    k, n, r = _check_pyramid(x, dw1, dw2, rates, stride)
    B, Cin, H, W = x.shape
    C = k * n
    if tail == 'residual' and (stride != 1 or Cin != C):
        raise ValueError('the residual tail needs stride 1 and Cin == k*n')
    dev = x.device
    f32 = torch.float32
    require(wred, 'wred', f32, (n, Cin), dev)
    for name, t, size in (('bred', bred, n), ('a1', a1, n), ('s2', s2, C),
                          ('b2', b2, C), ('a2', a2, C), ('bexp', bexp, C),
                          ('a3', a3, C)):
        require(t, name, f32, (size,), dev)
    require(wexp, 'wexp', f32, (C, C), dev)
    lib = library()
    stream = stream_ptr(x)
    red = torch.empty((B, n, H, W), dtype=f32, device=dev)
    check(lib.lednet_sesp_reduce(
        x.data_ptr(), wred.data_ptr(), bred.data_ptr(), a1.data_ptr(),
        red.data_ptr(), B, Cin, H * W, n, *reduce_config(B, H * W, n),
        stream), 'sesp_block/reduce')
    cfg = fused_config(B, H, W, n, k, tuple(rates), stride, dw2 is not None)
    out = torch.empty((B, C, -(-H // stride), -(-W // stride)), dtype=f32,
                      device=dev)
    check(lib.lednet_sesp_fused(
        red.data_ptr(), dw1.data_ptr(), ptr(dw2), s2.data_ptr(),
        b2.data_ptr(), a2.data_ptr(), _transposed(wexp).data_ptr(),
        bexp.data_ptr(), a3.data_ptr(),
        x.data_ptr() if tail == 'residual' else None,
        out.data_ptr(), B, n, H, W, k, *r, stride, TAILS[tail], cfg.th,
        cfg.tw, cfg.oc, cfg.jc, cfg.cs, cfg.ppt, stream),
        'sesp_block/fused')
    sesp_block.launches += 1
    return out


sesp_block.launches = 0
