"""Uncertainty-sampled points and the mask losses on them.

Counterpart of ``lednet_tpu/ops/point_loss.py`` (``point_sample_nhw`` :21,
``uncertain_point_coords`` :46, ``sampled_mask_bce_dice`` :66), which
Mask2Former's loss uses:

- ``point_sample_nhw``: bilinear samples of (N, H, W) maps at normalized
  (x, y) points, pixel centres at (i + 0.5) / size, each of the four taps
  outside the map counting 0 (mmcv's ``point_sample``:
  ``F.grid_sample(2 * coords - 1, align_corners=False,
  padding_mode='zeros')``; PointHead's ``point_sample`` clamps instead).
  It is written as the JAX code's gather (``floor``, four masked taps),
  so that it rounds as the JAX package does;
- ``uncertain_point_coords``: of ``num_points * oversample_ratio``
  uniform candidates, the ``importance_sample_ratio * num_points`` with
  the smallest |logit| sampled there, then fresh uniform points up to
  ``num_points``.  The candidates and the fresh points are arguments (the
  caller draws them) and so is the top-k (the caller's stable one, ties
  to the lower index as ``jax.lax.top_k``);
- ``sampled_mask_bce_dice``: per-mask BCE (through ``logsigmoid``) and
  Dice (eps 1) of the logits and the {0, 1} masks sampled at given
  points.  The caller chooses the points without gradient; the gradient
  flows through the samples.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def point_sample_nhw(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (N, P) of (N, H, W) ``maps`` at (N, P, 2)
    normalized (x, y) ``coords``, zero outside the map."""
    N, H, W = maps.shape
    x = coords[..., 0] * W - 0.5
    y = coords[..., 1] * H - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = maps.reshape(N, H * W)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return flat.gather(1, idx) * ok

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def point_counts(num_points: int, oversample_ratio: float,
                 importance_sample_ratio: float) -> Tuple[int, int]:
    """(candidates, important points) of one mask, as the JAX package
    rounds them."""
    return (int(num_points * oversample_ratio),
            int(importance_sample_ratio * num_points))


def draw_points(n: int, num_points: int, oversample_ratio: float,
                importance_sample_ratio: float,
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Uniform (n, candidates, 2) candidates and (n, fresh, 2) fresh points
    (None when every point is an important one), float32 on the CPU,
    drawn from ``generator``."""
    n_over, n_imp = point_counts(num_points, oversample_ratio,
                                 importance_sample_ratio)
    cand = torch.rand((n, n_over, 2), generator=generator)
    n_rand = num_points - n_imp
    fresh = (torch.rand((n, n_rand, 2), generator=generator)
             if n_rand > 0 else None)
    return cand, fresh


def uncertain_point_coords(mask_logit: torch.Tensor, candidates: torch.Tensor,
                           fresh: Optional[torch.Tensor], num_important: int,
                           top_k: Callable[[torch.Tensor, int], torch.Tensor]
                           ) -> torch.Tensor:
    """(N, P, 2) points: of ``candidates`` the ``num_important`` whose
    samples of (N, h, w) ``mask_logit`` are nearest 0 (``top_k`` of
    -|logit|: the indices of the k largest), then ``fresh``."""
    vals = point_sample_nhw(mask_logit, candidates)
    idx = top_k(-vals.abs(), num_important)
    picked = torch.gather(candidates, 1, idx.unsqueeze(-1).expand(-1, -1, 2))
    if fresh is not None:
        picked = torch.cat([picked, fresh], 1)
    return picked


def sampled_mask_bce_dice(mask_logit: torch.Tensor, gt_mask: torch.Tensor,
                          coords: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mask (BCE, Dice), each (N,), of (N, h, w) logits and {0, 1}
    masks sampled at (N, P, 2) ``coords``: BCE the mean over the points,
    Dice ``1 - (2 * inter + 1) / (sum p + sum g + 1)``."""
    pred = point_sample_nhw(mask_logit, coords)
    gt = point_sample_nhw(gt_mask.to(mask_logit.dtype), coords)
    bce = -(gt * F.logsigmoid(pred) + (1 - gt) * F.logsigmoid(-pred)).mean(-1)
    prob = torch.sigmoid(pred)
    inter = (prob * gt).sum(-1)
    dice = 1 - (2 * inter + 1) / (prob.sum(-1) + gt.sum(-1) + 1)
    return bce, dice
