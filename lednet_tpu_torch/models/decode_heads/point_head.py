"""PointHead (PointRend's refinement stage) and its ``point_sample``, NCHW.

Counterpart of ``lednet_tpu/models/decode_heads/point_setr_heads.py``
(``point_sample`` :39-58, ``PointHead`` :62-176):

- ``point_sample``: bilinear samples at normalized (x, y) points, pixel
  centres at (i + 0.5) / size, the source coordinate clamped to the map
  (the left/top corner clipped to [0, size - 1], the weights to [0, 1]):
  ``F.grid_sample`` with ``padding_mode='border'``, ``align_corners=False``
  (mmcv's own ``point_sample`` pads with zeros instead);
- the MLP: ``fc{i}`` and ``fc_seg`` are 1-D convolutions of kernel 1 over
  the points (flax's (1, in, out) kernels; ``nn.Conv1d`` here), each but
  ``fc_seg`` followed by a ReLU; the fine features' and the coarse
  logits' samples are concatenated first, and with
  ``coarse_pred_each_layer`` the coarse samples again after every ``fc``;
- eval, for each of ``subdivision_steps``: the running logits upsampled by
  ``scale_factor`` (bilinear), the uncertainty ``top2[1] - top2[0]`` over
  the classes, the ``min(subdivision_num_points, H * W)`` most uncertain
  pixels (a stable sort: ties to the lower index, as ``jax.lax.top_k``),
  their centres through the MLP, and the MLP's
  logits written over them (``scatter``, unique indices).  The output is
  (refined logits, the last step's point logits, their coordinates), all
  on the device with no host sync, so an eval step captures it into its
  CUDA graph;
- train: ``num_points * oversample_ratio`` uniform candidates, their
  uncertainty taken on the coarse logits sampled there, the
  ``importance_sample_ratio * num_points`` most uncertain kept, then fresh
  uniform points to ``num_points``; no gradient through the coordinates.
  The output is (coarse logits, point logits, coordinates).  The
  candidates and the fresh points are drawn on the CPU from the head's own
  ``generator`` (seeded with 0) and then moved, so a model on
  the card and its copy on the CPU draw the same points; the JAX package
  draws them from its ``dropout`` key, a stream no torch generator
  reproduces;
- the fine map: the level ``in_index`` selects, or the first of a list
  of them (``in_index=[0]`` selects as ``'multiple_select'``, as mmseg's
  PointHead does);
- ``loss_by_feat``: the labels at the points, nearest by truncation
  (``int(x * W)``, clipped), cross-entropy over the valid points divided by
  their number (at least 1), as ``loss_point`` (no loss weight);
  ``predict_by_feat`` resizes the refined logits.

The JAX head accepts the other heads' ``loss_decode`` and ``sampler``
and never reads them.  Here a ``loss_decode`` of one plain
cross-entropy at weight 1 (``pointrend_r50.py``'s), which is what
``loss_point`` computes, is accepted; any other, and any ``sampler``,
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.decode_heads.base import (resolve_out_channels,
                                                       select_inputs, sem_label)
from lednet_tpu_torch.models.losses.cross_entropy import pixelwise_cross_entropy
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def point_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (B, C, H, W) ``feat`` at (B, P, 2) normalized
    (x, y) ``coords``, the coordinates clamped to the map: (B, C, P)."""
    grid = (coords * 2 - 1).to(feat.dtype).unsqueeze(1)          # (B, 1, P, 2)
    return F.grid_sample(feat, grid, mode='bilinear', padding_mode='border',
                         align_corners=False).squeeze(2)


@MODELS.register_module()
class PointHead(nn.Module):

    def __init__(self, in_channels: Union[int, Sequence[int]], channels: int,
                 num_classes: int, num_points: int = 2048,
                 oversample_ratio: int = 3,
                 importance_sample_ratio: float = 0.75, num_fcs: int = 3,
                 coarse_pred_each_layer: bool = True,
                 subdivision_steps: int = 2,
                 subdivision_num_points: int = 8196, scale_factor: int = 2,
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, align_corners: bool = False,
                 ignore_index: int = 255,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 out_channels: Optional[int] = None,
                 loss_decode: Optional[Dict] = None,
                 sampler: Optional[Dict] = None,
                 init_cfg: Optional[Dict] = None):
        """``dropout_ratio``, ``norm_cfg`` and ``act_cfg`` are accepted and
        unused, as in the JAX package (the MLP has neither)."""
        super().__init__()
        plain_ce = dict(type='CrossEntropyLoss', use_sigmoid=False,
                        loss_weight=1.0)
        if loss_decode is not None and \
                dict(plain_ce, **loss_decode) != plain_ce:
            raise NotImplementedError(f'PointHead loss_decode={loss_decode}: '
                                      'its loss is loss_point alone, a plain '
                                      'cross-entropy, as in the JAX package')
        if sampler is not None:
            raise NotImplementedError('PointHead sampler: its loss is '
                                      'loss_point alone, as in the JAX package')
        if isinstance(in_channels, (list, tuple)):
            in_channels = (in_channels[0] if input_transform != 'resize_concat'
                           else sum(in_channels))
        if isinstance(in_index, (list, tuple)) and input_transform is None:
            # ``pointrend_r50.py``'s ``in_index=[0]``: mmseg's PointHead
            # always selects its levels as a list; the JAX head indexes the
            # outputs with the list and raises (ROADMAP, gaps on the
            # reference's side)
            input_transform = 'multiple_select'
        self.in_index = in_index
        self.input_transform = input_transform
        self.num_points = num_points
        self.n_over = int(num_points * oversample_ratio)
        self.n_important = int(importance_sample_ratio * num_points)
        self.num_fcs = num_fcs
        self.coarse_pred_each_layer = coarse_pred_each_layer
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.scale_factor = scale_factor
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        n_out = resolve_out_channels(num_classes, out_channels)
        coarse = n_out if coarse_pred_each_layer else 0
        for i in range(num_fcs):
            cin = in_channels + n_out if i == 0 else channels + coarse
            self.add_module(f'fc{i}', nn.Conv1d(cin, channels, 1))
        self.fc_seg = nn.Conv1d((channels + coarse) if num_fcs else
                                in_channels + n_out, n_out, 1)
        self.generator = torch.Generator().manual_seed(0)

    def mlp(self, fine: torch.Tensor, coarse: torch.Tensor,
            coords: torch.Tensor) -> torch.Tensor:
        """The point logits (B, classes, P) at ``coords`` (B, P, 2)."""
        coarse_pts = point_sample(coarse, coords)
        feat = torch.cat([point_sample(fine, coords), coarse_pts], 1)
        for i in range(self.num_fcs):
            feat = F.relu(getattr(self, f'fc{i}')(feat))
            if self.coarse_pred_each_layer:
                feat = torch.cat([feat, coarse_pts], 1)
        return self.fc_seg(feat)

    @staticmethod
    def uncertainty(logits: torch.Tensor) -> torch.Tensor:
        """``top2[1] - top2[0]`` over the classes (axis 1): 0 where the two
        best tie, more negative the more certain."""
        top2 = torch.topk(logits, 2, dim=1).values
        return top2[:, 1] - top2[:, 0]

    def top_uncertain(self, uncertainty: torch.Tensor, k: int) -> torch.Tensor:
        """The indices (B, k) of the ``k`` largest of (B, N) ``uncertainty``,
        largest first, equal values in index order, as ``jax.lax.top_k``
        breaks ties (``torch.topk`` leaves their order to the device, and
        points sampled in a map's clamped border tie exactly): the head's
        discrete decision."""
        order = torch.sort(uncertainty, dim=1, descending=True, stable=True)
        return order.indices[:, :k]

    def select_points(self, coarse: torch.Tensor, candidates: torch.Tensor,
                      fresh: Optional[torch.Tensor]) -> torch.Tensor:
        """The training points: of (B, n_over, 2) ``candidates`` the most
        uncertain on ``coarse`` sampled there, then ``fresh`` (B, n, 2)."""
        unc = self.uncertainty(point_sample(coarse, candidates))
        idx = self.top_uncertain(unc, self.n_important)
        coords = torch.gather(candidates, 1, idx.unsqueeze(-1).expand(-1, -1, 2))
        if fresh is not None:
            coords = torch.cat([coords, fresh], 1)
        return coords.detach()

    def train_points(self, coarse: torch.Tensor) -> torch.Tensor:
        """Uniform candidates and fresh points drawn from ``generator`` on
        the CPU, moved to ``coarse``'s device, then :meth:`select_points`."""
        B = coarse.shape[0]
        n_rand = self.num_points - self.n_important
        cand = torch.rand((B, self.n_over, 2), generator=self.generator)
        fresh = (torch.rand((B, n_rand, 2), generator=self.generator)
                 if n_rand > 0 else None)
        move = dict(device=coarse.device, dtype=coarse.dtype)
        return self.select_points(coarse, cand.to(**move),
                                  fresh.to(**move) if fresh is not None else None)

    def forward(self, inputs, prev_output=None, with_aux: bool = True):
        """(logits, point logits, coordinates) of the selected fine map and
        the previous stage's logits ``prev_output`` (see the module
        docstring)."""
        if prev_output is None:
            raise ValueError('PointHead is a cascade head: it needs the '
                             "previous stage's logits")
        fine = select_inputs(inputs, self.in_index, self.input_transform,
                             self.align_corners)
        if isinstance(fine, (list, tuple)):
            fine = fine[0]
        coarse = prev_output
        if self.training:
            coords = self.train_points(coarse)
            return coarse, self.mlp(fine, coarse, coords), coords
        refined, point_logits, coords = coarse, None, None
        B, C = coarse.shape[:2]
        for _ in range(self.subdivision_steps):
            H = refined.shape[-2] * self.scale_factor
            W = refined.shape[-1] * self.scale_factor
            refined = resize_bilinear(refined, (H, W), self.align_corners)
            k = min(self.subdivision_num_points, H * W)
            idx = self.top_uncertain(self.uncertainty(refined).reshape(B, H * W), k)
            xs = (idx % W).to(refined.dtype)
            ys = torch.div(idx, W, rounding_mode='floor').to(refined.dtype)
            coords = torch.stack([(xs + 0.5) / W, (ys + 0.5) / H], -1)
            point_logits = self.mlp(fine, coarse, coords)
            refined = refined.reshape(B, C, H * W).scatter(
                2, idx.unsqueeze(1).expand(-1, C, -1), point_logits
            ).reshape(B, C, H, W)
        return refined, point_logits, coords

    def loss_by_feat(self, seg_logits, seg_label) -> Dict[str, torch.Tensor]:
        _, point_logits, coords = seg_logits
        label = sem_label(seg_label)
        B, H, W = label.shape[-3:]
        ix = (coords[..., 0] * W).long().clamp(0, W - 1)
        iy = (coords[..., 1] * H).long().clamp(0, H - 1)
        pts = label.reshape(B, H * W).gather(1, iy * W + ix)
        pix, valid = pixelwise_cross_entropy(point_logits, pts, self.ignore_index)
        return {'loss_point': pix.sum() / valid.sum().clamp(min=1)}

    def predict_by_feat(self, seg_logits, size=None):
        refined = seg_logits[0] if isinstance(seg_logits, tuple) else seg_logits
        if size is None:
            return refined
        return resize_bilinear(refined, size, self.align_corners)
