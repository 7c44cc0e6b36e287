"""IoU metric.

Counterpart of ``lednet_tpu/evaluation/iou_metric.py`` (``IoUMetric`` :46,
``process``, ``compute_metrics`` :88, ``table`` :114): per-class intersect,
union, prediction and label areas over the pixels whose label is not
``ignore_index``, summed over the dataset, then IoU and Acc (and Dice or
Fscore) per class and aAcc/mIoU/mAcc, in percent rounded to 2 decimals.

The areas are int64 ``torch.bincount`` histograms kept on the predictions'
device; they come to the host once, in :meth:`IoUMetric.compute_metrics`.
(The JAX package sums float32 counts per batch and float64 ones on the
host.)  Labels at or above the class count that are not ignored fall out of
the label histogram, as the JAX scatter drops them.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lednet_tpu_torch.registry import METRICS


def intersect_and_union(pred: torch.Tensor, label: torch.Tensor,
                        num_classes: int, ignore_index: int = 255) -> torch.Tensor:
    """(4, C) int64: intersect, union, pred_area, label_area."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).to(pred.device).long()
    valid = label != ignore_index
    spill = torch.full_like(label, num_classes)  # a bin past the classes

    def hist(keep, values):
        idx = torch.where(keep & (values >= 0) & (values < num_classes),
                          values, spill)
        return torch.bincount(idx, minlength=num_classes + 1)[:num_classes]

    label_area = hist(valid, label)
    pred_area = hist(valid, pred)
    intersect = hist(valid & (pred == label), label)
    return torch.stack([intersect, pred_area + label_area - intersect,
                        pred_area, label_area])


@METRICS.register_module()
class IoUMetric:
    def __init__(self, ignore_index: int = 255,
                 iou_metrics: Sequence[str] = ('mIoU',),
                 nan_to_num: Optional[int] = None, beta: int = 1,
                 collect_device: str = 'cpu', output_dir: Optional[str] = None,
                 format_only: bool = False, prefix: Optional[str] = None,
                 **kwargs):
        self.ignore_index = ignore_index
        self.metrics = list(iou_metrics)
        self.nan_to_num = nan_to_num
        self.beta = beta
        self.output_dir = output_dir
        self.format_only = format_only
        self.class_names: Optional[Sequence[str]] = None
        self._totals: Optional[torch.Tensor] = None
        self._dump_count = 0

    def reset(self):
        self._totals = None
        self._dump_count = 0

    def process(self, pred: torch.Tensor, label: torch.Tensor,
                num_classes: int) -> None:
        """Add a batch: ``pred`` (B, H, W) or (H, W) class indices and
        ``label`` of the same shape (any device; counted on ``pred``'s)."""
        pred, label = torch.as_tensor(pred), torch.as_tensor(label)
        if self.output_dir:
            from lednet_tpu_torch.datasets import imageio
            os.makedirs(self.output_dir, exist_ok=True)
            planes = pred.reshape(-1, *pred.shape[-2:]).to(torch.uint8).cpu().numpy()
            for plane in planes:
                imageio.imwrite(os.path.join(
                    self.output_dir, f'pred_{self._dump_count:06d}.png'), plane)
                self._dump_count += 1
        if self.format_only:
            return
        counts = intersect_and_union(pred, label, num_classes, self.ignore_index)
        self._totals = counts if self._totals is None else self._totals + counts

    def compute_metrics(self) -> Dict[str, float]:
        if self._totals is None:
            raise RuntimeError('IoUMetric: no samples processed')
        intersect, union, pred_area, label_area = \
            self._totals.cpu().numpy().astype(np.float64)
        results: Dict[str, float] = {}
        with np.errstate(divide='ignore', invalid='ignore'):
            results['aAcc'] = _pct(intersect.sum() / label_area.sum())
            per_class = {'IoU': intersect / union, 'Acc': intersect / label_area}
            if 'mDice' in self.metrics:
                per_class['Dice'] = 2 * intersect / (pred_area + label_area)
            if 'mFscore' in self.metrics:
                precision = intersect / pred_area
                recall = intersect / label_area
                b2 = self.beta ** 2
                per_class.update(
                    Fscore=(1 + b2) * precision * recall / (b2 * precision + recall),
                    Precision=precision, Recall=recall)
        for name, vals in per_class.items():
            if self.nan_to_num is not None:
                vals = np.nan_to_num(vals, nan=self.nan_to_num)
            results[f'm{name}'] = _pct(np.nanmean(vals))
        self._per_class = {k: np.round(v * 100, 2) for k, v in per_class.items()}
        return results

    def table(self) -> str:
        """Per-class results (the reference prints a PrettyTable)."""
        names = self.class_names or [
            str(i) for i in range(len(next(iter(self._per_class.values()))))]
        cols = ['Class'] + list(self._per_class)
        rows = [[n] + [f'{self._per_class[c][i]:.2f}' for c in self._per_class]
                for i, n in enumerate(names)]
        widths = [max(len(str(r[i])) for r in [cols] + rows)
                  for i in range(len(cols))]

        def fmt(row):
            return ' | '.join(str(v).ljust(w) for v, w in zip(row, widths))
        sep = '-+-'.join('-' * w for w in widths)
        return '\n'.join([fmt(cols), sep] + [fmt(r) for r in rows])


def _pct(v: float) -> float:
    return float(np.round(v * 100, 2))
