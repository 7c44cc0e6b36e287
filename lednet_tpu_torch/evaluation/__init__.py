"""Evaluation metrics (counterpart of ``lednet_tpu/evaluation``)."""
from lednet_tpu_torch.evaluation.iou_metric import IoUMetric, intersect_and_union

__all__ = ['IoUMetric', 'intersect_and_union']
