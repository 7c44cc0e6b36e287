"""Loading transforms.

Counterpart of ``lednet_tpu/datasets/transforms/loading.py``
(``LoadImageFromFile`` :20, ``LoadImageFromNDArray`` :42,
``LoadAnnotations`` :57), reading through the port's PNG codec
(:mod:`lednet_tpu_torch.datasets.imageio`) instead of cv2 and PIL.
Transforms are called as ``t(results, rng)``; these draw nothing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from lednet_tpu_torch.datasets import imageio
from lednet_tpu_torch.registry import TRANSFORMS


@TRANSFORMS.register_module()
class LoadImageFromFile:
    """BGR uint8 (``color_type='color'``, ``cv2.IMREAD_COLOR``) or gray."""

    def __init__(self, to_float32: bool = False, color_type: str = 'color',
                 imdecode_backend: str = 'cv2', backend_args=None,
                 ignore_empty: bool = False):
        self.to_float32 = to_float32
        self.color_type = color_type

    def _set(self, results: Dict, img: np.ndarray) -> Dict:
        if self.to_float32:
            img = img.astype(np.float32)
        results['img'] = img
        results['img_shape'] = img.shape[:2]
        results['ori_shape'] = img.shape[:2]
        return results

    def __call__(self, results: Dict, rng=None) -> Dict:
        flag = 'color' if self.color_type == 'color' else 'grayscale'
        return self._set(results, imageio.imread(results['img_path'], flag))


@TRANSFORMS.register_module()
class LoadImageFromNDArray(LoadImageFromFile):
    """The array passed as ``results['img']`` (the inference APIs)."""

    def __call__(self, results: Dict, rng=None) -> Dict:
        results['img_path'] = None
        return self._set(results, results['img'])


@TRANSFORMS.register_module()
class LoadAnnotations:
    """The label map: with the default ``'pillow'`` backend a palette PNG
    gives its indices (PIL's reading), a color one its first (R) plane;
    ``'cv2'`` reads as ``cv2.IMREAD_UNCHANGED`` (first plane B).  Then
    ``reduce_zero_label`` (0 -> 255, x -> x - 1) and ``label_map``."""

    def __init__(self, reduce_zero_label=None, imdecode_backend: str = 'pillow',
                 backend_args=None):
        self.reduce_zero_label = reduce_zero_label
        self.imdecode_backend = imdecode_backend

    def __call__(self, results: Dict, rng=None) -> Dict:
        path = results['seg_map_path']
        seg = (imageio.imread_pil(path) if self.imdecode_backend == 'pillow'
               else imageio.imread(path, 'unchanged'))
        if seg.ndim == 3:
            seg = seg[:, :, 0]
        reduce_zero = self.reduce_zero_label
        if reduce_zero is None:
            reduce_zero = results.get('reduce_zero_label', False)
        if reduce_zero:
            seg = seg.astype(np.int32)
            seg[seg == 0] = 256
            seg = (seg - 1).astype(np.uint8)
        label_map = results.get('label_map')
        if label_map:
            out = seg.copy()
            for old, new in label_map.items():
                out[seg == old] = new
            seg = out
        results['gt_seg_map'] = seg
        results.setdefault('seg_fields', []).append('gt_seg_map')
        return results
