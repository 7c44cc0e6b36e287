"""``FusedRandomResizeCropFlip``: the Apple Branch train pipeline's geometry.

Counterpart of ``lednet_tpu/datasets/transforms/fused.py:22``: the
RandomResize -> RandomCrop -> RandomFlip chain drawn as there (a ratio in
``ratio_range`` against ``scale=(w, h)`` with a keep-ratio rescale, a crop
origin re-drawn up to 10 times while one class covers ``cat_max_ratio`` of
the crop's labels, the flip coin) and run as one pass per array in the host
library (:func:`lednet_tpu_torch.native.fused_resize_crop_flip`, the JAX
package's arithmetic bit for bit).  The draws come from the sample's
``RandomState``, in the JAX transform's order, so ``RandomState(s)`` draws
what the JAX transform draws after ``np.random.seed(s)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from lednet_tpu_torch import native
from lednet_tpu_torch.datasets.transforms.transforms import _need_rng, class_counts
from lednet_tpu_torch.registry import TRANSFORMS


@TRANSFORMS.register_module()
class FusedRandomResizeCropFlip:
    def __init__(self, scale: Tuple[int, int], crop_size: Tuple[int, int],
                 ratio_range: Tuple[float, float] = (0.5, 2.0),
                 cat_max_ratio: float = 1.0, flip_prob: float = 0.5,
                 ignore_index: int = 255):
        self.scale = scale          # (w, h)
        self.crop_size = crop_size  # (h, w)
        self.ratio_range = ratio_range
        self.cat_max_ratio = cat_max_ratio
        self.flip_prob = flip_prob
        self.ignore_index = ignore_index

    def _origin(self, rh, rw, ch, cw, rng):
        return (rng.randint(0, max(rh - ch, 0) + 1),
                rng.randint(0, max(rw - cw, 0) + 1))

    def _sample_geometry(self, h: int, w: int, rng):
        lo, hi = self.ratio_range
        ratio = rng.random_sample() * (hi - lo) + lo
        target = (int(self.scale[0] * ratio), int(self.scale[1] * ratio))
        f = min(max(target) / max(h, w), min(target) / min(h, w))
        rw, rh = int(w * f + 0.5), int(h * f + 0.5)
        ch, cw = min(self.crop_size[0], rh), min(self.crop_size[1], rw)
        cy, cx = self._origin(rh, rw, ch, cw, rng)
        flip = rng.rand() < self.flip_prob
        return rh, rw, cy, cx, ch, cw, flip

    def __call__(self, results: Dict, rng=None) -> Dict:
        rng = _need_rng(rng, 'FusedRandomResizeCropFlip')
        img = results['img']
        h, w = img.shape[:2]
        gt = results.get('gt_seg_map')
        rh, rw, cy, cx, ch, cw, flip = self._sample_geometry(h, w, rng)
        if self.cat_max_ratio < 1.0 and gt is not None:
            labels = gt.astype(np.uint8)
            for _ in range(10):
                crop = native.fused_resize_crop_flip(
                    labels, (rh, rw), (cy, cx), (ch, cw), False, nearest=True)
                cnt = class_counts(crop, self.ignore_index)
                if len(cnt) > 1 and cnt.max() / cnt.sum() < self.cat_max_ratio:
                    break
                cy, cx = self._origin(rh, rw, ch, cw, rng)   # origin only
        results['img'] = native.fused_resize_crop_flip(
            img, (rh, rw), (cy, cx), (ch, cw), flip, nearest=False)
        results['img_shape'] = (ch, cw)
        results['scale_factor'] = (rw / w, rh / h)
        results['flip'] = bool(flip)
        results['flip_direction'] = 'horizontal' if flip else None
        for key in results.get('seg_fields', []):
            arr = results[key]
            out = native.fused_resize_crop_flip(
                arr.astype(np.uint8), (rh, rw), (cy, cx), (ch, cw), flip,
                nearest=True)
            results[key] = out.astype(arr.dtype)
        return results
