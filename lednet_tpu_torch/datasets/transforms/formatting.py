"""``PackSegInputs``, the pipeline's last transform.

Counterpart of ``lednet_tpu/datasets/transforms/formatting.py:23``: the image
as contiguous HWC uint8 (BGR), labels as int32, and a flat meta dict.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from lednet_tpu_torch.registry import TRANSFORMS

META_KEYS = ('img_path', 'seg_map_path', 'ori_shape', 'img_shape',
             'pad_shape', 'scale_factor', 'flip', 'flip_direction',
             'reduce_zero_label', 'sample_idx')


@TRANSFORMS.register_module()
class PackSegInputs:
    def __init__(self, meta_keys: Sequence[str] = META_KEYS):
        self.meta_keys = meta_keys

    def __call__(self, results: Dict, rng=None) -> Dict:
        img = results['img']
        if img.ndim == 2:
            img = img[..., None]
        packed = {'inputs': np.ascontiguousarray(img)}
        for key in ('gt_seg_map', 'gt_edge_map'):
            if key in results:
                packed[key] = results[key].astype(np.int32)
        packed['metainfo'] = {k: results.get(k) for k in self.meta_keys
                              if k in results}
        return packed
