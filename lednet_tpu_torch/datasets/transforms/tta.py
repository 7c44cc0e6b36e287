"""``TestTimeAug``: one packed view per combination of its sub-transforms.

Counterpart of ``lednet_tpu/datasets/transforms/tta.py:21``: the cartesian
product of the transform lists (the LED configs' 6 scales x 2 flips, then
``LoadAnnotations`` and ``PackSegInputs``), each applied to a copy of the
sample; returns ``{'tta_views': [view, ...]}``.  Every view passes the
sample's ``rng`` on to its transforms.
"""
from __future__ import annotations

import copy
import itertools
from typing import Dict, List, Sequence

from lednet_tpu_torch.registry import TRANSFORMS


@TRANSFORMS.register_module()
class TestTimeAug:
    def __init__(self, transforms: Sequence[Sequence[Dict]]):
        from lednet_tpu_torch.datasets.basesegdataset import build_pipeline
        self.subpipelines = [build_pipeline(branch) for branch in transforms]

    def __call__(self, results: Dict, rng=None) -> Dict:
        views: List[Dict] = []
        for combo in itertools.product(*[range(len(b))
                                         for b in self.subpipelines]):
            view = copy.deepcopy(results)
            for branch, idx in zip(self.subpipelines, combo):
                view = branch[idx](view, rng)
                if view is None:
                    break
            if view is not None:
                views.append(view)
        return dict(tta_views=views)
