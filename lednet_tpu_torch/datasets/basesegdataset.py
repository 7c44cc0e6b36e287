"""Base segmentation dataset, ``Compose`` and the datasets of the LED configs.

Counterpart of ``lednet_tpu/datasets/basesegdataset.py`` (``Compose`` :31,
``BaseSegDataset`` :44 with ``load_data_list`` :104, ``PascalVOCDataset``
:154, ``CityscapesDataset`` :169, ``ADE20KDataset`` :190): suffix-pair directory scanning (a sorted
recursive walk) or an ``ann_file`` split list, ``METAINFO`` classes and
palette, ``reduce_zero_label``, the pipeline run per item.

Every random transform draws from an ``np.random.RandomState`` that the
caller passes (``dataset.prepare(idx, rng)``; the loader seeds one per
sample), where the JAX package's transforms draw from the global
``np.random``.  ``dataset[idx]`` seeds ``RandomState(idx)``.
"""
from __future__ import annotations

import copy
import os
import os.path as osp
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from lednet_tpu_torch.datasets import metainfo as _metainfo
from lednet_tpu_torch.registry import DATASETS, TRANSFORMS


def build_pipeline(pipeline) -> List[Callable]:
    return [t if callable(t) else TRANSFORMS.build(dict(t))
            for t in pipeline or []]


class Compose:
    """Run transforms in order; each is called as ``t(results, rng)``."""

    def __init__(self, transforms):
        self.transforms = build_pipeline(transforms)

    def __call__(self, results: Dict,
                 rng: Optional[np.random.RandomState] = None) -> Optional[Dict]:
        for t in self.transforms:
            results = t(results, rng)
            if results is None:
                return None
        return results


@DATASETS.register_module()
class BaseSegDataset:
    METAINFO: Dict[str, Any] = {}

    def __init__(self,
                 data_root: Optional[str] = None,
                 data_prefix: Optional[Dict[str, str]] = None,
                 ann_file: str = '',
                 img_suffix: str = '.jpg',
                 seg_map_suffix: str = '.png',
                 pipeline: Sequence = (),
                 metainfo: Optional[Dict] = None,
                 reduce_zero_label: bool = False,
                 ignore_index: int = 255,
                 test_mode: bool = False,
                 lazy_init: bool = False,
                 indices: Optional[Sequence[int]] = None,
                 serialize_data: bool = True,
                 max_refetch: int = 1000,
                 backend_args=None,
                 **kwargs):
        """``serialize_data``, ``max_refetch``, ``backend_args`` and other
        mmengine keys are accepted and unused, as in the JAX package."""
        self.data_root = data_root
        self.data_prefix = dict(img_path='', seg_map_path='')
        if data_prefix:
            self.data_prefix.update(data_prefix)
        self.ann_file = ann_file
        self.img_suffix = img_suffix
        self.seg_map_suffix = seg_map_suffix
        self.reduce_zero_label = reduce_zero_label
        self.ignore_index = ignore_index
        self.test_mode = test_mode
        self.pipeline = Compose(pipeline)
        self._metainfo = dict(self.METAINFO)
        if metainfo:
            self._metainfo.update(metainfo)
        self._metainfo.setdefault('reduce_zero_label', self.reduce_zero_label)
        self._indices = indices
        self.data_list: List[Dict] = []
        self._fully_initialized = False
        if not lazy_init:
            self.full_init()

    @property
    def metainfo(self) -> Dict:
        return copy.deepcopy(self._metainfo)

    def full_init(self):
        if self._fully_initialized:
            return
        self.data_list = self.load_data_list()
        if self._indices is not None:
            self.data_list = [self.data_list[i] for i in self._indices]
        self._fully_initialized = True

    def _join(self, prefix: str) -> str:
        if self.data_root and not osp.isabs(prefix):
            return osp.join(self.data_root, prefix)
        return prefix

    def load_data_list(self) -> List[Dict]:
        img_dir = self._join(self.data_prefix.get('img_path', ''))
        ann_dir = self._join(self.data_prefix.get('seg_map_path', ''))
        data_list = []
        if self.ann_file:
            with open(self._join(self.ann_file), encoding='utf-8') as f:
                stems = [ln.strip() for ln in f if ln.strip()]
            for stem in stems:
                item = dict(img_path=osp.join(img_dir, stem + self.img_suffix))
                if ann_dir:
                    item['seg_map_path'] = osp.join(ann_dir,
                                                    stem + self.seg_map_suffix)
                data_list.append(item)
        elif osp.isdir(img_dir):
            for root, _, files in sorted(os.walk(img_dir)):
                for fn in sorted(files):
                    if not fn.endswith(self.img_suffix):
                        continue
                    rel = osp.relpath(osp.join(root, fn), img_dir)
                    item = dict(img_path=osp.join(img_dir, rel))
                    if ann_dir:
                        item['seg_map_path'] = osp.join(
                            ann_dir, rel[:-len(self.img_suffix)] + self.seg_map_suffix)
                    data_list.append(item)
        for item in data_list:
            item['label_map'] = None
            item['reduce_zero_label'] = self.reduce_zero_label
            item['seg_fields'] = []
        return data_list

    def __len__(self) -> int:
        return len(self.data_list)

    def get_data_info(self, idx: int) -> Dict:
        info = copy.deepcopy(self.data_list[idx])
        info['sample_idx'] = idx
        return info

    def prepare(self, idx: int, rng: np.random.RandomState) -> Dict:
        """Item ``idx`` through the pipeline, its random draws from ``rng``."""
        data = self.pipeline(self.get_data_info(idx), rng)
        if data is None:
            raise RuntimeError(f'pipeline returned None for index {idx}')
        return data

    def __getitem__(self, idx: int) -> Dict:
        return self.prepare(idx, np.random.RandomState(idx))


@DATASETS.register_module()
class PascalVOCDataset(BaseSegDataset):
    """VOC-style dataset with the fork's 2-class Apple-Branch task."""
    METAINFO = dict(classes=_metainfo.APPLE_BRANCH_CLASSES,
                    palette=_metainfo.APPLE_BRANCH_PALETTE)

    def __init__(self, ann_file='', img_suffix='.png',
                 seg_map_suffix='.png', **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         ann_file=ann_file, **kwargs)


@DATASETS.register_module()
class CityscapesDataset(BaseSegDataset):
    """Cityscapes: ``*_leftImg8bit.png`` with ``*_gtFine_labelTrainIds.png``."""
    METAINFO = dict(classes=_metainfo.CITYSCAPES_CLASSES,
                    palette=_metainfo.CITYSCAPES_PALETTE)

    def __init__(self, img_suffix='_leftImg8bit.png',
                 seg_map_suffix='_gtFine_labelTrainIds.png', **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


@DATASETS.register_module()
class ADE20KDataset(BaseSegDataset):
    """ADE20K: ``.jpg`` images with ``.png`` labels 0..150, where 0 is
    "other"; ``reduce_zero_label`` maps 0 to 255 (ignored) and x to x - 1,
    so that the 150 classes are 0..149."""
    METAINFO = dict(classes=_metainfo.ADE20K_CLASSES,
                    palette=_metainfo.ADE20K_PALETTE)

    def __init__(self, img_suffix='.jpg', seg_map_suffix='.png',
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         reduce_zero_label=reduce_zero_label, **kwargs)
