"""The datasets of the slide-inference, COCO-Stuff and remote-sensing
configs, and the dataset wrappers.

Counterpart of ``lednet_tpu/datasets/more_datasets.py``
(``COCOStuffDataset`` :13, ``PascalContextDataset`` :24, ``LoveDADataset``
:34, ``PotsdamDataset`` :48, ``VaihingenDataset`` :62, ``ISPRSDataset``
:67, ``iSAIDDataset`` :72, ``_RetinaDataset`` :134, ``DRIVEDataset`` :144,
``STAREDataset`` :152, ``ChaseDB1Dataset`` :159, ``HRFDataset`` :167,
``ConcatDataset`` :248, ``RepeatDataset`` :285, ``PascalContextDataset59``
:335): each dataset is ``METAINFO`` and suffix conventions over
:class:`BaseSegDataset`.

- Pascal Context: ``JPEGImages/<name>.jpg`` with
  ``SegmentationClassContext/<name>.png`` labels 0..59 (0 background),
  listed by an ``ann_file`` split list.  The 59-class set drops the
  background: ``reduce_zero_label`` maps 0 to 255 (ignored) and x to x - 1.
- The retina sets (DRIVE, STARE, CHASE_DB1, HRF): ``.png`` images with
  0/1 vessel labels, each set with its own label suffix.
- COCO-Stuff: ``.jpg`` photos with ``_labelTrainIds.png`` labels 0..170.
- iSAID: ``.png`` tiles with ``_instance_color_RGB.png`` labels 0..15
  (a 3-channel label file gives its first plane, as ``LoadAnnotations``
  reads it: R under pillow, B under cv2).
- LoveDA, Potsdam, Vaihingen (``ISPRSDataset`` is Vaihingen's name in its
  config): ``.png`` tiles and labels whose 0 is ignored
  (``reduce_zero_label``).

The wrappers take nested dataset configs, as the JAX package's
``_build_dataset`` (:242) does.  The loader calls ``prepare(idx, rng)``
with each sample's own ``RandomState``; a wrapper hands that call, the same
``rng``, to the dataset that holds the index.  ``metainfo`` (a checkpoint's
``dataset_meta`` too) is the first child's or the inner dataset's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from lednet_tpu_torch.datasets import metainfo as _metainfo
from lednet_tpu_torch.datasets.basesegdataset import BaseSegDataset
from lednet_tpu_torch.registry import DATASETS


@DATASETS.register_module()
class COCOStuffDataset(BaseSegDataset):
    METAINFO = dict(classes=_metainfo.COCOSTUFF_CLASSES,
                    palette=_metainfo.COCOSTUFF_PALETTE)

    def __init__(self, img_suffix='.jpg', seg_map_suffix='_labelTrainIds.png',
                 **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


@DATASETS.register_module()
class PascalContextDataset(BaseSegDataset):
    METAINFO = dict(classes=_metainfo.PASCAL_CONTEXT_CLASSES,
                    palette=_metainfo.PASCAL_CONTEXT_PALETTE)

    def __init__(self, img_suffix='.jpg', seg_map_suffix='.png', **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


@DATASETS.register_module()
class PascalContextDataset59(BaseSegDataset):
    METAINFO = dict(classes=_metainfo.PASCAL_CONTEXT_59_CLASSES,
                    palette=_metainfo.PASCAL_CONTEXT_59_PALETTE)

    def __init__(self, ann_file='', img_suffix='.jpg', seg_map_suffix='.png',
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         ann_file=ann_file,
                         reduce_zero_label=reduce_zero_label, **kwargs)


@DATASETS.register_module()
class LoveDADataset(BaseSegDataset):
    METAINFO = dict(classes=_metainfo.LOVEDA_CLASSES,
                    palette=_metainfo.LOVEDA_PALETTE)

    def __init__(self, img_suffix='.png', seg_map_suffix='.png',
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         reduce_zero_label=reduce_zero_label, **kwargs)


@DATASETS.register_module()
class PotsdamDataset(BaseSegDataset):
    METAINFO = dict(classes=_metainfo.ISPRS_CLASSES,
                    palette=_metainfo.ISPRS_PALETTE)

    def __init__(self, img_suffix='.png', seg_map_suffix='.png',
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         reduce_zero_label=reduce_zero_label, **kwargs)


@DATASETS.register_module()
class VaihingenDataset(PotsdamDataset):
    pass


@DATASETS.register_module()
class ISPRSDataset(PotsdamDataset):
    pass


@DATASETS.register_module()
class iSAIDDataset(BaseSegDataset):
    METAINFO = dict(classes=_metainfo.ISAID_CLASSES,
                    palette=_metainfo.ISAID_PALETTE)

    def __init__(self, img_suffix='.png',
                 seg_map_suffix='_instance_color_RGB.png', **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


class _RetinaDataset(BaseSegDataset):
    METAINFO = dict(classes=_metainfo.RETINA_CLASSES,
                    palette=_metainfo.RETINA_PALETTE)

    def __init__(self, img_suffix='.png', seg_map_suffix='.png', **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


@DATASETS.register_module()
class DRIVEDataset(_RetinaDataset):
    def __init__(self, img_suffix='.png', seg_map_suffix='_manual1.png',
                 **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


@DATASETS.register_module()
class STAREDataset(_RetinaDataset):
    def __init__(self, img_suffix='.png', seg_map_suffix='.ah.png', **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


@DATASETS.register_module()
class ChaseDB1Dataset(_RetinaDataset):
    def __init__(self, img_suffix='.png', seg_map_suffix='_1stHO.png',
                 **kwargs):
        super().__init__(img_suffix=img_suffix, seg_map_suffix=seg_map_suffix,
                         **kwargs)


@DATASETS.register_module()
class HRFDataset(_RetinaDataset):
    pass


# ------------------------------------------------------------------ wrappers
def _build_dataset(dataset, lazy_init: bool):
    """A dataset from its config (a built one passes through); a lazy
    wrapper builds its children lazy too."""
    if not isinstance(dataset, dict):
        return dataset
    cfg = dict(dataset)
    if lazy_init:
        cfg.setdefault('lazy_init', True)
    return DATASETS.build(cfg)


def _in_range(idx: int, n: int) -> int:
    """``idx`` (negative from the end) as an index of 0..n-1, or
    ``IndexError``."""
    if not -n <= idx < n:
        raise IndexError(f'index {idx} out of range for {n} items')
    return idx + n if idx < 0 else idx


class _Wrapper:
    """What a wrapper shares: ``full_init`` of its children, and items as
    the base dataset gives them (``dataset[idx]`` seeds
    ``RandomState(idx)``)."""

    def children(self) -> List:
        raise NotImplementedError

    def full_init(self):
        for child in self.children():
            child.full_init()

    def locate(self, idx: int) -> Tuple[object, int]:
        raise NotImplementedError

    def get_data_info(self, idx: int) -> Dict:
        ds, local = self.locate(idx)
        return ds.get_data_info(local)

    def prepare(self, idx: int, rng: np.random.RandomState) -> Dict:
        """Item ``idx`` of the child that holds it, through that child's
        pipeline, its random draws from ``rng``."""
        ds, local = self.locate(idx)
        return ds.prepare(local, rng)

    def __getitem__(self, idx: int) -> Dict:
        return self.prepare(idx, np.random.RandomState(_in_range(idx, len(self))))


@DATASETS.register_module()
class ConcatDataset(_Wrapper):
    """The children's items in turn (VOC's train list, then SBD's aug
    list, ``configs/_base_/datasets/pascal_voc12_aug.py``).  ``metainfo``
    is the first child's; ``ignore_keys`` is accepted and unread, as in
    the JAX package."""

    def __init__(self, datasets: Sequence, lazy_init: bool = False,
                 ignore_keys=None, **kwargs):
        self.datasets = [_build_dataset(d, lazy_init) for d in datasets]

    def children(self) -> List:
        return self.datasets

    @property
    def metainfo(self) -> Dict:
        return self.datasets[0].metainfo

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def locate(self, idx: int) -> Tuple[object, int]:
        idx = _in_range(idx, len(self))
        for ds in self.datasets[:-1]:
            if idx < len(ds):
                return ds, idx
            idx -= len(ds)
        return self.datasets[-1], idx


@DATASETS.register_module()
class RepeatDataset(_Wrapper):
    """``dataset``'s items ``times`` over (the retina configs train on 20
    frames with ``times=40000``): index i is item i mod n.  The JAX
    wrapper takes any index modulo n; this one raises ``IndexError``
    outside -len..len-1, as a sequence does."""

    def __init__(self, dataset, times: int = 1, lazy_init: bool = False,
                 **kwargs):
        self.dataset = _build_dataset(dataset, lazy_init)
        self.times = times

    def children(self) -> List:
        return [self.dataset]

    @property
    def metainfo(self) -> Dict:
        return self.dataset.metainfo

    def __len__(self) -> int:
        return self.times * len(self.dataset)

    def locate(self, idx: int) -> Tuple[object, int]:
        return self.dataset, _in_range(idx, len(self)) % len(self.dataset)


def configure_datasets(dataset_cfg: Dict, **fields) -> Dict:
    """``dataset_cfg`` with ``fields`` set in every dataset it builds,
    through the wrappers (``datasets`` or ``dataset``): the test CLI's
    ``--tta`` sets ``pipeline``; a run on another tree sets ``data_root``."""
    cfg = dict(dataset_cfg)
    if 'datasets' in cfg:
        cfg['datasets'] = [configure_datasets(d, **fields) for d in cfg['datasets']]
    elif isinstance(cfg.get('dataset'), dict):
        cfg['dataset'] = configure_datasets(cfg['dataset'], **fields)
    else:
        cfg.update(fields)
    return cfg
