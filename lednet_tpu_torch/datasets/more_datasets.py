"""The datasets of the slide-inference configs: Pascal Context (60 and 59
classes) and the retina vessel datasets.

Counterpart of ``lednet_tpu/datasets/more_datasets.py``
(``PascalContextDataset`` :24, ``_RetinaDataset`` :134, ``DRIVEDataset``
:144, ``STAREDataset`` :152, ``ChaseDB1Dataset`` :159, ``HRFDataset`` :167,
``PascalContextDataset59`` :335): each is ``METAINFO`` and suffix
conventions over :class:`BaseSegDataset`.

- Pascal Context: ``JPEGImages/<name>.jpg`` with
  ``SegmentationClassContext/<name>.png`` labels 0..59 (0 background),
  listed by an ``ann_file`` split list.  The 59-class set drops the
  background: ``reduce_zero_label`` maps 0 to 255 (ignored) and x to x - 1.
- The retina sets (DRIVE, STARE, CHASE_DB1, HRF): ``.png`` images with
  0/1 vessel labels, each set with its own label suffix.
"""
from __future__ import annotations

from lednet_tpu_torch.datasets import metainfo as _metainfo
from lednet_tpu_torch.datasets.basesegdataset import BaseSegDataset
from lednet_tpu_torch.registry import DATASETS


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
