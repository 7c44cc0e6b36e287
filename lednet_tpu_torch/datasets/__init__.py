"""Datasets, transforms and loading (counterpart of ``lednet_tpu/datasets``).

Importing this package registers the datasets in ``DATASETS`` and the
transforms in ``TRANSFORMS``.
"""
from lednet_tpu_torch.datasets import transforms  # noqa: F401
from lednet_tpu_torch.datasets.basesegdataset import (ADE20KDataset,
                                                      BaseSegDataset,
                                                      CityscapesDataset,
                                                      Compose,
                                                      PascalVOCDataset)
from lednet_tpu_torch.datasets.loader import (DataLoader, DefaultSampler,
                                              DevicePrefetcher,
                                              InfiniteSampler,
                                              build_dataloader, collate)
from lednet_tpu_torch.datasets.more_datasets import (
    COCOStuffDataset, ChaseDB1Dataset, ConcatDataset, DRIVEDataset,
    HRFDataset, ISPRSDataset, LoveDADataset, PascalContextDataset,
    PascalContextDataset59, PotsdamDataset, RepeatDataset, STAREDataset,
    VaihingenDataset, configure_datasets, iSAIDDataset)

__all__ = ['ADE20KDataset', 'BaseSegDataset', 'COCOStuffDataset',
           'ChaseDB1Dataset', 'CityscapesDataset', 'Compose', 'ConcatDataset',
           'DRIVEDataset', 'DataLoader', 'DefaultSampler', 'DevicePrefetcher',
           'HRFDataset', 'ISPRSDataset', 'InfiniteSampler', 'LoveDADataset',
           'PascalContextDataset', 'PascalContextDataset59',
           'PascalVOCDataset', 'PotsdamDataset', 'RepeatDataset',
           'STAREDataset', 'VaihingenDataset', 'build_dataloader', 'collate',
           'configure_datasets', 'iSAIDDataset']
