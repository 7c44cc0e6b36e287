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
from lednet_tpu_torch.datasets.more_datasets import (ChaseDB1Dataset,
                                                     DRIVEDataset, HRFDataset,
                                                     PascalContextDataset,
                                                     PascalContextDataset59,
                                                     STAREDataset)

__all__ = ['ADE20KDataset', 'BaseSegDataset', 'ChaseDB1Dataset',
           'CityscapesDataset', 'Compose', 'DRIVEDataset', 'DataLoader',
           'DefaultSampler', 'DevicePrefetcher', 'HRFDataset',
           'InfiniteSampler', 'PascalContextDataset', 'PascalContextDataset59',
           'PascalVOCDataset', 'STAREDataset', 'build_dataloader', 'collate']
