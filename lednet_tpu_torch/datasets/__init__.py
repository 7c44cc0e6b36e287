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

__all__ = ['ADE20KDataset', 'BaseSegDataset', 'CityscapesDataset', 'Compose', 'DataLoader',
           'DefaultSampler', 'DevicePrefetcher', 'InfiniteSampler',
           'PascalVOCDataset', 'build_dataloader', 'collate']
