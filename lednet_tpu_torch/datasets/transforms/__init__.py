"""The data pipeline's transforms (registered in ``TRANSFORMS``)."""
from lednet_tpu_torch.datasets.transforms.formatting import PackSegInputs
from lednet_tpu_torch.datasets.transforms.loading import (LoadAnnotations,
                                                          LoadImageFromFile,
                                                          LoadImageFromNDArray)
from lednet_tpu_torch.datasets.transforms.transforms import (
    PhotoMetricDistortion, RandomCrop, RandomFlip, RandomResize, Resize)

__all__ = ['LoadAnnotations', 'LoadImageFromFile', 'LoadImageFromNDArray',
           'PackSegInputs', 'PhotoMetricDistortion', 'RandomCrop',
           'RandomFlip', 'RandomResize', 'Resize']
