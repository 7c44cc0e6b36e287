"""The data pipeline's transforms (registered in ``TRANSFORMS``)."""
from lednet_tpu_torch.datasets.transforms.formatting import PackSegInputs
from lednet_tpu_torch.datasets.transforms.fused import FusedRandomResizeCropFlip
from lednet_tpu_torch.datasets.transforms.loading import (LoadAnnotations,
                                                          LoadImageFromFile,
                                                          LoadImageFromNDArray)
from lednet_tpu_torch.datasets.transforms.transforms import (
    GenerateEdge, PhotoMetricDistortion, RandomCrop, RandomFlip, RandomResize,
    Resize)
from lednet_tpu_torch.datasets.transforms.tta import TestTimeAug

__all__ = ['FusedRandomResizeCropFlip', 'GenerateEdge', 'LoadAnnotations',
           'LoadImageFromFile', 'LoadImageFromNDArray', 'PackSegInputs',
           'PhotoMetricDistortion', 'RandomCrop', 'RandomFlip',
           'RandomResize', 'Resize', 'TestTimeAug']
