from lednet_tpu_torch.models.losses.cross_entropy import (CrossEntropyLoss,
                                                          OhemCrossEntropy,
                                                          accuracy)
from lednet_tpu_torch.models.losses.extra_losses import BoundaryLoss, DiceLoss

__all__ = ['BoundaryLoss', 'CrossEntropyLoss', 'DiceLoss', 'OhemCrossEntropy',
           'accuracy']
