from lednet_tpu_torch.models.losses.cross_entropy import (CrossEntropyLoss,
                                                          OhemCrossEntropy,
                                                          accuracy)

__all__ = ['CrossEntropyLoss', 'OhemCrossEntropy', 'accuracy']
