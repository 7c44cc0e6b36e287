# Importing the model modules registers them in MODELS.
from lednet_tpu_torch.models import data_preprocessor  # noqa: F401
from lednet_tpu_torch.models.backbones import (bisenetv1, bisenetv2,  # noqa: F401
                                               ddrnet, hrnet, lednet, mscan,
                                               pidnet, resnet, stdc)
from lednet_tpu_torch.models.decode_heads import (fcn_head, ham_head,  # noqa: F401
                                                  led_head, pid_head,
                                                  stdc_head)
from lednet_tpu_torch.models import losses  # noqa: F401
from lednet_tpu_torch import structures  # noqa: F401
from lednet_tpu_torch.models.segmentors import encoder_decoder  # noqa: F401
from lednet_tpu_torch.models.segmentors import seg_tta  # noqa: F401
