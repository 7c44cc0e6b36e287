# Importing the model modules registers them in MODELS.
from lednet_tpu_torch.models import data_preprocessor  # noqa: F401
from lednet_tpu_torch.models.backbones import lednet  # noqa: F401
from lednet_tpu_torch.models.decode_heads import led_head  # noqa: F401
from lednet_tpu_torch.models import losses  # noqa: F401
from lednet_tpu_torch.models.segmentors import encoder_decoder  # noqa: F401
from lednet_tpu_torch.models.segmentors import seg_tta  # noqa: F401
