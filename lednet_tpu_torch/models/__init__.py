# Importing the model modules registers them in MODELS.
from lednet_tpu_torch.models import data_preprocessor  # noqa: F401
from lednet_tpu_torch.models.backbones import (bisenetv1, bisenetv2,  # noqa: F401
                                               cgnet, ddrnet, dsnet, erfnet,
                                               fast_scnn, hrnet, icnet, lednet,
                                               mit, mobilenet_v3, mscan, pidnet,
                                               resnet, rtformer, sctnet, stdc,
                                               swin, unet, vit)
from lednet_tpu_torch.models.decode_heads import (context_heads,  # noqa: F401
                                                  dpt_head,
                                                  fcn_head, fpn_head,
                                                  ham_head, knet_head,
                                                  led_head, lraspp_head,
                                                  maskformer_head, ocr_head,
                                                  pid_head, point_head,
                                                  psa_head, psp_head, san_head,
                                                  sct_head, segformer_head,
                                                  segmenter_head, setr_head,
                                                  stdc_head, uper_head)
from lednet_tpu_torch.models import necks  # noqa: F401
from lednet_tpu_torch.models import text_encoder  # noqa: F401
from lednet_tpu_torch.models import losses  # noqa: F401
from lednet_tpu_torch import structures  # noqa: F401
from lednet_tpu_torch.models.segmentors import encoder_decoder  # noqa: F401
from lednet_tpu_torch.models.segmentors import cascade_encoder_decoder  # noqa: F401
from lednet_tpu_torch.models.segmentors import multimodal  # noqa: F401
from lednet_tpu_torch.models.segmentors import seg_tta  # noqa: F401
