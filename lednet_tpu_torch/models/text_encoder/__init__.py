from lednet_tpu_torch.models.text_encoder.clip_text_encoder import CLIPTextEncoder
from lednet_tpu_torch.models.text_encoder.tokenizer import tokenize

__all__ = ['CLIPTextEncoder', 'tokenize']
