"""lednet_tpu_torch: the PyTorch/CUDA port of ``lednet_tpu`` for NVIDIA Hopper.

It mirrors ``lednet_tpu``'s module paths and class names and reads the same
``configs/`` unchanged, but imports only torch and numpy (never JAX, flax or
the JAX package).  Public entry points keep the JAX package's NHWC layout at
their boundaries (the preprocessor, ``EncoderDecoder.predict``,
``postprocess_logits``, ``inference_model``); ``nn.Module`` bricks inside
compute NCHW.  The TPU's Pallas kernels on the inference path are
hand-written CUDA kernels under ``csrc/``, built on first use
(:mod:`lednet_tpu_torch.ops.kernels`).
"""
from lednet_tpu_torch.config import Config, ConfigDict
from lednet_tpu_torch.registry import MODELS

__version__ = '0.1.0'
