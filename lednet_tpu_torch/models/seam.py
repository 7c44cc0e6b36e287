"""SEAM: Laplacian edge-attention module (module form, NCHW).

Counterpart of ``lednet_tpu/models/seam.py`` :131.  The 1-channel projection
is min-max normalized PER SAMPLE (``seam.py:140-148``), Laplacian-filtered at
strides 1/2/4, clamped at 0 and binarized; the coarse maps are
nearest-upsampled, fused with weights [0.6, 0.3, 0.1], binarized again
(threshold 0.1) and re-projected to C channels.  The channel-free ``_fused_eval`` of the JAX
package is a TPU layout rewrite of the same math and is not carried over.
"""
from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import ConvModule
from lednet_tpu_torch.ops.resize import resize_nearest

_LAPLACIAN = ((-1., -1., -1.), (-1., 8., -1.), (-1., -1., -1.))
_FUSION = (0.6, 0.3, 0.1)
_THRESHOLD = 0.1


@functools.lru_cache(maxsize=None)
def _laplacian(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (1, 1, 3, 3) kernel on ``device``, kept so that a forward after
    the first copies nothing from the host (a CUDA graph cannot capture a
    copy from pageable host memory).  Never evicted: a captured graph reads
    it at every replay.  Made outside inference mode, so that training may
    use it too."""
    with torch.inference_mode(False):
        return torch.tensor(_LAPLACIAN, dtype=dtype, device=device).view(1, 1, 3, 3)


def _laplacian_conv(x: torch.Tensor, stride: int) -> torch.Tensor:
    return F.conv2d(x, _laplacian(x.dtype, x.device), stride=stride, padding=1)


def _binarize(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _THRESHOLD, 1.0, 0.0).to(t.dtype)


class SEAM(nn.Module):
    """Produces the C-channel edge-attention map from the stem feature."""

    def __init__(self, channels: int):
        super().__init__()
        bn = dict(type='BN')
        self.conv_1 = ConvModule(channels, 1, 3, padding=1, norm_cfg=bn,
                                 act_cfg=None)
        self.conv_2 = ConvModule(1, channels, 3, padding=1, norm_cfg=bn,
                                 act_cfg=None)

    def forward(self, x):
        proj = self.conv_1(x)
        lo = proj.amin(dim=(1, 2, 3), keepdim=True)
        hi = proj.amax(dim=(1, 2, 3), keepdim=True)
        seg = (proj - lo) / (hi - lo + 1e-12)
        b1 = _binarize(F.relu(_laplacian_conv(seg, 1)))
        b2 = F.relu(_laplacian_conv(seg, 2))
        b4 = F.relu(_laplacian_conv(seg, 4))
        size = b1.shape[-2:]
        b2 = _binarize(resize_nearest(b2, size))
        b4 = _binarize(resize_nearest(b4, size))
        fused = _binarize(_FUSION[0] * b1 + _FUSION[1] * b2 + _FUSION[2] * b4)
        return self.conv_2(fused)
