"""ERFNet backbone, NCHW.

Counterpart of ``lednet_tpu/models/backbones/erfnet.py``
(``DownsamplerBlock`` :26, ``NonBottleneck1d`` :46, ``UpsamplerBlock`` :76,
``ERFNet`` :95): an encoder of downsamplers (a 3x3/s2 conv with bias beside a
2x2 max pool, concatenated; on odd sizes the pool, one smaller, is resized
bilinearly to the conv's size) and non-bottleneck-1D blocks (3x1 and 1x3
convs with biases, twice, only the second pair dilated, a residual ReLU),
then a decoder of 3x3/s2 transposed convs (``ConvTranspose2d(3, 2, 1,
output_padding=1)``, flax's ``padding=((1, 2), (1, 2))``) and more blocks.
Returns the 1/2-resolution decoder map, as a 1-tuple.

Every block takes BatchNorm with eps 1e-3: the JAX package's ``ERFNet``
passes no ``norm_cfg`` to its blocks (``:111-113``), whatever the config
sets, so each falls back to ``_BN3``.  The encoder's blocks drop out at
``dropout_ratio`` in training (elementwise, ``nn.Dropout``), the
decoder's never.  The second encoder stage builds
``n // len(dilations) * len(dilations)`` blocks, as the JAX package does.

flax's ``ConvTranspose`` here keeps its default ``transpose_kernel=False``:
its (kh, kw, in, out) kernel is PyTorch's (in, out, kh, kw) weight flipped
in both spatial axes (:mod:`lednet_tpu_torch.convert` does that for this
block's ``deconv``, and not for UNet's).

On the card the transposed conv runs with cuDNN's deterministic
algorithms (``deterministic_cudnn``): the algorithm cuDNN picks otherwise
for these shapes sums in no fixed order, so two calls on the same input
differed by a few 1e-4 at outputs of 1e3, and the logits by 3e-3, enough
to flip an argmax at a near-tie between the eval step's replayed graph and
the eager path.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.layers import Norm2d
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS

_BN3 = dict(type='BN', eps=1e-3)


class DownsamplerBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels - in_channels, 3, 2, 1)
        self.bn = Norm2d(norm_cfg or _BN3, out_channels)

    def forward(self, x):
        conv = self.conv(x)
        pool = F.max_pool2d(x, 2, 2)
        if pool.shape[-2:] != conv.shape[-2:]:
            pool = resize_bilinear(pool, conv.shape[-2:])
        return F.relu(self.bn(torch.cat([conv, pool], 1)))


class NonBottleneck1d(nn.Module):

    def __init__(self, channels: int, dilation: int = 1, dropout: float = 0.0,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        c, d = channels, dilation
        norm_cfg = norm_cfg or _BN3
        self.conv3x1_1 = nn.Conv2d(c, c, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(c, c, (1, 3), padding=(0, 1))
        self.bn1 = Norm2d(norm_cfg, c)
        self.conv3x1_2 = nn.Conv2d(c, c, (3, 1), padding=(d, 0), dilation=(d, 1))
        self.conv1x3_2 = nn.Conv2d(c, c, (1, 3), padding=(0, d), dilation=(1, d))
        self.bn2 = Norm2d(norm_cfg, c)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def forward(self, x):
        h = self.conv1x3_1(F.relu(self.conv3x1_1(x)))
        h = F.relu(self.bn1(h))
        h = self.conv1x3_2(F.relu(self.conv3x1_2(h)))
        h = self.dropout(self.bn2(h))
        return F.relu(x + h)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside, the caller's
    flag restored after (the other cuDNN flags are left as they are)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


class UpsamplerBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_channels, out_channels, 3, 2, 1,
                                         output_padding=1)
        self.deconv.init_gain = 2.0     # the JAX package's kaiming_init
        self.bn = Norm2d(norm_cfg or _BN3, out_channels)

    def forward(self, x):
        with deterministic_cudnn():
            y = self.deconv(x)
        return F.relu(self.bn(y))


@MODELS.register_module()
class ERFNet(nn.Module):

    def __init__(self, in_channels: int = 3,
                 enc_downsample_channels: Sequence[int] = (16, 64, 128),
                 enc_stage_non_bottlenecks: Sequence[int] = (5, 8),
                 enc_non_bottleneck_dilations: Sequence[int] = (2, 4, 8, 16),
                 enc_non_bottleneck_channels: Sequence[int] = (64, 128),
                 dec_upsample_channels: Sequence[int] = (64, 16),
                 dec_stages_non_bottleneck: Sequence[int] = (2, 2),
                 dec_non_bottleneck_channels: Sequence[int] = (64, 16),
                 dropout_ratio: float = 0.1, norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None, init_cfg: Optional[Dict] = None):
        """``norm_cfg``, ``act_cfg`` and ``enc_non_bottleneck_channels`` are
        accepted for the configs and, as in the JAX package, unused; of
        ``dec_upsample_channels`` only the length counts."""
        super().__init__()
        dch = list(enc_downsample_channels)
        dils = list(enc_non_bottleneck_dilations)
        self.down0 = DownsamplerBlock(in_channels, dch[0])
        self.down1 = DownsamplerBlock(dch[0], dch[1])
        self.enc1 = [f'enc1_{i}' for i in range(enc_stage_non_bottlenecks[0])]
        for name in self.enc1:
            self.add_module(name, NonBottleneck1d(dch[1], 1, dropout_ratio))
        self.down2 = DownsamplerBlock(dch[1], dch[2])
        n2 = enc_stage_non_bottlenecks[1] // len(dils) * len(dils)
        self.enc2 = [f'enc2_{i}' for i in range(n2)]
        for i, name in enumerate(self.enc2):
            self.add_module(name, NonBottleneck1d(dch[2], dils[i % len(dils)],
                                                  dropout_ratio))
        self.dec = []
        in_ch = dch[2]
        for s in range(len(dec_upsample_channels)):
            ch = dec_non_bottleneck_channels[s]
            self.add_module(f'up{s}', UpsamplerBlock(in_ch, ch))
            self.dec.append(f'up{s}')
            for i in range(dec_stages_non_bottleneck[s]):
                self.add_module(f'dec{s}_{i}', NonBottleneck1d(ch))
                self.dec.append(f'dec{s}_{i}')
            in_ch = ch

    def forward(self, x, impl: Optional[str] = None):
        """x: (B, 3, H, W).  ``impl`` is accepted for the segmentor's call
        and unused: no kernel runs here."""
        x = self.down1(self.down0(x.to(self.down0.conv.weight.dtype)))
        for name in self.enc1:
            x = getattr(self, name)(x)
        x = self.down2(x)
        for name in self.enc2 + self.dec:
            x = getattr(self, name)(x)
        return (x,)
