"""PSANet's point-wise spatial attention head, NCHW: ``PSAHead`` and
``psa_mask``.

Counterpart of ``lednet_tpu/models/decode_heads/point_setr_heads.py``
(``psa_mask`` :178, ``PSAHead`` :201):

- ``reduce`` (and ``reduce_p`` for 'bi-direction'): a 1x1 ConvModule to
  ``channels``, resized down by ``shrink_factor`` (where both sides leave a
  remainder, they are rounded up and the resize flips to
  ``align_corners=True``, as mmseg's head does);
- ``attention{0,1}`` (``attention_p{0,1}``): a normed 1x1 ConvModule, then
  a bias-free 1x1 conv to ``mask_h * mask_w`` channels, each position's
  logits over the mask window centred on it;
- ``psa_mask`` places them into the (h*w, h*w) matrix of source by target
  position (mmcv's ``PSAMask``), zero outside the window; 'collect' reads
  it transposed, 'distribute' as it is; ``compact`` takes the raw channels
  as target positions (the mask as large as the map); a softmax over the
  sources (``psa_softmax``), the features' weighted sum over the sources,
  over ``normalization_factor`` (the mask's area where None);
- ``proj``: a 1x1 ConvModule with ``padding=1`` (the map grows by 2, as
  mmseg's does), resized to the input; ``bottleneck`` (3x3) of
  ``[input, output]``; ``cls``.

``psa_mask`` gathers on the device with no index built on the host: the
window offset of target t from source p is separable, ``(ty - py +
half_h, tx - px + half_w)``, so the matrix is two gathers along the mask's
columns and rows, each indexed by an (h, h) or (w, w) table expanded
without copies, and a product with the window's separable validity.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lednet_tpu_torch.models.decode_heads.psp_head import HeadBase
from lednet_tpu_torch.models.decode_heads.self_attention import (acc_dtype,
                                                                 plain_conv)
from lednet_tpu_torch.ops.resize import resize_bilinear
from lednet_tpu_torch.registry import MODELS


def _offsets(n: int, half: int, size: int, device) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """(clipped offset, in-window) tables of one axis: ``[p, t] = t - p +
    half``, (n, n)."""
    i = torch.arange(n, device=device)
    d = i.view(1, n) - i.view(n, 1) + half
    return d.clamp(0, size - 1), (d >= 0) & (d < size)


def psa_mask(y: torch.Tensor, mask_size: Sequence[int]) -> torch.Tensor:
    """``y`` (B, mh*mw, h, w), each position's logits over its mask window
    -> ``A`` (B, h*w, h*w) with ``A[b, p, t] = y[b, rel(t - p), p]``, zero
    where t lies outside p's window."""
    B, M, h, w = y.shape
    mh, mw = mask_size
    dh, vh = _offsets(h, (mh - 1) // 2, mh, y.device)
    dw, vw = _offsets(w, (mw - 1) // 2, mw, y.device)
    win = y.permute(0, 2, 3, 1).reshape(B, h, w, mh, mw)
    # the mask's columns at each target column: [b, py, px, dh, tx]
    cols = torch.gather(win, 4, dw.view(1, 1, w, 1, w).expand(B, h, w, mh, w))
    # then its rows at each target row: [b, py, px, ty, tx]
    a = torch.gather(cols, 3, dh.view(1, h, 1, h, 1).expand(B, h, w, h, w))
    valid = (vh.view(1, h, 1, h, 1) & vw.view(1, 1, w, 1, w)).to(y.dtype)
    return (a * valid).reshape(B, h * w, h * w)


@MODELS.register_module()
class PSAHead(HeadBase):

    def __init__(self, *args, mask_size: Sequence[int] = (97, 97),
                 psa_type: str = 'bi-direction', compact: bool = False,
                 shrink_factor: int = 2,
                 normalization_factor: Optional[float] = 1.0,
                 psa_softmax: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if psa_type not in ('collect', 'distribute', 'bi-direction'):
            raise ValueError(f'PSAHead psa_type {psa_type!r}')
        self.mask_size = tuple(mask_size)
        self.psa_type = psa_type
        self.compact = compact
        self.shrink_factor = shrink_factor
        mh, mw = self.mask_size
        self.normalization_factor = (float(mh * mw) if normalization_factor
                                     is None else normalization_factor)
        self.psa_softmax = psa_softmax
        C = self.channels
        branches = ('',) if psa_type != 'bi-direction' else ('', '_p')
        for b in branches:
            self.add_module(f'reduce{b}', self._conv(self.in_width, C, 1))
            self.add_module(f'attention{b}0', self._conv(C, C, 1))
            self.add_module(f'attention{b}1', plain_conv(C, mh * mw, bias=False))
        self.proj = self._conv(len(branches) * C, self.in_width, 1, padding=1)
        self.bottleneck = self._conv(2 * self.in_width, C, 3, padding=1)

    def _shrunk(self, h0: int, w0: int):
        """The attention's map size and the resizes' ``align_corners``."""
        sf = self.shrink_factor
        if sf == 1:
            return h0, w0, self.align_corners
        if h0 % sf and w0 % sf:
            return (h0 - 1) // sf + 1, (w0 - 1) // sf + 1, True
        return h0 // sf, w0 // sf, False

    def _attend(self, feat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``out[b, :, j] = sum_i Y[b, i, j] feat[b, :, i] / norm`` with
        ``Y`` softmaxed over its sources i."""
        B, C, h, w = feat.shape
        acc = acc_dtype(feat.dtype)
        y = y.to(acc)
        if self.psa_softmax:
            y = torch.softmax(y, dim=1)
        out = torch.matmul(feat.flatten(2).to(y.dtype), y) * \
            (1.0 / self.normalization_factor)
        return out.reshape(B, C, h, w).to(feat.dtype)

    def _matrix(self, name, feat, collect):
        """The (B, sources, targets) matrix of branch ``name``: the mask
        matrix ``A`` transposed to collect, as it is to distribute; with
        ``compact``, the raw channels ``F`` [p, channel] to collect,
        transposed to distribute."""
        y = getattr(self, f'{name}1')(getattr(self, f'{name}0')(feat))
        if self.compact:
            raw = y.flatten(2).transpose(1, 2)
            return raw if collect else raw.transpose(1, 2)
        a = psa_mask(y, self.mask_size)
        return a.transpose(1, 2) if collect else a

    def forward(self, inputs, with_aux: bool = True):
        x = self._select(inputs)
        h0, w0 = x.shape[-2:]
        h, w, align = self._shrunk(h0, w0)

        def reduce(name):
            r = getattr(self, name)(x)
            return r if (h, w) == (h0, w0) else resize_bilinear(r, (h, w), align)
        if self.psa_type == 'bi-direction':
            # as the JAX head: the collect branch through the mask even
            # with ``compact``, the distribute branch's raw channels then
            # read as collect's
            x_col, x_dis = reduce('reduce'), reduce('reduce_p')
            y_col = psa_mask(self.attention1(self.attention0(x_col)),
                             self.mask_size).transpose(1, 2)
            y_dis = self._matrix('attention_p', x_dis, collect=self.compact)
            out = torch.cat([self._attend(x_col, y_col),
                             self._attend(x_dis, y_dis)], 1)
        else:
            feat = reduce('reduce')
            out = self._attend(feat, self._matrix(
                'attention', feat, collect=self.psa_type == 'collect'))
        out = resize_bilinear(self.proj(out), (h0, w0), align)
        return self.cls(self.bottleneck(torch.cat([x, out], 1)))
