"""Geometric and photometric transforms of the LED configs' pipelines.

Counterpart of ``lednet_tpu/datasets/transforms/transforms.py`` (``Resize``
:48, ``RandomResize`` :89, ``RandomCrop`` :131, ``RandomFlip`` :169,
``Pad`` :217, ``PhotoMetricDistortion`` :340, ``GenerateEdge`` :474).
Three differences, all in how, not what:

- every random draw comes from the ``np.random.RandomState`` passed as
  ``t(results, rng)``, and the draws are the JAX transforms' calls in their
  order, so a transform given ``RandomState(s)`` draws what the JAX one
  draws after ``np.random.seed(s)``;
- cv2's resize and its 8-bit BGR<->HSV run in the port's host library
  (:mod:`lednet_tpu_torch.native`), which reproduces cv2's arithmetic;
- ``GenerateEdge``'s ``cv2.dilate`` is :func:`dilate`, in numpy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from lednet_tpu_torch import native
from lednet_tpu_torch.registry import TRANSFORMS


def _need_rng(rng, name):
    if rng is None:
        raise ValueError(f'{name} draws at random: pass an '
                         'np.random.RandomState as t(results, rng)')
    return rng


def rescale_size(old_size: Tuple[int, int], scale) -> Tuple[int, int]:
    """mmcv ``rescale_size``: the (w, h) of a keep-ratio resize of an image
    of (w, h) ``old_size`` to ``scale`` (a factor or a (long, short) pair)."""
    w, h = old_size
    if isinstance(scale, (float, int)):
        factor = scale
    else:
        factor = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


def class_counts(labels: np.ndarray, ignore_index: int) -> np.ndarray:
    """The nonzero label counts without ``ignore_index`` (what
    ``np.unique(..., return_counts=True)`` gives, in one bincount): the
    ``cat_max_ratio`` test of the random crops."""
    counts = np.bincount(labels.ravel())
    if ignore_index < len(counts):
        counts[ignore_index] = 0
    return counts[counts > 0]


def imresize(img: np.ndarray, size_wh, interpolation: str = 'bilinear'):
    """cv2.resize of a uint8 image to (w, h), bilinear or nearest."""
    if interpolation == 'bilinear':
        return native.resize_linear(img, size_wh)
    if interpolation == 'nearest':
        return native.resize_nearest(img, size_wh)
    raise NotImplementedError(f'{interpolation} resizing is not ported')


@TRANSFORMS.register_module()
class Resize:
    """mmcv Resize: ``scale=(w, h)``; ``keep_ratio`` rescales the long edge."""

    def __init__(self, scale=None, scale_factor=None, keep_ratio=False,
                 clip_object_border=True, interpolation='bilinear',
                 backend='cv2'):
        self.scale = scale
        self.scale_factor = scale_factor
        self.keep_ratio = keep_ratio
        self.interpolation = interpolation

    def _target_scale(self, results):
        if results.get('scale') is not None:
            return results['scale']
        if self.scale is not None:
            return self.scale
        h, w = results['img'].shape[:2]
        f = self.scale_factor
        if isinstance(f, (tuple, list)):
            f = f[0]
        return (int(w * f), int(h * f))

    def __call__(self, results: Dict, rng=None) -> Dict:
        h, w = results['img'].shape[:2]
        scale = self._target_scale(results)
        if self.keep_ratio:
            new_w, new_h = rescale_size((w, h), scale)
        else:
            new_w, new_h = int(scale[0]), int(scale[1])
        results['img'] = imresize(results['img'], (new_w, new_h),
                                  self.interpolation)
        results['img_shape'] = (new_h, new_w)
        results['scale'] = (new_w, new_h)
        results['scale_factor'] = (new_w / w, new_h / h)
        results['keep_ratio'] = self.keep_ratio
        for key in results.get('seg_fields', []):
            results[key] = imresize(results[key], (new_w, new_h), 'nearest')
        return results


@TRANSFORMS.register_module()
class RandomResize:
    """A ratio drawn uniformly in ``ratio_range`` against ``scale=(w, h)``,
    then ``Resize``."""

    def __init__(self, scale, ratio_range=(0.5, 2.0), keep_ratio=True,
                 interpolation='bilinear', resize_type='Resize', **kwargs):
        self.scale = scale
        self.ratio_range = ratio_range
        self.resize = Resize(scale=None, keep_ratio=keep_ratio,
                             interpolation=interpolation)

    def __call__(self, results: Dict, rng=None) -> Dict:
        lo, hi = self.ratio_range
        ratio = _need_rng(rng, 'RandomResize').random_sample() * (hi - lo) + lo
        results['scale'] = (int(self.scale[0] * ratio),
                            int(self.scale[1] * ratio))
        out = self.resize(results)
        out.pop('scale', None)
        return out


@TRANSFORMS.register_module()
class RandomCrop:
    """Random crop, redrawn (up to 10 times) while one class other than
    ``ignore_index`` covers ``cat_max_ratio`` or more of the crop's labels,
    or the crop holds one class only."""

    def __init__(self, crop_size, cat_max_ratio=1.0, ignore_index=255):
        self.crop_size = crop_size  # (h, w)
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def _sample_bbox(self, img_shape, rng):
        h, w = img_shape[:2]
        y = rng.randint(0, max(h - self.crop_size[0], 0) + 1)
        x = rng.randint(0, max(w - self.crop_size[1], 0) + 1)
        return y, min(y + self.crop_size[0], h), x, min(x + self.crop_size[1], w)

    def __call__(self, results: Dict, rng=None) -> Dict:
        rng = _need_rng(rng, 'RandomCrop')
        img = results['img']
        y1, y2, x1, x2 = self._sample_bbox(img.shape, rng)
        gt = results.get('gt_seg_map')
        if self.cat_max_ratio < 1.0 and gt is not None:
            for _ in range(10):
                cnt = class_counts(gt[y1:y2, x1:x2], self.ignore_index)
                if len(cnt) > 1 and cnt.max() / cnt.sum() < self.cat_max_ratio:
                    break
                y1, y2, x1, x2 = self._sample_bbox(img.shape, rng)
        results['img'] = img[y1:y2, x1:x2]
        results['img_shape'] = results['img'].shape[:2]
        for key in results.get('seg_fields', []):
            results[key] = results[key][y1:y2, x1:x2]
        return results


@TRANSFORMS.register_module()
class RandomFlip:
    def __init__(self, prob=None, direction='horizontal', swap_seg_labels=None):
        self.prob = prob
        self.direction = direction

    def __call__(self, results: Dict, rng=None) -> Dict:
        flip = self.prob is not None and \
            _need_rng(rng, 'RandomFlip').rand() < self.prob
        results['flip'] = flip
        results['flip_direction'] = self.direction if flip else None
        if flip:
            axis = 1 if self.direction == 'horizontal' else 0
            results['img'] = np.flip(results['img'], axis=axis).copy()
            for key in results.get('seg_fields', []):
                results[key] = np.flip(results[key], axis=axis).copy()
        return results


@TRANSFORMS.register_module()
class Pad:
    """Pad bottom-right to ``size=(h, w)`` (a larger side is kept) or to the
    next multiples of ``size_divisor``: the image with ``pad_val``, every
    seg field with ``seg_pad_val``; ``pad_val`` may be ``dict(img=,
    seg=)``.  Sets ``pad_shape`` and ``img_shape`` to the padded size.
    ``pad_to_square`` is accepted and unread, as in the JAX package."""

    def __init__(self, size=None, size_divisor=None, pad_val=0,
                 seg_pad_val=255, pad_to_square=False):
        if (size is None) == (size_divisor is None):
            raise ValueError('Pad takes exactly one of size and size_divisor')
        self.size = size
        self.size_divisor = size_divisor
        if isinstance(pad_val, dict):
            seg_pad_val = pad_val.get('seg', seg_pad_val)
            pad_val = pad_val.get('img', 0)
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def _target(self, h: int, w: int) -> Tuple[int, int]:
        if self.size is not None:
            return max(self.size[0], h), max(self.size[1], w)
        d = self.size_divisor
        return -(-h // d) * d, -(-w // d) * d

    @staticmethod
    def _pad(arr: np.ndarray, th: int, tw: int, value) -> np.ndarray:
        pad = ((0, th - arr.shape[0]), (0, tw - arr.shape[1])) + \
            ((0, 0),) * (arr.ndim - 2)
        return np.pad(arr, pad, constant_values=value)

    def __call__(self, results: Dict, rng=None) -> Dict:
        th, tw = self._target(*results['img'].shape[:2])
        results['img'] = self._pad(results['img'], th, tw, self.pad_val)
        results['pad_shape'] = (th, tw)
        results['img_shape'] = (th, tw)
        for key in results.get('seg_fields', []):
            results[key] = self._pad(results[key], th, tw, self.seg_pad_val)
        return results


@TRANSFORMS.register_module()
class PhotoMetricDistortion:
    """SSD-style photometric jitter in uint8 BGR/HSV space: brightness,
    contrast before or after (a coin), saturation, hue; each step on a coin
    flip."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def _convert(img, alpha=1.0, beta=0.0):
        return np.clip(img.astype(np.float32) * alpha + beta, 0, 255
                       ).astype(np.uint8)

    def _brightness(self, img, rng):
        if rng.randint(2):
            return self._convert(img, beta=rng.uniform(-self.brightness_delta,
                                                       self.brightness_delta))
        return img

    def _contrast(self, img, rng):
        if rng.randint(2):
            return self._convert(img, alpha=rng.uniform(self.contrast_lower,
                                                        self.contrast_upper))
        return img

    def _saturation(self, img, rng):
        if rng.randint(2):
            hsv = native.bgr2hsv(img)
            hsv[:, :, 1] = self._convert(
                hsv[:, :, 1], alpha=rng.uniform(self.saturation_lower,
                                                self.saturation_upper))
            img = native.hsv2bgr(hsv)
        return img

    def _hue(self, img, rng):
        if rng.randint(2):
            hsv = native.bgr2hsv(img)
            hsv[:, :, 0] = (hsv[:, :, 0].astype(int) +
                            rng.randint(-self.hue_delta, self.hue_delta)) % 180
            img = native.hsv2bgr(hsv)
        return img

    def __call__(self, results: Dict, rng=None) -> Dict:
        rng = _need_rng(rng, 'PhotoMetricDistortion')
        img = self._brightness(results['img'], rng)
        mode = rng.randint(2)
        if mode == 1:
            img = self._contrast(img, rng)
        img = self._saturation(img, rng)
        img = self._hue(img, rng)
        if mode == 0:
            img = self._contrast(img, rng)
        results['img'] = img
        return results


def dilate(mask: np.ndarray, width: int) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((width, width)))`` of a 2-D uint8 map, bit
    for bit: the maximum over a width x width window whose anchor is cv2's
    default ``width // 2``, so that an even window spans offsets
    ``-(width // 2) .. width - 1 - width // 2`` (-2..+1 for 4) and is not
    centred.  Cells outside the map never win (cv2's border value for
    dilation is the type's minimum)."""
    if width <= 1:
        return mask.copy()
    anchor = width // 2
    h, w = mask.shape
    padded = np.zeros((h + width - 1, w + width - 1), mask.dtype)
    padded[anchor:anchor + h, anchor:anchor + w] = mask
    rows = padded[:h].copy()
    for i in range(1, width):
        np.maximum(rows, padded[i:i + h], out=rows)
    out = rows[:, :w].copy()
    for j in range(1, width):
        np.maximum(out, rows[:, j:j + w], out=out)
    return out


@TRANSFORMS.register_module()
class GenerateEdge:
    """The boundary label of PIDNet's train pipeline, ``gt_edge_map``
    (uint8, added to ``seg_fields``): 1 where a pixel's label differs from a
    4-neighbour's and is not ``ignore_index``, then dilated by an
    ``edge_width`` square (:func:`dilate`)."""

    def __init__(self, edge_width=3, ignore_index=255):
        self.edge_width = edge_width
        self.ignore_index = ignore_index

    def __call__(self, results: Dict, rng=None) -> Dict:
        seg = results['gt_seg_map']
        diff = np.zeros(seg.shape, dtype=bool)
        vertical = seg[1:, :] != seg[:-1, :]
        horizontal = seg[:, 1:] != seg[:, :-1]
        diff[1:, :] |= vertical
        diff[:-1, :] |= vertical
        diff[:, 1:] |= horizontal
        diff[:, :-1] |= horizontal
        edge = (diff & (seg != self.ignore_index)).astype(np.uint8)
        results['gt_edge_map'] = dilate(edge, self.edge_width)
        results.setdefault('seg_fields', []).append('gt_edge_map')
        return results
