"""numpy versions of the arithmetic in ``augment.cpp``, for the tests.

Each function computes what its counterpart in
:mod:`lednet_tpu_torch.native` computes, step for step, so the tests can
hold the library to it exactly (the fused multiply-adds of
:func:`hsv2bgr` are taken in float64 and rounded once to float32).  They are
slow and are not used by the pipeline.
"""
from __future__ import annotations

import numpy as np

_F32 = np.float32
COEF_SCALE = 2048
HSV_SHIFT = 12
HSV_BLOCK = 32
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def _taps(dsize: int, ssize: int):
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(_F32)).astype(_F32)


def _coef(f):
    return np.rint((_F32(1) - f) * _F32(COEF_SCALE)).astype(np.int64), \
        np.rint(f * _F32(COEF_SCALE)).astype(np.int64)


def resize_linear(img: np.ndarray, size_wh) -> np.ndarray:
    dw, dh = size_wh
    src = img if img.ndim == 3 else img[..., None]
    sh, sw, _ = src.shape
    if (sh, sw) == (dh, dw):
        out = src.copy()
    elif (sh, sw) == (2 * dh, 2 * dw):
        s = src.astype(np.int64)
        out = ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
                + 2) >> 2).astype(np.uint8)
    else:
        sx, fx = _taps(dw, sw)
        fx = np.where(sx < 0, _F32(0), fx)
        sx = np.maximum(sx, 0)
        clamped = np.nonzero(sx + 1 >= sw)[0]
        xmax = clamped[0] if len(clamped) else dw
        fx = np.where(sx >= sw - 1, _F32(0), fx)
        sx = np.minimum(sx, sw - 1)
        a0, a1 = _coef(fx)
        s = src.astype(np.int64)
        rows = s[:, sx] * a0[None, :, None] + \
            s[:, np.minimum(sx + 1, sw - 1)] * a1[None, :, None]
        rows[:, xmax:] = s[:, sx[xmax:]] * COEF_SCALE
        sy, fy = _taps(dh, sh)
        b0, b1 = _coef(fy)
        top = rows[np.clip(sy, 0, sh - 1)]
        bot = rows[np.clip(sy + 1, 0, sh - 1)]
        t = (((top >> 4) * b0[:, None, None]) >> 16) + \
            (((bot >> 4) * b1[:, None, None]) >> 16)
        out = np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def resize_nearest(img: np.ndarray, size_wh) -> np.ndarray:
    dw, dh = size_wh
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))).astype(np.int64),
                    sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))).astype(np.int64),
                    sh - 1)
    return img[ys][:, xs]


def png_unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.int64)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(height):
        kind, row = data[y, 0], data[y, 1:].astype(np.int64)
        if kind == 0:
            cur = row
        elif kind == 2:
            cur = (row + prev) % 256
        elif kind in (1, 3, 4):
            cur = np.zeros(rowbytes, np.int64)
            for i in range(rowbytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (row[i] + pred) % 256
        else:
            raise ValueError(f'unknown PNG filter type {kind}')
        out[y] = prev = cur
    return out.astype(np.uint8)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6 * i))]).astype(np.int64)
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fma_one(a, b):
    """float32(1 - a * b) rounded once, as ``std::fma(-a, b, 1.f)``."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(_F32)


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    one = _F32(1)
    s = img[..., 1].astype(_F32) * _F32(1 / 255)
    v = img[..., 2].astype(_F32) * _F32(1 / 255)
    h = img[..., 0].astype(_F32) * _F32(6 / 180)
    # the vector body: truncated sector, truncating output
    pre = np.trunc(h)
    hv = h - pre
    sector_v = (pre - np.trunc(pre * _F32(1 / 6)) * _F32(6)).astype(np.int64)
    tab = np.stack([v, v * (one - s), v * _fma_one(s, hv),
                    v * _fma_one(s, one - hv)], -1)
    body = np.trunc(np.take_along_axis(tab, _SECTORS[sector_v], -1) * _F32(255))
    # the scalar tail: fmod, floored sector, s == 0 shortcut, rounding
    hs = np.fmod(h, _F32(6))
    hs = np.where(hs < 0, hs + _F32(6), hs)
    sector_s = np.floor(hs).astype(np.int64)
    hs = hs - sector_s.astype(_F32)
    tab = np.stack([v, v * (one - s), v * _fma_one(s, hs),
                    v * _fma_one(s, one - hs)], -1)
    tail = np.take_along_axis(tab, _SECTORS[sector_s], -1)
    tail = np.rint(np.where((s == 0)[..., None], v[..., None], tail) * _F32(255))
    width = img.shape[1]
    in_body = (np.arange(width) < width // HSV_BLOCK * HSV_BLOCK)[None, :, None]
    return np.clip(np.where(in_body, body, tail), 0, 255).astype(np.uint8)
