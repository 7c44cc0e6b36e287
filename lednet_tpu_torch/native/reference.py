"""numpy versions of the arithmetic in ``augment.cpp`` and ``jpeg.cpp``, for
the tests.

Each function computes what its counterpart in
:mod:`lednet_tpu_torch.native` computes, step for step, so the tests can
hold the library to it exactly (the fused multiply-adds of
:func:`hsv2bgr` are taken in float64 and rounded once to float32).  They are
slow and are not used by the pipeline.
"""
from __future__ import annotations

from typing import Sequence

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


# ------------------------------------------------------------------- JPEG
_IDCT_FIX = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373,
                 c1175=9633, c1501=12299, c1847=15137, c1961=16069,
                 c2053=16819, c2562=20995, c3072=25172)


def _idct_1d(x, shift):
    """One islow pass over the last axis (8 values), descaled by ``shift``."""
    f = _IDCT_FIX
    z1 = (x[..., 2] + x[..., 6]) * f['c0541']
    tmp2 = z1 - x[..., 6] * f['c1847']
    tmp3 = z1 + x[..., 2] * f['c0765']
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f['c1175']
    o0, o1, o2, o3 = (o0 * f['c0298'], o1 * f['c2053'], o2 * f['c3072'],
                      o3 * f['c1501'])
    z1, z2 = z1 * -f['c0899'], z2 * -f['c2562']
    z3, z4 = z3 * -f['c1961'] + z5, z4 * -f['c0390'] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    out = np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                    t13 - o0, t12 - o1, t11 - o2, t10 - o3], -1)
    return (out + (1 << (shift - 1))) >> shift


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg's islow inverse DCT of (..., 8, 8) quantized coefficients
    (natural order) with an (8, 8) table -> (..., 8, 8) uint8 samples."""
    x = coefs.astype(np.int64) * qtable.astype(np.int64)
    cols = _idct_1d(np.swapaxes(x, -1, -2), 11)          # pass 1: columns
    rows = _idct_1d(np.swapaxes(cols, -1, -2), 18)       # pass 2: rows
    return np.clip(rows + 128, 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, hf: int, vf: int, dh: int, dw: int,
              height: int) -> np.ndarray:
    """jdsample.c: a (dh, dw) component plane to ``height`` rows and
    ``dw * hf`` columns."""
    p = plane[:dh, :dw].astype(np.int64)
    if (hf, vf) == (1, 1):
        return p[:height]
    iy = np.arange(height) // vf
    near = p[np.minimum(iy, dh - 1)]
    far = p[np.clip(np.where(np.arange(height) % 2 == 1, iy + 1, iy - 1), 0, dh - 1)]
    if (hf, vf) == (1, 2):
        bias = np.where(np.arange(height) % 2 == 1, 2, 1)[:, None]
        return (near * 3 + far + bias) >> 2
    fancy = dw > 2 and hf == 2 and vf in (1, 2)
    if not fancy:
        return np.repeat(near, hf, axis=1)
    if vf == 1:          # h2v1: (3 * this + neighbour + 1 or 2) >> 2
        c, even_bias, odd_bias, shift = near, 1, 2, 2
    else:                # h2v2: column sums of 3 * near + far, >> 4
        c, even_bias, odd_bias, shift = near * 3 + far, 8, 7, 4
    left = np.concatenate([c[:, :1], c[:, :-1]], 1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], 1)
    out = np.empty((height, 2 * dw), np.int64)
    out[:, 0::2] = (c * 3 + left + even_bias) >> shift
    out[:, 1::2] = (c * 3 + right + odd_bias) >> shift
    return out


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def jpeg_pixels(head: dict, blocks: Sequence[np.ndarray],
                qtables: Sequence[np.ndarray], gray: bool = False) -> np.ndarray:
    """The pixels of a JPEG from its coefficients (``native.jpeg_coefficients``):
    islow IDCT, fancy upsampling, jdcolor.c's conversion; (H, W, 3) BGR or
    (H, W) gray, as ``native.jpeg_decode``."""
    H, W = head['height'], head['width']
    maxh = max(h for h, _ in head['sampling'])
    maxv = max(v for _, v in head['sampling'])
    space = head['color_space']
    needed = 1 if gray and space != 'rgb' else head['components']
    planes = []
    for ci in range(needed):
        h, v = head['sampling'][ci]
        b = idct_islow(blocks[ci], qtables[ci])
        rows, cols = b.shape[:2]
        plane = b.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        dh, dw = -(-H * v // maxv), -(-W * h // maxh)
        planes.append(_upsample(plane, maxh // h, maxv // v, dh, dw, H)[:, :W])
    if needed == 1:
        p = planes[0].astype(np.uint8)
        return p if gray else np.repeat(p[..., None], 3, axis=2)
    p0, p1, p2 = planes
    if space == 'rgb':
        if gray:
            return ((_fix16(0.299) * p0 + _fix16(0.587) * p1 +
                     _fix16(0.114) * p2 + 32768) >> 16).astype(np.uint8)
        return np.stack([p2, p1, p0], -1).astype(np.uint8)
    x = np.arange(256) - 128
    cr_r = (_fix16(1.402) * x + 32768) >> 16
    cb_b = (_fix16(1.772) * x + 32768) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + 32768
    r = p0 + cr_r[p2]
    g = p0 + ((cb_g[p1] + cr_g[p2]) >> 16)
    b = p0 + cb_b[p1]
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)
