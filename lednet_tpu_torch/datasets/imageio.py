"""Image files without cv2 or PIL: a PNG codec on ``zlib``.

The port's stand-in for ``cv2.imread``/``cv2.imwrite`` and ``PIL.Image.open``
in the data pipeline (the GPU machine has neither library).  It reads
8-bit PNGs of every color type (gray, gray + alpha, RGB, RGBA, palette) and
all five row filters, the unfilter step in the host library
(:func:`lednet_tpu_torch.native.png_unfilter`), and writes 8-bit gray, RGB,
RGBA and palette PNGs.  Other formats (JPEG) go to cv2, imported only then;
where it is missing they raise.

- :func:`imread` follows ``cv2.imread``: ``'color'`` gives BGR (H, W, 3)
  (gray replicated, alpha dropped, palettes expanded), ``'unchanged'`` gray
  as (H, W) and the rest as BGR or BGRA, ``'grayscale'`` a gray file as
  (H, W).
- :func:`imread_pil` follows ``np.array(PIL.Image.open(path))``: channels
  in RGB(A) order and a palette image as its palette indices, which is how
  ``LoadAnnotations`` reads label maps.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from lednet_tpu_torch import native

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(pixels as stored, palette): gray (H, W), gray + alpha (H, W, 2),
    RGB (H, W, 3), RGBA (H, W, 4) or palette indices (H, W), all uint8;
    the palette as (N, 3) uint8 RGB for a palette image, else None."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError('not a PNG file')
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError('truncated PNG chunk')
        if zlib.crc32(kind + body) != struct.unpack('>I', crc)[0]:
            raise ValueError(f'PNG chunk {kind!r} fails its CRC')
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError('PNG without IHDR or IDAT')
    width, height, depth, color, _, _, interlace = header
    # 8 bits per sample, or 1, 2 or 4 bits per palette index
    if interlace or color not in _CHANNELS or not (
            depth == 8 or color == 3 and depth in (1, 2, 4)):
        raise NotImplementedError(
            f'the port reads non-interlaced PNGs of 8 bits per sample (1-8 '
            f'per palette index); this one has bit depth {depth}, color '
            f'type {color}, interlace {interlace}')
    if color == 3 and palette is None:
        raise ValueError('palette PNG without a PLTE chunk')
    ch = _CHANNELS[color]
    raw = zlib.decompress(b''.join(idat))
    rowbytes = (width * ch * depth + 7) // 8
    pixels = native.png_unfilter(raw, height, rowbytes, max(ch * depth // 8, 1))
    if depth < 8:    # unpack the indices, most significant bits first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        pixels = ((pixels[..., None] >> shifts) & ((1 << depth) - 1))
        pixels = pixels.reshape(height, -1)[:, :width]
    pixels = pixels.reshape(height, width, ch) if ch > 1 else \
        pixels.reshape(height, width)
    return np.ascontiguousarray(pixels), (palette if color == 3 else None)


def _filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """PNG-filter (H, rowbytes) uint8 rows with one filter type (the
    encoder sees the original bytes, so every type vectorizes)."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f'PNG filter types are 0-4, got {kind}')
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body)))


def encode_png(pixels: np.ndarray, palette: Optional[np.ndarray] = None,
               filter_type: int = 1, level: int = 6) -> bytes:
    """PNG bytes of uint8 pixels in stored order: (H, W) gray (palette
    indices when ``palette``, (N, 3) RGB, is given), (H, W, 2) gray +
    alpha, (H, W, 3) RGB or (H, W, 4) RGBA.  Every row gets ``filter_type``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); ``level`` is zlib's."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8:
        raise TypeError(f'PNG pixels must be uint8, got {pixels.dtype}')
    h, w = pixels.shape[:2]
    ch = 1 if pixels.ndim == 2 else pixels.shape[2]
    if palette is not None:
        if ch != 1:
            raise ValueError('a palette image takes (H, W) indices')
        color = 3
    else:
        color = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
        if color is None:
            raise ValueError(f'cannot write {ch} channels as PNG')
    rows = _filter_rows(pixels.reshape(h, w * ch), ch, filter_type)
    stream = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)
    out = [PNG_SIGNATURE,
           _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes()))
    out.append(_chunk(b'IDAT', zlib.compress(stream.tobytes(), level)))
    out.append(_chunk(b'IEND', b''))
    return b''.join(out)


def _read_bytes(path: str) -> bytes:
    with open(path, 'rb') as f:
        return f.read()


def _cv2_imread(path: str, flag: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f'{path}: the port reads PNG files itself; other '
                           'formats need cv2, which is not installed') from e
    img = cv2.imread(path, {'color': cv2.IMREAD_COLOR,
                            'grayscale': cv2.IMREAD_GRAYSCALE,
                            'unchanged': cv2.IMREAD_UNCHANGED}[flag])
    if img is None:
        raise FileNotFoundError(path)
    return img


def imread(path: str, flag: str = 'color') -> np.ndarray:
    """``cv2.imread(path, flag)`` for ``flag`` in 'color', 'grayscale',
    'unchanged' (see the module docstring).  A missing file raises
    ``FileNotFoundError``."""
    if flag not in ('color', 'grayscale', 'unchanged'):
        raise ValueError(f'unknown imread flag {flag!r}')
    data = _read_bytes(path)
    if data[:8] != PNG_SIGNATURE:
        return _cv2_imread(path, flag)
    pixels, palette = decode_png(data)
    if palette is not None:
        pixels = palette[pixels]                         # RGB
    ch = 1 if pixels.ndim == 2 else pixels.shape[2]
    gray = pixels if ch == 1 else pixels[..., 0]         # ch <= 2
    if flag == 'grayscale':
        if ch > 2:
            raise NotImplementedError(f'{path}: reading a color PNG as '
                                      'grayscale is not ported')
        return np.ascontiguousarray(gray)
    if flag == 'color':
        return (np.repeat(gray[..., None], 3, axis=2) if ch <= 2 else
                np.ascontiguousarray(pixels[..., 2::-1]))      # BGR
    if ch == 1:
        return pixels
    if ch == 2:                                          # gray + alpha: BGRA
        return np.ascontiguousarray(pixels[..., [0, 0, 0, 1]])
    return np.ascontiguousarray(pixels[..., 2::-1] if ch == 3 else
                                pixels[..., [2, 1, 0, 3]])     # BGR(A)


def imread_pil(path: str) -> np.ndarray:
    """``np.array(PIL.Image.open(path))``: RGB(A) order, palette images as
    their indices, gray as (H, W)."""
    data = _read_bytes(path)
    if data[:8] != PNG_SIGNATURE:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f'{path}: the port reads PNG files itself; '
                               'other formats need PIL, which is not '
                               'installed') from e
        with Image.open(path) as im:
            return np.array(im)
    return decode_png(data)[0]


def imwrite(path: str, img: np.ndarray, filter_type: int = 1,
            level: int = 6) -> None:
    """``cv2.imwrite`` to a PNG: (H, W) gray, (H, W, 3) BGR or (H, W, 4)
    BGRA uint8."""
    if not str(path).lower().endswith('.png'):
        raise NotImplementedError(f'{path}: the port writes PNG files only')
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]
    elif img.ndim == 3 and img.shape[2] == 4:
        img = img[..., [2, 1, 0, 3]]
    with open(path, 'wb') as f:
        f.write(encode_png(img, filter_type=filter_type, level=level))
