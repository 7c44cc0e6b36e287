"""Image files without cv2 or PIL: PNG on ``zlib``, JPEG in the host library.

The port's stand-in for ``cv2.imread``/``cv2.imwrite`` and ``PIL.Image.open``
in the data pipeline (the GPU machine has neither library).

- PNG: 8 bits per sample, every color type (gray, gray + alpha, RGB, RGBA,
  palette) and all five row filters, the unfilter step in the host library
  (:func:`lednet_tpu_torch.native.png_unfilter`); written as 8-bit gray,
  RGB, RGBA or palette.
- JPEG: baseline and extended sequential Huffman files, 8-bit, gray or
  3-component, decoded as libjpeg-turbo decodes them by default, which is
  what cv2 and PIL give (:func:`lednet_tpu_torch.native.jpeg_decode`); the
  EXIF orientation is applied as ``cv2.imread`` applies it.  Progressive,
  arithmetic-coded, lossless, 12-bit and CMYK files raise ``ValueError``.
  Written as baseline 4:2:0 or 4:4:4 (:func:`lednet_tpu_torch.native.jpeg_encode`).

Other formats raise ``ValueError``; nothing is handed to another decoder.

- :func:`imread` follows ``cv2.imread``: ``'color'`` gives BGR (H, W, 3)
  (gray replicated, alpha dropped, palettes expanded), ``'unchanged'`` gray
  as (H, W) and the rest as BGR or BGRA, ``'grayscale'`` a gray file as
  (H, W) and a YCbCr JPEG as its luma plane.  ``'color'`` and
  ``'grayscale'`` turn a JPEG by its EXIF orientation, ``'unchanged'``
  does not.
- :func:`imread_pil` follows ``np.array(PIL.Image.open(path))``: channels
  in RGB(A) order and a palette image as its palette indices, which is how
  ``LoadAnnotations`` reads label maps; no EXIF orientation.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from lednet_tpu_torch import native

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
JPEG_SOI = b'\xff\xd8'
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


def exif_orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn an image stored with EXIF ``orientation`` upright, as cv2's
    ``ExifTransform`` does (2: mirror, 3: 180 degrees, 4: flip, 5:
    transpose, 6: 90 degrees clockwise, 7: transverse, 8: 90 degrees
    counter-clockwise; any other value: as stored)."""
    if orientation in (5, 6, 7, 8):
        img = np.swapaxes(img, 0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(orientation)
    if axes:
        img = np.flip(img, axes)
    return np.ascontiguousarray(img)


def _imread_jpeg(path: str, data: bytes, flag: str) -> np.ndarray:
    try:
        head = native.jpeg_header(data)
        gray = flag == 'grayscale' or (flag == 'unchanged' and
                                       head['components'] == 1)
        img = native.jpeg_decode(data, gray=gray)
    except ValueError as e:
        raise ValueError(f'{path}: {e}') from None
    if flag == 'unchanged':
        return img
    return exif_orient(img, head['orientation'])


def imread(path: str, flag: str = 'color') -> np.ndarray:
    """``cv2.imread(path, flag)`` for ``flag`` in 'color', 'grayscale',
    'unchanged' (see the module docstring).  A missing file raises
    ``FileNotFoundError``."""
    if flag not in ('color', 'grayscale', 'unchanged'):
        raise ValueError(f'unknown imread flag {flag!r}')
    data = _read_bytes(path)
    if data[:2] == JPEG_SOI:
        return _imread_jpeg(path, data, flag)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f'{path}: neither a PNG nor a JPEG file')
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
    if data[:2] == JPEG_SOI:
        img = _imread_jpeg(path, data, 'unchanged')
        return np.ascontiguousarray(img[..., ::-1]) if img.ndim == 3 else img
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f'{path}: neither a PNG nor a JPEG file')
    return decode_png(data)[0]


def imwrite(path: str, img: np.ndarray, filter_type: int = 1,
            level: int = 6, quality: int = 95, subsampling: str = '420',
            orientation: int = 0) -> None:
    """``cv2.imwrite``: (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8
    to a PNG (``filter_type``, zlib ``level``), or gray or BGR to a JPEG by
    the suffix ``.jpg``/``.jpeg`` (``quality`` as cv2's, ``subsampling``
    '420' or '444', an EXIF ``orientation`` tag when 1-8)."""
    suffix = str(path).lower().rsplit('.', 1)[-1]
    if suffix in ('jpg', 'jpeg'):
        data = native.jpeg_encode(img, quality, subsampling, orientation)
    elif suffix == 'png':
        if img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        elif img.ndim == 3 and img.shape[2] == 4:
            img = img[..., [2, 1, 0, 3]]
        data = encode_png(img, filter_type=filter_type, level=level)
    else:
        raise ValueError(f'{path}: the port writes PNG and JPEG files')
    with open(path, 'wb') as f:
        f.write(data)
