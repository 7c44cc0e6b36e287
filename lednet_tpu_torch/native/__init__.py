"""The port's host image library (``augment.cpp``, ``jpeg.cpp``), loaded
with ``ctypes``.

Counterpart of ``lednet_tpu/native`` for the data pipeline: cv2's bilinear
and nearest uint8 resize, the JAX package's fused resize + crop + flip, the
PNG unfilter step, cv2's 8-bit BGR<->HSV, and baseline JPEG decoding (what
libjpeg-turbo, and so ``cv2.imread``, gives) and encoding, in C++ so that
loader threads run them without the interpreter lock.  One
``g++ -O3 -shared`` call builds the library at first use into
``lednet_tpu_torch/_build/native/<hash>/`` (git-ignored); it is written under
a temporary name and moved into place, so concurrent builds never load a
half-written file.  A failed build raises: there is no numpy fallback.
:mod:`lednet_tpu_torch.native.reference` holds numpy versions of the same
arithmetic, which the tests hold the library to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ('augment.cpp', 'jpeg.cpp'))
BUILD_ROOT = Path(__file__).resolve().parents[1] / '_build' / 'native'
LIB_NAME = 'libledaug.so'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-ffp-contract=off')

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I = ctypes.c_int
_LL = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {   # name -> (argtypes, restype)
    'resize_linear_u8': ([_U8, _I, _I, _I, _U8, _I, _I], None),
    'fused_resize_crop_flip_u8': ([_U8] + [_I] * 11 + [_U8], None),
    'jpeg_header': ([_U8, _LL, _IP, ctypes.c_char_p], _I),
    'jpeg_decode': ([_U8, _LL, _I, _U8, ctypes.c_char_p], _I),
    'jpeg_coefficients': ([_U8, _LL, ctypes.POINTER(ctypes.c_int16),
                           ctypes.POINTER(ctypes.c_uint16), ctypes.c_char_p], _I),
    'jpeg_encode': ([_U8, _I, _I, _I, _I, _I, _I, _U8, _LL], _LL),
    'resize_nearest_u8': ([_U8, _I, _I, _I, _U8, _I, _I], None),
    'png_unfilter': ([_U8, _I, _I, _I, _U8], _I),
    'bgr2hsv_u8': ([_U8, ctypes.c_longlong, _U8], None),
    'hsv2bgr_u8': ([_U8, _I, _I, _U8], None),
}


_BUILD_LOCK = threading.Lock()


def build() -> Path:
    """Compile the library unless this source is built already; returns its
    path.  Raises with the compiler's output on failure.  The loader's
    threads reach it together at their first sample: they build one at a
    time (the first builds, the others find its result), and each process
    writes its own temporary file before renaming it into place."""
    with _BUILD_LOCK:
        return _build()


def _build() -> Path:
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f'{LIB_NAME}.tmp{os.getpid()}'
    proc = subprocess.run(['g++', *CXX_FLAGS, *map(str, SOURCES), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed to build {LIB_NAME} '
                           f'(rc={proc.returncode}):\n{proc.stderr[-4000:]}')
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load the library."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8)


def _u8_hwc(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8:
        raise TypeError(f'expected a uint8 image, got {img.dtype}')
    if img.ndim not in (2, 3):
        raise ValueError(f'expected an (H, W) or (H, W, C) image, got {img.shape}')
    return np.ascontiguousarray(img if img.ndim == 3 else img[..., None])


def _resize(fn, img: np.ndarray, size_wh) -> np.ndarray:
    src = _u8_hwc(img)
    dw, dh = (int(v) for v in size_wh)
    if dw <= 0 or dh <= 0:
        raise ValueError(f'resize to a non-positive size {size_wh}')
    sh, sw, c = src.shape
    out = np.empty((dh, dw, c), np.uint8)
    fn(_ptr(src), sh, sw, c, _ptr(out), dh, dw)
    return out if img.ndim == 3 else out[..., 0]


def resize_linear(img: np.ndarray, size_wh) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR)`` on a
    uint8 (H, W) or (H, W, C) image."""
    return _resize(library().resize_linear_u8, img, size_wh)


def resize_nearest(img: np.ndarray, size_wh) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_NEAREST)``."""
    return _resize(library().resize_nearest_u8, img, size_wh)


def png_unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the row filters of a decompressed PNG image stream: ``raw`` is
    ``height`` rows of one filter byte + ``rowbytes``; returns
    (height, rowbytes) uint8."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (rowbytes + 1):
        raise ValueError(f'PNG data holds {src.size} bytes, expected '
                         f'{height * (rowbytes + 1)}')
    out = np.empty((height, rowbytes), np.uint8)
    bad = library().png_unfilter(_ptr(src), height, rowbytes, bpp, _ptr(out))
    if bad:
        raise ValueError(f'PNG row {bad - 1} has an unknown filter type '
                         f'{src[(bad - 1) * (rowbytes + 1)]}')
    return out


def _hwc3(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'expected a uint8 (H, W, 3) image, got {img.dtype} '
                         f'{img.shape}')
    return np.ascontiguousarray(img)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on a uint8 (H, W, 3) image."""
    src = _hwc3(img)
    out = np.empty_like(src)
    library().bgr2hsv_u8(_ptr(src), src.shape[0] * src.shape[1], _ptr(out))
    return out


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on a uint8 (H, W, 3) image."""
    src = _hwc3(img)
    out = np.empty_like(src)
    library().hsv2bgr_u8(_ptr(src), src.shape[0], src.shape[1], _ptr(out))
    return out


def fused_resize_crop_flip(img: np.ndarray, resize_hw, crop_yx, crop_hw,
                           flip: bool, nearest: bool = False) -> np.ndarray:
    """``lednet_tpu.native.fused_resize_crop_flip``: resize a uint8 (H, W) or
    (H, W, C) image to ``resize_hw``, crop ``crop_hw`` at ``crop_yx`` and
    flip it horizontally when ``flip``, in one pass (bilinear, or nearest
    for label maps)."""
    src = _u8_hwc(img)
    sh, sw, c = src.shape
    rh, rw = (int(v) for v in resize_hw)
    cy, cx = (int(v) for v in crop_yx)
    ch, cw = (int(v) for v in crop_hw)
    if min(rh, rw, ch, cw) <= 0 or cy < 0 or cx < 0 or \
            cy + ch > rh or cx + cw > rw:
        raise ValueError(f'crop {crop_hw} at {crop_yx} does not fit a '
                         f'{resize_hw} resize')
    out = np.empty((ch, cw, c), np.uint8)
    library().fused_resize_crop_flip_u8(_ptr(src), sh, sw, c, rh, rw, cy, cx,
                                        ch, cw, int(bool(flip)),
                                        int(bool(nearest)), _ptr(out))
    return out if img.ndim == 3 else out[..., 0]


# ------------------------------------------------------------------- JPEG
JPEG_INFO_LEN = 13


def _jpeg_call(fn, data, *args):
    err = ctypes.create_string_buffer(256)
    src = np.frombuffer(data, np.uint8)
    rc = fn(_ptr(src), src.size, *args, err)
    if rc:
        raise ValueError(err.value.decode(errors='replace'))


def jpeg_header(data: bytes) -> dict:
    """The frame of a JPEG: ``width``, ``height``, ``components``,
    ``color_space`` ('gray', 'ycbcr' or 'rgb', as libjpeg infers it),
    ``orientation`` (the EXIF tag, 1 without one) and ``sampling`` (each
    component's (h, v) factors).  Unsupported files raise ``ValueError``
    naming the feature."""
    info = (ctypes.c_int * JPEG_INFO_LEN)()
    _jpeg_call(library().jpeg_header, data, info)
    n = info[2]
    return dict(width=info[0], height=info[1], components=n,
                color_space=('gray', 'ycbcr', 'rgb')[info[3]],
                orientation=info[4],
                sampling=[(info[7 + 2 * i], info[8 + 2 * i]) for i in range(n)])


def jpeg_decode(data: bytes, gray: bool = False) -> np.ndarray:
    """Decode a baseline JPEG as libjpeg-turbo does by default: (H, W, 3)
    BGR, or (H, W) luma when ``gray``, in stored orientation (EXIF not
    applied)."""
    head = jpeg_header(data)
    shape = (head['height'], head['width']) + (() if gray else (3,))
    out = np.empty(shape, np.uint8)
    _jpeg_call(library().jpeg_decode, data, int(bool(gray)), _ptr(out))
    return out


def jpeg_coefficients(data: bytes):
    """The entropy-decoded, quantized DCT coefficients of a baseline JPEG:
    (header, [per component (block rows, block cols, 8, 8) int16, MCU-padded,
    natural order], [per component (8, 8) uint16 quantization table])."""
    head = jpeg_header(data)
    maxh = max(h for h, _ in head['sampling'])
    maxv = max(v for _, v in head['sampling'])
    mcus_x = -(-head['width'] // (8 * maxh))
    mcus_y = -(-head['height'] // (8 * maxv))
    shapes = [(mcus_y * v, mcus_x * h) for h, v in head['sampling']]
    coefs = np.zeros(sum(r * c * 64 for r, c in shapes), np.int16)
    qtables = np.zeros((3, 64), np.uint16)
    _jpeg_call(library().jpeg_coefficients, data,
               coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
               qtables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    blocks, at = [], 0
    for r, c in shapes:
        blocks.append(coefs[at:at + r * c * 64].reshape(r, c, 8, 8))
        at += r * c * 64
    return head, blocks, [qtables[i].reshape(8, 8)
                          for i in range(head['components'])]


def jpeg_encode(img: np.ndarray, quality: int = 95, subsampling: str = '420',
                orientation: int = 0) -> bytes:
    """Baseline JPEG bytes of a uint8 (H, W, 3) BGR or (H, W) gray image:
    libjpeg's quality scaling of the Annex K tables, the standard Huffman
    tables, ``subsampling`` '420' or '444' chroma, and an EXIF orientation
    tag when ``orientation`` is 1-8."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            img.ndim == 3 and img.shape[2] != 3:
        raise ValueError(f'JPEG takes uint8 (H, W) or (H, W, 3), got '
                         f'{img.dtype} {img.shape}')
    if subsampling not in ('420', '444'):
        raise ValueError(f"subsampling is '420' or '444', got {subsampling!r}")
    if not 0 <= orientation <= 8:
        raise ValueError(f'EXIF orientation is 1-8 (0: none), got {orientation}')
    src = np.ascontiguousarray(img)
    h, w = src.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f'JPEG sizes are 1-65535, got {h}x{w}')
    ch = 1 if src.ndim == 2 else 3
    cap = h * w * ch * 2 + 4096
    out = np.empty(cap, np.uint8)
    n = library().jpeg_encode(_ptr(src), h, w, ch, int(quality),
                              int(subsampling == '420'), int(orientation),
                              _ptr(out), cap)
    if n < 0:
        raise RuntimeError(f'JPEG encoder needed {-n} bytes, had {cap}')
    return out[:n].tobytes()
