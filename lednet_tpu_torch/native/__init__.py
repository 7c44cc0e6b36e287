"""The port's host image library (``augment.cpp``), loaded with ``ctypes``.

Counterpart of ``lednet_tpu/native`` for the data pipeline: cv2's bilinear
and nearest uint8 resize, the PNG unfilter step and cv2's 8-bit BGR<->HSV,
in C++ so that loader threads run them without the interpreter lock.  One
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
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'augment.cpp'
BUILD_ROOT = Path(__file__).resolve().parents[1] / '_build' / 'native'
LIB_NAME = 'libledaug.so'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-ffp-contract=off')

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I = ctypes.c_int
SIGNATURES = {   # name -> (argtypes, restype)
    'resize_linear_u8': ([_U8, _I, _I, _I, _U8, _I, _I], None),
    'resize_nearest_u8': ([_U8, _I, _I, _I, _U8, _I, _I], None),
    'png_unfilter': ([_U8, _I, _I, _I, _U8], _I),
    'bgr2hsv_u8': ([_U8, ctypes.c_longlong, _U8], None),
    'hsv2bgr_u8': ([_U8, _I, _I, _U8], None),
}


def build() -> Path:
    """Compile the library unless this source is built already; returns its
    path.  Raises with the compiler's output on failure."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f'{LIB_NAME}.tmp{os.getpid()}'
    proc = subprocess.run(['g++', *CXX_FLAGS, str(SOURCE), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed to build {SOURCE.name} '
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
