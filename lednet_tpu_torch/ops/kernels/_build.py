"""Build and load the port's CUDA kernels, and dispatch between a kernel and
its plain PyTorch version.

Each of ``lednet_tpu_torch/csrc/*.cu`` is compiled by a plain ``nvcc -c``
for ``sm_90a``, all of them started together, and one more ``nvcc`` links
the objects into one shared library with a plain C interface, loaded with
``ctypes``.  PyTorch's headers are never included (``torch.utils.cpp_extension``
spends minutes on them), so the build takes the time of the slowest source.

The library lands in ``lednet_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and the flags; it is written
under a temporary name and moved into place with ``os.replace``, so a reader
never sees a half-written library.  Nothing is built or loaded at import time:
the first kernel launch builds.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG / '_build'
LIB_NAME = 'liblednet_kernels.so'
_ARCH = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = (*_ARCH, '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
# one source to an object; the objects to the library
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != '-shared') + ('-c',)
LINK_FLAGS = (*_ARCH, '-shared')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point: argument types in order (restype is int).
SIGNATURES = {
    'lednet_normalize_image': [_P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                               _I, _I, _P],
    'lednet_stem_fused': [_P] * 7 + [_I] * 10 + [_P],
    'lednet_basic_block': [_P] * 4 + [_I] * 8 + [_P],
    'lednet_sesp_reduce': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    'lednet_sesp_fused': [_P] * 11 + [_I] * 17 + [_P],
    'lednet_sesp_pyramid': [_P] * 4 + [_I] * 24 + [_P],
}


def _sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def build_dir() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    if not path.exists():
        raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                           'machine with the CUDA toolkit')
    return str(path)


def build() -> Path:
    """Compile the kernels unless this source hash is built already;
    returns the library's path."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f'tmp{os.getpid()}'
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = []
    for src in sorted(CSRC.glob('*.cu')):
        cmd = [nvcc, *COMPILE_FLAGS, '-o', str(out_dir / f'{src.stem}.{tag}.o'),
               str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    steps = [(cmd, proc.communicate()[0], proc.returncode)
             for cmd, proc in compiles]
    objs = [cmd[-2] for cmd, _, _ in steps]
    tmp = out_dir / f'{LIB_NAME}.{tag}'
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, *LINK_FLAGS, '-o', str(tmp), *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        steps.append((cmd, proc.stdout, proc.returncode))
    rc = max(step[2] for step in steps)
    log = (f'# {len(compiles)} sources compiled in parallel, then linked: '
           f'{time.perf_counter() - t0:.1f} s, rc={rc}\n' +
           ''.join(f'$ {" ".join(cmd)}\n# rc={code}\n{out}'
                   for cmd, out, code in steps))
    (out_dir / 'build.log').write_text(log)
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed (rc={rc}):\n{log[-6000:]}')
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lednet_error_string.argtypes = [ctypes.c_int]
    lib.lednet_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().lednet_error_string(code).decode()
        raise RuntimeError(f'{name}: CUDA error {code}: {msg}')


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """``None`` picks ``'cuda'`` for a CUDA tensor and ``'plain'`` for a CPU
    one.  ``'cuda'`` on a CPU tensor raises; there is no fallback."""
    if impl is None:
        return 'cuda' if x.is_cuda else 'plain'
    if impl not in ('cuda', 'plain'):
        raise ValueError(f"impl must be 'cuda', 'plain' or None, got {impl!r}")
    if impl == 'cuda' and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f'{x.device}')
    return impl


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: Optional[torch.device] = None) -> None:
    """Check what a kernel takes: device, dtype, shape and contiguity."""
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f'{name} must lie on {device or "a CUDA device"}, '
                         f'got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} must have shape {tuple(shape)}, got '
                         f'{tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
