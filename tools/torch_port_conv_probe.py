#!/usr/bin/env python3
"""Where the time of kernels B (``stem_convs``) and C (``basic_pair``) goes,
on one GPU: the card's ``mma.sync`` TF32 rate and phase knockouts.

    python3 tools/torch_port_conv_probe.py

1. ``mma.sync.m16n8k8`` TF32 throughput: a register-only kernel of
   independent MMAs, at several occupancies; what the 3xTF32 convs can reach
   at most (three MMAs per float32 product).
2. Knockouts: copies of ``lednet_tpu_torch/csrc``'s conv sources, each phase
   guarded by a bit of a ``__constant__`` mask, built by ``nvcc`` into
   ``lednet_tpu_torch/_build/probe/`` (git-ignored).  Each row turns one or
   more phases off (the outputs are then wrong; they are not checked) and
   reports the device time per call from ``torch.profiler`` at the
   flagship's shapes: B on a (1, 3, 1024, 1024) bf16 image, C (two
   launches) on a (1, 32, 256, 256) map.  The time a phase costs is
   the full time less the time without it; phases that overlap do not add
   up.

Prints one line per measurement and last one JSON line.  Needs a GPU and
``nvcc``.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / 'lednet_tpu_torch' / 'csrc'
OUT = REPO / 'lednet_tpu_torch' / '_build' / 'probe'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

# knockout bits
NO_MMA, NO_OUT_STORE, NO_INPUT_STAGING, NO_WEIGHT_STAGING = 1, 2, 4, 8
RING_FILL_ONLY, FIRST_CONV_ONLY = 16, 32
NO_CONV1_MMA, NO_X1_STORE, NO_CONV2 = 64, 128, 256

# (file, text, guarded text): each must match the sources exactly once
PATCHES = [
    ('conv3x3_core.cuh', 'constexpr int kConvThreads = 256;',
     'constexpr int kConvThreads = 256;\n__constant__ int g_knock;\n'
     'LEDNET_API int probe_knock(int v) {\n'
     '  return (int)cudaMemcpyToSymbol(g_knock, &v, sizeof(int));\n}'),
    ('conv3x3_core.cuh',
     '          const int o0 = poff[m][0] + o, o1 = poff[m][1] + o;',
     '          if (g_knock & 1) continue;\n'
     '          const int o0 = poff[m][0] + o, o1 = poff[m][1] + o;'),
    ('conv_block.cu', '            x.outb[co * x.plane',
     '            if (!(g_knock & 2)) x.outb[co * x.plane'),
    ('conv_block.cu', '      if (g < K::CH) {',
     '      if (g < K::CH && !(g_knock & 4)) {'),
    ('conv_block.cu', '      stage_frags(ring',
     '      if (!(g_knock & 8)) stage_frags(ring'),
    ('conv_block.cu', '  for (int g = 0; g < K::S; ++g) ctx.issue(g);',
     '  for (int g = 0; g < K::S; ++g) ctx.issue(g);\n'
     '  if (g_knock & 16) { cp_async_wait<0>(); return; }'),
    ('conv_block.cu', '  block_stage<C, 0>(ctx);',
     '  block_stage<C, 0>(ctx);\n  if (g_knock & 32) return;'),
    ('stem_conv.cu',
     '      for (int ks = 0; ks < K::KS1; ++ks) {\n        uint32_t bh[NT][2]',
     '      for (int ks = 0; ks < ((g_knock & 64) ? 0 : K::KS1); ++ks) {\n'
     '        uint32_t bh[NT][2]'),
    ('stem_conv.cu', 'if (gy >= H1 || gx >= W1) continue;',
     'if ((g_knock & 128) || gy >= H1 || gx >= W1) continue;'),
    ('stem_conv.cu', '        conv_chunk<NT, 1, 3>(acc, xs + 8 * q * K::XCS',
     '        if (!(g_knock & 256)) conv_chunk<NT, 1, 3>(acc, xs + 8 * q * K::XCS'),
]

MMA_BENCH = r'''
#include "conv3x3_core.cuh"
using namespace lednet;
template <int NACC>
__global__ void mma_rate_kernel(float* out, int iters) {
  float acc[NACC][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) mma_tf32(acc[k], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NACC; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  if (s == 1.2345f) out[threadIdx.x] = s;
}
LEDNET_API int probe_mma(float* out, int blocks, int threads, int iters) {
  mma_rate_kernel<8><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
'''


def build():
    """The patched sources and the MMA benchmark, one library each."""
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    for name in ('common.cuh', 'conv3x3_core.cuh', 'conv_block.cu',
                 'stem_conv.cu'):
        shutil.copy(CSRC / name, OUT / name)
    for name, old, new in PATCHES:
        text = (OUT / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f'{name}: the probe no longer matches the '
                               f'sources at {old!r}')
        (OUT / name).write_text(text.replace(old, new))
    (OUT / 'mma_rate.cu').write_text(MMA_BENCH)
    nvcc = shutil.which('nvcc') or str(Path(os.environ.get(
        'CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc')
    libs = {}
    for src in ('conv_block.cu', 'stem_conv.cu', 'mma_rate.cu'):
        so = OUT / f'lib{Path(src).stem}.so'
        subprocess.run([nvcc, *NVCC_FLAGS, '-o', str(so), str(OUT / src)],
                       check=True)
        libs[Path(src).stem] = ctypes.CDLL(str(so))
    return libs


def device_ms(fn, n=20):
    """Mean device time per call of the lednet kernels fn launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    keys = ('lednet::', 'mma_rate_kernel')
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(k in e.key for k in keys)) / 1e3 / n


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('torch_port_conv_probe: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lednet_tpu_torch.ops.kernels.conv3x3 import (block_config,
                                                      pair_fragments,
                                                      stem_config,
                                                      stem_fragments)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build()
    P, I = ctypes.c_void_p, ctypes.c_int
    libs['mma_rate'].probe_mma.argtypes = [P, I, I, I]
    libs['conv_block'].lednet_basic_block.argtypes = [P] * 4 + [I] * 8 + [P]
    libs['stem_conv'].lednet_stem_fused.argtypes = [P] * 7 + [I] * 10 + [P]
    report = dict(card=card, mma_tf32=[], stem=[], pair=[])

    scratch = torch.zeros(1024, device='cuda')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for blocks, threads in ((sms, 128), (sms, 256), (2 * sms, 256),
                            (4 * sms, 256)):
        t = device_ms(lambda: libs['mma_rate'].probe_mma(
            scratch.data_ptr(), blocks, threads, iters), 5)
        mmas = blocks * threads // 32 * iters * 8
        tflops = mmas * 2 * 16 * 8 * 8 / (t * 1e-3) / 1e12
        print(f'mma.sync m16n8k8 TF32, {blocks} CTAs x {threads} threads: '
              f'{tflops:.1f} TFLOP/s', flush=True)
        report['mma_tf32'].append(dict(ctas=blocks, threads=threads,
                                       tflops=tflops))

    gen = torch.Generator().manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    C = 32
    w1 = (0.3 * torch.randn(C, 3, 3, 3, generator=gen)).cuda()
    w2 = (0.1 * torch.randn(C, C, 3, 3, generator=gen)).cuda()
    b1, b2 = torch.zeros(C, device='cuda'), torch.zeros(C, device='cuda')
    f1, f2 = stem_fragments(w1, w2)
    x = torch.randn(1, 3, 1024, 1024, generator=gen).cuda().bfloat16()
    x1 = torch.empty(1, C, 512, 512, device='cuda')
    x2 = torch.empty(1, C, 256, 256, device='cuda')
    cfg = stem_config(1, C, 1024, 1024, True, sms)
    stem = lambda: libs['stem_conv'].lednet_stem_fused(
        x.data_ptr(), f1.data_ptr(), b1.data_ptr(), f2.data_ptr(),
        b2.data_ptr(), x1.data_ptr(), x2.data_ptr(), 1, 3, C, 1024, 1024, 1,
        cfg.th, cfg.tw, cfg.smem, cfg.grid[0], stream())
    for what, knock in (('full', 0), ('no conv1 MMAs', NO_CONV1_MMA),
                        ('no x1 stores', NO_X1_STORE),
                        ('no conv2', NO_CONV2),
                        ('image, epilogues and staging only',
                         NO_CONV1_MMA | NO_X1_STORE | NO_CONV2)):
        libs['stem_conv'].probe_knock(knock)
        t = device_ms(stem)
        print(f'stem_convs [{what}]: {t:.4f} ms', flush=True)
        report['stem'].append(dict(knockout=what, ms=t))

    ws = (0.08 * torch.randn(4, C, C, 3, 3, generator=gen)).cuda()
    bs = torch.zeros(4, C, device='cuda')
    fp = pair_fragments(ws)
    xp = torch.randn(1, C, 256, 256, generator=gen).relu().cuda()
    h, out = torch.empty_like(xp), torch.empty_like(xp)
    cfg = block_config(1, C, 256, 256)

    def pair():
        for conv0, v, o in ((0, xp, h), (2, h, out)):
            libs['conv_block'].lednet_basic_block(
                v.data_ptr(), fp.data_ptr(), bs.data_ptr(), o.data_ptr(), 1, C,
                256, 256, conv0, cfg.th, cfg.tw, cfg.smem, stream())
    for what, knock in (('full', 0), ('no MMAs', NO_MMA),
                        ('no input staging', NO_INPUT_STAGING),
                        ('no weight staging', NO_WEIGHT_STAGING),
                        ('no output stores', NO_OUT_STORE),
                        ('first ring fill only', RING_FILL_ONLY),
                        ('first conv of each block only', FIRST_CONV_ONLY)):
        libs['conv_block'].probe_knock(knock)
        t = device_ms(pair)
        print(f'basic_pair [{what}]: {t:.4f} ms', flush=True)
        report['pair'].append(dict(knockout=what, ms=t))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
