#!/usr/bin/env python3
"""Where the time of kernel E (``sesp_pyramid``) goes, on one GPU: phase
knockouts and a per-item cycle breakdown.

    python3 tools/torch_port_pyramid_probe.py [--set val|flagship]

The kernel library is built by ``nvcc`` from a copy of
``lednet_tpu_torch/csrc/`` into ``lednet_tpu_torch/_build/probe/pyramid/``
(git-ignored), with ``sesp_pyramid.cu`` patched: a ``__constant__`` mask of
knockout bits and ``clock64`` accounting.  The process loads that library
alone (two copies of the kernel library in one process do not launch), so
the flagship forward that gives the pyramid shapes runs on it too.

1. Knockouts, device time per call (``torch.profiler``) at the set's 16
   pyramid calls, as ``chip_smoke.py`` phase 3b builds them (the
   flagship's 8 pyramid shapes with and without the v2 stage; ``val``: at
   Runner.val's B=8 and W doubled), beside the full
   kernel: without the output stores, and without the v2 stage (its
   stores go with it).  The outputs are then wrong; they are not checked.
   The time a phase costs is the full time less the time without it;
   phases that overlap do not add up.
2. Cycles per item (``clock64`` of threads 0 and 255, summed over every
   item of every CTA by atomics): the wait for the item's box, stage 1,
   the barrier after it, stage 2 (v2), and the barrier at the item's end.
   Thread 255 takes one stage-1 strip where a 64-row tile has more strips
   than threads and thread 0 two: its barrier wait is the imbalance.

Prints one line per measurement and last one JSON line.  Needs a GPU and
``nvcc``.
"""
import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / 'lednet_tpu_torch' / 'csrc'
OUT = REPO / 'lednet_tpu_torch' / '_build' / 'probe' / 'pyramid'

NO_STORES, NO_STAGE2, CLOCKS = 1, 2, 4

# (text, patched text): each must match csrc/sesp_pyramid.cu exactly once
PATCHES = [
    ('namespace lednet {\nnamespace ring {\n',
     'namespace lednet {\n__constant__ int g_knock;\n'
     '__device__ unsigned long long g_clock[16];\nnamespace ring {\n'),
    ('  const int lane = threadIdx.x & 31, odd = lane & 1;\n',
     '  if (g_knock & 1) return;\n'
     '  const int lane = threadIdx.x & 31, odd = lane & 1;\n'),
    ('    if (tma) {\n      mbar_wait(',
     '    const long long c0 = clock64();\n    if (tma) {\n      mbar_wait('),
    ('    const Item item = item_at(G, first + it * step);\n',
     '    const long long c1 = clock64();\n'
     '    const Item item = item_at(G, first + it * step);\n'),
    ("    if (v2) {  // stage 2: branch g's v2 at dilation rates[g] + 1\n"
     "      __syncthreads();\n",
     "    long long c2 = clock64(), c3 = c2, c4 = c2;\n"
     "    if (v2 && !(g_knock & 2)) {  // stage 2\n"
     "      __syncthreads();\n      c3 = clock64();\n"),
    ('    if (it + 1 < mine && threadIdx.x < G.k * kTap)\n',
     '    if (v2 && !(g_knock & 2)) c4 = clock64();\n'
     '    if (it + 1 < mine && threadIdx.x < G.k * kTap)\n'),
    ('    __syncthreads();  // the box and the sums are free, the next taps in\n',
     '    __syncthreads();  // the box and the sums are free, the next taps in\n'
     '    if ((g_knock & 4) && (threadIdx.x == 0 || threadIdx.x == 255)) {\n'
     '      unsigned long long* p = g_clock + (threadIdx.x ? 8 : 0);\n'
     '      const long long c5 = clock64();\n'
     '      atomicAdd(p, c1 - c0);\n      atomicAdd(p + 1, c2 - c1);\n'
     '      atomicAdd(p + 2, c3 - c2);\n      atomicAdd(p + 3, c4 - c3);\n'
     '      atomicAdd(p + 4, c5 - c4);\n      atomicAdd(p + 5, 1ull);\n'
     '    }\n'),
]
PROBE_API = r'''
LEDNET_API int probe_knock(int v) {
  return (int)cudaMemcpyToSymbol(lednet::g_knock, &v, sizeof(int));
}
LEDNET_API int probe_clock(unsigned long long* host, int reset) {
  unsigned long long zero[16] = {0};
  if (reset) return (int)cudaMemcpyToSymbol(lednet::g_clock, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, lednet::g_clock, sizeof(zero));
}
'''
PHASES = ('wait', 'stage1', 'sync1', 'stage2', 'sync2')


def build():
    """The patched library; returns its path."""
    sys.path.insert(0, str(REPO))
    from lednet_tpu_torch.ops.kernels import _build
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    for src in [*CSRC.glob('*.cuh'), *CSRC.glob('*.cu')]:
        shutil.copy(src, OUT)
    text = (CSRC / 'sesp_pyramid.cu').read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f'probe patch does not match once: {old!r}')
        text = text.replace(old, new)
    (OUT / 'sesp_pyramid.cu').write_text(text + PROBE_API)
    so = OUT / 'libprobe.so'
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(so),
                           *map(str, sorted(OUT.glob('*.cu')))],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed:\n{proc.stdout}{proc.stderr}'[-6000:])
    for line in (proc.stdout + proc.stderr).splitlines():
        if 'pyramid_ring' in line or 'registers' in line or 'spill' in line:
            print('  ' + line.strip(), flush=True)
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--set', choices=('val', 'flagship'), default='val')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_port_pyramid_probe: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / 'tools'))
    import numpy as np
    from chip_smoke import device_ms
    from torch_port_profile import CONFIG, pyramid_sets
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.ops.kernels import _build, sesp_pyramid
    kmod = sys.modules['lednet_tpu_torch.ops.kernels.sesp_pyramid']
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    so = build()
    _build.build = lambda: so       # every kernel launches from the probe
    lib = _build.library()
    lib.probe_knock.argtypes = [ctypes.c_int]
    lib.probe_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    torch.backends.cudnn.allow_tf32 = False
    model = init_model(str(REPO / CONFIG), device='cuda',
                       generator=torch.Generator().manual_seed(0))
    img = np.random.default_rng(0).integers(0, 256, (1, 1024, 1024, 3),
                                            dtype=np.uint8)
    with torch.inference_mode():
        calls = pyramid_sets(model, torch.from_numpy(img).cuda(),
                             args.set == 'val')[args.set]
    report = dict(card=card, set=args.set, rows={}, clocks={})
    for row, knock in (('full', 0), ('no output stores', NO_STORES),
                       ('no v2 stage', NO_STAGE2)):
        assert lib.probe_knock(knock) == 0
        times = []
        with torch.inference_mode():
            for label, red, dw1, d2, rates, stride in calls:
                times.append(device_ms(
                    lambda: sesp_pyramid(red, dw1, d2, rates, stride=stride,
                                         impl='cuda'), 'sesp_pyramid'))
        report['rows'][row] = times
        print(f'[{row}] {sum(times):.4f} ms over {len(times)} calls: '
              + ' '.join(f'{t:.4f}' for t in times), flush=True)
    assert lib.probe_knock(CLOCKS) == 0
    with torch.inference_mode():
        for label, red, dw1, d2, rates, stride in calls:
            run = lambda: sesp_pyramid(red, dw1, d2, rates, stride=stride,
                                       impl='cuda')
            run()
            torch.cuda.synchronize()
            assert lib.probe_clock(None, 1) == 0
            for _ in range(10):
                run()
            torch.cuda.synchronize()
            got = (ctypes.c_ulonglong * 16)()
            assert lib.probe_clock(ctypes.addressof(got), 0) == 0
            geo = kmod.pyramid_geometry(*red.shape[:1], *red.shape[2:],
                                        red.shape[1], len(rates), tuple(rates),
                                        stride, d2 is not None)
            per = {}
            for thread, base in ((0, 0), (255, 8)):
                items = max(got[base + 5], 1)
                per[thread] = {p: got[base + i] / items
                               for i, p in enumerate(PHASES)}
            report['clocks'][label] = dict(tile=(geo.th, geo.tw), **{
                f'thread{t}': v for t, v in per.items()})
            print(f'  {label}, tile {geo.th}x{geo.tw}: cycles per item, '
                  + '; '.join(f'thread {t} ' + ' '.join(
                      f'{p} {c:.0f}' for p, c in v.items())
                      for t, v in per.items()), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
