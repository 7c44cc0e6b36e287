#!/usr/bin/env python3
"""Where the time of the PyTorch port's forward goes, on one GPU.

    python3 tools/torch_port_profile.py [--size 1024] [--iters 20]

Builds the flagship LED-Net (``configs/LED_Net/lednet_80k_cityscapes-1024x1024.py``)
with seeded random weights through ``lednet_tpu_torch.apis.init_model``, and
profiles bs=1 forwards (preprocess + ``predict``) with ``torch.profiler``, once
through the CUDA kernels and once through the plain module forms.  Prints,
per path: wall time per forward (host clock around synchronized forwards),
device busy time per forward (the sum of the device ops' self time), the
idle share 1 - busy/wall, the number of device ops per forward, the top
device kernels by time and the top aten ops by the device time they
launched, and last the whole report as one JSON line.  Needs a GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

CONFIG = 'configs/LED_Net/lednet_80k_cityscapes-1024x1024.py'


def _time_us(evt, names):
    for name in names:
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _self_device_us(evt):
    return _time_us(evt, ('self_device_time_total', 'self_cuda_time_total'))


def _device_us(evt):
    return _time_us(evt, ('device_time_total', 'cuda_time_total'))


def profile_path(model, x, impl, iters):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def forward():
        y, _, _ = model.data_preprocessor(x, impl=impl)
        return model.predict(y, impl)

    with torch.inference_mode():
        for _ in range(5):
            forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                forward()
            torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side entries (kernels, memcpy/memset) carry the device time
    # once; the host-side aten ops that launched them repeat it
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_self_device_us(e) for e in device) / 1e3 / iters
    n_ops = sum(e.count for e in device) / iters
    aten = [e for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith('aten::') and _device_us(e) > 0]

    def rows(evts, key):
        return [dict(name=e.key[:90], ms_per_forward=key(e) / 1e3 / iters,
                     calls_per_forward=e.count / iters)
                for e in sorted(evts, key=key, reverse=True)[:15]]
    return dict(impl=impl, wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                device_ops_per_forward=n_ops,
                top_kernels=rows(device, _self_device_us),
                top_aten_ops=rows(aten, _device_us))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--size', type=int, default=1024)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('torch_port_profile: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lednet_tpu_torch.apis import init_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = init_model(os.path.join(repo, CONFIG), device='cuda',
                       generator=torch.Generator().manual_seed(0))
    img = np.random.default_rng(0).integers(0, 256, (1, args.size, args.size, 3),
                                            dtype=np.uint8)
    x = torch.from_numpy(img).cuda()
    report = dict(card=card, size=args.size, iters=args.iters, paths=[])
    for impl in ('cuda', 'plain'):
        r = profile_path(model, x, impl, args.iters)
        report['paths'].append(r)
        print(f"[{impl}] wall {r['wall_ms']:.3f} ms/forward, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_ops_per_forward']:.0f} device ops/forward", flush=True)
        for title in ('top_kernels', 'top_aten_ops'):
            print(f'  {title}:', flush=True)
            for t in r[title]:
                print(f"    {t['ms_per_forward']:8.4f} ms  x{t['calls_per_forward']:5.1f}  "
                      f"{t['name']}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
