#!/usr/bin/env python3
"""Where the time of the PyTorch port's forward goes, on one GPU.

    python3 tools/torch_port_profile.py [--size 1024] [--iters 20] [--config CFG]

Builds the flagship LED-Net (``configs/LED_Net/lednet_80k_cityscapes-1024x1024.py``,
or the model of ``--config``: DDRNet and BiSeNetV1 run kernel A alone and
skip the kernel E readings below)
with seeded random weights through ``lednet_tpu_torch.apis.init_model``, and
profiles bs=1 forwards (preprocess + ``predict``) with ``torch.profiler``, once
through the CUDA kernels and once through the plain module forms.  Prints,
per path: wall time per forward (host clock around synchronized forwards),
device busy time per forward (the sum of the device ops' self time), the
idle share 1 - busy/wall, the number of device ops per forward, the device
time and launches per forward of each of the port's CUDA kernels by op
(kernel D's reduce and fused launches; kernel E, which no model calls,
reads 0), the top device kernels by time and the top aten ops by the device
time they launched, and last the whole report as one JSON line.  Needs a
GPU.

    python3 tools/torch_port_profile.py --graph

adds a third path: the forward as the eval step replays it
(``lednet_tpu_torch.engine.make_eval_step``: one CUDA graph of preprocess +
``predict`` on the kernel path), with the same readings.  Every run also
reads kernel E's device time per launch at the pyramid shapes of the
forward's SESP calls (with and without the v2 stage, on seeded random
maps, as ``chip_smoke.py`` phase 3b checks them): no model calls E, so no
forward shows it.  ``--ops FILE`` also writes every device op (kernel,
memcpy, memset) of each path with its calls per forward to FILE, to diff
two trees' forwards.

    python3 tools/torch_port_profile.py --sesp-sweep

instead times kernel D's fused launch at every launch geometry that
``fused_candidates`` offers, at each distinct SESP call site of the
flagship's forward (CUDA events, 30 launches each), checks every geometry
against the plain version (max|kernel - plain| <= 1e-5 * max|plain|), and
prints per site the chosen geometry's time beside the fastest one's, then
one JSON line.
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


def eager_forward(model, x, impl):
    def forward():
        y, _, _ = model.data_preprocessor(x, impl=impl)
        return model.predict(y, impl)
    return forward


def profile_path(forward, impl, iters):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lednet_tpu_torch.ops.kernels import DEVICE_FUNCTIONS

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

    port = {}
    for op, fns in DEVICE_FUNCTIONS.items():
        per_fn = {fn: [e for e in device if f'lednet::{fn}' in e.key]
                  for fn in fns}
        port[op] = dict(
            ms_per_forward=sum(_self_device_us(e) for es in per_fn.values()
                               for e in es) / 1e3 / iters,
            launches_per_forward=sum(e.count for es in per_fn.values()
                                     for e in es) / iters,
            by_kernel={fn: sum(_self_device_us(e) for e in es) / 1e3 / iters
                       for fn, es in per_fn.items()})

    def rows(evts, key):
        return [dict(name=e.key[:90], ms_per_forward=key(e) / 1e3 / iters,
                     calls_per_forward=e.count / iters)
                for e in sorted(evts, key=key, reverse=True)[:15]]
    return dict(impl=impl, wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                device_ops_per_forward=n_ops, port_kernels=port,
                top_kernels=rows(device, _self_device_us),
                top_aten_ops=rows(aten, _device_us),
                device_ops={e.key: e.count / iters for e in device})


def _sesp_calls(model, x):
    """(args, kwargs) of every kernel-D call of one kernel-path forward."""
    import lednet_tpu_torch.models.espnet as espnet
    calls, op = [], espnet.sesp_block

    def record(*a, **kw):
        calls.append((a, kw))
        return op(*a, **kw)
    espnet.sesp_block = record
    try:
        y, _, _ = model.data_preprocessor(x, impl='cuda')
        model.predict(y, 'cuda')
    finally:
        espnet.sesp_block = op
    return calls


def pyramid_device_time(model, x, iters):
    """Kernel E's device ms per launch at each distinct pyramid shape of the
    forward's SESP calls, with the v2 stage and without."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lednet_tpu_torch.ops.kernels import sesp_pyramid
    gen = torch.Generator().manual_seed(0)
    shapes = {}
    for a, kw in _sesp_calls(model, x):
        xx, dw1, dw2 = a[0], a[4], a[5]
        shapes.setdefault((dw1.shape[1], *xx.shape[2:], tuple(kw['rates']),
                           kw['stride']), (xx.shape[0], dw1, dw2))
    launches = []
    for (n, H, W, rates, stride), (B, dw1, dw2) in shapes.items():
        red = torch.randn((B, n, H, W), generator=gen).cuda()
        for d2 in (dw2, None):
            launches.append(lambda red=red, dw1=dw1, d2=d2, rates=rates,
                            stride=stride: sesp_pyramid(red, dw1, d2, rates,
                                                        stride=stride,
                                                        impl='cuda'))
    for launch in launches:
        launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for launch in launches:
                launch()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and 'lednet::sesp_pyramid_kernel' in e.key]
    count = sum(e.count for e in evts)
    return dict(shapes=len(launches), launches=count,
                ms_per_launch=sum(_self_device_us(e) for e in evts) / 1e3 / count)


def sesp_sweep(model, x):
    """Time every fused-launch geometry of kernel D at the forward's SESP
    call sites (see the module docstring)."""
    import torch
    from lednet_tpu_torch.ops.kernels import _build
    kmod = sys.modules['lednet_tpu_torch.ops.kernels.sesp_pyramid']
    calls = _sesp_calls(model, x)
    lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
    sites, seen = [], set()
    for a, kw in calls:
        (xx, wred, bred, a1, dw1, dw2, s2, b2, a2, wexp, bexp, a3) = a
        key = (tuple(xx.shape), tuple(dw1.shape), kw['rates'], kw['stride'])
        if key in seen:
            continue
        seen.add(key)
        B, cin, H, W = xx.shape
        k, n = dw1.shape[:2]
        rates, stride, tail = tuple(kw['rates']), kw['stride'], kw['tail']
        ref = kmod.sesp_block_plain(*a, rates, stride, tail)
        red = torch.einsum('oi,bihw->bohw', wred, xx) + bred.view(1, -1, 1, 1)
        red = torch.where(red >= 0, red, a1.view(1, -1, 1, 1) * red)
        out, wt = torch.empty_like(ref), wexp.t().contiguous()
        chosen = kmod.fused_config(B, H, W, n, k, rates, stride, dw2 is not None)
        rows = []
        for _, c in kmod.fused_candidates(B, H, W, n, k, rates, stride,
                                          dw2 is not None):
            def launch(c=c):
                return lib.lednet_sesp_fused(
                    red.data_ptr(), dw1.data_ptr(), _build.ptr(dw2),
                    s2.data_ptr(), b2.data_ptr(), a2.data_ptr(), wt.data_ptr(),
                    bexp.data_ptr(), a3.data_ptr(),
                    xx.data_ptr() if tail == 'residual' else None,
                    out.data_ptr(), B, n, H, W, k, *rates, stride,
                    kmod.TAILS[tail], c.th, c.tw, c.oc, c.jc, c.cs, c.ppt,
                    stream)
            out.fill_(float('nan'))
            _build.check(launch(), 'sesp_sweep')
            torch.cuda.synchronize()
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            if not err <= 1e-5:
                raise AssertionError(f'{key} {c}: rel {err:.3e}')
            for _ in range(3):
                launch()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(30):
                launch()
            end.record()
            torch.cuda.synchronize()
            rows.append(dict(config=c._asdict(), ms=start.elapsed_time(end) / 30,
                             rel=err))
        best = min(rows, key=lambda r: r['ms'])
        mine = next(r for r in rows if r['config'] == chosen._asdict())
        sites.append(dict(input=key[0], n=n, rates=rates, stride=stride,
                          calls=sum(1 for a_, kw_ in calls if
                                    (tuple(a_[0].shape), tuple(a_[4].shape),
                                     kw_['rates'], kw_['stride']) == key),
                          candidates=len(rows), chosen=mine, fastest=best))
        print(f"  x{'x'.join(map(str, key[0]))} n={n} rates={rates} "
              f"stride={stride}: chosen {mine['ms']:.4f} ms {chosen}; fastest "
              f"{best['ms']:.4f} ms {best['config']}; {len(rows)} geometries, "
              f"max rel err {max(r['rel'] for r in rows):.2e}", flush=True)
    for key in ('chosen', 'fastest'):
        total = sum(s_['calls'] * s_[key]['ms'] for s_ in sites)
        print(f'  {key}: {total:.4f} ms of fused launches per forward', flush=True)
    return sites


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--config', default=CONFIG,
                    help='the model to profile (default: the flagship LED-Net)')
    ap.add_argument('--size', type=int, default=1024)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--graph', action='store_true',
                    help='also profile the replayed CUDA graph of the eval step')
    ap.add_argument('--ops', metavar='FILE',
                    help='write every device op of each path, with its calls '
                         'per forward, to FILE as JSON')
    ap.add_argument('--sesp-sweep', action='store_true',
                    help="time every launch geometry of kernel D's fused "
                         'launch at the SESP call sites instead')
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
    model = init_model(os.path.join(repo, args.config), device='cuda',
                       generator=torch.Generator().manual_seed(0))
    img = np.random.default_rng(0).integers(0, 256, (1, args.size, args.size, 3),
                                            dtype=np.uint8)
    x = torch.from_numpy(img).cuda()
    if args.sesp_sweep:
        with torch.inference_mode():
            sites = sesp_sweep(model, x)
        print(json.dumps(dict(card=card, size=args.size, sesp_sweep=sites)),
              flush=True)
        return 0
    report = dict(card=card, size=args.size, iters=args.iters, paths=[])
    paths = [('cuda', eager_forward(model, x, 'cuda')),
             ('plain', eager_forward(model, x, 'plain'))]
    if args.graph:
        from lednet_tpu_torch.engine import make_eval_step
        step = make_eval_step(model, model.data_preprocessor)
        paths.append(('graph', lambda: step(x)))
    ops = {}
    for impl, forward in paths:
        r = profile_path(forward, impl, args.iters)
        ops[impl] = r.pop('device_ops')
        report['paths'].append(r)
        print(f"[{impl}] wall {r['wall_ms']:.3f} ms/forward, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_ops_per_forward']:.0f} device ops/forward", flush=True)
        print('  port_kernels:', flush=True)
        for op, k in r['port_kernels'].items():
            parts = ', '.join(f'{fn} {ms:.4f}' for fn, ms in k['by_kernel'].items())
            print(f"    {k['ms_per_forward']:8.4f} ms  x{k['launches_per_forward']:5.1f}  "
                  f"{op} ({parts})", flush=True)
        for title in ('top_kernels', 'top_aten_ops'):
            print(f'  {title}:', flush=True)
            for t in r[title]:
                print(f"    {t['ms_per_forward']:8.4f} ms  x{t['calls_per_forward']:5.1f}  "
                      f"{t['name']}", flush=True)
    if args.config == CONFIG:
        with torch.inference_mode():
            report['sesp_pyramid'] = e = pyramid_device_time(model, x, args.iters)
        print(f"[sesp_pyramid] {e['ms_per_launch']:.4f} ms device time per "
              f"launch over {e['launches']} launches at {e['shapes']} pyramid "
              f"shapes", flush=True)
    if args.ops:
        with open(args.ops, 'w') as f:
            json.dump(dict(card=card, size=args.size, paths=ops), f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
