#!/usr/bin/env python3
"""Where the time of the PyTorch port's forward goes, on one GPU.

    python3 tools/torch_port_profile.py [--size 1024 | --hw H W] [--iters 20] [--config CFG]
        [--cfg-options KEY=VALUE ...]

Builds the flagship LED-Net (``configs/LED_Net/lednet_80k_cityscapes-1024x1024.py``,
or the model of ``--config``: DDRNet, BiSeNetV1, PIDNet, STDC, BiSeNetV2,
HRNet, SegNeXt, UNet, ICNet, Fast-SCNN, ERFNet, CGNet, LR-ASPP, SCTNet,
RTFormer, PSPNet, DeepLabV3+, OCRNet, PointRend, SegFormer, Swin, K-Net,
Mask2Former, SAN (``--cfg-options model.image_encoder.out_origin=True``)
and the ViT and FPN ``_base_`` files as ``chip_smoke.compose_base``
composes them run kernel A alone and skip the kernel E readings
below) with seeded random weights through ``lednet_tpu_torch.apis.init_model``,
and profiles bs=1 forwards (preprocess + ``predict``, or ``predict_slide``
where the config's ``test_cfg`` says slide) of a ``--size`` square or an
``--hw`` frame (the DRIVE frame as ``inference_model`` pads it: ``--hw 608
576``) with ``torch.profiler``, once through the CUDA kernels and once
through the plain module forms.  Prints,
per path: wall time per forward (host clock around synchronized forwards),
device busy time per forward (the sum of the device ops' self time), the
idle share 1 - busy/wall, the number of device ops per forward, the device
time per forward by kind (``by_kind``: convolutions, BatchNorm, the other
norms (GroupNorm, LayerNorm), the rest; by the device kernels' names,
:func:`kind_of`), the device time per forward of the Hamburger head's NMF
(``nmf_ms``: the device time of the kernels launched inside a profiler
range that this script puts around each call of ``ham_head._nmf``; 0 for
other models and in a replayed graph, which runs no host code), that of
SCTNet's and RTFormer's attention the same way (``attention_ms``: ranges
around ``ConvolutionalAttention``, ``ExternalAttention`` and
``CrossResolutionAttention``; its kernels count in ``by_kind`` too), and
of K-Net's and MaskFormer's heads (``kernel_update_ms``: each
``KernelUpdateHead`` stage; ``pixel_decoder_ms``: MaskFormer's pixel
decoder, FPN or deformable; ``transformer_decoder_ms``: its decoder
layers; ``matching_ms``: the Hungarian assignment, a host round trip, in
a ``--train`` step, SAN's too), of SAN's parts (``text_encoder_ms``: the
CLIP text tower; ``side_adapter_ms``: the side adapter network with its
mask decoder; ``recognition_ms``: ``RecWithAttnbias``), each also as
``*_host_ms``, the host time inside the range), the device
time and launches per forward of each of the port's CUDA kernels by op
(kernel D's reduce and fused launches; kernel E, which no model calls,
reads 0), the top device kernels by time and the top aten ops by the device
time they launched, and last the whole report as one JSON line.  In slide
mode it also reads each part of the slide forward alone, under a profiler
of its own on the kernel path (``slide_parts``: device launches and
device ms per forward of the crop gather, ``slide_crops``; the backbone on
the stacked crops, ``extract_feat``; the decode head with its resize to the
crop; the accumulate, ``slide_accumulate``: every crop added in grid order,
then the division by the visit count).  ``--cudnn-benchmark`` lets cuDNN
time its algorithms for each conv shape (``torch.backends.cudnn.benchmark``)
before the profiles; the port leaves that flag off.  Needs a GPU.

    python3 tools/torch_port_profile.py --graph

adds a third path: the forward as the eval step replays it
(``lednet_tpu_torch.engine.make_eval_step``: one CUDA graph of preprocess +
``predict`` on the kernel path), with the same readings.  Every run also
reads kernel E's device time per launch at each pyramid shape of the
forward's SESP calls (with and without the v2 stage, on seeded random
maps, as ``chip_smoke.py`` phase 3b checks them), one profiler session per
shape, by the device function names in ``ops.kernels.DEVICE_FUNCTIONS``:
no model calls E, so no forward shows it.  ``--ops FILE`` also writes
every device op (kernel, memcpy, memset) of each path with its calls per
forward to FILE, to diff two trees' forwards.

    python3 tools/torch_port_profile.py --config CFG --train

instead profiles the config's train step (``make_train_step``, TF32 off;
in bfloat16 where the config sets ``bf16``) at its train batch and its
loader's crop (``chip_smoke.loader_crop``: the pipeline's ``RandomCrop``,
which for STDC and the real-time zoo is larger than the preprocessor's
``size``) (``chip_smoke.train_batch``; with edge maps
where the pipeline has ``GenerateEdge``), ``--iters`` steps after two, with
the same readings per step.

    python3 tools/torch_port_profile.py --config CFG --hw H W --macs

counts the multiply-adds of one forward's convs and Linear layers on the
CPU (no GPU needed) and prints them as one JSON line.

    python3 tools/torch_port_profile.py --pyramid [--val]

reads kernel E alone, without the forward profiles; ``--val`` (also with
the forward profiles) adds the same shapes at ``Runner.val``'s batch and
frame width (8 x 1024 x 2048: B=8 and W doubled).

    python3 tools/torch_port_profile.py --pyramid-sweep [--val]

instead times kernel E at every tile that fits two CTAs per SM (th 8-64,
tw 16 or 32, a ring of 2 or 3 boxes) at each of those shapes, and the
chosen tile also with its boxes loaded by cp.async in place of TMA, checks
each against the plain version, and prints per shape the tile that
``pyramid_geometry`` chooses beside the fastest one and beside its
cp.async form.

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
# the profiler ranges main() puts around calls
RANGES = ('nmf', 'attention', 'kernel_update', 'pixel_decoder',
          'transformer_decoder', 'matching', 'text_encoder', 'side_adapter',
          'recognition')


def _time_us(evt, names):
    for name in names:
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _self_device_us(evt):
    return _time_us(evt, ('self_device_time_total', 'self_cuda_time_total'))


def _device_us(evt):
    return _time_us(evt, ('device_time_total', 'cuda_time_total'))


def kind_of(kernel: str) -> str:
    """'conv', 'batch_norm', 'norm' or 'rest' by a device kernel's name:
    cuDNN's and PyTorch's own convolution kernels (implicit GEMMs, direct
    and grouped convolutions, forward and backward; the NMF's batched
    matmuls too), BatchNorm's (cuDNN's ``bn_fw`` / ``bn_bw``, PyTorch's
    ``batch_norm``), GroupNorm's and LayerNorm's (PyTorch's
    ``group_norm`` / ``GroupNorm`` / ``layer_norm`` / ``LayerNorm``
    kernels and their moments); layout transposes, resizes, pools,
    elementwise ops and the port's kernels are the rest."""
    name = kernel.lower()
    if any(k in name for k in ('bn_fw', 'bn_bw', 'batch_norm', 'batchnorm')):
        return 'batch_norm'
    if any(k in name for k in ('group_norm', 'groupnorm', 'layer_norm',
                               'layernorm', 'rowwisemoments',
                               'computefusedparams')):
        return 'norm'
    if any(k in name for k in ('conv', 'xmma', 'gemm', 'winograd', 'cutlass')):
        return 'conv'
    return 'rest'


def eager_forward(model, x, impl):
    predict = (model.predict_slide if model.test_cfg.get('mode') == 'slide'
               else model.predict)

    def forward():
        y, _, _ = model.data_preprocessor(x, impl=impl)
        return predict(y, impl)
    return forward


def slide_parts(model, x, iters):
    """Each part of the slide forward of ``x`` (kernel path) alone, on
    the inputs the forward gives it, under a profiler of its own:
    {part: {launches_per_forward, device_ms_per_forward}}, and the crops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lednet_tpu_torch.models.segmentors.encoder_decoder import _slide_grid
    crop = tuple(model.test_cfg['crop_size'])
    y, _, _ = model.data_preprocessor(x)
    H, W = y.shape[1:3]
    starts = _slide_grid(H, W, crop, tuple(model.test_cfg['stride']))
    crops = model.slide_crops(y.permute(0, 3, 1, 2), starts, crop)
    feats = model.extract_feat(crops, 'cuda')
    logits = model.decode_head.predict_by_feat(model.decode(feats), crop)
    parts = {
        'gather': lambda: model.slide_crops(y.permute(0, 3, 1, 2), starts, crop),
        'backbone': lambda: model.extract_feat(crops, 'cuda'),
        'head': lambda: model.decode_head.predict_by_feat(
            model.decode(feats), crop),
        'accumulate': lambda: model.slide_accumulate(logits, starts, (H, W))}
    out = dict(crops=len(starts))
    for name, part in parts.items():
        for _ in range(3):
            part()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                part()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        out[name] = dict(
            launches_per_forward=sum(e.count for e in device) / iters,
            device_ms_per_forward=sum(_self_device_us(e) for e in device)
            / 1e3 / iters)
    return out


def train_step(model):
    """One call of the config's train step per call (see ``--train``)."""
    import numpy as np
    import torch
    import chip_smoke
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_train_step)
    from lednet_tpu_torch.models.segmentors.cascade_encoder_decoder import \
        predicting_head_cfg
    cfg = model.cfg
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    step = make_train_step(model, opt, model.data_preprocessor,
                           amp=bool(cfg.get('bf16', False)))
    state = create_train_state(model, opt, sched)
    imgs, lbl = chip_smoke.train_batch(
        np.random.default_rng(0), cfg.train_dataloader.batch_size,
        chip_smoke.loader_crop(cfg), chip_smoke.edge_width(cfg),
        predicting_head_cfg(cfg.model)['num_classes'])
    imgs, lbl = imgs.cuda(), chip_smoke.to_device(lbl, 'cuda')

    def run():
        nonlocal state
        state, _ = step(state, imgs, lbl)
    return run


def profile_path(forward, impl, iters):
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lednet_tpu_torch.ops.kernels import DEVICE_FUNCTIONS

    with (contextlib.nullcontext() if impl == 'train' else
          torch.inference_mode()):
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
    # once; the host-side aten ops that launched them repeat it.  The NMF's
    # range shows on the device too, as a span: not a device op
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.key not in RANGES]
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
    by_kind = {'conv': 0.0, 'batch_norm': 0.0, 'norm': 0.0, 'rest': 0.0}
    for e in device:
        by_kind[kind_of(e.key)] += _self_device_us(e) / 1e3 / iters
    ranged = {f'{r}_ms': sum(_device_us(e) for e in events if e.key == r and
                             e.device_type == DeviceType.CPU) / 1e3 / iters
              for r in RANGES}
    ranged.update({f'{r}_host_ms': sum(e.cpu_time_total for e in events
                                       if e.key == r and
                                       e.device_type == DeviceType.CPU)
                   / 1e3 / iters for r in RANGES})
    return dict(impl=impl, wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                device_ops_per_forward=n_ops, by_kind=by_kind, **ranged,
                port_kernels=port,
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


def pyramid_sets(model, x, val=False):
    """Kernel E's operands by set, as ``chip_smoke.py`` phase 3b builds
    them (``chip_smoke.pyramid_sets``) from this forward's SESP calls:
    ``flagship``, every distinct pyramid shape (n, H, W, rates, stride;
    their dw1 / dw2 and a seeded random map), each with and without the v2
    stage; with ``val`` also ``val``, the same shapes at the batch and frame
    width of ``Runner.val`` (8 x 1024 x 2048: B=8 and W doubled).  Each
    entry is (label, red, dw1, dw2, rates, stride)."""
    import torch
    import chip_smoke
    calls = [('sesp_block', None, a, kw) for a, kw in _sesp_calls(model, x)]
    built = chip_smoke.pyramid_sets(calls, torch.Generator().manual_seed(0))
    sets = {}
    for name in ('flagship', 'val') if val else ('flagship',):
        sets[name] = []
        for _, _, (red, dw1, dw2, rates), kw in built[name]:
            label = (f'{"x".join(map(str, red.shape))} rates {rates} stride '
                     f'{kw["stride"]} v2 {dw2 is not None}')
            sets[name].append((label, red, dw1, dw2, rates, kw['stride']))
    return sets


def pyramid_device_time(model, x, iters, val=False):
    """Kernel E's device ms per launch at each operand of
    :func:`pyramid_sets`, one profiler session per shape, read by the
    names of E's device functions (``DEVICE_FUNCTIONS``)."""
    from chip_smoke import device_ms
    from lednet_tpu_torch.ops.kernels import sesp_pyramid
    report = {}
    for name, calls in pyramid_sets(model, x, val).items():
        rows = []
        for label, red, dw1, d2, rates, stride in calls:
            def launch():
                return sesp_pyramid(red, dw1, d2, rates, stride=stride,
                                    impl='cuda')
            ms, count = device_ms(launch, 'sesp_pyramid', iters, counts=True)
            rows.append(dict(shape=label, launches=count, ms_per_launch=ms))
            print(f'  [{name}] {label}: {ms:.4f} ms device time per launch '
                  f'({count} launches)', flush=True)
        total = sum(r['ms_per_launch'] for r in rows)
        report[name] = dict(shapes=rows, sum_ms=total, ms_per_launch=total / len(rows))
        print(f'[sesp_pyramid {name}] {total / len(rows):.4f} ms device time '
              f'per launch, {total:.4f} ms over {len(rows)} shapes', flush=True)
    return report


def pyramid_sweep(model, x, val=False):
    """Time kernel E at every tile that fits two CTAs per SM (th 8-64, tw
    16 or 32, a ring of 2 or 3 boxes) at each operand of
    :func:`pyramid_sets`, and the chosen tile's launch also with its boxes
    loaded by cp.async in place of TMA; check each against the plain
    version, and print per shape the chosen geometry's device time beside
    the fastest one's and beside its cp.async form: the data behind
    ``pyramid_geometry``'s rule and its choice of TMA."""
    import torch
    from chip_smoke import device_ms
    kmod = sys.modules['lednet_tpu_torch.ops.kernels.sesp_pyramid']
    report = {}
    for name, calls in pyramid_sets(model, x, val).items():
        rows = []
        totals = {'chosen': 0.0, 'fastest': 0.0, 'chosen_cp_async': 0.0}
        for label, red, dw1, d2, rates, stride in calls:
            B, n, H, W = red.shape
            k, v2 = len(rates), d2 is not None
            H2, W2 = -(-H // stride), -(-W // stride)
            ref = kmod.sesp_pyramid_plain(red, dw1, d2, rates, stride)
            out = torch.empty_like(ref)

            def timed(geo, what):
                def launch():
                    kmod.launch_pyramid(red, dw1, d2, out, rates, stride, geo)
                out.fill_(float('nan'))
                launch()
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                if not err <= 1e-5:
                    raise AssertionError(f'{label} {what}: rel {err:.3e}')
                return device_ms(launch, 'sesp_pyramid')
            chosen = kmod.pyramid_geometry(B, H, W, n, k, tuple(rates), stride,
                                           v2)
            times = {}
            for tw in (16, 32):
                for th in (8, 16, 32, 64):
                    for stages in (2, 3):
                        geo = kmod.pyramid_tile(B, H, W, n, rates, stride, v2,
                                                th, tw, stages, W % 4 == 0)
                        if (geo.ctas_per_sm < kmod.E_CTAS_PER_SM
                                or max(geo.rh, geo.rw) > kmod.TMA_BOX_MAX
                                or th > 2 * max(H2, 8) or tw > 2 * max(W2, 16)):
                            continue
                        times[(th, tw, stages)] = timed(geo, f'{th}x{tw}')
            key = (chosen.th, chosen.tw, chosen.stages)
            best = min(times, key=times.get)
            cp_async = (timed(chosen._replace(tma=False), 'cp.async')
                        if chosen.tma else times[key])
            totals['chosen'] += times[key]
            totals['fastest'] += times[best]
            totals['chosen_cp_async'] += cp_async
            rows.append(dict(shape=label, chosen=dict(tile=key, ms=times[key],
                                                      tma=chosen.tma,
                                                      cp_async_ms=cp_async),
                             fastest=dict(tile=best, ms=times[best]),
                             tiles=len(times)))
            print(f'  [{name}] {label}: chosen {key} {times[key]:.4f} ms '
                  f'({"TMA" if chosen.tma else "cp.async"}; by cp.async '
                  f'{cp_async:.4f} ms), fastest {best} {times[best]:.4f} ms '
                  f'of {len(times)} tiles', flush=True)
        report[name] = dict(shapes=rows, **{f'{k}_ms': v for k, v in totals.items()})
        print(f"[pyramid sweep {name}] chosen {totals['chosen']:.4f} ms, by "
              f"cp.async {totals['chosen_cp_async']:.4f} ms, fastest "
              f"{totals['fastest']:.4f} ms over {len(rows)} shapes", flush=True)
    return report


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


def count_macs(args) -> int:
    """``--macs``: the multiply-adds of one bs-1 forward of ``--hw`` (or
    ``--size``) on the CPU, by forward hooks on every ``nn.Conv2d`` (output
    elements x in / groups x kh x kw) and ``nn.Linear`` (output elements x
    in); einsums and matmuls outside them are not counted."""
    import torch
    import torch.nn as nn
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lednet_tpu_torch.apis import init_model
    model = init_model(args.config, device='cpu',
                       cfg_options=dict(kv.split('=', 1) for kv in args.cfg_options))
    macs = {'conv': 0, 'linear': 0}

    def conv(mod, _, out):
        k = mod.weight.shape
        macs['conv'] += out.numel() * k[1] * k[2] * k[3]

    def linear(mod, _, out):
        macs['linear'] += out.numel() * mod.in_features
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.register_forward_hook(conv)
        elif isinstance(mod, nn.Linear):
            mod.register_forward_hook(linear)
    hw = tuple(args.hw or (args.size, args.size))
    with torch.inference_mode():
        x, _, _ = model.data_preprocessor(torch.zeros((1,) + hw + (3,),
                                                      dtype=torch.uint8))
        model.predict(x)
    print(json.dumps(dict(config=args.config, hw=hw, cfg_options=args.cfg_options,
                          gmac={k: v / 1e9 for k, v in macs.items()})), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--config', default=CONFIG,
                    help='the model to profile (default: the flagship LED-Net)')
    ap.add_argument('--cfg-options', nargs='+', default=[],
                    help='KEY=VALUE overrides of the config, as the CLIs take '
                         "them (e.g. model.decode_head.pixel_decoder=msdeform)")
    ap.add_argument('--macs', action='store_true',
                    help='count the forward\'s multiply-adds on the CPU and '
                         'exit (no GPU needed)')
    ap.add_argument('--size', type=int, default=1024)
    ap.add_argument('--hw', type=int, nargs=2, metavar=('H', 'W'),
                    help='the frame (default: --size x --size)')
    ap.add_argument('--cudnn-benchmark', action='store_true',
                    help='let cuDNN time its algorithms per conv shape')
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--graph', action='store_true',
                    help='also profile the replayed CUDA graph of the eval step')
    ap.add_argument('--train', action='store_true',
                    help="profile the config's train step instead")
    ap.add_argument('--ops', metavar='FILE',
                    help='write every device op of each path, with its calls '
                         'per forward, to FILE as JSON')
    ap.add_argument('--pyramid', action='store_true',
                    help="only kernel E's device time per shape (no forward "
                         'profiles)')
    ap.add_argument('--val', action='store_true',
                    help="also read kernel E at Runner.val's shapes (B=8, W "
                         'doubled)')
    ap.add_argument('--pyramid-sweep', action='store_true',
                    help='time kernel E at every tile that fits, at its '
                         'shapes (with --val also the val set), instead')
    ap.add_argument('--sesp-sweep', action='store_true',
                    help="time every launch geometry of kernel D's fused "
                         'launch at the SESP call sites instead')
    args = ap.parse_args()
    import numpy as np
    import torch
    if args.macs:
        return count_macs(args)
    if not torch.cuda.is_available():
        print('torch_port_profile: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lednet_tpu_torch.apis import init_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = init_model(os.path.join(repo, args.config), device='cuda',
                       generator=torch.Generator().manual_seed(0),
                       cfg_options=dict(kv.split('=', 1) for kv in args.cfg_options))
    hw = tuple(args.hw or (args.size, args.size))
    img = np.random.default_rng(0).integers(0, 256, (1,) + hw + (3,),
                                            dtype=np.uint8)
    x = torch.from_numpy(img).cuda()
    if args.sesp_sweep:
        with torch.inference_mode():
            sites = sesp_sweep(model, x)
        print(json.dumps(dict(card=card, size=args.size, sesp_sweep=sites)),
              flush=True)
        return 0
    report = dict(card=card, size=args.size, hw=hw, iters=args.iters,
                  cudnn_benchmark=args.cudnn_benchmark, paths=[])
    if args.pyramid_sweep:
        with torch.inference_mode():
            report['pyramid_sweep'] = pyramid_sweep(model, x, args.val)
        print(json.dumps(report), flush=True)
        return 0
    if args.pyramid:
        with torch.inference_mode():
            report['sesp_pyramid'] = pyramid_device_time(model, x, args.iters,
                                                         args.val)
        print(json.dumps(report), flush=True)
        return 0
    from lednet_tpu_torch.models.backbones import rtformer, sctnet
    from lednet_tpu_torch.models.decode_heads import (ham_head, knet_head,
                                                      maskformer_head, san_head)
    from lednet_tpu_torch.models.text_encoder import CLIPTextEncoder

    def ranged(fn, name):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call
    ham_head._nmf = ranged(ham_head._nmf, 'nmf')
    for cls in (sctnet.ConvolutionalAttention, rtformer.ExternalAttention,
                rtformer.CrossResolutionAttention):
        cls.forward = ranged(cls.forward, 'attention')
    knet_head.KernelUpdateHead.forward = ranged(
        knet_head.KernelUpdateHead.forward, 'kernel_update')
    mf = maskformer_head.MaskFormerHead
    mf.pixel_features = ranged(mf.pixel_features, 'pixel_decoder')
    mf.assign = ranged(mf.assign, 'matching')
    maskformer_head._DecoderLayer.forward = ranged(
        maskformer_head._DecoderLayer.forward, 'transformer_decoder')
    CLIPTextEncoder.forward = ranged(CLIPTextEncoder.forward, 'text_encoder')
    san_head.SideAdapterNetwork.forward = ranged(
        san_head.SideAdapterNetwork.forward, 'side_adapter')
    san_head.RecWithAttnbias.forward = ranged(san_head.RecWithAttnbias.forward,
                                              'recognition')
    san_head.SideAdapterCLIPHead.assign = ranged(
        san_head.SideAdapterCLIPHead.assign, 'matching')
    slide = model.test_cfg.get('mode') == 'slide'
    paths = [('cuda', eager_forward(model, x, 'cuda')),
             ('plain', eager_forward(model, x, 'plain'))]
    if args.train:
        paths = [('train', train_step(model))]
    if args.graph:
        from lednet_tpu_torch.engine import make_eval_step
        step = make_eval_step(model, model.data_preprocessor,
                              'slide' if slide else 'whole')
        paths.append(('graph', lambda: step(x)))
    ops = {}
    for impl, forward in paths:
        r = profile_path(forward, impl, args.iters)
        ops[impl] = r.pop('device_ops')
        report['paths'].append(r)
        print(f"[{impl}] wall {r['wall_ms']:.3f} ms/forward, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_ops_per_forward']:.0f} device ops/forward; by kind "
              + ', '.join(f'{k} {ms:.3f} ms' for k, ms in r['by_kind'].items())
              + '; ' + ', '.join(f"{n} {r[n + '_ms']:.3f} ms" for n in RANGES),
              flush=True)
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
    if slide and not args.train:
        with torch.inference_mode():
            report['slide_parts'] = parts = slide_parts(model, x, args.iters)
        print(f"slide forward by part, each alone ({parts['crops']} crops): " +
              ', '.join(f"{k} {v['device_ms_per_forward']:.4f} ms in "
                        f"{v['launches_per_forward']:.0f} launches"
                        for k, v in parts.items() if k != 'crops'), flush=True)
    if args.config == CONFIG and not args.train:
        with torch.inference_mode():
            report['sesp_pyramid'] = pyramid_device_time(model, x, args.iters,
                                                         args.val)
    if args.ops:
        with open(args.ops, 'w') as f:
            json.dump(dict(card=card, size=args.size, paths=ops), f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
