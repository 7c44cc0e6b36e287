#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lednet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the flagship LED-Net (``configs/LED_Net/lednet_80k_cityscapes-1024x1024.py``:
LEDNet c=32, ppm_channels=128, LEDHead with 19 classes) through the port's
own entry points, ``init_model`` -> ``inference_model``, at full width on
1024x1024 images, with seeded random weights and non-trivial BatchNorm
running stats.  It imports nothing of JAX or of the JAX package.  Phases, each
printing one flushed line with its seconds:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the CUDA kernels from ``lednet_tpu_torch/csrc`` (one ``nvcc``);
3. kernels: one forward records every kernel call of the main path; each
   call is re-run through the kernel and through its plain PyTorch version on
   the same inputs and held to max|kernel - plain| <= TOL * max|plain|
   (normalization: bit-exact);
4. model: launch counts set to 0, ``inference_model`` on 4 seeded
   1024x1024 BGR uint8 images through the kernels, counts read (every kernel
   must have launched), then the same images with ``impl='plain'`` (module
   forms) and a 256x256 image against the model copied to the CPU;
5. timing: CUDA-event time of the kernel-path forward (preprocess +
   predict, bs=1, 5 warm-up + 50 timed), the plain path's, and each kernel's
   and plain version's time per launch at the main path's inputs.

It prints the card line and a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""
import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

CONFIG = 'configs/LED_Net/lednet_80k_cityscapes-1024x1024.py'
SIZE = 1024
N_IMAGES = 4
SEED = 0
TOL_KERNEL = 1e-5         # float32 kernels against their plain versions
TOL_MODEL = 1e-3          # whole logits, kernel path against module forms
MIN_ARGMAX_AGREEMENT = 0.999
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

KERNEL_INFO = {   # name -> (CUDA source, TPU kernel it replaces)
    'normalize_image': ('lednet_tpu_torch/csrc/normalize.cu',
                        'lednet_tpu/ops/pallas/s2d_input.py:80'),
    'stem_convs': ('lednet_tpu_torch/csrc/stem_conv.cu',
                   'lednet_tpu/ops/pallas/stem_conv.py:57'),
    'basic_pair': ('lednet_tpu_torch/csrc/conv_block.cu',
                   'lednet_tpu/ops/pallas/conv_block.py:73'),
    'sesp_block': ('lednet_tpu_torch/csrc/sesp_block.cu',
                   'lednet_tpu/ops/pallas/sesp_pyramid.py:207'),
}


class PhaseError(RuntimeError):
    pass


def say(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        say(f'[{name}] FAILED after {time.perf_counter() - t0:.2f} s: '
            f'{type(e).__name__}: {e}')
        raise PhaseError(name) from e
    say(f'[{name}] ok in {time.perf_counter() - t0:.2f} s')


def rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def cuda_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- capture
def _call_sites():
    import lednet_tpu_torch.models.backbones.lednet as backbone
    import lednet_tpu_torch.models.data_preprocessor as pre
    import lednet_tpu_torch.models.espnet as espnet
    return [(pre, 'normalize_image'), (backbone, 'stem_convs'),
            (backbone, 'basic_pair'), (espnet, 'sesp_block')]


@contextlib.contextmanager
def recording(calls):
    """Record (name, op, args, kwargs) of every kernel op the model calls."""
    saved = []
    for mod, attr in _call_sites():
        op = getattr(mod, attr)
        saved.append((mod, attr, op))

        def rec(*args, _op=op, **kw):
            calls.append((_op.__name__, _op, args, kw))
            return _op(*args, **kw)
        setattr(mod, attr, rec)
    try:
        yield
    finally:
        for mod, attr, op in saved:
            setattr(mod, attr, op)


def work(name, args, kw):
    """(bytes moved, float32 operations) the op's function needs: each input
    read once, each output written once."""
    nb = lambda t: t.numel() * t.element_size()
    tensors = [a for a in args if hasattr(a, 'numel')]
    if name == 'normalize_image':
        x = args[0]
        out_bytes = x.numel() * (2 if kw.get('out_dtype') is None or
                                 str(kw['out_dtype']).endswith('bfloat16') else 4)
        return nb(x) + out_bytes, 2 * x.numel()
    if name == 'stem_convs':
        x, w1, b1, w2, b2 = args[:5]
        B, cin, H, W = x.shape
        c1, c2 = w1.shape[0], w2.shape[0]
        h1, w1_ = -(-H // 2), -(-W // 2)
        h2, w2_ = -(-h1 // 2), -(-w1_ // 2)
        out = 4 * B * (c1 * h1 * w1_ + c2 * h2 * w2_)
        flops = 2 * B * (c1 * h1 * w1_ * cin * 9 + c2 * h2 * w2_ * c1 * 9)
        return sum(nb(t) for t in tensors) + out, flops
    if name == 'basic_pair':
        x = args[0]
        B, C, H, W = x.shape
        return sum(nb(t) for t in tensors) + nb(x), 4 * 2 * B * H * W * C * C * 9
    if name == 'sesp_block':
        x, dw1 = args[0], args[4]
        B, cin, H, W = x.shape
        k, n = dw1.shape[0], dw1.shape[1]
        C = k * n
        stride = kw.get('stride', 1)
        h2, w2 = -(-H // stride), -(-W // stride)
        v2 = args[5] is not None
        flops = B * (2 * H * W * n * cin + h2 * w2 * (18 * C + C)
                     + (18 * C if v2 else 0) * h2 * w2 + 2 * C * C * h2 * w2)
        return sum(nb(t) for t in tensors) + 4 * B * C * h2 * w2, flops
    raise ValueError(name)


def outputs(res):
    return list(res) if isinstance(res, tuple) else [res]


def shape_of(args):
    return 'x' + 'x'.join(str(s) for s in args[0].shape)


# ---------------------------------------------------------------- phases
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    try:
        import lednet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here: {e}',
              file=sys.stderr)
        return 2
    from lednet_tpu_torch.apis import inference_model, init_model
    from lednet_tpu_torch.ops import kernels
    from lednet_tpu_torch.ops.kernels import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    repo = os.path.dirname(os.path.abspath(__file__))
    os.chdir(repo)

    with phase('1 card'):
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0].strip()
        say(card)
        say(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
            f'device {torch.cuda.get_device_name(0)}, '
            f'count {torch.cuda.device_count()}')

    with phase('2 build'):
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.library()
        say(f'build {time.perf_counter() - t0:.2f} s -> '
            f'{os.path.relpath(lib_path, repo)}')
        log = (lib_path.parent / 'build.log').read_text().splitlines()
        for line in log[1:2] + [l for l in log if 'registers' in l or 'spill' in l]:
            say('  ' + line.strip())

    gen = torch.Generator().manual_seed(SEED)
    with phase('3 kernels'):
        model = init_model(CONFIG, device='cuda', generator=gen)
        with torch.no_grad():        # non-trivial BatchNorm and PReLU state
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                    m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                           generator=gen))
                    m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                         generator=gen))
        rng = np.random.default_rng(SEED)
        imgs = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                for _ in range(N_IMAGES)]
        x_dev = torch.from_numpy(imgs[0][None]).cuda()
        calls = []
        with recording(calls), torch.inference_mode():
            x, _, _ = model.data_preprocessor(x_dev, impl='cuda')
            model.predict(x, 'cuda')
        torch.cuda.synchronize()
        errs = {name: [] for name in KERNEL_INFO}
        for name, op, args, kw in calls:
            with torch.inference_mode():
                got = outputs(op(*args, **dict(kw, impl='cuda')))
                torch.cuda.synchronize()
                ref = outputs(op(*args, **dict(kw, impl='plain')))
                torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if g.shape != r.shape or g.dtype != r.dtype:
                    raise AssertionError(f'{name} {shape_of(args)}: {g.shape} '
                                         f'{g.dtype} vs {r.shape} {r.dtype}')
                e_rel, e_abs = rel(g, r), (g.double() - r.double()).abs().max().item()
                tol = 0.0 if name == 'normalize_image' else TOL_KERNEL
                say(f'  {name} {shape_of(args)}: max_abs {e_abs:.3e} '
                    f'rel {e_rel:.3e} (tol {tol:g})')
                if not e_rel <= tol:
                    raise AssertionError(f'{name} {shape_of(args)} disagrees '
                                         f'with its plain version')
                errs[name].append(e_abs)
        missing = [n for n, e in errs.items() if not e]
        if missing:
            raise AssertionError(f'the main path called no {missing}')

    with phase('4 model'):
        kernels.reset_launch_counts()
        res = inference_model(model, imgs, impl='cuda')
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        say(f'  launches in {N_IMAGES} forwards: {launches}')
        if not all(launches.values()):
            raise AssertionError(f'a kernel never launched: {launches}')
        plain = inference_model(model, imgs, impl='plain')
        for i, (a, b) in enumerate(zip(res, plain)):
            la, lb = a['seg_logits'], b['seg_logits']
            if la.shape != (SIZE, SIZE, 19) or a['pred_sem_seg'].shape != (SIZE, SIZE):
                raise AssertionError(f'image {i}: shape {la.shape}')
            if not np.isfinite(la).all():
                raise AssertionError(f'image {i}: non-finite logits')
            e = np.abs(la - lb).max() / np.abs(lb).max()
            agree = (a['pred_sem_seg'] == b['pred_sem_seg']).mean()
            say(f'  image {i}: kernels vs module forms rel {e:.3e} '
                f'(tol {TOL_MODEL:g}), argmax agreement {agree:.6f}, '
                f'max|logit| {np.abs(lb).max():.3f}')
            if not (e <= TOL_MODEL and agree >= MIN_ARGMAX_AGREEMENT):
                raise AssertionError(f'image {i}: kernel path disagrees')
        small = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        gpu = inference_model(model, small)
        cpu = inference_model(copy.deepcopy(model).to('cpu'), small)
        e = np.abs(gpu['seg_logits'] - cpu['seg_logits']).max() / \
            np.abs(cpu['seg_logits']).max()
        agree = (gpu['pred_sem_seg'] == cpu['pred_sem_seg']).mean()
        say(f'  256x256: GPU kernels vs CPU module forms rel {e:.3e} '
            f'(tol {TOL_MODEL:g}), argmax agreement {agree:.6f}')
        if not (e <= TOL_MODEL and agree >= MIN_ARGMAX_AGREEMENT):
            raise AssertionError('GPU and CPU disagree')

    with phase('5 timing'):
        def forward(impl):
            def run():
                x, _, _ = model.data_preprocessor(x_dev, impl=impl)
                return model.predict(x, impl)
            return run
        with torch.inference_mode():
            fwd_ms = cuda_ms(forward('cuda'), reps=50, warmup=5)
            plain_fwd_ms = cuda_ms(forward('plain'), reps=50, warmup=5)
        say(f'  forward 1x{SIZE}x{SIZE} kernel path: {fwd_ms:.3f} ms '
            f'({1000 / fwd_ms:.1f} img/s); module forms: {plain_fwd_ms:.3f} ms '
            f'({1000 / plain_fwd_ms:.1f} img/s)')
        rows = []
        for name, (source, replaces) in KERNEL_INFO.items():
            mine = [(op, args, kw) for n, op, args, kw in calls if n == name]
            ms = plain_ms = bound = 0.0
            bound_by = {'bytes': 0.0, 'operations': 0.0}
            with torch.inference_mode():
                for op, args, kw in mine:
                    ms += cuda_ms(lambda: op(*args, **dict(kw, impl='cuda')), 20)
                    plain_ms += cuda_ms(lambda: op(*args, **dict(kw, impl='plain')), 20)
                    nbytes, flops = work(name, args, kw)
                    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
                    bound += max(tb, tf)
                    bound_by['bytes' if tb >= tf else 'operations'] += max(tb, tf)
            k = len(mine)
            rows.append(dict(
                name=name, route='cuda', source=source, replaces=replaces,
                launches=launches[name], max_abs_err=max(errs[name]),
                ms=ms / k, plain_ms=plain_ms / k, bound_ms=bound / k,
                bound_by=max(bound_by, key=bound_by.get), library_ms=None))
            say(f'  {name}: {ms / k:.4f} ms/launch, {launches[name] / N_IMAGES:g} '
                f'launches/forward, bound {bound / k:.4f} ms '
                f'({rows[-1]["bound_by"]}), plain {plain_ms / k:.4f} ms')

    say(card)
    say(json.dumps({'kernels': rows}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except PhaseError:
        sys.exit(1)
