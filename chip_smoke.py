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
3. kernels: one forward records every kernel call of the main path, and
   a device trace (``torch.profiler``) of it counts each kernel's CUDA
   launches per forward; each call is re-run through the kernel and through
   its plain PyTorch version on the same inputs and held to
   max|kernel - plain| <= TOL * max|plain| (normalization: bit-exact);
3b. pyramid: kernel E (``sesp_pyramid``), which no model calls, at each
   distinct pyramid shape of the SESP calls recorded in phase 3 (n, H, W,
   rates, stride; their dw1/dw2 and a seeded random reduced map), with the
   v2 stage and without, held to its plain version like phase 3;
3c. ragged: kernels B and C called directly at shapes the main path (which
   pads to /32) never gives them: batch 2, sizes that are not multiples of
   the tiles (odd and even), maps smaller than one tile, bf16 and float32
   stem inputs, the 16-channel width; held like phase 3;
4. model: launch counts set to 0, ``inference_model`` on 4 seeded
   1024x1024 BGR uint8 images through the kernels under a device trace,
   counts read.  ``inference_model`` runs one eager warm-up forward, captures
   a CUDA graph and replays it 4 times: every kernel of the main path, A-D,
   must count launches in its wrapper (warm-up and capture; E is on no path
   and is not required), and the trace must show each kernel's launches of
   one forward (phase 3) 5 times over, which the replays run.  Then the
   same images with ``impl='plain'`` (module forms), the
   same images again under torch's default flags (cuDNN convs in TF32)
   against those float32 module forms, and a 256x256 image against the
   model copied to the CPU;
5. timing: CUDA-event time of the kernel-path forward (preprocess +
   predict, bs=1, 5 warm-up + 50 timed), the plain path's, and each kernel's
   and plain version's time per launch at the main path's inputs (E's at
   phase 3b's inputs); kernel D's time is printed per call site, and B's,
   C's and D's beside their times before their redesigns.
   Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
   operations over the peak of the units it runs them on: TF32 tensor cores
   (495 TFLOP/s, three TF32 products per float32 product, two for a bf16
   operand) for B and C, the float32 pipes (67 TFLOP/s) for the others;
6. train: ``make_train_step`` (module forms, BatchNorm on batch statistics,
   the config's two OHEM losses, SGD + poly lr) on a fresh seeded flagship
   model, at the config's batch of 6 seeded 1024x1024 BGR uint8 crops with
   about 2% of labels at 255: one warm-up step and 5 timed steps (CUDA
   events; loss, acc_seg and grad_norm of each must be finite), peak memory,
   3 more steps under torch's default flags (cuDNN TF32); then, for 4
   seeds, one step on the card against the same step of the port on the
   CPU (flagship widths, 2 images at 256x256, same seeded weights and
   batch, float32, TF32 off), with the config's OHEM losses and with
   ``CrossEntropyLoss`` in their place, held to the loss within 1e-5,
   every weight within atol 1e-4 / rtol 5e-3 and the BatchNorm running
   stats within atol 1e-5 (var also rtol 1e-4) with the card's convs in
   PyTorch's own CUDA kernels (cuDNN off), and to the loss and stat bounds
   with cuDNN (its weights printed beside them): cuDNN's float32 weight
   gradients sum in an order about 600 times less exact than PyTorch's
   own, and move the weights past the bound at some seeds
   (``tools/torch_port_train_gap.py``, ``PERF.md`` section 6);
7. eval graph: ``make_eval_step`` on the phase-3 model, bs=1, 1024x1024:
   the replayed CUDA graph against the eager kernel path (max abs error <=
   TOL_KERNEL x max|logit|, argmax agreement 1.0); then one train step
   changes the weights, and the step must capture again and match the eager
   forward with the new weights under the same bound; ``inference_model``
   against the eager path likewise; then the forward latency of the replay
   against the eager kernel path (CUDA events, 5 warm-up + 50 timed), the
   same one frame at a time (host clock, synchronized after each call), the
   host time of the step's check of the weights, and the number of graphs
   captured.

It prints the card line and a ``{"kernels": [...]}`` line (``launches``:
the wrappers' count in phase 4; ``device_launches``: the CUDA launches the
device trace saw there), and last ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
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
TRAIN_STEPS = 5           # timed train steps, after one warm-up step
TRAIN_BATCH = 6           # the flagship config's train batch
# one train step on the card against the CPU, the bounds that
# tests/test_train_parity.py holds lednet_tpu to torch
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_WEIGHT = dict(atol=1e-4, rtol=5e-3)
TOL_TRAIN_MEAN = dict(atol=1e-5, rtol=0.0)
TOL_TRAIN_VAR = dict(atol=1e-5, rtol=1e-4)
TRAIN_CHECK_SEEDS = (2, 3, 4, 5)   # the card's step against the CPU's
CE_LOSSES = [dict(type='CrossEntropyLoss', loss_weight=1.0),
             dict(type='CrossEntropyLoss', loss_weight=0.4)]
MIN_ARGMAX_AGREEMENT = 0.999
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
# kernels whose convs run in 3xTF32 on the tensor cores: each float32
# product costs three TF32 products (two for a bf16 operand, exact in TF32)
TENSOR_CORE_KERNELS = ('stem_convs', 'basic_pair')

KERNEL_INFO = {   # name -> (CUDA source, TPU kernel it replaces)
    'normalize_image': ('lednet_tpu_torch/csrc/normalize.cu',
                        'lednet_tpu/ops/pallas/s2d_input.py:80'),
    'stem_convs': ('lednet_tpu_torch/csrc/stem_conv.cu',
                   'lednet_tpu/ops/pallas/stem_conv.py:57'),
    'basic_pair': ('lednet_tpu_torch/csrc/conv_block.cu',
                   'lednet_tpu/ops/pallas/conv_block.py:73'),
    'sesp_block': ('lednet_tpu_torch/csrc/sesp_block.cu',
                   'lednet_tpu/ops/pallas/sesp_pyramid.py:207'),
    'sesp_pyramid': ('lednet_tpu_torch/csrc/sesp_pyramid.cu',
                     'lednet_tpu/ops/pallas/sesp_pyramid.py:79'),
}
OFF_PATH = ('sesp_pyramid',)   # kernels that no model calls
# kernel D's mean ms per call before it was fused (three launches per call),
# measured by this script in three runs on an NVIDIA H100 80GB HBM3 at 700 W
EARLIER_SESP_MS = (0.1155, 0.1265, 0.1262)
# kernels B and C before their tensor-core redesign (B two launches, C four,
# float32 pipes), measured by this script on an NVIDIA H100 80GB HBM3 at 700 W
EARLIER_STEM_MS = 0.1260
EARLIER_PAIR_MS = 0.2622
# shapes off the main path (which pads to /32) for kernels B and C: batch 2,
# odd and even sizes that are not multiples of the tiles, maps smaller than
# one tile, and the 16-channel width; B's bf16 input is staged by 16-byte
# copies when its width is a multiple of 8 (264) and element by element
# otherwise (378, 45, 9)
RAGGED_STEM = [((2, 3, 250, 378), 32), ((2, 3, 200, 264), 32),
               ((2, 3, 37, 45), 32), ((1, 3, 7, 9), 32),
               ((2, 3, 250, 378), 16)]
RAGGED_PAIR = [((2, 32, 37, 70), 32), ((2, 32, 36, 64), 32),
               ((1, 32, 5, 11), 32), ((2, 16, 37, 70), 16)]


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


@contextlib.contextmanager
def device_trace(counts):
    """Fill ``counts`` with the CUDA launches of each port kernel that ran
    on the device inside (``kernels.device_launches`` of a CUPTI trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lednet_tpu_torch.ops import kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    counts.update(kernels.device_launches(prof.key_averages()))


def synced_ms(fn, reps, warmup=3):
    """Host-clock ms per call of ``fn`` with the device synchronized after
    each call: the latency of one frame at a time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


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
    """(bytes moved, float32 operations, tensor-core TF32 operations) the
    op's function needs: each input read once, each output written once; the
    third is the TF32 work of the 3xTF32 kernels (B, C), else 0."""
    nb = lambda t: t.numel() * t.element_size()
    tensors = [a for a in args if hasattr(a, 'numel')]
    if name == 'normalize_image':
        x = args[0]
        out_bytes = x.numel() * (2 if kw.get('out_dtype') is None or
                                 str(kw['out_dtype']).endswith('bfloat16') else 4)
        return nb(x) + out_bytes, 2 * x.numel(), 0
    if name == 'stem_convs':
        x, w1, b1, w2, b2 = args[:5]
        B, cin, H, W = x.shape
        c1, c2 = w1.shape[0], w2.shape[0]
        h1, w1_ = -(-H // 2), -(-W // 2)
        h2, w2_ = -(-h1 // 2), -(-w1_ // 2)
        out = 4 * B * (c1 * h1 * w1_ + c2 * h2 * w2_)
        conv1 = 2 * B * c1 * h1 * w1_ * cin * 9
        conv2 = 2 * B * c2 * h2 * w2_ * c1 * 9
        bf16 = str(x.dtype).endswith('bfloat16')
        return (sum(nb(t) for t in tensors) + out, conv1 + conv2,
                (2 if bf16 else 3) * conv1 + 3 * conv2)
    if name == 'basic_pair':
        x = args[0]
        B, C, H, W = x.shape
        flops = 4 * 2 * B * H * W * C * C * 9
        return sum(nb(t) for t in tensors) + nb(x), flops, 3 * flops
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
        return sum(nb(t) for t in tensors) + 4 * B * C * h2 * w2, flops, 0
    if name == 'sesp_pyramid':
        red, dw1, dw2 = args[:3]
        B, n, H, W = red.shape
        C = dw1.shape[0] * n
        stride = kw.get('stride', 1)
        h2, w2 = -(-H // stride), -(-W // stride)
        stages = 1 if dw2 is None else 2
        return (sum(nb(t) for t in tensors) + 4 * B * C * h2 * w2,
                B * (18 * C * stages + C) * h2 * w2, 0)
    raise ValueError(name)


def outputs(res):
    return list(res) if isinstance(res, tuple) else [res]


def shape_of(args):
    return 'x' + 'x'.join(str(s) for s in args[0].shape)


def bounds_ms(name, args, kw):
    """(bound ms, 'bytes' or 'operations', the float32-pipe bound ms): the
    larger of bytes over the memory rate and operations over the peak rate
    of the units the kernel runs them on (TF32 tensor cores for B and C,
    float32 pipes for the rest).  The third is the earlier float32-pipe
    bound of every kernel, for comparison with earlier rows."""
    nbytes, flops, tc_ops = work(name, args, kw)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf32 = flops / F32_FLOPS_PER_S * 1e3
    to = tc_ops / TF32_FLOPS_PER_S * 1e3 if name in TENSOR_CORE_KERNELS else tf32
    return max(tb, to), 'bytes' if tb >= to else 'operations', max(tb, tf32)


def check_against_plain(name, op, args, kw, tol, errs):
    """Run op through its kernel and its plain version on the same inputs
    and hold every output to max|kernel - plain| <= tol * max|plain|."""
    import torch
    with torch.inference_mode():
        got = outputs(op(*args, **dict(kw, impl='cuda')))
        torch.cuda.synchronize()
        ref = outputs(op(*args, **dict(kw, impl='plain')))
        torch.cuda.synchronize()
    extra = f' stride={kw["stride"]}' if 'stride' in kw else ''
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f'{name} {shape_of(args)}: {g.shape} '
                                 f'{g.dtype} vs {r.shape} {r.dtype}')
        e_rel, e_abs = rel(g, r), (g.double() - r.double()).abs().max().item()
        say(f'  {name} {shape_of(args)} {args[0].dtype}{extra}: max_abs '
            f'{e_abs:.3e} rel {e_rel:.3e} (tol {tol:g})')
        if not e_rel <= tol:
            raise AssertionError(f'{name} {shape_of(args)} disagrees with '
                                 f'its plain version')
        errs.append(e_abs)


def train_batch(rng, n, size):
    """n seeded BGR uint8 crops (n, size, size, 3) and int64 labels of the
    19 classes with about 2% at 255 (ignored)."""
    import torch
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    lbl = np.where(rng.random((n, size, size)) < 0.02, 255,
                   rng.integers(0, 19, (n, size, size)))
    return torch.from_numpy(imgs), torch.from_numpy(lbl.astype(np.int64))


def train_once(cfg, device, imgs, lbl, seed, dtype=None):
    """One train step of a seeded model of ``cfg`` on ``device`` (its
    weights cast to ``dtype`` if given): (loss, state_dict on the CPU)."""
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_train_step)
    model = init_model(cfg, device=device,
                       generator=torch.Generator().manual_seed(seed))
    if dtype is not None:
        model.to(dtype)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    step = make_train_step(model, opt, model.data_preprocessor)
    _, logs = step(create_train_state(model, opt, sched), imgs.to(device),
                   lbl.to(device))
    return logs['loss'].item(), {k: v.detach().cpu()
                                 for k, v in model.state_dict().items()}


def train_distance(run, ref):
    """(|loss - loss_ref|, max |diff| of the weights, of the BatchNorm
    stats, every tensor's largest share of its TOL_TRAIN_* bound as (share,
    name), largest first: a share above 1 is outside it)."""
    (loss, sd), (loss_ref, sd_ref) = run, ref
    worst = {'weight': 0.0, 'bn_stat': 0.0}
    shares = []
    for k, want in sd_ref.items():
        if k.endswith('num_batches_tracked'):
            continue
        tol = (TOL_TRAIN_MEAN if k.endswith('running_mean') else
               TOL_TRAIN_VAR if k.endswith('running_var') else TOL_TRAIN_WEIGHT)
        want = want.double()
        d = (sd[k].double() - want).abs()
        kind = 'bn_stat' if 'running' in k else 'weight'
        worst[kind] = max(worst[kind], d.max().item())
        shares.append(((d / (tol['atol'] + tol['rtol'] * want.abs())).max().item(), k))
    return (abs(loss - loss_ref), worst['weight'], worst['bn_stat'],
            sorted(shares, reverse=True))


def hold_train(name, card, cpu, bounds):
    """Hold a train step on the card to the CPU's: the loss within
    TOL_TRAIN_LOSS, and the weights and BatchNorm stats within their
    TOL_TRAIN_* where ``bounds`` names them ('weights', 'bn_stats')."""
    dl, dw, ds, shares = train_distance(card, cpu)
    worst = {'weights': max((r for r, k in shares if 'running' not in k),
                            default=0.0),
             'bn_stats': max((r for r, k in shares if 'running' in k),
                             default=0.0)}
    say(f'  {name}: |loss diff| {dl:.3e} (tol {TOL_TRAIN_LOSS:g}), max |diff| '
        f'weights {dw:.3e}, BatchNorm stats {ds:.3e}; nearest their bound: ' +
        ', '.join(f'{k} {r:.3f}' for r, k in shares[:3]) + '; held: loss, ' +
        ', '.join(bounds))
    if not (dl <= TOL_TRAIN_LOSS and all(worst[b] <= 1.0 for b in bounds)):
        raise AssertionError(f'{name}: card and CPU disagree')


def check_logits(name, out, ref):
    """max |out - ref| <= TOL_KERNEL x max |ref| and argmax agreement 1."""
    err = (out.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
    say(f'  {name}: max_abs {err:.3e} (tol {TOL_KERNEL:g} x max|logit| '
        f'{scale:.3f}), argmax agreement {agree:.6f}')
    if not (err <= TOL_KERNEL * scale and agree == 1.0):
        raise AssertionError(f'{name} disagrees with the eager kernel path')


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
    from lednet_tpu_torch.ops.kernels import _build, basic_pair, stem_convs
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
        calls, per_forward = [], {}
        with recording(calls), torch.inference_mode(), device_trace(per_forward):
            x, _, _ = model.data_preprocessor(x_dev, impl='cuda')
            model.predict(x, 'cuda')
        say(f'  CUDA launches of one forward (device trace): {per_forward}')
        errs = {name: [] for name in KERNEL_INFO}
        for name, op, args, kw in calls:
            tol = 0.0 if name == 'normalize_image' else TOL_KERNEL
            check_against_plain(name, op, args, kw, tol, errs[name])
        missing = [n for n, e in errs.items() if not e and n not in OFF_PATH]
        if missing:
            raise AssertionError(f'the main path called no {missing}')

    with phase('3b pyramid'):
        from lednet_tpu_torch.ops.kernels import sesp_pyramid
        shapes = {}
        for name, op, args, kw in calls:
            if name == 'sesp_block':
                x, dw1, dw2 = args[0], args[4], args[5]
                key = (dw1.shape[1], *x.shape[2:], tuple(kw['rates']),
                       kw['stride'])
                shapes.setdefault(key, (x.shape[0], dw1, dw2))
        pyr_calls = []
        for (n, H, W, rates, stride), (B, dw1, dw2) in shapes.items():
            red = torch.randn((B, n, H, W), generator=gen).cuda()
            for d2 in (dw2, None):
                pyr_calls.append(('sesp_pyramid', sesp_pyramid,
                                  (red, dw1, d2, rates), {'stride': stride}))
        for name, op, args, kw in pyr_calls:
            with torch.inference_mode():
                got = op(*args, **dict(kw, impl='cuda'))
                torch.cuda.synchronize()
                ref = op(*args, **dict(kw, impl='plain'))
                torch.cuda.synchronize()
            if got.shape != ref.shape:
                raise AssertionError(f'{name}: {got.shape} vs {ref.shape}')
            e_rel, e_abs = rel(got, ref), (got.double() - ref.double()).abs().max().item()
            say(f'  {name} {shape_of(args)} rates {args[3]} stride '
                f'{kw["stride"]} v2 {args[2] is not None}: max_abs {e_abs:.3e} '
                f'rel {e_rel:.3e} (tol {TOL_KERNEL:g})')
            if not e_rel <= TOL_KERNEL:
                raise AssertionError(f'{name} {shape_of(args)} disagrees '
                                     f'with its plain version')
            errs[name].append(e_abs)

    with phase('3c ragged'):
        # kernels B and C called directly at shapes the main path never
        # gives them (it pads to /32): tile edges, batch 2, tiny maps
        ragged = []
        for shape, c in RAGGED_STEM:
            w1 = 0.3 * torch.randn((c, 3, 3, 3), generator=gen)
            w2 = 0.1 * torch.randn((c, c, 3, 3), generator=gen)
            b1, b2 = 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen)
            x = torch.randn(shape, generator=gen)
            for dt in (torch.bfloat16, torch.float32):
                ragged.append(('stem_convs', stem_convs,
                               tuple(t.cuda() for t in (x.to(dt), w1, b1, w2, b2)), {}))
        for shape, c in RAGGED_PAIR:
            ws = 0.08 * torch.randn((4, c, c, 3, 3), generator=gen)
            bs = 0.1 * torch.randn((4, c), generator=gen)
            x = torch.randn(shape, generator=gen).relu()
            ragged.append(('basic_pair', basic_pair,
                           (x.cuda(), ws.cuda(), bs.cuda()), {}))
        for name, op, args, kw in ragged:
            check_against_plain(name, op, args, kw, TOL_KERNEL, errs[name])

    with phase('4 model'):
        kernels.reset_launch_counts()
        device = {}
        with device_trace(device):
            res = inference_model(model, imgs, impl='cuda')
        launches = kernels.launch_counts()
        # one eager warm-up forward and N_IMAGES replays ran on the device
        forwards = N_IMAGES + model._eval_step.captures
        say(f'  wrapper launches (one eager warm-up forward, one capture): '
            f'{launches}')
        say(f'  CUDA launches on the device (trace of {forwards} forwards, '
            f'{N_IMAGES} of them replayed): {device}')
        if not all(c for n, c in launches.items() if n not in OFF_PATH):
            raise AssertionError(f'a kernel never launched: {launches}')
        want = {n: c * forwards for n, c in per_forward.items()}
        if device != want:
            raise AssertionError(f'the device ran {device} kernel launches, '
                                 f'not {want}')
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
        # a caller's defaults: torch runs cuDNN's float32 convs in TF32
        # (allow_tf32 True) and float32 matmuls in full float32; the module
        # forms above ran with TF32 off
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = inference_model(model, imgs)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        for i, (a, b) in enumerate(zip(tf32, plain)):
            la, lb = a['seg_logits'], b['seg_logits']
            e = np.abs(la - lb).max() / np.abs(lb).max()
            agree = (a['pred_sem_seg'] == b['pred_sem_seg']).mean()
            say(f'  image {i}: inference_model under torch defaults (cuDNN '
                f'TF32 on) vs float32 module forms rel {e:.3e} (tol '
                f'{TOL_MODEL:g}), argmax agreement {agree:.6f}')
            if not (np.isfinite(la).all() and e <= TOL_MODEL
                    and agree >= MIN_ARGMAX_AGREEMENT):
                raise AssertionError(f'image {i}: TF32 defaults change the '
                                     f'answer')
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
            mine = [(op, args, kw) for n, op, args, kw in calls + pyr_calls
                    if n == name]
            ms = plain_ms = bound = old_bound = 0.0
            bound_by = {'bytes': 0.0, 'operations': 0.0}
            with torch.inference_mode():
                for op, args, kw in mine:
                    t = cuda_ms(lambda: op(*args, **dict(kw, impl='cuda')), 20)
                    t_plain = cuda_ms(lambda: op(*args, **dict(kw, impl='plain')), 20)
                    b, by, b_f32 = bounds_ms(name, args, kw)
                    ms, plain_ms, bound = ms + t, plain_ms + t_plain, bound + b
                    old_bound += b_f32
                    bound_by[by] += b
                    if name in ('sesp_block', 'sesp_pyramid'):
                        rates = kw['rates'] if name == 'sesp_block' else args[3]
                        say(f'    {name} {shape_of(args)} rates {tuple(rates)} '
                            f'stride {kw["stride"]}: {t:.4f} ms, bound '
                            f'{b:.4f} ms, plain {t_plain:.4f} ms')
            k = len(mine)
            rows.append(dict(
                name=name, route='cuda', source=source, replaces=replaces,
                launches=launches[name], device_launches=device[name],
                max_abs_err=max(errs[name]),
                ms=ms / k, plain_ms=plain_ms / k, bound_ms=bound / k,
                bound_by=max(bound_by, key=bound_by.get), library_ms=None))
            units = ('TF32 tensor cores, 3xTF32' if name in TENSOR_CORE_KERNELS
                     else 'float32 pipes')
            path_calls = sum(1 for n, *_ in calls if n == name)
            say(f'  {name}: {ms / k:.4f} ms/launch, {path_calls} launches '
                f'({per_forward[name]} CUDA launches)/forward, bound {bound / k:.4f} ms '
                f'({rows[-1]["bound_by"]}, {units}; float32-pipe bound '
                f'{old_bound / k:.4f} ms), plain {plain_ms / k:.4f} ms')
            earlier = {'sesp_block': ' / '.join(f'{t:.4f}' for t in EARLIER_SESP_MS),
                       'stem_convs': f'{EARLIER_STEM_MS:.4f}',
                       'basic_pair': f'{EARLIER_PAIR_MS:.4f}'}
            if name in earlier:
                say(f'  {name} before its redesign (same card type): '
                    f'{earlier[name]} ms/launch')

    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_eval_step, make_train_step)
    with phase('6 train'):
        train_model = init_model(CONFIG, device='cuda',
                                 generator=torch.Generator().manual_seed(SEED + 1))
        cfg = train_model.cfg
        opt, sched = build_optimizer(train_model, cfg.optim_wrapper,
                                     cfg.param_scheduler)
        train = make_train_step(train_model, opt, train_model.data_preprocessor)
        state = create_train_state(train_model, opt, sched)
        t_imgs, t_lbl = (t.cuda() for t in train_batch(rng, TRAIN_BATCH, SIZE))
        torch.cuda.reset_peak_memory_stats()
        for flags, n in (('TF32 off', 1 + TRAIN_STEPS),
                         ("torch's defaults, cuDNN TF32 on", 3)):
            torch.backends.cudnn.allow_tf32 = flags != 'TF32 off'
            times = []
            for i in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, logs = train(state, t_imgs, t_lbl)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                vals = {k: v.item() for k, v in logs.items()}
                say(f'  step {state.step} ({flags}): ' + ', '.join(
                    f'{k} {v:.5f}' for k, v in vals.items()) +
                    f', {times[-1]:.3f} ms')
                if not all(np.isfinite(v) for v in vals.values()):
                    raise AssertionError(f'step {state.step}: non-finite logs')
            ms = sum(times[1:]) / (n - 1)
            say(f'  train step, bs {TRAIN_BATCH} at {SIZE}x{SIZE} ({flags}): '
                f'{ms:.3f} ms/step ({TRAIN_BATCH * 1000 / ms:.2f} img/s) over '
                f'{n - 1} steps after a warm-up, on {card}')
        torch.backends.cudnn.allow_tf32 = False
        say(f'  peak memory allocated: '
            f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
        del train_model, opt, train, state, t_imgs, t_lbl, logs
        torch.cuda.empty_cache()
        for seed in TRAIN_CHECK_SEEDS:
            s_imgs, s_lbl = train_batch(np.random.default_rng(seed), 2, 256)
            for name, extra in (("the config's OHEM losses", {}),
                                ('CrossEntropyLoss',
                                 {'model.decode_head.loss_decode': CE_LOSSES})):
                cfg = Config.fromfile(CONFIG)
                cfg.merge_from_dict(dict(
                    {'model.data_preprocessor.size': (256, 256)}, **extra))
                cpu_run = train_once(cfg, 'cpu', s_imgs, s_lbl, seed)
                with torch.backends.cudnn.flags(enabled=False):
                    own_convs = train_once(cfg, 'cuda', s_imgs, s_lbl, seed)
                hold_train(f'one step, seed {seed}, 2x256x256, {name}, '
                           "PyTorch's own CUDA convs", own_convs, cpu_run,
                           ('weights', 'bn_stats'))
                hold_train(f'one step, seed {seed}, 2x256x256, {name}, cuDNN',
                           train_once(cfg, 'cuda', s_imgs, s_lbl, seed),
                           cpu_run, ('bn_stats',))

    with phase('7 eval graph'):
        step = make_eval_step(model, model.data_preprocessor)

        def eager():
            x, _, _ = model.data_preprocessor(x_dev, impl='cuda')
            return model.predict(x, 'cuda')
        with torch.inference_mode():
            ref = eager()
            check_logits('replay vs eager kernel path', step(x_dev), ref)
        opt, sched = build_optimizer(model, model.cfg.optim_wrapper,
                                     model.cfg.param_scheduler)
        b_imgs, b_lbl = (t.cuda() for t in train_batch(rng, 2, SIZE))
        make_train_step(model, opt, model.data_preprocessor)(
            create_train_state(model, opt, sched), b_imgs, b_lbl)
        model.eval()
        with torch.inference_mode():
            ref2 = eager()
            moved = (ref2 - ref).abs().max().item()
            check_logits('replay after a train step vs eager', step(x_dev), ref2)
        say(f'  the train step moved the logits by up to {moved:.3e}; graphs '
            f'captured by the step: {step.captures}')
        if not (moved > 0 and step.captures == 2):
            raise AssertionError('the step did not capture again after the '
                                 'weights changed')
        res = inference_model(model, imgs[0])
        check_logits('inference_model vs eager',
                     torch.from_numpy(res['seg_logits']), ref2[0].cpu())
        with torch.inference_mode():
            replay_ms = cuda_ms(lambda: step(x_dev), reps=50, warmup=5)
            eager_ms = cuda_ms(eager, reps=50, warmup=5)
        say(f'  forward 1x{SIZE}x{SIZE}: replayed graph {replay_ms:.3f} ms '
            f'({1000 / replay_ms:.1f} img/s), eager kernel path {eager_ms:.3f} '
            f'ms ({1000 / eager_ms:.1f} img/s); graphs captured: step '
            f'{step.captures}, inference_model {model._eval_step.captures}')
        with torch.inference_mode():
            sync_replay, sync_eager = (synced_ms(f, reps=50, warmup=5)
                                       for f in (lambda: step(x_dev), eager))
        t0 = time.perf_counter()
        for _ in range(200):
            step.weights_key()
        key_ms = (time.perf_counter() - t0) / 200 * 1e3
        say(f'  one frame at a time (host clock, synchronized after each of '
            f'50 calls): replayed graph {sync_replay:.3f} ms, eager kernel '
            f'path {sync_eager:.3f} ms; host time of the step\'s weights '
            f'check {key_ms:.3f} ms per call')

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
