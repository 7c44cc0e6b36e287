#!/usr/bin/env python3
"""How far apart float32 train steps of the port land from each other and
from the same step in float64, on the card and on the CPU.

    python3 tools/torch_port_train_gap.py [--seeds 2 3 4 5] [--size 256]

For each seed, one train step of the flagship config at full width
(``chip_smoke.train_once``: seeded weights, 2 seeded BGR uint8 images of
size x size with about 2% of labels ignored, the config's OHEM losses, SGD,
TF32 off) runs

- on the card in float32, twice;
- on the CPU in float64;
- on the CPU in float32 with every thread, with one thread, and with every
  thread on the batch in reverse order (the same sums in another order).

It prints, for each pair, the distance that ``chip_smoke.py`` phase 6
reads (|loss diff|, the largest weight and BatchNorm-stat differences and
the three tensors nearest the bounds, as shares of them: loss 1e-5,
weights atol 1e-4 / rtol 5e-3, stats atol 1e-5) and how many pixels of
SEAM's binarized edge maps (a threshold at 0.1) fell on different sides,
then one JSON line.  ``--cpu-only`` leaves out the card's steps;
``--cudnn MODE ...`` adds a card step per cuDNN setting (``deterministic``,
``benchmark``: its algorithm search; ``off``: PyTorch's own CUDA convs),
each held against the CPU's float64 step.  ``--conv-probe`` instead
measures one conv's weight gradient on the card in float32 against float64
(stem_conv1's shape at 2 x 256x256: 3 -> 32 channels, 3x3, stride 2; N(0,1)
input, N(0,1) output gradient made zero-mean per channel, as BatchNorm's
backward makes it), with cuDNN and with PyTorch's own convs, as a multiple
of float32's unit roundoff times the largest sum of |terms|.

``--grad-trace CONFIG`` instead runs one step of CONFIG (``--batch``
seeded images, 2 by default, of size x size, the first seed, dropout 0 in every head; with their edge
maps where the config's pipeline has ``GenerateEdge``, as PIDNet's) in
float64 on the CPU, then in float32 on the CPU and on the card (cuDNN off)
with their discrete decisions (OHEM, ReLU, max pool, PIDHead's boundary
gate, each ``OHEMPixelSampler``'s keep mask) pinned to the float64 step's,
as ``chip_smoke.decisions`` pins them,
and
prints, in the order the float64 backward reaches them, each leaf module's
output and input gradient and each parameter's gradient as the float32
runs' largest error relative to the float64 one's largest value; before
that, in forward order, each leaf module call's output (``name #k``: its
k-th call, a shared module is entered more than once) as the float32
runs' largest and mean error relative to the float64 output's largest
value, and each loss term's absolute error.  A third float32 run on the
CPU has oneDNN off (``cpu32_im2col``: PyTorch's own im2col + GEMM convs,
as the card's cuDNN-off step).  The whole table goes to
``chiprun_out/grad_trace.json``.
"""
import argparse
import json
import os
import subprocess
import sys

import contextlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (run, reference): each run's SEAM maps are compared with its reference's
PAIRS = (('card', 'cpu64'), ('card_again', 'card'), ('cpu32', 'cpu64'),
         ('cpu32_one_thread', 'cpu32'), ('cpu32_reversed', 'cpu32'),
         ('card', 'cpu32'))


@contextlib.contextmanager
def seam_maps(maps):
    """Append the (input, map) of each of SEAM's binarizations
    (``models/seam.py::_binarize``, a threshold at 0.1) inside to ``maps``."""
    import lednet_tpu_torch.models.seam as seam
    binarize = seam._binarize

    def watched(t):
        out = binarize(t)
        maps.append((t.detach().cpu(), out.detach().cpu()))
        return out
    seam._binarize = watched
    try:
        yield
    finally:
        seam._binarize = binarize


def conv_probe():
    """Error of stem_conv1's float32 weight gradient on the card, in units
    of 2**-24 x the largest sum of |x * g| over a weight's terms."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 256, 256), generator=gen, dtype=torch.float64)
    w = 0.3 * torch.randn((32, 3, 3, 3), generator=gen, dtype=torch.float64)
    g = torch.randn((2, 32, 128, 128), generator=gen, dtype=torch.float64)
    g -= g.mean(dim=(0, 2, 3), keepdim=True)
    cols = F.unfold(x, 3, padding=1, stride=2)
    exact = torch.einsum('nkl,nol->ok', cols, g.flatten(2)).view_as(w)
    scale = torch.einsum('nkl,nol->ok', cols.abs(), g.abs().flatten(2)).max().item()
    out = {}
    for mode in ('cudnn', 'native'):
        with torch.backends.cudnn.flags(enabled=mode == 'cudnn'):
            xc, wc = x.float().cuda(), w.float().cuda().requires_grad_()
            F.conv2d(xc, wc, stride=2, padding=1).backward(g.float().cuda())
            err = (wc.grad.double().cpu() - exact).abs().max().item()
        out[mode] = err / (2 ** -24 * scale)
        print(f'conv probe, {mode}: max |wgrad - exact| {err:.3e} = '
              f'{out[mode]:.1f} x 2^-24 x max sum|terms| ({scale:.1f}); '
              f'max |exact| {exact.abs().max().item():.3f}', flush=True)
    return out


def grad_trace(config, size, seed, batch=2):
    """Relative gradient errors of one float32 step against float64, module
    by module in backward order (see the module docstring)."""
    import numpy as np
    import torch
    import chip_smoke as smoke
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_train_step)
    cfg = Config.fromfile(os.path.join(REPO, config))
    extra, _ = smoke.without_dropout(cfg)
    extra['model.data_preprocessor.size'] = (size, size)
    cfg.merge_from_dict(extra)
    imgs, lbl = smoke.train_batch(np.random.default_rng(seed), batch, size,
                                  smoke.edge_width(cfg))

    def traced(device, dtype, kept, flips, pin, mkldnn=True):
        model = init_model(cfg, device=device,
                           generator=torch.Generator().manual_seed(seed))
        model.to(dtype)
        grads, order, values, calls = {}, [], {}, {}

        def keep(name, t):
            def hook(g):
                if name not in grads:
                    order.append(name)
                grads[name] = g.detach().double().cpu()
            if torch.is_tensor(t) and t.requires_grad:
                t.register_hook(hook)

        def forward_hook(name):
            def hook(mod, inp, out):
                k = calls[name] = calls.get(name, -1) + 1
                if torch.is_tensor(out):
                    values[f'{name} #{k}'] = out.detach().double().cpu()
                keep(f'{name} out', out)
                keep(f'{name} in', inp[0] if inp else None)
            return hook
        for name, m in model.named_modules():
            if not list(m.children()):
                m.register_forward_hook(forward_hook(name))
        for name, p in model.named_parameters():
            keep(f'{name} param', p)
        opt, sched = build_optimizer(model, cfg.optim_wrapper,
                                     cfg.param_scheduler)
        step = make_train_step(model, opt, model.data_preprocessor)
        with torch.backends.cudnn.flags(enabled=False), \
                torch.backends.mkldnn.flags(enabled=mkldnn), \
                smoke.decisions(kept, flips, pin):
            _, logs = step(create_train_state(model, opt, sched),
                           imgs.to(device), smoke.to_device(lbl, device))
        logs = {k: float(v) for k, v in logs.items()}
        return grads, order, values, logs

    kept = []
    exact, order, exact_values, exact_logs = traced('cpu', torch.float64,
                                                    kept, None, False)
    runs, run_values, run_logs = {}, {}, {}
    for name, device, mkldnn in (('cpu32', 'cpu', True),
                                 ('cpu32_im2col', 'cpu', False),
                                 ('card32', 'cuda', True)):
        if device == 'cuda' and not torch.cuda.is_available():
            continue
        n = {}
        runs[name], _, run_values[name], run_logs[name] = traced(
            device, torch.float32, kept, n, True, mkldnn)
        print(f'{name}: elements decided otherwise than in float64 (then '
              f'pinned): {n}', flush=True)
    forward = []
    for key, ref in exact_values.items():
        scale = ref.abs().max().item()
        errs = {}
        for name, vals in run_values.items():
            d = (vals[key] - ref).abs()
            errs[name] = ((d.max().item() / scale, d.mean().item() / scale)
                          if scale > 0 else None)
        forward.append(dict(key=key, shape=list(ref.shape), max_abs=scale,
                            **errs))
        print(f'forward {key} {tuple(ref.shape)}: max|y| {scale:.3e}; rel err '
              '(max, mean) ' + ', '.join(
                  f'{n} {e[0]:.2e} {e[1]:.2e}' if e else f'{n} -'
                  for n, e in errs.items()), flush=True)
    terms = {k: {name: abs(logs[k] - v) for name, logs in run_logs.items()}
             for k, v in exact_logs.items()}
    for k, errs in terms.items():
        print(f'log {k}: float64 {exact_logs[k]:.9f}; |diff| ' + ', '.join(
            f'{n} {e:.3e}' for n, e in errs.items()), flush=True)
    rows = []
    for key in order:
        ref = exact[key]
        scale = ref.abs().max().item()
        errs = {name: ((g[key] - ref).abs().max().item() / scale
                       if scale > 0 and key in g else None)
                for name, g in runs.items()}
        rows.append(dict(key=key, max_abs=scale, **errs))
        print(f'{key}: max|g| {scale:.3e}; rel err ' + ', '.join(
            f'{n} {e:.2e}' if e is not None else f'{n} -'
            for n, e in errs.items()), flush=True)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'grad_trace.json'), 'w') as f:
        json.dump(dict(config=config, size=size, batch=batch, seed=seed,
                       rows=rows,
                       forward=forward, logs=terms), f)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--seeds', type=int, nargs='+', default=[2, 3, 4, 5])
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--cpu-only', action='store_true')
    ap.add_argument('--conv-probe', action='store_true')
    ap.add_argument('--grad-trace', metavar='CONFIG')
    ap.add_argument('--cudnn', nargs='*', default=[],
                    choices=('deterministic', 'benchmark', 'off'))
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as smoke
    from lednet_tpu_torch.config import Config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.conv_probe:
        print(json.dumps(dict(conv_probe=conv_probe())), flush=True)
        return 0
    card = None
    if not args.cpu_only:
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0].strip()
        print(card, flush=True)
    if args.grad_trace:
        grad_trace(args.grad_trace, args.size, args.seeds[0], args.batch)
        return 0
    cfg = Config.fromfile(os.path.join(REPO, smoke.CONFIG))
    cfg.merge_from_dict({'model.data_preprocessor.size': (args.size, args.size)})
    threads = torch.get_num_threads()
    report = dict(card=card, size=args.size, threads=threads, seeds={})
    for seed in args.seeds:
        imgs, lbl = smoke.train_batch(np.random.default_rng(seed), 2, args.size)
        runs, maps = {}, {}

        def run(name, device='cpu', dtype=None, batch=(imgs, lbl)):
            maps[name] = []
            with seam_maps(maps[name]):
                runs[name] = smoke.train_once(cfg, device, *batch, seed, dtype)
        run('cpu64', dtype=torch.float64)
        run('cpu32')
        # the batch reversed: its maps are compared image by image below
        run('cpu32_reversed', batch=(imgs.flip(0), lbl.flip(0)))
        maps['cpu32_reversed'] = [(t.flip(0), m.flip(0))
                                  for t, m in maps['cpu32_reversed']]
        torch.set_num_threads(1)
        try:
            run('cpu32_one_thread')
        finally:
            torch.set_num_threads(threads)
        if not args.cpu_only:
            run('card', 'cuda')
            run('card_again', 'cuda')
            for mode in args.cudnn:
                flag = 'enabled' if mode == 'off' else mode
                saved = getattr(torch.backends.cudnn, flag)
                setattr(torch.backends.cudnn, flag, mode != 'off')
                try:
                    run(f'card_cudnn_{mode}', 'cuda')
                finally:
                    setattr(torch.backends.cudnn, flag, saved)
        rows = report['seeds'][seed] = []
        for a, b in PAIRS + tuple((f'card_cudnn_{m}', ref) for m in args.cudnn
                                  for ref in ('cpu64', 'cpu32')):
            if a not in runs or b not in runs:
                continue
            dl, dw, ds, shares = smoke.train_distance(runs[a], runs[b])
            top = shares[:3]
            # SEAM pixels on different sides of 0.1, largest input gap
            n = sum(int((ma != mb).sum()) for (_, ma), (_, mb)
                    in zip(maps[a], maps[b]))
            gap = max((ta.double() - tb.double()).abs().max().item()
                      for (ta, _), (tb, _) in zip(maps[a], maps[b]))
            rows.append(dict(run=a, ref=b, loss=dl, weights=dw, bn_stats=ds,
                             nearest=[(k, r) for r, k in top],
                             seam_flips=n, seam_input_gap=gap))
            print(f'seed {seed}, {a} vs {b}: SEAM pixels flipped {n} (input '
                  f'gap up to {gap:.2e}); |loss diff| {dl:.3e}, max |diff| '
                  f'weights {dw:.3e}, BatchNorm stats {ds:.3e}; nearest their '
                  'bound: ' + ', '.join(f'{k} {r:.3f}' for r, k in top),
                  flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
