#!/usr/bin/env python3
"""Which module's output differs between the eval step's replayed CUDA
graph and the eager path, on one GPU.

    python3 tools/torch_port_replay_probe.py --config CFG [--hw H W] [--runs N]

Builds the config's model on the card with seeded weights and non-trivial
BatchNorm stats (``chip_smoke.randomize_norms``), as ``chip_smoke.py``'s zoo
phases do, and records the output of every leaf module (forward hooks that
keep a copy) on a seeded uint8 frame of ``--hw`` (default 1024 x 2048):
twice on the eager path, and in the eval step's graph
(``lednet_tpu_torch.engine.make_eval_step``: the copies made during capture
are written at each replay and read after it).  Prints, for each of
``--runs`` replays, the largest absolute difference of the logits against
the eager path and the first leaf module in call order whose output
differs, and for the second eager forward the same against the first (the
eager path's own run-to-run difference).  Each module prints on one line
with its type and, for a convolution, its shape and stride, so a
differing op names itself.  Float32 throughout (TF32 off), as the eval
step runs.  Exits non-zero without a GPU.
"""
import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def record(model, into):
    """Forward hooks on every leaf module of ``model`` appending
    ``(name, copy of the output)`` to ``into()``'s list; returns the
    handles."""
    import torch
    handles = []
    for name, mod in model.named_modules():
        if next(mod.children(), None) is not None:
            continue

        def hook(m, args, out, name=name):
            if isinstance(out, torch.Tensor):
                into().append((name, out.detach().clone()))
        handles.append(mod.register_forward_hook(hook))
    return handles


def first_difference(a, b):
    """(max |a - b| over the logits, the first (name, max |diff|, max |b|)
    whose outputs differ, or None)."""
    for (na, ta), (nb, tb) in zip(a, b):
        if na != nb:
            raise AssertionError(f'call order differs: {na} / {nb}')
        d = (ta.double() - tb.double()).abs().max().item()
        if d > 0:
            return na, d, tb.double().abs().max().item()
    return None


def describe(model, name):
    mod = dict(model.named_modules())[name]
    extra = ''
    if hasattr(mod, 'weight') and mod.weight is not None and mod.weight.dim() == 4:
        extra = (f' weight {tuple(mod.weight.shape)} stride '
                 f'{getattr(mod, "stride", None)}')
    return f'{name} ({type(mod).__name__}{extra})'


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--config', required=True)
    ap.add_argument('--hw', type=int, nargs=2, default=(1024, 2048))
    ap.add_argument('--runs', type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_port_replay_probe: CUDA is not available', file=sys.stderr)
        return 2
    import chip_smoke
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.engine import float32_math, make_eval_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 10)
    model = init_model(args.config, device='cuda', generator=gen)
    chip_smoke.randomize_norms(model, gen)
    model.eval()
    pre = model.data_preprocessor
    rng = np.random.default_rng(chip_smoke.SEED + 10)
    x8 = torch.from_numpy(rng.integers(0, 256, (1,) + tuple(args.hw) + (3,),
                                       dtype=np.uint8)).cuda()
    lists = {'now': []}
    handles = record(model, lambda: lists['now'])

    def eager():
        lists['now'] = []
        with float32_math(), torch.no_grad():
            out = model.predict(pre(x8)[0])
        torch.cuda.synchronize()
        return lists['now'], out

    first, out1 = eager()
    second, out2 = eager()
    step = make_eval_step(model, pre)
    captured = []

    def into():
        # the warm-up's copies are dropped; the capture's are the graph's
        return captured if torch.cuda.is_current_stream_capturing() else []
    for h in handles:
        h.remove()
    record(model, into)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True).stdout.strip()
    print(f'{args.config} at 1x{args.hw[0]}x{args.hw[1]}, {len(first)} leaf '
          f'outputs; on {card}')
    d = (out2.double() - out1.double()).abs().max().item()
    hit = first_difference(second, first)
    print(f'eager vs eager: logits max |diff| {d:.3e}; first differing '
          f'module: ' + (f'{describe(model, hit[0])} max |diff| {hit[1]:.3e} '
                         f'of max |out| {hit[2]:.3e}' if hit else 'none'))
    for run in range(args.runs):
        got = step(x8)
        torch.cuda.synchronize()
        if len(captured) != len(first):
            raise AssertionError(f'{len(captured)} outputs captured, not '
                                 f'{len(first)}')
        d = (got.double() - out1.double()).abs().max().item()
        hit = first_difference(captured, first)
        print(f'replay {run} vs eager: logits max |diff| {d:.3e} of max '
              f'|logit| {out1.abs().max().item():.3e}; first differing '
              f'module: ' + (f'{describe(model, hit[0])} max |diff| '
                             f'{hit[1]:.3e} of max |out| {hit[2]:.3e}'
                             if hit else 'none'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
