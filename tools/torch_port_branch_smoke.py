#!/usr/bin/env python3
"""The Apple Branch phase of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/torch_port_branch_smoke.py

Prints the card's name and power limit, builds the kernels, takes one
flagship forward's CUDA launches from a device trace (what phase 9 holds
each eval shape to) and runs ``chip_smoke.branch_path``: the branch config
through the train and test CLIs (``--tta`` too) on a fabricated JPEG tree,
kernels A-D against their plain versions at every eval shape, and the
card's numbers.  About 2.5 minutes; exits non-zero if the phase fails or
there is no GPU.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('torch_port_branch_smoke: CUDA is not available', file=sys.stderr)
        return 2
    os.chdir(REPO)
    import chip_smoke
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.ops.kernels import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    chip_smoke.say(f'{card}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    _build.build()
    _build.library()
    model = init_model(chip_smoke.CONFIG, device='cuda',
                       generator=torch.Generator().manual_seed(chip_smoke.SEED))
    x = torch.randint(0, 256, (1, chip_smoke.SIZE, chip_smoke.SIZE, 3),
                      dtype=torch.uint8).cuda()
    with torch.inference_mode():
        y, _, _ = model.data_preprocessor(x, impl='cuda')
        model.predict(y, 'cuda')
    _, per_forward = chip_smoke.traced_forward(model, x)
    chip_smoke.say(f'CUDA launches of one flagship forward: {per_forward}')
    del model, x, y
    torch.cuda.empty_cache()
    try:
        with chip_smoke.phase('9 branch'):
            launches, device, errs = chip_smoke.branch_path(card, per_forward)
    except chip_smoke.PhaseError:
        return 1
    chip_smoke.say(f'launches {launches}; device {device}; max abs err {errs}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
