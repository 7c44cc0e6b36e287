#!/usr/bin/env python3
"""The zoo phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/torch_port_zoo_smoke.py [--phase 10 | 11 | 12 | 13 | 10 11 12 13]

Prints the card's name and power limit, builds the kernels, fabricates the
zoo's Cityscapes tree (``chip_smoke.zoo_tree``) and runs
``chip_smoke.zoo_models`` and ``chip_smoke.zoo_entry_points`` for each
phase asked for (default 10):

- 10: DDRNet-23-slim and BiSeNetV1 R-18 at their configs' widths through
  ``inference_model`` (kernel A at float32 output against its plain
  version, the kernel path against the module forms, the eval graph
  against the eager path), DDRNet-23 once, their train steps (timed, and
  held to the CPU's), then DDRNet-23-slim through the train and test CLIs;
- 11: the same of PIDNet-S and STDC1 (PIDNet-M, PIDNet-L and STDC2 once;
  PIDNet-S trains on edge maps), then PIDNet-S through the CLIs;
- 12: ``init_model`` on the card of the 4 BiSeNetV2 and 10 Cityscapes
  HRNet configs, then as 10 of BiSeNetV2 (its ``-ohem-`` config) and
  HRNet-W18 (HRNet-W18-Small and W48 once), the ``-amp-`` config's
  bfloat16 step beside its float32 one (``chip_smoke.bf16_step``), then
  the ``-amp-`` config and HRNet-W18 through the CLIs;
- 13: ``init_model`` on the card of the 4 SegNeXt configs, then as 10 of
  SegNeXt-T (S, B and L once; the card's step against the CPU's past the
  warm-up), then T through the CLIs on a fabricated ADE20K tree
  (``chip_smoke.segnext``).

Exits non-zero if a phase fails or there is no GPU.
"""
import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--phase', nargs='+', choices=('10', '11', '12', '13'),
                    default=['10'])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_port_zoo_smoke: CUDA is not available', file=sys.stderr)
        return 2
    os.chdir(REPO)
    import chip_smoke
    from lednet_tpu_torch.ops.kernels import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    chip_smoke.say(f'{card}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    _build.build()
    _build.library()

    def zoo(models, wide):
        def run(tree):
            out = chip_smoke.zoo_models(card, models, wide)
            chip_smoke.zoo_entry_points(card, tree, *models[0])
            return out
        return run
    phases = {'10': ('10 zoo', zoo(chip_smoke.ZOO, chip_smoke.ZOO_WIDE)),
              '11': ('11 pidnet stdc', zoo(chip_smoke.PID_STDC,
                                           chip_smoke.PID_STDC_WIDE)),
              '12': ('12 bisenetv2 hrnet',
                     lambda tree: chip_smoke.bise_hrnet(card, tree)),
              '13': ('13 segnext', lambda tree: chip_smoke.segnext(card, tree))}
    try:
        with chip_smoke.zoo_tree() as tree:
            for key in args.phase:
                name, run = phases[key]
                with chip_smoke.phase(name):
                    launches, device, a_err = run(tree)
                chip_smoke.say(f'phase {key}: launches {launches}; device '
                               f'{device}; kernel A max abs err at float32 '
                               f'output {a_err}')
    except chip_smoke.PhaseError:
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
