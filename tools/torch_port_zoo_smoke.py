#!/usr/bin/env python3
"""The zoo phase of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/torch_port_zoo_smoke.py

Prints the card's name and power limit, builds the kernels and runs
``chip_smoke.zoo_models`` and ``chip_smoke.zoo_entry_points``: DDRNet-23-slim
and BiSeNetV1 R-18 at their configs' widths through ``inference_model``
(kernel A at float32 output against its plain version, the kernel path
against the module forms, the eval graph against the eager path, DDRNet-23
once), their train steps (timed, and held to the CPU's), then DDRNet-23-slim
through the train and test CLIs.  Exits non-zero if the phase fails or there
is no GPU.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
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
    try:
        with chip_smoke.phase('10 zoo'):
            launches, device, a_err = chip_smoke.zoo_models(card)
            chip_smoke.zoo_entry_points(card)
    except chip_smoke.PhaseError:
        return 1
    chip_smoke.say(f'launches {launches}; device {device}; kernel A max abs '
                   f'err at float32 output {a_err}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
