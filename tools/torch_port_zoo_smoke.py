#!/usr/bin/env python3
"""The zoo phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/torch_port_zoo_smoke.py [--phase 10 | 11 | ... | 20 | 10 11 ...]

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
  (``chip_smoke.segnext``);
- 14: slide inference (``chip_smoke.slide``): ``init_model`` on the card
  of the DRIVE config and the 12 HRNet Pascal Context configs, then as 10
  of UNet-S5-D16 on a 584x565 DRIVE frame (196 crops of 64x64 per
  forward; the card's step against the CPU's at 4 x 64x64), HRNet-W18's
  Pascal Context-59 slide forward once (and ``inference_model`` raising on
  a 500x375 photo, as in the JAX package), then UNet through the CLIs on a
  fabricated DRIVE tree (the test CLI equal to the val, then with
  ``--tta``) and HRNet-W18 on a fabricated Pascal Context tree;
- 15: the datasets (``chip_smoke.datasets``): ``init_model`` on the card
  of the 24 HRNet VOC aug / iSAID / LoveDA / Potsdam / Vaihingen and
  BiSeNetV1 COCO-Stuff configs, then as 10 of BiSeNetV1 R-50 (R-101
  once), then HRNet-W18 on a fabricated VOC + SBD aug tree and BiSeNetV1
  R-50 on a COCO-Stuff one through the train and test CLIs, and
  HRNet-W18-Small on an iSAID one (896x896 crops) through the train CLI;
- 16: the real-time zoo (``chip_smoke.realtime``): as 10 of ICNet R-18,
  Fast-SCNN, ERFNet, CGNet and LR-ASPP MobileNetV3-L on the 1024x2048
  Cityscapes test frame (each also against its copy on the CPU at 256x512,
  each train step at its loader's 1024x1024 crops), then ICNet and CGNet
  through the train and test CLIs;
- 17: ``chip_smoke.sct_rtformer_psp``: as 16 of SCTNet-B, RTFormer-Base,
  PSPNet R50-D8 and DeepLabV3+ R50-D8 (RTFormer-Slim once), DSNet-S as
  the module the JAX package runs (its forward on the card against its
  CPU copy; ``init_model`` raising on its config), then RTFormer-Base and
  DeepLabV3+ through the train and test CLIs;
- 18: ``chip_smoke.cascade_transformers``: as 16 of OCRNet HR18 and
  PointRend R50 (the cascade segmentor) and SegFormer-B0 on the 1024x2048
  Cityscapes test frame, and UPerNet Swin-T on a 512x683 ADE20K test
  frame (its CPU copy at 128x171), then OCRNet and Swin-T through the
  train and test CLIs (Swin on a fabricated ADE20K tree);
- 19: ``chip_smoke.knet_mask2former``: as 16 of K-Net s3 R50-D8 and
  Mask2Former R50 on the 1024x2048 Cityscapes test frame (the float32
  card-against-CPU step with the heads' hard masks, attention masks,
  Hungarian assignment and sampled points pinned), one Mask2Former
  forward with the deformable pixel decoder, then both through the train
  and test CLIs;
- 20: ``chip_smoke.san``: as 16 of SAN ViT-B16 (``out_origin=True``
  through the config options) on the 1024x2048 Cityscapes test frame, with
  the matching's host time in its train step and the text tower's share
  of the forward, its card-against-CPU checks with one prompt template,
  then through the train and test CLIs, and the config as shipped raising.

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
    ap.add_argument('--phase', nargs='+',
                    choices=('10', '11', '12', '13', '14', '15', '16', '17',
                             '18', '19', '20'),
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
              '13': ('13 segnext', lambda tree: chip_smoke.segnext(card, tree)),
              '14': ('14 slide', lambda tree: chip_smoke.slide(card, tree)),
              '15': ('15 datasets',
                     lambda tree: chip_smoke.datasets(card, tree)),
              '16': ('16 realtime',
                     lambda tree: chip_smoke.realtime(card, tree)),
              '17': ('17 sctnet rtformer psp',
                     lambda tree: chip_smoke.sct_rtformer_psp(card, tree)),
              '18': ('18 cascade transformers',
                     lambda tree: chip_smoke.cascade_transformers(card, tree)),
              '19': ('19 knet mask2former',
                     lambda tree: chip_smoke.knet_mask2former(card, tree)),
              '20': ('20 san', lambda tree: chip_smoke.san(card, tree))}
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
