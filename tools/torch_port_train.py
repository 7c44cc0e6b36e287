#!/usr/bin/env python
"""Train a segmentor with the PyTorch port (``lednet_tpu_torch``).

    python tools/torch_port_train.py CONFIG [--work-dir DIR] [--resume]
        [--amp] [--cfg-options KEY=VALUE ...] [--seed N]

The CLI of ``tools/train.py``, on one GPU through the port's ``Runner``.
It runs on CUDA and raises without a GPU (``--device cpu`` runs on the
CPU).  ``--launcher`` takes only ``none``: multi-GPU training is later
work (ROADMAP: multi-GPU).
"""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a segmentor (PyTorch port)')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', help='dir to save logs and checkpoints')
    p.add_argument('--resume', action='store_true',
                   help='resume from the latest checkpoint in work_dir')
    p.add_argument('--amp', action='store_true',
                   help='bfloat16 autocast for the forward and backward')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config entries: key=value (dotted keys ok)')
    p.add_argument('--launcher', default='none',
                   choices=['none', 'pytorch', 'slurm', 'mpi'])
    p.add_argument('--local_rank', '--local-rank', type=int, default=0)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.launcher != 'none':
        raise NotImplementedError('multi-GPU training is later work in the '
                                  'port (ROADMAP: multi-GPU)')
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine.runner import Runner

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(dict(kv.split('=', 1) for kv in args.cfg_options))
    work_dir = args.work_dir or cfg.get('work_dir') or osp.join(
        './work_dirs', osp.splitext(osp.basename(args.config))[0])
    if args.amp:
        cfg['bf16'] = True
    runner = Runner(cfg, work_dir=work_dir, device=args.device, seed=args.seed)
    runner.train(resume=args.resume or cfg.get('resume', False))


if __name__ == '__main__':
    main()
