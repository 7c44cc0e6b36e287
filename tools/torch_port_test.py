#!/usr/bin/env python
"""Evaluate a checkpoint with the PyTorch port (``lednet_tpu_torch``).

    python tools/torch_port_test.py CONFIG CHECKPOINT [--work-dir DIR]
        [--out DIR] [--tta] [--cfg-options KEY=VALUE ...]

The CLI of ``tools/test.py``: the test loader through the port's
``Runner.test`` on one GPU (``--device cpu`` runs on the CPU); prints the
metrics as one JSON line and writes them to ``WORK_DIR/test_results.json``.
CHECKPOINT is an ``iter_N.pth`` of ``tools/torch_port_train.py``.  ``--out``
writes each prediction as a PNG.  ``--tta`` swaps the test pipeline for the
config's ``tta_pipeline`` (each image's views merged by their mean
probabilities).  ``--launcher`` other than ``none`` raises: multi-GPU
evaluation is later work (ROADMAP: multi-GPU).
"""
import argparse
import json
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Test a segmentor (PyTorch port)')
    p.add_argument('config', help='config file path')
    p.add_argument('checkpoint', help='checkpoint file (iter_N.pth)')
    p.add_argument('--work-dir', help='dir to save evaluation results')
    p.add_argument('--out', help='dump predictions to this directory')
    p.add_argument('--tta', action='store_true', help='test-time augmentation')
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--launcher', default='none',
                   choices=['none', 'pytorch', 'slurm', 'mpi'])
    p.add_argument('--local_rank', '--local-rank', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.launcher != 'none':
        raise NotImplementedError('multi-GPU evaluation is later work in the '
                                  'port (ROADMAP: multi-GPU)')
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.datasets import configure_datasets
    from lednet_tpu_torch.engine.runner import Runner

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(dict(kv.split('=', 1) for kv in args.cfg_options))
    work_dir = args.work_dir or osp.join(
        './work_dirs', osp.splitext(osp.basename(args.config))[0])
    if args.tta:
        cfg['test_dataloader']['dataset'] = configure_datasets(
            cfg['test_dataloader']['dataset'], pipeline=cfg['tta_pipeline'])
    if args.out:
        ev = dict(cfg.get('test_evaluator') or cfg.get('val_evaluator')
                  or dict(type='IoUMetric'))
        ev['output_dir'] = args.out
        cfg['test_evaluator'] = ev
    runner = Runner(cfg, work_dir=work_dir, device=args.device)
    metrics = runner.test(args.checkpoint)
    print(json.dumps(metrics), flush=True)
    with open(osp.join(work_dir, 'test_results.json'), 'w', encoding='utf-8') as f:
        json.dump(metrics, f)
    return metrics


if __name__ == '__main__':
    main()
