"""Training observability: console lines, ``scalars.json`` and TensorBoard.

Counterpart of ``lednet_tpu/engine/loggers.py`` (``ScalarLogger`` :18): the
reference's LoggerHook console lines and its ``vis_data/scalars.json``
JSON-lines file; TensorBoard when ``torch.utils.tensorboard`` imports.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Optional


class ScalarLogger:
    def __init__(self, work_dir: str, use_tensorboard: bool = True):
        self.vis_dir = osp.join(work_dir, 'vis_data')
        os.makedirs(self.vis_dir, exist_ok=True)
        self.scalar_path = osp.join(self.vis_dir, 'scalars.json')
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:          # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(osp.join(self.vis_dir, 'tb'))

    def log(self, step: int, scalars: Dict[str, float], prefix: str = '') -> None:
        record = {f'{prefix}{k}': _to_float(v) for k, v in scalars.items()}
        record['step'] = step
        with open(self.scalar_path, 'a', encoding='utf-8') as f:
            f.write(json.dumps(record) + '\n')
        if self._tb is not None:
            for k, v in record.items():
                if k != 'step':
                    self._tb.add_scalar(k, v, step)

    def console(self, step: int, max_iters: int, scalars: Dict[str, float],
                lr: Optional[float] = None, iter_time: Optional[float] = None,
                data_time: Optional[float] = None,
                memory_mb: Optional[float] = None) -> None:
        parts = [f'Iter [{step}/{max_iters}]']
        if lr is not None:
            parts.append(f'lr: {lr:.4e}')
        if iter_time is not None:
            parts.append(f'time: {iter_time:.3f}s')
            if data_time is not None:
                parts.append(f'data_time: {data_time:.3f}s')
            parts.append(f'eta: {_fmt_eta((max_iters - step) * iter_time)}')
        if memory_mb is not None:
            parts.append(f'memory: {memory_mb:.0f}')
        parts += [f'{k}: {_to_float(v):.4f}' for k, v in scalars.items()]
        print('  '.join(parts), flush=True)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


def _to_float(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float('nan')


def _fmt_eta(seconds: float) -> str:
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    return f'{h:d}:{m:02d}:{s:02d}'
