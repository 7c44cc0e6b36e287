"""Checkpoints: save, load and find the latest.

Counterpart of ``lednet_tpu/engine/checkpoint.py`` (``save_checkpoint`` :24,
``load_checkpoint`` :43, ``find_latest_checkpoint`` :60).  orbax is a JAX
library, so a checkpoint is the reference's own layout,
``work_dir/iter_N.pth`` written by ``torch.save``: ``state_dict`` (the
model's), ``optimizer`` (its state: SGD's momentum buffers), ``step`` and
``meta`` (``dataset_meta``, ``iter``), with ``work_dir/last_checkpoint``
naming the newest.  ``init_model(cfg, 'iter_N.pth')`` reads the same file.
"""
from __future__ import annotations

import os
import os.path as osp
import re
from typing import Dict, Optional, Tuple

import torch

from lednet_tpu_torch.engine.state import TrainState


def save_checkpoint(work_dir: str, state: TrainState,
                    meta: Optional[Dict] = None) -> str:
    """Write ``iter_<step>.pth`` (via a temporary file, so a reader never
    sees half of it) and point ``last_checkpoint`` at it; returns its path."""
    path = osp.abspath(osp.join(work_dir, f'iter_{state.step}.pth'))
    payload = dict(state_dict=state.model.state_dict(),
                   optimizer=state.optimizer.optimizer.state_dict(),
                   step=state.step, meta=dict(meta or {}, iter=state.step))
    tmp = f'{path}.tmp{os.getpid()}'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(osp.join(work_dir, 'last_checkpoint'), 'w', encoding='utf-8') as f:
        f.write(path)
    return path


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict]:
    """Restore the model, the optimizer state and the step saved by
    :func:`save_checkpoint` into ``state`` (in place); returns (state, meta)."""
    payload = torch.load(path, map_location='cpu')
    state.model.load_state_dict(payload['state_dict'])
    state.optimizer.optimizer.load_state_dict(payload['optimizer'])
    state.step = int(payload['step'])
    return state, payload.get('meta', {})


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    """The file ``last_checkpoint`` names, else the ``iter_N.pth`` with the
    largest N (reference ``tools/train.py`` ``--resume``)."""
    marker = osp.join(work_dir, 'last_checkpoint')
    if osp.exists(marker):
        with open(marker, encoding='utf-8') as f:
            path = f.read().strip()
        if osp.isfile(path):
            return path
    if not osp.isdir(work_dir):
        return None
    found = [(int(m.group(1)), osp.join(work_dir, name))
             for name in os.listdir(work_dir)
             for m in [re.fullmatch(r'iter_(\d+)\.pth', name)] if m]
    return max(found)[1] if found else None
