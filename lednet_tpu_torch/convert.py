"""Weight bridge: flax ``params``/``batch_stats`` -> the port's ``state_dict``.

The port's modules carry the flax module names, so the mapping is by path:

- conv kernels HWIO -> OIHW (``kernel`` -> ``weight``, axes (3, 2, 0, 1)); a
  depthwise kernel (kh, kw, 1, C) becomes (C, 1, kh, kw) the same way, as do
  the raw SESP branch kernels ``spp_dw{i}`` / ``spp_dw_v2_{i}`` (3, 3, 1, n);
- BatchNorm ``scale``/``bias`` + ``mean``/``var`` -> ``weight``/``bias`` +
  ``running_mean``/``running_var`` (+ ``num_batches_tracked`` = 0); a
  LayerNorm ``scale`` -> ``weight``;
- PReLU ``alpha``, GETB ``relative_position_bias_table`` and biases keep
  their names;
- the segmentor's ``_backbone``/``_decode_head`` lose the leading underscore.

A checkpoint file is a ``.npz`` whose keys are ``'/'``-joined paths under a
``params/`` or ``batch_stats/`` root (see :func:`save_npz_variables`).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _param_entry(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = (p.lstrip('_') for p in path)
    if leaf == 'kernel' and value.ndim == 4 or leaf.startswith('spp_dw'):
        value = np.transpose(value, (3, 2, 0, 1))
        leaf = 'weight' if leaf == 'kernel' else leaf
    elif leaf == 'kernel':
        raise ValueError(f'unexpected {value.ndim}-D kernel at {"/".join(path)}')
    elif leaf == 'scale':
        leaf = 'weight'
    return '.'.join(mods + [leaf]), value


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """Nested flax variable dicts (numpy or jax arrays) -> a ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        name, arr = _param_entry(path, np.asarray(value, np.float32))
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, value in _flatten(batch_stats or {}):
        *mods, leaf = (p.lstrip('_') for p in path)
        if leaf not in ('mean', 'var'):
            raise ValueError(f'unexpected batch stat {"/".join(path)}')
        sd['.'.join(mods + ['running_' + leaf])] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(value, np.float32)))
        sd['.'.join(mods + ['num_batches_tracked'])] = torch.tensor(0)
    return sd


def save_npz_variables(path: str, params: Mapping,
                       batch_stats: Optional[Mapping] = None) -> None:
    """Write flax variables as a flat ``.npz`` checkpoint."""
    flat = {}
    for root, tree in (('params', params), ('batch_stats', batch_stats or {})):
        for p, value in _flatten(tree):
            flat['/'.join((root,) + p)] = np.asarray(value)
    np.savez(path, **flat)


def load_npz_variables(path: str) -> Tuple[Dict, Dict]:
    """Read a flat ``.npz`` checkpoint back into nested (params, batch_stats)."""
    trees: Dict[str, Dict] = {'params': {}, 'batch_stats': {}}
    with np.load(path) as data:
        for key in data.files:
            root, *parts = key.split('/')
            if root not in trees:
                raise ValueError(f'unexpected checkpoint key {key}')
            node = trees[root]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return trees['params'], trees['batch_stats']
