"""Weight bridge: flax ``params``/``batch_stats`` -> the port's ``state_dict``.

The port's modules carry the flax module names, so the mapping is by path:

- conv kernels HWIO -> OIHW (``kernel`` -> ``weight``, axes (3, 2, 0, 1)); a
  depthwise kernel (kh, kw, 1, C) becomes (C, 1, kh, kw) the same way, as do
  the raw SESP branch kernels ``spp_dw{i}`` / ``spp_dw_v2_{i}`` (3, 3, 1, n);
  so does UNet's transposed conv (``deconv``): flax's ``ConvTranspose``
  kernel with ``transpose_kernel=True`` is (k, k, out, in), the forward
  conv's, and its transpose is ``ConvTranspose2d``'s (in, out, k, k),
  unflipped;
- BatchNorm ``scale``/``bias`` + ``mean``/``var`` -> ``weight``/``bias`` +
  ``running_mean``/``running_var`` (+ ``num_batches_tracked`` = 0); a
  LayerNorm's or GroupNorm's ``scale`` -> ``weight``;
- PReLU ``alpha``, GETB ``relative_position_bias_table``, MSCAN's
  ``layer_scale_{1,2}`` and biases keep their names;
- the segmentor's ``_backbone``/``_decode_head`` lose the leading
  underscore, and its auxiliary heads ``_aux_heads_{i}`` become
  ``aux_heads.{i}``;
- the trunk that ``BiSeNetV1`` and ``STDCContextPathNet`` build inline,
  which flax names after its class (``ResNet_0``, ``ResNetV1c_0``,
  ``STDCNet_0``), is ``backbone``.

Every other module keeps its name: ``_Stage``'s ``block{i}``, ResNet's
``stem``/``stem{i}`` and ``layer{i}_{j}``, DAPPM's ``scale{i}`` /
``process{i}`` / ``compression`` / ``shortcut`` (PAPPM's grouped
``processes``), BiSeNetV1's ``spatial_path`` / ``arm16`` / ``arm32`` /
``ffm`` / ``gap_conv`` / ``conv_head16`` / ``conv_head32``, PIDNet's
``pag_{i}`` / ``diff_{i}`` / ``{i,p,d}_layer{n}`` / ``spp`` / ``dfm`` and
PIDHead's ``{i,p,d}_head`` / ``{,p_,d_}cls_seg``, STDCNet's
``stage{s}_{j}`` (``conv{i}`` / ``downsample`` / ``skip_dw`` /
``skip_pw``), STDCContextPathNet's ``conv_avg`` / ``arm{i}`` / ``conv{i}``
/ ``ffm`` (``conv0`` / ``attn1`` / ``attn2``), FCNHead's ``conv{i}`` /
``conv_cat`` / ``cls``, MSCAN's ``stem{1,2}`` / ``down{i}`` /
``down_norm{i}`` / ``s{i}_b{j}`` (``norm{1,2}``, ``proj_{1,2}``, ``attn``
with ``conv0`` / ``conv{k}_{1,2}`` / ``conv_mix``, ``fc{1,2}``, ``dw``) /
``stage_norm{i}``, and LightHamHead's ``squeeze`` / ``hamburger``
(``ham_in`` / ``ham_out``) / ``align`` / ``cls``, UNet's ``enc{i}`` /
``up{i}`` / ``dec{i}`` (``conv{j}``; ``InterpConv``'s ``conv``,
``DeconvModule``'s ``deconv`` / ``norm``); a norm's module is
``bn``, ``gn`` or ``ln`` by its type.  Any other automatic flax name (``ClassName_{n}``)
has no counterpart in the port and raises.

A checkpoint file is a ``.npz`` whose keys are ``'/'``-joined paths under a
``params/`` or ``batch_stats/`` root (see :func:`save_npz_variables`).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


_AUTO_NAME = re.compile(r'[A-Z][A-Za-z0-9]*_\d+')
_TRUNK = re.compile(r'(ResNet(V1c)?|STDCNet)_0')
_AUX_HEAD = re.compile(r'aux_heads_(\d+)')


def _module_path(path: Tuple[str, ...]) -> List[str]:
    """The port's names of a flax module path (see the module docstring)."""
    out = []
    for part in (p.lstrip('_') for p in path):
        aux = _AUX_HEAD.fullmatch(part)
        if aux:
            out += ['aux_heads', aux.group(1)]
        elif _TRUNK.fullmatch(part):
            out.append('backbone')
        elif _AUTO_NAME.fullmatch(part):
            raise ValueError(f'no port module for the flax name {part!r} in '
                             f'{"/".join(path)}')
        else:
            out.append(part)
    return out


def _param_entry(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    mods, leaf = _module_path(path[:-1]), path[-1]
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
        mods, leaf = _module_path(path[:-1]), path[-1]
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
