"""Optimizer and LR-schedule builders from mmseg-style config dicts.

Counterpart of ``lednet_tpu/engine/optim.py`` (``build_lr_schedule`` :22,
``build_optimizer`` :76, the paramwise rules :132-328).  The JAX package
builds an optax chain; the port builds a ``torch.optim`` optimizer whose
param groups carry the same per-parameter multipliers, inside an
:class:`OptimWrapper` that sets each step's lr and clips the gradients:

- SGD: weight decay folds into the gradient before the momentum trace and
  the update is ``p -= lr * v``, which is ``torch.optim.SGD``'s own rule
  (``add_decayed_weights`` -> ``trace`` -> lr scaling in optax); nesterov
  as ``optax.trace(nesterov=True)``.
- Adam and AdamW: both decay *decoupled*, after the Adam scaling
  (``optim.py:111-118``): ``torch.optim.AdamW`` for either type (not
  ``torch.optim.Adam``, whose decay is L2 in the gradient).
- lr multipliers (``custom_keys`` ``lr_mult``, ``bias_lr_mult``, layer
  decay) scale the whole update in optax, decay included; in torch they
  scale a group's lr, which is the same product.
- decay multipliers (``custom_keys`` ``decay_mult``, norm / bias / dwconv /
  flat rules) scale a group's ``weight_decay``.

Paths are the port's dotted parameter names (lower-cased), which mirror the
flax tree, so the JAX package's ``/``-path rules become ``.``-path rules.
A depthwise conv is an ``nn.Conv2d`` with ``groups == in_channels``.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def build_lr_schedule(param_scheduler, base_lr: float) -> Callable[[int], float]:
    """Compose the (list of) scheduler configs into ``step -> lr``; the
    update at step 0 gets the base lr.  Computed in float32, as the JAX
    package's traced schedule is."""
    if param_scheduler is None:
        return lambda step: base_lr
    cfgs = [dict(c) for c in (param_scheduler if isinstance(
        param_scheduler, (list, tuple)) else [param_scheduler])]
    f32 = np.float32

    def lr_at(step: int) -> float:
        step = f32(step)
        lr = f32(base_lr)
        for cfg in cfgs:
            stype = cfg.get('type', 'PolyLR')
            begin = cfg.get('begin', 0)
            end = cfg.get('end', None)
            span = None if end is None else f32(max(end - begin, 1))
            if stype in ('PolyLR', 'PolyLRRatio'):
                if end is None or end <= begin:
                    continue
                power = f32(cfg.get('power', 1.0))
                eta_min = f32(cfg.get('eta_min', 0.0))
                if stype == 'PolyLRRatio' and cfg.get('eta_min_ratio') is not None:
                    eta_min = lr * f32(cfg['eta_min_ratio'])
                t = min(max(step - f32(begin), f32(0)), span)
                lr = (lr - eta_min) * (f32(1) - t / span) ** power + eta_min
            elif stype == 'LinearLR':
                if end is None or end <= begin:
                    continue
                start = f32(cfg.get('start_factor', 1.0 / 3))
                stop = f32(cfg.get('end_factor', 1.0))
                t = min(max(step - f32(begin), f32(0)), span)
                if step >= begin:
                    lr = lr * (start + (stop - start) * t / span)
            elif stype == 'ConstantLR':
                if step >= begin and (end is None or step < end):
                    lr = lr * f32(cfg.get('factor', 1.0))
            elif stype == 'MultiStepLR':
                count = sum(step >= m for m in cfg.get('milestones', []))
                lr = lr * f32(cfg.get('gamma', 0.1)) ** f32(count)
            else:
                raise ValueError(f'Unsupported scheduler: {stype}')
        return float(lr)

    return lr_at


# ---- paramwise rules -------------------------------------------------------
def _layer_id(path: str, num_layers: int, decay_type: str) -> int:
    """Layer binning of layer-wise lr decay: patch embed / stem -> 0, block i
    -> i + 1, everything else -> num_layers + 1."""
    if 'patch_embed' in path or 'stem' in path or 'pos_embed' in path \
            or 'cls_token' in path:
        return 0
    m = re.search(r'(?:^|\.)b(\d+)_', path) or \
        re.search(r'(?:^|\.)(?:blocks?|layers?)[._/]?(\d+)', path) or \
        re.search(r's(\d+)_b(\d+)', path)
    if m:
        idx = int(m.group(m.lastindex))
        if decay_type == 'stage_wise':
            return idx + 1
        return min(idx + 1, num_layers)
    return num_layers + 1


def _is_norm_path(s: str) -> bool:
    s = '.' + s  # so a top-level 'bn.*' module matches '.bn.' too
    return any(t in s for t in ('.bn.', '.norm', '.gn.', '.ln.',
                                'batchnorm', 'layernorm'))


def _is_bias_path(s: str) -> bool:
    return s.endswith('.bias') or s.endswith('.b')


def _dwconv_prefixes(model: nn.Module) -> set:
    """Names of the depthwise convs: ``groups == in_channels``."""
    return {name.lower() for name, m in model.named_modules()
            if isinstance(m, nn.Conv2d) and m.groups == m.in_channels}


def param_multipliers(model: nn.Module, paramwise_cfg: Optional[Dict]
                      ) -> Dict[str, Tuple[float, float]]:
    """``{parameter name: (lr_mult, decay_mult)}`` under the paramwise rules.

    - decay: the longest matching ``custom_keys`` entry wins (its
      ``decay_mult`` defaulting to 1), unless ``force_default_settings``, in
      which case the default rules override it where they apply; the
      default rules in order: norm -> bias -> depthwise conv -> flat (1-D).
    - lr: ``custom_keys`` ``lr_mult`` (longest match), ``bias_lr_mult`` for
      non-norm biases when no key matched (or under
      ``force_default_settings``), times the layer-wise decay
      ``decay_rate ** (num_layers + 1 - layer_id)`` when ``decay_rate`` is
      set or the constructor is ``LearningRateDecayOptimizerConstructor``.
    """
    cfg = dict(paramwise_cfg or {})
    custom = {k: dict(v) for k, v in (cfg.get('custom_keys') or {}).items()}
    custom_order = sorted(custom, key=len, reverse=True)
    norm_mult = cfg.get('norm_decay_mult')
    bias_mult = cfg.get('bias_decay_mult')
    dw_mult = cfg.get('dwconv_decay_mult')
    flat_mult = cfg.get('flat_decay_mult')
    bias_lr_mult = cfg.get('bias_lr_mult')
    force = bool(cfg.get('force_default_settings', False))
    layer_decay = cfg.get('constructor') == \
        'LearningRateDecayOptimizerConstructor' or 'decay_rate' in cfg
    decay_rate = cfg.get('decay_rate', 0.9)
    num_layers = cfg.get('num_layers', 12)
    decay_type = cfg.get('decay_type', 'layer_wise')
    dw_prefixes = _dwconv_prefixes(model)

    out = {}
    for name, p in model.named_parameters():
        s = name.lower()
        hit = next((custom[k] for k in custom_order if k.lower() in s), None)
        decay = float(hit.get('decay_mult', 1.0)) if hit is not None else None
        lr = float(hit.get('lr_mult', 1.0)) if hit is not None else 1.0
        if hit is None or force:
            # the None-ness of each mult is part of its elif condition, so a
            # norm bias falls through to the bias rule when norm_decay_mult
            # is unset
            if _is_norm_path(s) and norm_mult is not None:
                decay = float(norm_mult)
            elif _is_bias_path(s) and bias_mult is not None:
                decay = float(bias_mult)
            elif s.rsplit('.', 1)[0] in dw_prefixes and dw_mult is not None:
                decay = float(dw_mult)
            elif p.dim() == 1 and flat_mult is not None:
                decay = float(flat_mult)
            if bias_lr_mult is not None and _is_bias_path(s) \
                    and not _is_norm_path(s):
                lr = float(bias_lr_mult)
        if layer_decay:
            lr *= decay_rate ** (num_layers + 1 -
                                 _layer_id(s, num_layers, decay_type))
        out[name] = (lr, 1.0 if decay is None else decay)
    return out


# ---- optimizer -------------------------------------------------------------
class OptimWrapper:
    """A ``torch.optim`` optimizer with the JAX chain's per-step lr and
    gradient clipping.  Each param group carries ``lr_mult``; :meth:`step`
    clips the gradients (``clip_grad``: ``max_norm`` by their global norm as
    ``optax.clip_by_global_norm`` does, or ``clip_value`` elementwise), sets
    every group's lr to ``lr * lr_mult`` and steps."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 clip_grad: Optional[Dict] = None):
        self.optimizer = optimizer
        self.clip_grad = dict(clip_grad) if clip_grad else None

    @property
    def param_groups(self) -> List[Dict]:
        return self.optimizer.param_groups

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, lr: float) -> torch.Tensor:
        """One update at ``lr``; returns the global norm of the gradients
        before clipping.  A parameter that the loss does not reach (SEAM's
        ``conv_1``, behind a binarization) gets a zero gradient, so that it
        decays and keeps its momentum as under optax, where every parameter
        has a gradient; ``torch.optim`` would skip it."""
        params = [p for g in self.param_groups for p in g['params']]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if self.clip_grad and 'max_norm' in self.clip_grad:
            max_norm = self.clip_grad['max_norm']
            torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                                   max_norm / norm))
        elif self.clip_grad and 'clip_value' in self.clip_grad:
            v = self.clip_grad['clip_value']
            torch._foreach_clamp_min_(grads, -v)
            torch._foreach_clamp_max_(grads, v)
        for group in self.param_groups:
            group['lr'] = lr * group['lr_mult']
        self.optimizer.step()
        return norm


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def build_optimizer(model: nn.Module, optim_wrapper: Dict, param_scheduler=None
                    ) -> Tuple[OptimWrapper, Callable[[int], float]]:
    """``(optimizer, lr_schedule)`` from an mmseg ``optim_wrapper`` config
    (``optimizer``, ``clip_grad``, ``paramwise_cfg``, ``constructor``) and
    ``param_scheduler``."""
    ow = dict(optim_wrapper or {})
    opt_cfg = dict(ow.get('optimizer', dict(type='SGD', lr=0.01)))
    otype = opt_cfg.pop('type', 'SGD')
    lr = opt_cfg.pop('lr', 0.01)
    schedule = build_lr_schedule(param_scheduler, lr)
    paramwise = dict(ow.get('paramwise_cfg') or {})
    if ow.get('constructor'):
        paramwise['constructor'] = ow['constructor']
    if otype == 'SGD':
        wd = opt_cfg.pop('weight_decay', 0.0)
        momentum = opt_cfg.pop('momentum', 0.0)
        # as in optax, nesterov only shapes a momentum trace
        kwargs = dict(momentum=momentum,
                      nesterov=bool(opt_cfg.pop('nesterov', False) and momentum))
        make = torch.optim.SGD
    elif otype in ('Adam', 'AdamW'):
        wd = opt_cfg.pop('weight_decay', 0.01 if otype == 'AdamW' else 0.0)
        kwargs = dict(betas=tuple(opt_cfg.pop('betas', (0.9, 0.999))),
                      eps=opt_cfg.pop('eps', 1e-8))
        make = torch.optim.AdamW
    else:
        raise ValueError(f'Unsupported optimizer: {otype}')

    mults = param_multipliers(model, paramwise)
    groups: Dict[Tuple[float, float], List[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        groups.setdefault(mults[name], []).append(p)
    param_groups = [dict(params=ps, lr=lr * lr_mult, lr_mult=lr_mult,
                         weight_decay=wd * decay_mult)
                    for (lr_mult, decay_mult), ps in groups.items()]
    optimizer = make(param_groups, lr=lr, weight_decay=wd, **kwargs)
    return OptimWrapper(optimizer, ow.get('clip_grad')), schedule
