"""Core NN bricks: PReLU, BatchNorm, LayerNorm2d, Norm2d, ConvModule,
BasicBlock, Bottleneck, ResBottleneck, DropPath.

Counterpart of ``lednet_tpu/models/layers.py``.  Modules here take and return
NCHW tensors (torch's layout); submodule and parameter names follow the flax
module tree (``conv``, ``norm.bn``, ``act.alpha``), so that
:mod:`lednet_tpu_torch.convert` maps a flax checkpoint onto them by name.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.ops.kernels.sesp_pyramid import bn_fold


class PReLU(nn.Module):
    """Per-channel PReLU, ``where(x >= 0, x, alpha * x)``."""

    def __init__(self, num_parameters: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_parameters,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.view(1, -1, 1, 1) * x)


def build_activation(act_cfg: Optional[Dict]) -> nn.Module:
    """mmcv ``build_activation_layer`` for the activations the port's
    configs use: ReLU, ReLU6 (MobileNetV2's inverted residual), Sigmoid
    (LR-ASPP's gate) and GELU (exact, erf); ``act_cfg=None`` means
    identity."""
    if act_cfg is None:
        return nn.Identity()
    if act_cfg['type'] == 'ReLU':
        return nn.ReLU()
    if act_cfg['type'] == 'ReLU6':
        return nn.ReLU6()
    if act_cfg['type'] == 'Sigmoid':
        return nn.Sigmoid()
    if act_cfg['type'] == 'GELU':
        return nn.GELU()
    raise ValueError(f"Unsupported activation in the port: {act_cfg['type']}")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d.  torch updates ``running_var`` with the unbiased batch
    variance, which is the semantics ``lednet_tpu``'s own BatchNorm exists to
    reproduce; eval mode normalizes with the running stats.

    With one value per channel in training (a global pool's map at batch 1:
    DAPPM's last branch, BiSeNetV1's attention) torch refuses; the JAX
    package normalizes it to the bias and updates the running variance with
    the variance 0 (its Bessel factor is ``n / max(n - 1, 1)``), and so does
    this module.  A bfloat16 map is normalized in float32 and the result
    cast back, as in the JAX package."""

    def forward(self, x):
        one = self.training and x.numel() == x.shape[1]
        low = x.dtype in (torch.bfloat16, torch.float16)
        if not (one or low):
            return super().forward(x)
        # a bfloat16 map (the bf16 train step, whose weights are bfloat16
        # too) is normalized in float32 and cast back, as the JAX package's
        # BatchNorm does; the running stats stay float32
        xf = x.float() if low else x
        weight, bias = self.weight.to(xf.dtype), self.bias.to(xf.dtype)
        if not one:
            if self.training:
                self.num_batches_tracked += 1
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                weight, bias, self.training, self.momentum,
                                self.eps).to(x.dtype)
        mean = xf.mean((0, 2, 3))
        var = (xf - mean.view(1, -1, 1, 1)).square().mean((0, 2, 3))
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach().to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.detach().to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked += 1
        scale = weight * torch.rsqrt(var + self.eps)
        return ((xf - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
                + bias.view(1, -1, 1, 1)).to(x.dtype)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (flax ``nn.LayerNorm`` on
    the last axis of NHWC)."""

    def forward(self, x):
        return F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                            self.weight, self.bias, self.eps).permute(0, 3, 1, 2)


class Norm2d(nn.Module):
    """Normalization selected by an mmseg ``norm_cfg``, named as in the
    JAX package: ``bn`` (``BN``, ``BN2d``; ``SyncBN`` is BatchNorm on one
    card), ``gn`` (``GN``: ``num_groups``, 32 by default, halved until it
    divides the channels, as ``lednet_tpu/models/layers.py:147-153`` does)
    or ``ln`` (``LN``: over the channels)."""

    def __init__(self, norm_cfg: Optional[Dict], channels: int):
        super().__init__()
        cfg = norm_cfg or dict(type='BN')
        norm_type = cfg.get('type', 'BN')
        eps = cfg.get('eps', 1e-5)
        if norm_type in ('BN', 'SyncBN', 'BN2d'):
            self.kind = 'bn'
            self.bn = BatchNorm(channels, eps=eps,
                                momentum=cfg.get('momentum', 0.1))
        elif norm_type == 'GN':
            groups = cfg.get('num_groups', 32)
            while channels % groups:
                groups //= 2
            self.kind = 'gn'
            self.gn = nn.GroupNorm(max(groups, 1), channels, eps=eps)
        elif norm_type == 'LN':
            self.kind = 'ln'
            self.ln = LayerNorm2d(channels, eps=eps)
        else:
            raise ValueError(f'Unsupported norm type in the port: {norm_type}')

    def forward(self, x):
        return getattr(self, self.kind)(x)


class ConvModule(nn.Module):
    """conv + norm + act with a configurable ``order``.  ``bias='auto'``
    gives the conv a bias only without a norm (mmcv's rule); a bool sets it.
    A norm before the conv (the pre-activation order) normalizes the input
    width.  ``groups`` splits the conv's channels into groups (PAPPM's
    per-scale convs, STDC's depthwise downsampling)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: Union[bool, str] = 'auto',
                 norm_cfg: Optional[Dict] = None, act_cfg: Optional[Dict] = None,
                 order: Tuple[str, ...] = ('conv', 'norm', 'act')):
        super().__init__()
        self.order = tuple(order)
        use_bias = bias if isinstance(bias, bool) else norm_cfg is None
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding, dilation, groups, bias=use_bias)
        norm_after_conv = self.order.index('norm') > self.order.index('conv')
        self.norm = (Norm2d(norm_cfg, out_channels if norm_after_conv
                            else in_channels) if norm_cfg is not None else None)
        self.act = build_activation(act_cfg)

    def forward(self, x):
        for layer in self.order:
            if layer == 'conv':
                x = self.conv(x)
            elif layer == 'norm' and self.norm is not None:
                x = self.norm(x)
            elif layer == 'act':
                x = self.act(x)
        return x


class BasicBlock(nn.Module):
    """ResNet basic block; ``dilation`` dilates the first conv (ResNet's
    ``_ResBasicBlock``, ``lednet_tpu/models/backbones/resnet.py:22``)."""
    expansion = 1

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 downsample: bool = False, norm_cfg: Optional[Dict] = None,
                 act_out: bool = True, dilation: int = 1):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.act_out = act_out
        self.conv1 = ConvModule(in_channels, channels, 3, stride=stride,
                                padding=dilation, dilation=dilation,
                                norm_cfg=norm_cfg, act_cfg=dict(type='ReLU'))
        self.conv2 = ConvModule(channels, channels, 3, padding=1,
                                norm_cfg=norm_cfg, act_cfg=None)
        if downsample:
            self.downsample_conv = nn.Conv2d(in_channels, channels, 1,
                                             stride, bias=False)
            self.downsample_norm = Norm2d(norm_cfg, channels)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        out = out + x
        return F.relu(out) if self.act_out else out


class Bottleneck(nn.Module):
    """ResNet bottleneck block of expansion 2 (DDRNet's): 1x1, 3x3 with the
    stride and ``dilation``, 1x1 to ``expansion * channels``; no output ReLU
    unless ``act_out``.  Counterpart of ``lednet_tpu/models/layers.py:243``."""
    expansion = 2

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 downsample: bool = False, norm_cfg: Optional[Dict] = None,
                 act_out: bool = False, dilation: int = 1):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        relu = dict(type='ReLU')
        out_channels = channels * self.expansion
        self.act_out = act_out
        self.conv1 = ConvModule(in_channels, channels, 1, norm_cfg=norm_cfg,
                                act_cfg=relu)
        self.conv2 = ConvModule(channels, channels, 3, stride=stride,
                                padding=dilation, dilation=dilation,
                                norm_cfg=norm_cfg, act_cfg=relu)
        self.conv3 = ConvModule(channels, out_channels, 1, norm_cfg=norm_cfg,
                                act_cfg=None)
        if downsample:
            self.downsample_conv = nn.Conv2d(in_channels, out_channels, 1,
                                             stride, bias=False)
            self.downsample_norm = Norm2d(norm_cfg, out_channels)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        out = out + x
        return F.relu(out) if self.act_out else out


class ResBottleneck(Bottleneck):
    """ResNet's bottleneck: expansion 4 and the output ReLU (ResNet's
    ``_ResBottleneck``, ``lednet_tpu/models/backbones/resnet.py:62``, and
    HRNet's stage 1, ``lednet_tpu/models/backbones/hrnet.py:89``)."""
    expansion = 4

    def __init__(self, *args, **kwargs):
        super().__init__(*args, act_out=True, **kwargs)


def drop_path_rates(drop_path_rate: float, depths) -> list:
    """Per-block stochastic-depth rates, linear over the total depth
    (``lednet_tpu/models/layers.py:277``)."""
    total = sum(depths)
    return [drop_path_rate * i / max(total - 1, 1) for i in range(total)]


class DropPath(nn.Module):
    """Per-sample stochastic depth: in training, each sample's branch is
    kept with probability 1 - ``rate`` and scaled by 1 / (1 - ``rate``),
    else zeroed; the identity in eval or at rate 0.  The mask is drawn from
    torch's default generator of the input's device, as ``nn.Dropout``
    draws its own, so one seed governs both."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1),
                           dtype=x.dtype, device=x.device).bernoulli_(keep)
        return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention of (B, heads, N, d) ``q`` and (B, heads, M, d)
    ``k`` / ``v``: scores at scale ``d ** -0.5`` (plus the additive
    ``bias``) through a softmax at float32 or wider, then the values.
    Plain matmuls and a softmax, as the JAX package computes attention
    outside any Pallas kernel (the ViT, the CLIP text tower, SAN's
    blocks)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-2, -1)) * \
        q.shape[-1] ** -0.5
    if bias is not None:
        scores = scores + bias
    return torch.matmul(scores.softmax(-1).to(v.dtype), v)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, heads, N, C // heads), the channels head-major."""
    B, N, C = x.shape
    return x.view(B, N, heads, C // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, N, d) -> (B, N, heads * d)."""
    B, h, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, h * d)


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm of a module as a per-channel (scale, bias) pair."""
    return bn_fold(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


def fold_conv_bn(conv: nn.Conv2d, norm: Norm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bias-free conv followed by eval BatchNorm as one conv: (weight, bias)."""
    scale, bias = fold_bn(norm.bn)
    return conv.weight * scale.view(-1, 1, 1, 1), bias


def cached_operands(module: nn.Module, sources: Sequence[torch.Tensor],
                    build: Callable[[], tuple]) -> tuple:
    """``build()``, computed once and kept on ``module`` until a tensor of
    ``sources`` changes.  The key is each source's ``_version``,
    ``data_ptr()`` and device, so an in-place edit, ``load_state_dict``,
    ``.to()`` or a copied module all rebuild.  Built without autograd and
    outside inference mode; a plain attribute, so not in ``state_dict()``."""
    key = tuple((t._version, t.data_ptr(), t.device) for t in sources)
    hit = module.__dict__.get('_operand_cache')
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.inference_mode(False), torch.no_grad():
        value = build()
    module._operand_cache = (key, value)
    return value


def module_tensors(*modules: nn.Module):
    """Every parameter and buffer of ``modules``."""
    return [t for m in modules for t in (*m.parameters(), *m.buffers())]


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=generator) * std)


def _truncated_normal_(t: torch.Tensor, std: float,
                       generator: torch.Generator) -> None:
    """A standard normal truncated to (-2, 2), by its inverse CDF, times
    ``std``."""
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(t.shape, generator=generator,
                                    dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    t.copy_(z.clamp(-2.0, 2.0) * std)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation matching the JAX package's initialisers: conv
    kernels kaiming-normal (fan_out, relu gain), conv biases 0, BatchNorm,
    GroupNorm and LayerNorm scale 1 / bias 0, BatchNorm running mean 0 /
    var 1, PReLU 0.25, MSCAN's ``layer_scale_{1,2}`` 1e-2,
    relative-position tables normal(0.02) clipped at two standard
    deviations, transposed-conv kernels LeCun normal (variance 1 / fan_in,
    flax's default for UNet's ``DeconvModule``) or, where the module sets
    ``init_gain = 2.0`` (ERFNet's ``UpsamplerBlock``), kaiming-normal over
    the same fan, linear kernels LeCun normal and biases 0 (flax's
    ``Dense``, CGNet's context gate), conv kernels LeCun normal where the
    conv sets ``lecun_init`` (a bare flax ``nn.Conv`` with flax's default
    initialiser: RTFormer's ``cross_kv`` and ``ConvFFN.conv2``, DSNet's
    ``_SegHead.conv2``), and a module's raw parameters by its
    ``raw_init`` table, name -> (kind, std): ``'truncated_normal'`` draws
    a standard normal truncated to (-2, 2) times std (flax's
    ``truncated_normal``: SCTNet's ``kv`` / ``kv3``, std 0.001; Swin's
    ``s{i}_b{j}_rel_bias`` tables, 0.02; MaskFormer's ``query_embed``,
    0.02), ``'normal'`` a normal of that std
    (RTFormer's ``k`` / ``v``, 0.02; Mask2Former's ``level_embed``,
    1.0), ``'zeros'`` zeros (K-Net's ``seg_bias``, the deformable
    attention's ``sampling_offsets`` weight), and 1-D conv kernels (PointHead's
    MLP, flax ``nn.Conv``) LeCun normal.
    Every parameter is
    overwritten, so the result depends on ``generator`` alone; a parameter of
    no known kind raises."""
    done = set()
    for mod in module.modules():
        raw = getattr(mod, 'raw_init', {})
        for name, p in mod.named_parameters(recurse=False):
            if name in raw:
                kind, std = raw[name]
                if kind == 'truncated_normal':
                    _truncated_normal_(p, std, generator)
                elif kind == 'normal':
                    _normal_(p, std, generator)
                elif kind == 'zeros':
                    p.zero_()
                else:
                    raise ValueError(f'unknown raw_init kind {kind!r}')
            elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d,
                                  nn.Linear)) and name == 'bias':
                p.zero_()
            elif isinstance(mod, nn.Conv1d):              # (out, in, k)
                _normal_(p, math.sqrt(1.0 / (p.shape[1] * p.shape[2])),
                         generator)
            elif isinstance(mod, nn.ConvTranspose2d):     # (in, out, k, k)
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                gain = getattr(mod, 'init_gain', 1.0)
                _normal_(p, math.sqrt(gain / fan_in), generator)
            elif isinstance(mod, nn.Linear):              # (out, in)
                _normal_(p, math.sqrt(1.0 / p.shape[1]), generator)
            elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
                p.fill_(1.0 if name == 'weight' else 0.0)
            elif isinstance(mod, PReLU):
                p.fill_(0.25)
            elif name in ('layer_scale_1', 'layer_scale_2'):
                p.fill_(1e-2)
            elif name == 'relative_position_bias_table':
                p.copy_(torch.clamp(torch.randn(p.shape, generator=generator),
                                    -2.0, 2.0) * 0.02)
            elif p.dim() == 4 and getattr(mod, 'lecun_init', False):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                _normal_(p, math.sqrt(1.0 / fan_in), generator)
            elif p.dim() == 4:       # conv kernels and raw depthwise kernels
                fan_out = p.shape[0] * p.shape[2] * p.shape[3]
                _normal_(p, math.sqrt(2.0 / fan_out), generator)
            else:
                raise ValueError(f'no initialiser for {type(mod).__name__}.{name}')
            done.add(id(p))
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    missing = [n for n, p in module.named_parameters() if id(p) not in done]
    if missing:
        raise ValueError(f'parameters left uninitialised: {missing}')
