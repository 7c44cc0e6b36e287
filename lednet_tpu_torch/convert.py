"""Weight bridge: flax ``params``/``batch_stats`` -> the port's ``state_dict``.

The port's modules carry the flax module names, so the mapping is by path:

- conv kernels HWIO -> OIHW (``kernel`` -> ``weight``, axes (3, 2, 0, 1)); a
  depthwise kernel (kh, kw, 1, C) becomes (C, 1, kh, kw) the same way, as do
  the raw SESP branch kernels ``spp_dw{i}`` / ``spp_dw_v2_{i}`` (3, 3, 1, n);
- a transposed conv (``deconv``) by the module that holds it: in UNet's
  ``DeconvModule`` (beside ``norm``) flax's ``ConvTranspose`` has
  ``transpose_kernel=True`` and a (k, k, out, in) kernel, the forward
  conv's, whose (3, 2, 0, 1) transpose is ``ConvTranspose2d``'s (in, out,
  k, k), unflipped; in ERFNet's ``UpsamplerBlock`` (beside ``bn``) it keeps
  the default ``transpose_kernel=False`` and a (k, k, in, out) kernel,
  which is ``ConvTranspose2d``'s weight flipped in both spatial axes, so it
  is flipped back and transposed (2, 3, 0, 1); a ``deconv`` in any other
  module raises;
- the 2-D kernels of flax ``Dense`` layers ((in, out)) -> ``nn.Linear``'s
  (out, in) weight, where the module is one: CGNet's context gate
  (``f_glo``'s ``fc1`` / ``fc2``), MiT's ``q`` / ``kv`` / ``proj`` /
  ``fc1`` / ``fc2``, Swin's ``s{i}_b{j}_{qkv,proj,fc1,fc2}`` and
  ``merge{s}``, K-Net's ``dynamic_layer`` / ``input_layer`` /
  ``input_gate`` / ``update_gate`` / ``fc_layer`` / ``attn_{q,k,v,proj}``
  / ``ffn_fc{1,2}`` / ``mask_fc{i}`` / ``fc_mask``, MaskFormer's
  ``{c,s}{q,k,v}`` / ``{c,s}proj`` / ``interm_embed`` / ``cls_embed`` /
  ``mask_mlp{i}`` / ``mask_embed``, the deformable attention's
  ``sampling_offsets`` / ``attention_weights`` / ``value_proj{l}`` /
  ``output_proj``, the ViT's ``b{i}_attn`` (``qkv`` / ``proj``) and
  ``b{i}_fc{1,2}``, the CLIP text and SAN side-adapter blocks' ``q`` /
  ``k`` / ``v`` / ``proj`` / ``fc{1,2}``, SAN's recognition blocks'
  ``b{i}_{q,k,v,proj,fc1,fc2}`` and ``proj``, and its mask decoder's MLPs
  ``{query,pix,attn}_mlp`` (``fc{i}``); any other 2-D kernel raises;
- an ``nn.Embed``'s ``embedding`` (the CLIP text tower's
  ``token_embedding``) -> ``nn.Embedding``'s ``weight``, same layout;
- the 3-D kernels of PointHead's 1-D convs ``fc{i}`` / ``fc_seg`` ((1, in,
  out)) -> ``nn.Conv1d``'s (out, in, 1) weight, axes (2, 1, 0); any other
  3-D kernel raises;
- the raw banks, by an explicit rule: SCTNet's strip banks ``kv`` (7, 1,
  in, 64) and ``kv3`` (1, 7, in, 64) are HWIO kernels of the conv into the
  64 channels, and become its (64, in, kh, kw) weight by the kernel's
  (3, 2, 0, 1) transpose (``ConvolutionalAttention`` runs the conv back
  through ``weight.transpose(0, 1)``); K-Net's ``seg_kernel`` (1, 1, C,
  N) is the 1x1 classifier's (N, C, 1, 1) weight by the same transpose;
  RTFormer's token banks ``k`` (heads, d, m) and ``v`` (heads, m, d) keep
  their layout; a bank of another rank raises;
- BatchNorm ``scale``/``bias`` + ``mean``/``var`` -> ``weight``/``bias`` +
  ``running_mean``/``running_var`` (+ ``num_batches_tracked`` = 0); a
  LayerNorm's or GroupNorm's ``scale`` -> ``weight``;
- PReLU ``alpha``, GETB ``relative_position_bias_table``, MSCAN's
  ``layer_scale_{1,2}``, K-Net's ``seg_bias``, MaskFormer's
  ``query_embed`` (1, Q, D), the deformable decoder's ``level_embed`` (L,
  D), the ViT's ``pos_embed`` / ``cls_token``, the text tower's
  ``positional_embedding`` / ``text_projection`` (in, out) /
  ``bg_embed``, the side adapter's ``pos_embed`` / ``query_embed`` /
  ``query_pos_embed`` and biases keep their names and layouts;
- the segmentor's ``_backbone``/``_neck``/``_decode_head`` (SAN's
  ``_image_encoder`` / ``_text_encoder`` too) lose the leading underscore, its auxiliary heads ``_aux_heads_{i}`` become
  ``aux_heads.{i}``, and a cascade's heads ``_heads_{i}`` become
  ``decode_heads.{i}``;
- the trunk that ``BiSeNetV1``, ``STDCContextPathNet`` and ``ICNet`` build
  inline, which flax names after its class (``ResNet_0``, ``ResNetV1c_0``,
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
``DeconvModule``'s ``deconv`` / ``norm``), ICNet's ``sub1_conv{1,2,3}`` /
``conv_sub2`` / ``ppm{i}`` / ``psp_bottleneck`` / ``conv_sub4`` and
ICNeck's ``cff_{24,12}`` (``conv_low`` / ``conv_high``), Fast-SCNN's
``ltd_conv`` / ``ltd_sep{1,2}`` (``dw`` / ``pw``) / ``gfe{i}_{j}``
(``expand`` / ``dw`` / ``project``) / ``ppm`` (``pool{s}``) / ``gfe_out`` /
``ffm_{dw,low,high}`` and its separable head's ``conv{i}`` (``dw`` /
``pw``), ERFNet's ``down{i}`` (``conv`` / ``bn``) / ``enc{1,2}_{i}`` /
``dec{s}_{i}`` (``conv3x1_{1,2}`` / ``conv1x3_{1,2}`` / ``bn{1,2}``) /
``up{s}`` (``deconv`` / ``bn``), CGNet's ``stem{i}`` / ``stem_norm{i}`` /
``stem_act{i}`` / ``norm_prelu_{i}`` / ``act_prelu_{i}`` / ``level{1,2}_{i}``
(``conv1x1`` / ``norm1`` / ``act1`` / ``f_loc`` / ``f_sur`` / ``bn`` /
``act2`` / ``reduce`` / ``f_glo``), MobileNetV3's ``stem_conv`` /
``stem_norm`` / ``b{i}_{expand,dw,se,project}`` (the SE block's ``fc1`` /
``fc2``) / ``final_conv``, and LRASPPHead's ``aspp_conv`` / ``image_pool``
/ ``conv_up_input`` / ``convs{i}`` / ``conv_up{i}`` / ``cls``, SCTNet's
``stem{1,2}`` / ``layer{s}_{i}`` (``conv1`` / ``conv2`` / ``down``) /
``layer3_2`` / ``convdown4`` / ``layer{4,5}`` (``CFBlock``: ``attn`` with
``norm``, ``kv``, ``kv3``; ``mlp_norm`` / ``mlp_conv{1,2}``) / ``spp`` and
SCTHead's ``conv1`` / ``bn2`` / ``cls``, RTFormer's ``stem{1,2}`` /
``layer{1,2,3}_{i}`` / ``layer3h_0`` / ``compression3`` / ``down3`` /
``block{4,5}`` (``down`` / ``low_attn`` with ``pre_norm``, ``k``, ``v`` /
``low_ffn`` and ``high_ffn`` with ``pre_norm`` / ``conv1`` / ``conv2`` /
``high_attn`` with ``pre_norm`` / ``cross_kv`` / ``compression``) /
``spp``, PSPHead's ``ppm{scale}`` / ``bottleneck`` / ``cls``, ASPPHead's
``image_pool`` / ``aspp{i}`` (``dw`` / ``pw`` where separable) /
``bottleneck`` / ``c1_bottleneck`` / ``sep{1,2}`` / ``cls``, and DSNet's
``conv1a`` / ``conv1b`` / ``layer1_{i}`` / ``layer1_a`` / ``layer2_{i}`` /
``layer{3,4}_{i}`` (``MFACB``: ``conv{i}`` / ``process{1,2}``) /
``layer{3,4}__{i}`` / ``compression{3,4,5}`` / ``aff{1,2,3}`` /
``layer5_`` / ``layer5`` / ``spp`` (``SPASPP``: ``conv{i}`` /
``pooling`` / ``process{1,2,3}``) / ``up8`` / ``lastlayer`` /
``seghead_{p,d}`` (``conv1`` / ``conv2``), OCRHead's ``bottleneck`` /
``object_context`` (``{query,key,value,out}_project{i}``) / ``project`` /
``cls``, PointHead's ``fc{i}`` / ``fc_seg``, MiT's ``patch_embed{i}`` /
``embed_norm{i}`` / ``s{i}_b{j}_{norm1,attn,norm2,ffn}`` (``q`` / ``sr`` /
``sr_norm`` / ``kv`` / ``proj``; ``fc1`` / ``dw`` / ``fc2``) /
``stage_norm{i}``, SegformerHead's ``conv{i}`` / ``fusion_conv`` / ``cls``,
Swin's ``patch_embed`` / ``patch_norm`` / ``s{s}_b{b}_{norm1,qkv,proj,
norm2,fc1,fc2}`` and its ``s{s}_b{b}_rel_bias`` table / ``out_norm{s}`` /
``merge_norm{s}`` / ``merge{s}``, and UPerHead's ``ppm{s}`` /
``psp_bottleneck`` / ``lateral{i}`` / ``fpn{i}`` / ``fpn_bottleneck`` /
``cls``, IterativeDecodeHead's ``conv{i}`` / ``kernel_update_head{s}``
(``kernel_update_conv`` with its ``*_norm*`` LayerNorms, ``attention_norm``,
``ffn_norm``, ``mask_norm{i}``), MaskFormerHead's ``lateral{i}`` /
``fpn{i}`` / ``mask_feat`` / ``dec{l}`` (``norm_{cross,self,ffn}``) /
``dec_norm`` and its ``pixel_decoder`` (``input_proj{i}`` / ``enc{l}``
with ``attn``, ``norm{1,2}`` / ``lateral`` / ``mask_feat``), the ViT's
``patch_embed`` / ``pre_ln`` / ``b{i}_norm{1,2}`` / ``final_norm``, the
text tower's ``block{i}`` (``ln_1`` / ``ln_2``) / ``ln_final``, and SAN's
``side_adapter_network`` (``patch_embed`` / ``clip_ln{i}`` /
``clip_proj{i}`` / ``layer{i}`` / ``mask_decoder``) and
``rec_with_attnbias`` (``b{i}_ln{1,2}`` / ``ln_post``); a norm's
module is ``bn``, ``gn`` or ``ln`` by its type.  Any other automatic flax name (``ClassName_{n}``)
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
_CASCADE_HEAD = re.compile(r'heads_(\d+)')


def _module_path(path: Tuple[str, ...]) -> List[str]:
    """The port's names of a flax module path (see the module docstring)."""
    out = []
    for part in (p.lstrip('_') for p in path):
        aux = _AUX_HEAD.fullmatch(part)
        cascade = _CASCADE_HEAD.fullmatch(part)
        if aux:
            out += ['aux_heads', aux.group(1)]
        elif cascade:
            out += ['decode_heads', cascade.group(1)]
        elif _TRUNK.fullmatch(part):
            out.append('backbone')
        elif _AUTO_NAME.fullmatch(part):
            raise ValueError(f'no port module for the flax name {part!r} in '
                             f'{"/".join(path)}')
        else:
            out.append(part)
    return out


# modules whose 2-D kernels are Dense's: by the module's own name, or,
# for CGNet's gate, by the module that holds it
_DENSE = re.compile(
    r'q|kv|proj|fc[12]|s\d+_b\d+_(qkv|proj|fc[12])|merge\d+'
    # K-Net's kernel update heads
    r'|dynamic_layer|input_layer|input_gate|update_gate|fc_layer|attn_[qkv]'
    r'|attn_proj|ffn_fc[12]|mask_fc\d+|fc_mask'
    # MaskFormer's decoder and outputs, the deformable attention
    r'|[cs][qkv]|[cs]proj|interm_embed|cls_embed|mask_mlp\d+|mask_embed'
    r'|sampling_offsets|attention_weights|value_proj\d+|output_proj'
    # SAN: the ViT's fused ``qkv`` and its blocks' ``b{i}_fc{1,2}``, the
    # split ``q`` / ``k`` / ``v`` of the text, side-adapter and
    # recognition blocks (``b{i}_*`` in the last), the mask decoder's MLPs
    r'|qkv|[kv]|b\d+_([qkv]|proj|fc[12])|fc\d+')
_DENSE_MODULES = ('f_glo',)
_CONV1D = re.compile(r'fc\d+|fc_seg')    # PointHead's 1-D convs
# raw parameter banks: name -> (rank, axes to the port's layout or None)
_RAW_BANKS = {'kv': (4, (3, 2, 0, 1)), 'kv3': (4, (3, 2, 0, 1)),
              'k': (3, None), 'v': (3, None), 'seg_kernel': (4, (3, 2, 0, 1))}


def _param_entry(path: Tuple[str, ...], value: np.ndarray,
                 siblings: frozenset) -> Tuple[str, np.ndarray]:
    """The port's name and value of the flax leaf at ``path``; ``siblings``
    are the names of the modules beside the leaf's own (its parent's
    children, :func:`_children`), which tell a transposed conv's module."""
    mods, leaf = _module_path(path[:-1]), path[-1]
    where = '/'.join(path)
    if leaf == 'kernel' and path[-2] == 'deconv':
        if value.ndim == 4 and 'norm' in siblings:        # UNet's DeconvModule
            value = np.transpose(value, (3, 2, 0, 1))
        elif value.ndim == 4 and siblings == {'deconv', 'bn'}:   # UpsamplerBlock
            value = np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        else:
            raise ValueError(f'no port module for the transposed conv at {where}')
        leaf = 'weight'
    elif leaf in _RAW_BANKS:
        rank, axes = _RAW_BANKS[leaf]
        if value.ndim != rank:
            raise ValueError(f'a {value.ndim}-D bank at {where}: the port '
                             f'reads {leaf!r} as {rank}-D')
        value = value if axes is None else np.transpose(value, axes)
    elif leaf == 'kernel' and value.ndim == 4 or leaf.startswith('spp_dw'):
        value = np.transpose(value, (3, 2, 0, 1))
        leaf = 'weight' if leaf == 'kernel' else leaf
    elif leaf == 'kernel' and value.ndim == 2 and (
            _DENSE.fullmatch(path[-2]) or
            len(path) > 2 and path[-3] in _DENSE_MODULES):
        value, leaf = value.T, 'weight'
    elif leaf == 'kernel' and value.ndim == 3 and _CONV1D.fullmatch(path[-2]):
        value, leaf = np.transpose(value, (2, 1, 0)), 'weight'
    elif leaf == 'kernel':
        raise ValueError(f'unexpected {value.ndim}-D kernel at {where}')
    elif leaf in ('scale', 'embedding'):       # a norm's; an ``nn.Embed``'s
        leaf = 'weight'
    return '.'.join(mods + [leaf]), value


def _children(tree: Mapping, path: Tuple[str, ...]) -> frozenset:
    for key in path:
        tree = tree[key]
    return frozenset(tree)


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """Nested flax variable dicts (numpy or jax arrays) -> a ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        name, arr = _param_entry(path, np.asarray(value, np.float32),
                                 _children(params, path[:-2]))
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
