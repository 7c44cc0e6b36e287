"""PyTorch port: the first transformers, SegFormer (``MixVisionTransformer``
and ``SegformerHead``) and UPerNet Swin-T (``SwinTransformer`` and
``UPerHead``), against ``lednet_tpu`` on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- the bricks in eval mode, rel 1e-5 of the largest output: MiT's
  ``EfficientAttention`` with and without spatial reduction (the ``sr``
  conv truncating a remainder), ``MixFFN``, MiT narrow (every LayerNorm at
  eps 1e-6) and ``SegformerHead``; Swin narrow at widths of 3, 2 and 1 mod
  4 (683, 682, 681: flax's 'SAME' patch padding on one side and on both)
  with odd stage sizes (window and merge padding), its patch merging
  against a merge weight with two 2x2 neighbours swapped; ``UPerHead`` on a
  deepest map of 16x16 (6 bins overlap) and of 2x3 (bins outnumber it);
- the SegFormer MiT-B0 and UPerNet Swin-T configs: built unchanged at full
  width, every flax leaf lands on a port key and none is left over; narrow
  copies give logits within 1e-4 x max|logit|, argmax agreement >= 99.9%,
  the CPU eval step equal to ``predict``;
- one AdamW train step of each narrow config (dropout and drop path 0;
  SegFormer at state step 2000, past its LinearLR warm-up; Swin with its
  auxiliary FCN head): loss within 1e-5; each weight's update within
  1e-6 of JAX's where its gradient is above 1e-3 of the largest, within
  2 lr elsewhere (AdamW's first step moves a weight by about +-lr on the
  sign of its gradient, which below that is float32 rounding); the
  BatchNorm running stats within atol 1e-5 / rtol 1e-4;
- ``convert.py``'s Dense kernels of MiT and Swin, and ``init_weights``'
  draws for the new leaves (LeCun normal Dense and flax-default convs,
  kaiming patch embeds, truncated normal bias tables).

torch runs on one thread in every test here (``one_thread``).  A JAX
reference that runs once runs op by op, without ``jax.jit``; the train
steps are the JAX package's jitted step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lednet_tpu.config import Config as JConfig
from lednet_tpu.engine import optim as joptim
from lednet_tpu.engine.state import TrainState as JTrainState
from lednet_tpu.engine.state import make_train_step as jmake_train_step
from lednet_tpu.registry import MODELS as JMODELS
import lednet_tpu_torch.models  # noqa: F401  (registers the port's modules)
from lednet_tpu_torch.apis import init_model
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import flax_to_state_dict
from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                     make_eval_step, make_train_step)
from lednet_tpu_torch.registry import MODELS
from test_torch_port_common import (REPO, jax_variables, load_port, nchw,
                                    nhwc, random_variables, rel_err)
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_bisenetv2_hrnet import _pair
from test_torch_port_sct_rtformer_psp import _full_width_leaves
from test_torch_port_zoo import _apply, _hold, _normal, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

CONFIGS = {'segformer': f'{REPO}/configs/segformer/'
                        'segformer_mit-b0_cityscapes-1024x1024.py',
           'swin': f'{REPO}/configs/swin/upernet_swin-t_ade20k-512x512.py'}
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


# narrow copies: MiT at embed_dims 8 (stages 8, 16, 40, 64), Swin at 16
# (16, 32, 64, 128) with (1, 2, 2, 4) heads, the heads at 16 channels
NARROW_MIT = dict(embed_dims=8, num_heads=[1, 2, 5, 8], num_layers=[2, 2, 2, 2])
NARROW_SWIN = dict(embed_dims=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
NARROW = {
    'segformer': {**{f'model.backbone.{k}': v for k, v in NARROW_MIT.items()},
                  'model.decode_head.in_channels': [8, 16, 40, 64],
                  'model.decode_head.channels': 16},
    'swin': {**{f'model.backbone.{k}': v for k, v in NARROW_SWIN.items()},
             'model.decode_head.in_channels': [16, 32, 64, 128],
             'model.decode_head.channels': 16,
             'model.auxiliary_head.in_channels': 64,
             'model.auxiliary_head.channels': 8}}


def _configs(name, extra=None, classes=None):
    """The (JAX, port) configs of ``name``, narrow, with ``extra`` merged
    and the heads cut to ``classes``."""
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(CONFIGS[name])
        more = dict(NARROW[name], **dict(extra or {}))
        if classes is not None:
            more['model.decode_head.num_classes'] = classes
            if cfg.model.get('auxiliary_head'):
                more['model.auxiliary_head.num_classes'] = classes
        cfg.merge_from_dict(more)
        out.append(cfg)
    return out


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with.
# ------------------------------------------------------------------ training
START = {'segformer': 2000, 'swin': 0}     # past SegFormer's LinearLR warm-up


@pytest.mark.parametrize('name', list(CONFIGS))
def test_train_step_matches_jax(name):
    """One AdamW step of the narrow config in both packages from the same
    weights and batch (4 x 64x64, 3 classes, dropout and drop path 0):
    SegFormer's CE at state step 2000 (at step 0 its lr is 6e-11 and no
    weight moves by float32's resolution), UPerNet Swin's CE on the decode
    head at 1.0 and the auxiliary FCN head at 0.4.  Batch 4: UPerHead's 1x1
    pool is BatchNormed over one value per image."""
    extra = {'model.backbone.drop_path_rate': 0.0,
             'model.decode_head.dropout_ratio': 0.0,
             'model.data_preprocessor.size': (64, 64)}
    if name == 'swin':
        extra['model.auxiliary_head.dropout_ratio'] = 0.0
    jcfg, cfg = _configs(name, extra, classes=3)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    start = START[name]
    rng = np.random.default_rng(120)
    imgs = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    lbl = np.where(rng.random((4, 64, 64)) < 0.05, 255,
                   rng.integers(0, 3, (4, 64, 64))).astype(np.int32)
    params, stats = loss_variables(jmodel, (1, 64, 64), n_classes=3, seed=121)
    # a copy: the JAX step donates its state, whose buffers may alias the
    # numpy arrays that flax_to_state_dict's tensors share
    before = {k: v.clone() for k, v in flax_to_state_dict(params, stats).items()}
    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    step = make_train_step(model, opt, model.data_preprocessor)
    state = dataclasses.replace(create_train_state(model, opt, sched), step=start)
    tstate, logs = step(state, torch.from_numpy(imgs),
                        torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == start + 1 and model.training

    tx, jsched = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    assert float(jsched(start)) == pytest.approx(sched(start), rel=1e-6)
    jvars = jax_variables(params, stats)
    # optax reads the lr at its own count, not at the state's step: start
    # the schedule's count there too (Adam's stays 0, as torch's AdamW
    # state starts empty: both take a first step)
    opt_state = tuple(
        s._replace(count=jnp.asarray(start, jnp.int32))
        if isinstance(s, optax.ScaleByScheduleState) else s
        for s in tx.init(jvars['params']))
    jstate = JTrainState(step=jnp.asarray(start, jnp.int32),
                         params=jvars['params'], batch_stats=jvars['batch_stats'],
                         opt_state=opt_state)
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))

    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    heads = ('decode', 'aux') if name == 'swin' else ('decode',)
    assert set(logs) - {'loss', 'grad_norm'} == keys == {
        f'{h}.{k}' for h in heads for k in ('loss_ce', 'acc_seg')}
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    # acc_seg is an argmax of logits upsampled 4x (16x for the auxiliary
    # head): a near-tie of one logit decides a block of pixels
    block = 256 * 100.0 / int((lbl != 255).sum())
    for k in keys:
        tol = dict(rel=0, abs=1.01 * block) if k.endswith('acc_seg') \
            else dict(rel=1e-4, abs=1e-5)
        assert logs[k].item() == pytest.approx(float(jlogs[k]), **tol), k
    assert logs['grad_norm'].item() == pytest.approx(float(jlogs['grad_norm']),
                                                     rel=1e-3)
    want = flax_to_state_dict(jax.device_get(jstate.params),
                              jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    grads = {k: p.grad.abs() for k, p in model.named_parameters()}
    scale = max(g.max().item() for g in grads.values())
    lr, moved = sched(start), 0.0
    for k, ref in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        if k.endswith('running_mean') or k.endswith('running_var'):
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(), err_msg=k,
                                       atol=1e-5, rtol=1e-4)
            continue
        # AdamW's first step moves each weight by lr * (g / (|g| + eps) +
        # weight_decay * w): by about +-lr whatever |g|, so the updates
        # are held, not the weights.  Where |g| is above 1e-3 of the
        # largest gradient, far above either package's float32 rounding
        # (the port's gradients lie within 6e-5 of its float64 ones, the
        # JAX jitted step's up to 2e-4, of that largest), both take the
        # same step to float32's resolution; below it the sign of g is
        # rounding, and a flipped sign moves the weight 2 lr the other way
        upd, jupd = got[k] - before[k], ref - before[k]
        clear = grads[k] > 1e-3 * scale
        if clear.any():
            assert (upd - jupd)[clear].abs().max().item() <= 1e-6, k
        assert (upd - jupd).abs().max().item() <= 2.02 * lr, k
        moved = max(moved, upd.abs().max().item())
    assert moved > 0.5 * lr


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name,shape', [('segformer', (96, 160)),
                                        ('swin', (96, 170))])
def test_segmentor_predict_matches_jax(name, shape):
    """The narrow copy of the config (19 or 150 classes, float32 input):
    ``predict`` of two seeded images, the CPU eval step equal to it.  At
    96x160 MiT's first stage (24x40) is reduced 8x to 3x5 keys; at 96x170
    Swin's patch grid is 24x43 (170 is 2 mod 4: 'SAME' pads a column on
    each side), its stages 12x22, 6x11 and 3x6 (odd sizes merge-padded)."""
    jcfg, cfg = _configs(name)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1, 64, 64), n_classes=19, seed=122)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    imgs = np.random.default_rng(123).integers(0, 256, (2,) + shape + (3,),
                                               dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    ref = np.asarray(jmodel.apply(jax_variables(params, stats), x,
                                  method='predict'))
    with torch.no_grad():
        px, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        out = model.predict(px).numpy()
    classes = 150 if name == 'swin' else 19
    assert out.shape == ref.shape == (2,) + shape + (classes,)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree
    step = make_eval_step(model, model.data_preprocessor)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_config_builds_and_every_leaf_maps(name):
    """The config unchanged, at full width: every converted flax leaf is a
    port key of the same shape, and none of the port's is left over."""
    jmodel = JMODELS.build(dict(JConfig.fromfile(CONFIGS[name]).model))
    port = init_model(CONFIGS[name], device='cpu')
    sd = _full_width_leaves(jmodel, (1, 64, 64), method='loss')
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    port.load_state_dict(sd)
    norms = [m for m in port.backbone.modules()
             if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.eps == 1e-6 for m in norms)


# ------------------------------------------------------------------ Swin
@pytest.mark.parametrize('width', [683, 682, 681])
def test_swin_matches_jax(width):
    """Swin narrow on a 50 x ``width`` map: the patch grid is 13 x 171 (683
    pads no row and one column after; 682 one column each side; 681 one
    before and two after; 50 rows one each side), stages 13x171, 7x86,
    4x43 and 2x22, each padded to windows of 7, odd ones merge-padded; the
    four ``out_norm`` outputs."""
    from lednet_tpu.models.backbones.vit import SwinTransformer as J
    from lednet_tpu_torch.models.backbones.swin import SwinTransformer, same_pad
    assert same_pad(width, 4, 4) == {683: (0, 1), 682: (1, 1), 681: (1, 2)}[width]
    ref, out = _pair(J(**NARROW_SWIN), SwinTransformer(**NARROW_SWIN),
                     _normal((1, 50, width, 3), seed=124), seed=125)
    assert [tuple(o.shape[1:]) for o in out] == [
        (16, 13, 171), (32, 7, 86), (64, 4, 43), (128, 2, 22)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_swin_merge_channel_order():
    """Patch merging concatenates each 2x2 neighbourhood as channel ``(dw
    * 2 + dh) * C + c``: with ``merge0``'s input rows of the (dh=1, dw=0)
    and (dh=0, dw=1) neighbours swapped the second stage differs."""
    from lednet_tpu.models.backbones.vit import SwinTransformer as J
    from lednet_tpu_torch.models.backbones.swin import SwinTransformer
    kw = dict(embed_dims=8, depths=(1, 1), num_heads=(1, 2), out_indices=(0, 1))
    x = _normal((1, 36, 44, 3), seed=126)
    jmod = J(**kw)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=127)
    port = load_port(SwinTransformer(**kw), params, stats)
    ref = _apply(jmod, params, stats, jnp.asarray(x))
    with torch.no_grad():
        out = port(nchw(x))
        _hold(nhwc(out[1]), ref[1])
        w = port.merge0.weight          # (2C, 4C), input rows in blocks of C
        w.copy_(torch.cat([w[:, :8], w[:, 16:24], w[:, 8:16], w[:, 24:]], 1))
        swapped = port(nchw(x))[1]
    assert rel_err(nhwc(swapped), ref[1]) > 1e-3


def test_swin_shift_mask_matches_jax():
    """The -100 mask of a shifted block on a padded 14x21 grid, as the JAX
    block builds it (its three-slice ``img_mask``)."""
    from lednet_tpu_torch.models.backbones.swin import shift_mask
    ws, shift, Hp, Wp = 7, 3, 14, 21
    img = np.zeros((Hp, Wp), np.int32)
    regions = ((0, Hp - ws), (Hp - ws, Hp - shift), (Hp - shift, Hp))
    cols = ((0, Wp - ws), (Wp - ws, Wp - shift), (Wp - shift, Wp))
    for i, (a, b) in enumerate(regions):
        for j, (c, d) in enumerate(cols):
            img[a:b, c:d] = 3 * i + j
    mask = shift_mask(Hp, Wp, ws, shift)
    assert mask.shape == (6, 49, 49)
    for w in range(6):
        r, c = divmod(w, 3)
        ids = img[r * ws:(r + 1) * ws, c * ws:(c + 1) * ws].reshape(-1)
        np.testing.assert_array_equal(mask[w], np.where(
            ids[:, None] != ids[None, :], -100.0, 0.0))
    assert (mask[:2] == 0).all() and (mask[5] != 0).any()


@pytest.mark.parametrize('hw', [(16, 16), (2, 3)], ids=['overlap', 'outnumber'])
def test_uper_head_matches_jax(hw):
    """UPerHead on four levels whose deepest is ``hw``: at 16x16 the 3- and
    6-bin pools overlap (16 is no multiple of 6), at 2x3 the 6 bins
    outnumber the cells; logits at the finest level and the loss."""
    cfg = dict(type='UPerHead', in_channels=[4, 6, 8, 10], channels=8,
               num_classes=5, dropout_ratio=0.0)
    h, w = hw
    feats = [_normal((2, h * 8 // s, w * 8 // s, c), seed=128 + i)
             for i, (s, c) in enumerate(zip((1, 2, 4, 8), (4, 6, 8, 10)))]
    jhead = JMODELS.build(dict(cfg))
    jin = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jhead, jin, seed=132)
    head = load_port(MODELS.build(dict(cfg)), params, stats)
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    ref = _apply(jhead, params, stats, jin)
    assert tuple(out.shape) == (2, 5, 8 * h, 8 * w)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(133).integers(0, 5, (2, 16 * h, 16 * w))
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl.astype(np.int32)))
    got = head.loss_by_feat(out, torch.from_numpy(lbl))
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


def test_swin_unported_options_raise():
    from lednet_tpu_torch.models.backbones.mit import MixVisionTransformer
    from lednet_tpu_torch.models.backbones.swin import SwinTransformer
    for kw, word in ((dict(qk_scale=0.1), 'qk_scale'),
                     (dict(use_abs_pos_embed=True), 'use_abs_pos_embed'),
                     (dict(attn_drop_rate=0.1), 'attn_drop_rate')):
        with pytest.raises(NotImplementedError, match=word):
            SwinTransformer(**kw)
    with pytest.raises(NotImplementedError, match='drop_rate'):
        MixVisionTransformer(drop_rate=0.1)
    with pytest.raises(NotImplementedError, match='input_transform'):
        MODELS.build(dict(type='UPerHead', in_channels=[4, 8], channels=8,
                          num_classes=3, input_transform='resize_concat'))


# ------------------------------------------------------------------ MiT
@pytest.mark.parametrize('sr', [1, 4], ids=['plain', 'reduced'])
def test_efficient_attention_matches_jax(sr):
    """On a 13x18 map (sr 4 truncates to 3x4 keys), 2 heads."""
    from lednet_tpu.models.backbones.mit import EfficientAttention as J
    from lednet_tpu_torch.models.backbones.mit import EfficientAttention
    x = _normal((2, 13, 18, 16), seed=134)
    jmod = J(16, 2, sr)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=135)
    port = load_port(EfficientAttention(16, 2, sr), params, stats)
    if sr > 1:
        assert port.sr_norm.eps == 1e-6
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    _hold(out.numpy(), _apply(jmod, params, stats, jnp.asarray(x)))


def test_mix_ffn_matches_jax():
    from lednet_tpu.models.backbones.mit import MixFFN as J
    from lednet_tpu_torch.models.backbones.mit import MixFFN
    x = _normal((2, 9, 11, 8), seed=136)
    jmod = J(8, 32)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=137)
    port = load_port(MixFFN(8, 32), params, stats)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    _hold(out.numpy(), _apply(jmod, params, stats, jnp.asarray(x)))


def test_mit_matches_jax():
    """MiT narrow on 70x90 (patch embeds 18x23, 9x12, 5x6, 3x3; the first
    stage's keys 2x2 after an 8x8 reduction of 18x23)."""
    from lednet_tpu.models.backbones.mit import MixVisionTransformer as J
    from lednet_tpu_torch.models.backbones.mit import MixVisionTransformer
    kw = dict(NARROW_MIT, drop_path_rate=0.1)
    ref, out = _pair(J(**kw), MixVisionTransformer(**kw),
                     _normal((1, 70, 90, 3), seed=138), seed=139)
    assert [tuple(o.shape[1:]) for o in out] == [
        (8, 18, 23), (16, 9, 12), (40, 5, 6), (64, 3, 3)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_segformer_head_matches_jax():
    cfg = dict(type='SegformerHead', in_channels=[4, 6, 8, 10], channels=8,
               num_classes=5, dropout_ratio=0.0)
    feats = [_normal((2, 18 // s + 1, 23 // s + 1, c), seed=140 + i)
             for i, (s, c) in enumerate(zip((1, 2, 4, 8), (4, 6, 8, 10)))]
    jhead = JMODELS.build(dict(cfg))
    jin = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jhead, jin, seed=144)
    head = load_port(MODELS.build(dict(cfg)), params, stats)
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    assert tuple(out.shape) == (2, 5, 19, 24)
    _hold(nhwc(out), _apply(jhead, params, stats, jin))


# ------------------------------------------------------------------ bridge
def test_convert_dense_kernels():
    """MiT's and Swin's Dense kernels (in, out) become ``nn.Linear``'s (out,
    in); a bias table keeps its name and layout."""
    rng = np.random.default_rng(145)
    kv = rng.standard_normal((16, 32)).astype(np.float32)
    merge = rng.standard_normal((64, 32)).astype(np.float32)
    table = rng.standard_normal((169, 3)).astype(np.float32)
    sd = flax_to_state_dict({'_backbone': {
        's0_b0_attn': {'kv': {'kernel': kv}},
        'merge0': {'kernel': merge}, 's1_b1_qkv': {'kernel': merge},
        's1_b1_rel_bias': table}})
    np.testing.assert_array_equal(sd['backbone.s0_b0_attn.kv.weight'].numpy(), kv.T)
    np.testing.assert_array_equal(sd['backbone.merge0.weight'].numpy(), merge.T)
    np.testing.assert_array_equal(sd['backbone.s1_b1_qkv.weight'].numpy(), merge.T)
    np.testing.assert_array_equal(sd['backbone.s1_b1_rel_bias'].numpy(), table)


def test_init_weights_new_leaves():
    """Swin's bias tables truncated normal(0.02) at two deviations, Dense
    layers LeCun normal, the flax-default convs (MiT's ``sr`` and ``dw``,
    Swin's ``patch_embed``) LeCun normal, MiT's patch embeds kaiming normal
    over fan_out; the same generator, the same draw."""
    from lednet_tpu_torch.models.backbones.mit import MixVisionTransformer
    from lednet_tpu_torch.models.backbones.swin import SwinTransformer
    from lednet_tpu_torch.models.layers import init_weights

    def build():
        mods = torch.nn.ModuleDict(dict(
            mit=MixVisionTransformer(embed_dims=32, num_heads=[1, 2, 5, 8],
                                     num_layers=[1, 1, 1, 1]),
            swin=SwinTransformer(depths=(2, 2, 2, 2))))
        init_weights(mods, torch.Generator().manual_seed(0))
        return mods
    mods = build()
    table = mods.swin.s2_b0_rel_bias.detach()
    assert table.abs().max() <= 0.04 and table.std().item() == pytest.approx(
        0.02 * 0.8796, rel=0.05)
    fc = mods.swin.s2_b0_fc1.weight
    assert fc.std().item() == pytest.approx(fc.shape[1] ** -0.5, rel=0.05)
    for conv in (mods.mit.s0_b0_attn.sr, mods.mit.s1_b0_ffn.dw,
                 mods.swin.patch_embed):
        fan_in = conv.weight[0].numel()
        assert conv.weight.std().item() == pytest.approx(fan_in ** -0.5, rel=0.1)
    w = mods.mit.patch_embed1.weight
    assert w.std().item() == pytest.approx((2 / (w.shape[0] * 9)) ** 0.5, rel=0.05)
    for a, b in zip(mods.parameters(), build().parameters()):
        assert torch.equal(a, b)
