"""PyTorch port: the R50-D8 context heads (ANN, APC, CC, DA, DM, EMA, Enc,
GC, ISA, PSA, NL, DNL) and the general ``SelfAttentionBlock`` against
``lednet_tpu`` on the CPU.

The ten ``configs/_base_/models/*_r50-d8.py`` files that build are
composed as mmsegmentation's top-level configs of their families compose
them (``chip_smoke.CONTEXT_HEADS``, ``chip_smoke.compose_base``:
Cityscapes, the 80k schedule, 19 classes, the 512x1024 crop) into the
test's ``tmp_path``, and both packages read the same file.  Each test feeds
the same numpy inputs (``numpy.random.default_rng(seed)``) through the JAX
module and its port after ``lednet_tpu_torch.convert`` has carried the same
random flax weights and BatchNorm running stats across (every norm scale
drawn near 1, ``_norm_scales``; DA's and CC's gammas drawn in [0.5, 1.5],
where fresh weights hold them at 0 and no attention would show; EncHead's
smoothing factors in [-1, 0], as the JAX head draws them), and holds them
together:

- each head in eval mode at narrow widths, rel 1e-5 of the largest output:
  GC ('att' with 'channel_add'; 'avg' with both fusions), CC, DA (its
  three logits), EMA, ISA (a map that pads unevenly), APC, DM (an even
  filter size, padded asymmetrically), ANN (one query scale, and two),
  Enc (with and without laterals; its two outputs), PSA ('bi-direction',
  'collect', 'distribute', each compact and not, shrunk with and without
  the ``align_corners`` flip), NL and DNL; the general
  ``SelfAttentionBlock`` (pooled keys, shared key and query, plain
  projections);
- EMA in train mode: the output, the bases buffer and the BatchNorm
  stats after one forward equal JAX's;
- Enc's ``loss_se`` and DA's ``loss_ce`` / ``pam_loss_ce`` /
  ``cam_loss_ce`` equal JAX's;
- the ten files build in both packages at full width with equal leaf
  maps (``jax.eval_shape``, nothing run); NL's and DNL's files raise
  ``TypeError`` in both (they pass ``mode``);
- narrow copies of EMANet, EncNet, DANet and PSANet: ``predict`` within
  1e-4 x max|logit| with argmax agreement >= 99.9%, the CPU eval step
  equal to it;
- one train step each of EMANet (the bases buffer, the decay of
  ``ema_mid_conv``, which gets no gradient), EncNet (``loss_se``,
  ``encoding_bn``'s biased variance) and DANet (three losses) over a
  ResNetV1c-18 trunk (the narrow R50's float32 step rounds past the bounds
  in both packages, ROADMAP Queue 3), within phase 6's bounds (loss 1e-5;
  weights atol 1e-4 / rtol 5e-3; BatchNorm stats atol 1e-5 / rtol 1e-4).

torch runs on one thread in every test here (``one_thread``).  A JAX
brick runs op by op; a segmentor's ``predict`` and train step are jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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
from test_torch_port_knet_mask2former import _norm_scales
from test_torch_port_sct_rtformer_psp import _full_width_leaves
from test_torch_port_vit_fpn import _seeded as _vit_fpn_seeded
from test_torch_port_zoo import _normal

pytestmark = pytest.mark.usefixtures('one_thread')

ENTRIES = {e[1].split('_')[0]: e for e in chip_smoke.CONTEXT_HEADS}
TOL_BRICK = 1e-5           # modules, rel to the largest output
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


def _hold(out, ref, tol=TOL_BRICK):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= tol, rel_err(out, ref)


def _context(tree, seed):
    """``tree`` with every ``*_gamma`` in [0.5, 1.5] and EncHead's
    ``scale`` (beside ``codewords``) in [-1, 0]."""
    rng = np.random.default_rng(seed + 1)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.endswith('_gamma'):
                out[k] = np.float32(rng.uniform(0.5, 1.5))
            elif k == 'scale' and 'codewords' in t:
                out[k] = rng.uniform(-1.0, 0.0, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(tree)


def _variables(jmod, jin, seed, **kw):
    params, stats = random_variables(jmod, jin, seed=seed, **kw)
    return _context(_norm_scales(params, seed), seed), stats


def _brick(jmod, port, jin, tin, seed):
    """(port output, JAX output) of a head in eval on the same weights."""
    params, stats = _variables(jmod, jin, seed)
    load_port(port, params, stats)
    with torch.no_grad():
        out = port(tin)
    return out, jmod.apply(jax_variables(params, stats), jin, train=False)


def _feats(seed, hw=(9, 11), widths=(4, 6, 10, 12), n=2):
    """Four levels of (n, h, w, width) features, numpy and NCHW torch."""
    feats = [_normal((n,) + hw + (c,), seed=seed + i)
             for i, c in enumerate(widths)]
    return [jnp.asarray(f) for f in feats], [nchw(f) for f in feats]


def _jax_head(name):
    from lednet_tpu.models.decode_heads import context_heads, point_setr_heads
    from lednet_tpu.models.decode_heads import uper_ocr
    for mod in (context_heads, point_setr_heads, uper_ocr):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


# ------------------------------------------------------------ composition
_R50_NARROW = {'model.backbone.stem_channels': 16,
               'model.backbone.base_channels': 8}   # stages 32, 64, 128, 256
_HEADS_NARROW = {
    'ann': {'model.decode_head.in_channels': [128, 256],
            'model.decode_head.channels': 16,
            'model.decode_head.project_channels': 8},
    'apcnet': {'model.decode_head.in_channels': 256,
               'model.decode_head.channels': 16},
    'ccnet': {'model.decode_head.in_channels': 256,
              'model.decode_head.channels': 16},
    'danet': {'model.decode_head.in_channels': 256,
              'model.decode_head.channels': 16,
              'model.decode_head.pam_channels': 8},
    'dmnet': {'model.decode_head.in_channels': 256,
              'model.decode_head.channels': 16},
    'emanet': {'model.decode_head.in_channels': 256,
               'model.decode_head.channels': 16,
               'model.decode_head.ema_channels': 24,
               'model.decode_head.num_bases': 8},
    'encnet': {'model.decode_head.in_channels': [64, 128, 256],
               'model.decode_head.channels': 16,
               'model.decode_head.num_codes': 8},
    'gcnet': {'model.decode_head.in_channels': 256,
              'model.decode_head.channels': 16},
    'isanet': {'model.decode_head.in_channels': 256,
               'model.decode_head.channels': 16,
               'model.decode_head.isa_channels': 8},
    'psanet': {'model.decode_head.in_channels': 256,
               'model.decode_head.channels': 16}}


def narrow(name):
    """Options that cut the composed config of ``name`` to a test width:
    ResNet-50's stages 32-256 wide, the heads 8-24, the auxiliary FCN 8."""
    return dict(_R50_NARROW, **_HEADS_NARROW[name], **{
        'model.auxiliary_head.in_channels': 128,
        'model.auxiliary_head.channels': 8})


def _configs(tmp_path, name, extra=None):
    """(JAX config, port config) of the composed file of ``name``, the
    options ``extra`` (or the narrow ones) merged."""
    path = chip_smoke.compose_base(str(tmp_path), ENTRIES[name])
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(path)
        cfg.merge_from_dict(narrow(name) if extra is None else extra)
        out.append(cfg)
    return out


def _seeded(jmodel, shape, seed):
    """The seeded variables of a JAX segmentor (``test_torch_port_vit_fpn.
    _seeded``: initialised through ``loss``, every norm scale near 1),
    then ``_context``."""
    params, stats = _vit_fpn_seeded(jmodel, shape, seed)
    return _context(params, seed), stats


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with.
# ------------------------------------------------------------------ training
_R18 = {'model.backbone.depth': 18, 'model.backbone.stem_channels': 16,
        'model.backbone.base_channels': 8,           # stages 8, 16, 32, 64
        'model.auxiliary_head.in_channels': 32,
        'model.auxiliary_head.channels': 8,
        'model.auxiliary_head.num_classes': 3,
        'model.auxiliary_head.dropout_ratio': 0.0,
        'model.decode_head.num_classes': 3,
        'model.decode_head.dropout_ratio': 0.0,
        'model.data_preprocessor.size': (64, 64)}
TRAIN = {
    'emanet': {'model.decode_head.in_channels': 64,
               'model.decode_head.channels': 16,
               'model.decode_head.ema_channels': 24,
               'model.decode_head.num_bases': 8},
    'encnet': {'model.decode_head.in_channels': [16, 32, 64],
               'model.decode_head.channels': 16,
               'model.decode_head.num_codes': 8},
    'danet': {'model.decode_head.in_channels': 64,
              'model.decode_head.channels': 16,
              'model.decode_head.pam_channels': 8}}
LOSSES = {'emanet': {'loss_ce'}, 'encnet': {'loss_ce', 'loss_se'},
          'danet': {'loss_ce', 'pam_loss_ce', 'cam_loss_ce'}}


@pytest.mark.parametrize('name', list(TRAIN))
def test_train_step_matches_jax(tmp_path, name):
    """One SGD step of the composed config over a ResNetV1c-18 trunk in
    both packages from the same weights and batch (4 x 64x64, 3 classes,
    dropout 0): EMANet's bases buffer moved by the step and ``ema_mid_conv``
    decayed without a gradient; EncNet's ``loss_se`` and ``encoding_bn``'s
    running stats; DANet's three losses.  Loss within 1e-5, every weight
    and buffer within atol 1e-4 / rtol 5e-3, the BatchNorm running stats
    within atol 1e-5 / rtol 1e-4."""
    jcfg, cfg = _configs(tmp_path, name, dict(_R18, **TRAIN[name]))
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    shape = (4, 64, 64)
    rng = np.random.default_rng(230)
    imgs = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lbl = rng.integers(0, 3, (shape[0], shape[1] // 8, shape[2] // 8))
    lbl = lbl.repeat(8, 1).repeat(8, 2)
    lbl = np.where(rng.random(shape) < 0.02, 255, lbl).astype(np.int32)
    params, stats = _seeded(jmodel, (1,) + shape[1:], 231)
    jvars = jax_variables(params, stats)
    # a copy: the JAX step donates its state, whose buffers may alias the
    # numpy arrays that flax_to_state_dict's tensors share
    before = {k: v.clone() for k, v in flax_to_state_dict(params, stats).items()}
    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    step = make_train_step(model, opt, model.data_preprocessor)
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs),
                        torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == 1 and model.training

    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                         batch_stats=jvars['batch_stats'],
                         opt_state=tx.init(jvars['params']))
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))

    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    assert set(logs) - {'loss', 'grad_norm'} == keys
    assert {f'decode.{k}' for k in LOSSES[name]} <= keys
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    # acc_seg is an argmax of logits upsampled 8x: a near-tie of one 1/8
    # logit decides an 8x8 block of pixels
    block = 64 * 100.0 / int((lbl != 255).sum())
    for k in keys:
        tol = dict(rel=0, abs=1.01 * block) if k.endswith('acc_seg') \
            else dict(rel=1e-4, abs=1e-5)
        assert logs[k].item() == pytest.approx(float(jlogs[k]), **tol), k
    assert logs['grad_norm'].item() == pytest.approx(
        float(jlogs['grad_norm']), rel=1e-3)
    want = flax_to_state_dict(jax.device_get(jstate.params),
                              jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0.0
    for k, ref in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        stat = k.endswith('running_mean') or k.endswith('running_var')
        np.testing.assert_allclose(
            got[k].numpy(), ref.numpy(), err_msg=k,
            **(dict(atol=1e-5, rtol=1e-4) if stat else dict(atol=1e-4, rtol=5e-3)))
        if not stat:
            moved = max(moved, (got[k] - before[k]).abs().max().item())
    assert moved > 1e-4          # the step learned something
    if name == 'emanet':
        bases = 'decode_head.bases'
        assert (got[bases] - before[bases]).abs().max() > 1e-3
        mid = 'decode_head.ema_mid_conv.conv.weight'
        assert model.decode_head.ema_mid_conv.conv.weight.requires_grad
        assert not torch.equal(got[mid], before[mid])      # decayed


# ------------------------------------------------------------------ configs
PREDICT = {'emanet': (72, 104), 'encnet': (72, 104), 'danet': (72, 104),
           'psanet': (72, 104)}


@pytest.mark.parametrize('name', list(PREDICT))
def test_segmentor_predict_matches_jax(tmp_path, name):
    """The narrow copy of the composed config (19 classes, float32 input):
    ``predict`` of two seeded 72x104 images (a 9x13 map at 1/8: PSANet's
    shrink rounds it up to 5x7 and flips to ``align_corners``), the CPU
    eval step equal to it."""
    jcfg, cfg = _configs(tmp_path, name)
    shape = PREDICT[name]
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = _seeded(jmodel, (1, 64, 64), 232)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    imgs = np.random.default_rng(233).integers(0, 256, (2,) + shape + (3,),
                                               dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method='predict'))(
        jax_variables(params, stats), x))
    with torch.no_grad():
        px, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        out = model.predict(px).numpy()
    assert out.shape == ref.shape == (2,) + shape + (19,)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree
    step = make_eval_step(model, model.data_preprocessor)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


@pytest.mark.parametrize('name', list(ENTRIES))
def test_base_model_builds_and_every_leaf_maps(name):
    """The ``_base_/models`` file unchanged, at full width: every converted
    flax leaf is a port key of the same shape, and none of the port's is
    left over (EMA's bases buffer and Enc's codewords, smoothing factors
    and code BatchNorm included)."""
    path = f'{REPO}/configs/_base_/models/{ENTRIES[name][1]}'
    sd = _full_width_leaves(JMODELS.build(dict(JConfig.fromfile(path).model)),
                            (1, 64, 64), method='loss')
    want = init_model(path, device='cpu').state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k


@pytest.mark.parametrize('head,name', chip_smoke.NL_HEADS)
def test_nl_dnl_files_raise_type_error(head, name):
    """``nonlocal_r50-d8.py`` and ``dnl_r50-d8.py`` pass ``mode``, which
    neither package's head takes: building the head raises ``TypeError``
    in both, and so does the port's ``init_model`` of the file; without
    ``mode`` the head builds in both."""
    path = f'{REPO}/configs/_base_/models/{name}'
    jcfg = dict(JConfig.fromfile(path).model.decode_head)
    assert jcfg.pop('type') == head and jcfg['mode'] == 'embedded_gaussian'
    with pytest.raises(TypeError, match='mode'):
        _jax_head(head)(**jcfg)
    with pytest.raises(TypeError, match='mode'):
        init_model(path, device='cpu')
    cfg = dict(Config.fromfile(path).model.decode_head)
    cfg.pop('mode')
    jcfg.pop('mode')
    assert type(MODELS.build(cfg)).__name__ == head
    _jax_head(head)(**jcfg)


# ------------------------------------------------------------------ bricks
BRICKS = {
    'gc-att-add': ('GCHead', dict(in_channels=12, channels=16)),
    'gc-avg-mul-add': ('GCHead', dict(
        in_channels=12, channels=16, pooling_type='avg',
        fusion_types=('channel_add', 'channel_mul'), concat_input=False)),
    'cc': ('CCHead', dict(in_channels=12, channels=16, recurrence=2)),
    'da': ('DAHead', dict(in_channels=12, channels=16, pam_channels=4)),
    'ema': ('EMAHead', dict(in_channels=12, channels=8, ema_channels=16,
                            num_bases=6, num_stages=3)),
    'isa': ('ISAHead', dict(in_channels=12, channels=16, isa_channels=8,
                            down_factor=(4, 4))),
    'apc': ('APCHead', dict(in_channels=12, channels=8)),
    'dm': ('DMHead', dict(in_channels=12, channels=8, filter_sizes=(1, 2, 3, 7),
                          fusion=True)),
    'ann': ('ANNHead', dict(in_channels=[10, 12], in_index=[2, 3], channels=16,
                            project_channels=8)),
    'ann-two-scales': ('ANNHead', dict(in_channels=[10, 12], in_index=[2, 3],
                                       channels=16, project_channels=8,
                                       query_scales=(1, 2))),
    'enc': ('EncHead', dict(in_channels=[6, 10, 12], in_index=(1, 2, 3),
                            channels=16, num_codes=8)),
    'enc-lateral': ('EncHead', dict(in_channels=[6, 10, 12], in_index=(1, 2, 3),
                                    channels=16, num_codes=8, add_lateral=True)),
    'psa-bi': ('PSAHead', dict(in_channels=12, channels=8, mask_size=(7, 9))),
    'psa-collect': ('PSAHead', dict(in_channels=12, channels=8, mask_size=(7, 9),
                                    psa_type='collect')),
    'psa-distribute': ('PSAHead', dict(in_channels=12, channels=8,
                                       mask_size=(5, 5), psa_type='distribute',
                                       normalization_factor=None)),
    'psa-collect-compact': ('PSAHead', dict(
        in_channels=12, channels=8, mask_size=(5, 6), psa_type='collect',
        compact=True)),
    'psa-distribute-compact': ('PSAHead', dict(
        in_channels=12, channels=8, mask_size=(5, 6), psa_type='distribute',
        compact=True, psa_softmax=False)),
    'psa-bi-compact': ('PSAHead', dict(in_channels=12, channels=8,
                                       mask_size=(5, 6), compact=True)),
    'psa-even': ('PSAHead', dict(in_channels=12, channels=8, mask_size=(7, 7),
                                 hw=(10, 12))),
    'nl': ('NLHead', dict(in_channels=12, channels=16)),
    'dnl': ('DNLHead', dict(in_channels=12, channels=16, temperature=0.5)),
}


@pytest.mark.parametrize('case', list(BRICKS))
def test_head_matches_jax(case):
    """The head in eval on four levels of 9x11 features (PSA-even: 10x12,
    shrunk without the flip), narrow widths, 5 classes: every output (DA's
    three logits, Enc's logits and class-presence logits) within 1e-5 of
    the largest.  ISA pads 9x11 to 12x12 (1 row above, 2 below); the
    compact PSA forms take a mask as large as the shrunk 5x6 map."""
    head, cfg = BRICKS[case]
    cfg = dict(cfg, num_classes=5, dropout_ratio=0.0)
    hw = cfg.pop('hw', (9, 11))
    if 'in_index' not in cfg:
        cfg['in_index'] = 3
    jin, tin = _feats(240 + len(case), hw)
    port = MODELS.build(dict(cfg, type=head))
    out, ref = _brick(_jax_head(head)(**cfg), port, jin, tin, seed=241)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(outs) == len(refs) == {'DAHead': 3, 'EncHead': 2}.get(head, 1)
    for o, r in zip(outs, refs):
        _hold(nhwc(o) if o.dim() == 4 else o.numpy(), r)
    assert tuple(outs[0].shape) == (2, 5) + hw


@pytest.mark.parametrize('form', ['pooled-keys', 'shared-plain'])
def test_self_attention_block_matches_jax(form):
    """The general block on 9x11 queries and 6x7 keys: ANN's form (normed
    query / key convs, keys and values pooled to 1, 2 and 3, with_out,
    matmul_norm) and the plain form (un-normed projections, shared key
    and query, two value convs, no out)."""
    from lednet_tpu.models.decode_heads.context_heads import \
        SelfAttentionBlock as J
    from lednet_tpu_torch.models.decode_heads.self_attention import \
        SelfAttentionBlock
    kw = dict(key_in_channels=12, query_in_channels=12, channels=8,
              out_channels=10)
    kw.update(dict(key_query_norm=True, matmul_norm=True, with_out=True,
                   key_pool_scales=(1, 2, 3)) if form == 'pooled-keys' else
              dict(share_key_query=True, value_out_num_convs=2))
    q = _normal((2, 9, 11, 12), seed=242)
    k = _normal((2, 6, 7, 12), seed=243, scale=2.0)
    jmod = J(**kw)
    params, stats = random_variables(jmod, jnp.asarray(q), jnp.asarray(k),
                                     seed=244)
    params = _norm_scales(params, 244)
    port = load_port(SelfAttentionBlock(**kw), params, stats)
    assert ('key_project0' in dict(port.named_children())) == (form == 'pooled-keys')
    with torch.no_grad():
        out = port(nchw(q), nchw(k))
    ref = jmod.apply(jax_variables(params, stats), jnp.asarray(q),
                     jnp.asarray(k), train=False)
    assert tuple(out.shape) == (2, 10, 9, 11)
    _hold(nhwc(out), ref)


def test_ema_train_forward_updates_bases_as_jax():
    """EMAHead in train mode, one forward: the output (BatchNorm on batch
    statistics), the bases buffer moved toward the batch's mean bases and
    every BatchNorm's running stats, as the JAX head's mutable
    ``batch_stats``."""
    cfg = dict(in_channels=12, channels=8, ema_channels=16, num_bases=6,
               num_classes=5, dropout_ratio=0.0, in_index=3)
    jin, tin = _feats(245)
    jmod = _jax_head('EMAHead')(**cfg)
    params, stats = _variables(jmod, jin, 246)
    port = load_port(MODELS.build(dict(cfg, type='EMAHead')), params, stats)
    before = port.bases.clone()
    port.train()
    with torch.no_grad():
        out = port(tin)
    ref, new = jmod.apply(jax_variables(params, stats), jin, train=True,
                          mutable=['batch_stats'])
    _hold(nhwc(out), ref)
    want = flax_to_state_dict(params, jax.device_get(new['batch_stats']))
    got = port.state_dict()
    assert (got['bases'] - before).abs().max() > 1e-3
    for k, v in want.items():
        if 'running' in k or k == 'bases':
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize('head', ['EncHead', 'DAHead'])
def test_head_losses_match_jax(head):
    """Enc's ``loss_ce`` and ``loss_se`` (the class-presence BCE over the
    labels that are not ignored, weight 0.2) and DA's ``loss_ce``,
    ``pam_loss_ce`` and ``cam_loss_ce``, each with ``acc_seg``, on the
    same logits and labels (5% ignored, one class absent)."""
    case = {'EncHead': 'enc', 'DAHead': 'da'}[head]
    cfg = dict(BRICKS[case][1], num_classes=5, dropout_ratio=0.0)
    cfg.setdefault('in_index', 3)
    if head == 'EncHead':
        cfg['loss_se_decode'] = dict(type='CrossEntropyLoss', use_sigmoid=True,
                                     loss_weight=0.2)
    jin, tin = _feats(247)
    jmod = _jax_head(head)(**cfg)
    port = MODELS.build(dict(cfg, type=head))
    out, ref = _brick(jmod, port, jin, tin, seed=248)
    rng = np.random.default_rng(249)
    lbl = rng.integers(0, 4, (2, 36, 44))
    lbl = np.where(rng.random(lbl.shape) < 0.05, 255, lbl).astype(np.int32)
    want = jmod.loss_by_feat(ref, jnp.asarray(lbl))
    got = port.loss_by_feat(out, torch.from_numpy(lbl).long())
    keys = {'EncHead': {'loss_ce', 'loss_se', 'acc_seg'},
            'DAHead': {'loss_ce', 'pam_loss_ce', 'cam_loss_ce', 'acc_seg'}}
    assert set(got) == set(want) == keys[head]
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= TOL_BRICK, k


def test_unported_options_raise():
    """A sampler on DA or Enc (whose JAX losses take none) and a
    ``loss_se_decode`` other than the sigmoid cross-entropy raise
    ``NotImplementedError``."""
    for head in ('DAHead', 'EncHead'):
        cfg = dict(BRICKS[{'DAHead': 'da', 'EncHead': 'enc'}[head]][1],
                   num_classes=5, type=head,
                   sampler=dict(type='OHEMPixelSampler', thresh=0.7))
        with pytest.raises(NotImplementedError, match='sampler'):
            MODELS.build(cfg)
    with pytest.raises(NotImplementedError, match='loss_se_decode'):
        MODELS.build(dict(BRICKS['enc'][1], num_classes=5, type='EncHead',
                          loss_se_decode=dict(type='FocalLoss')))
