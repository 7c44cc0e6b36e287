"""PyTorch port: the paper's two same-val baselines, DDRNet and BiSeNetV1
(ResNet-18 context path), against ``lednet_tpu`` on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- the bricks in eval mode, rel 1e-5 of the largest output: ``Bottleneck``,
  ``DAPPM`` (on a 16x16 map, where the 17x17 pool sees mostly padding, and
  on a 5x7 map), ``DDRNet`` (c=8, 64x96), ``DDRHead`` (predict at a size
  that is not 8x its logit, and ``loss_by_feat`` with the OHEM pair),
  ``ResNet`` (depth 18 on 64x64 and on an odd size; depth 50 as ResNetV1c
  with the d8 dilations and ``contract_dilation``), ``BiSeNetV1``
  (64x128), ``FCNHead`` with ``concat_input`` True and False (logits and
  loss), LEDNet with ``context_pool='dappm'``; the max pool bit-exact with
  all-negative inputs (its padding is ``-inf``); BatchNorm in
  training on one value per channel (torch refuses it; JAX does not);
- the three shipped configs built unchanged (DDRNet-23-slim at 100x156,
  where 8x the head's logit is not the input size; DDRNet-23 at 128x128;
  BiSeNetV1 R-18 at 96x160), and BiSeNetV1 R-50's COCO-Stuff config at a
  test width with its 171 classes (96x128): logits within 1e-4 x
  max|logit| with argmax agreement >= 99.9%, and the CPU eval step equal
  to ``predict``;
- one train step of DDRNet-23-slim (its OHEM pair, at batch 2 and 1) and
  of BiSeNetV1 with a ResNet-18 and a ResNet-50 trunk (CE
  plus two FCN auxiliary heads, ``dropout_ratio`` 0 in all three heads,
  as two RNG streams cannot drop the same units) at a test width: loss
  within 1e-5, every weight within atol 1e-4 / rtol 5e-3, the BatchNorm
  running stats within atol 1e-5 / rtol 1e-4 (the bounds of
  ``tests/test_torch_port_train.py``; R-50's logs within the larger of
  these and 3x the port's own float32-vs-float64 distance, see
  ``OWN_ROUNDING``); the BiSeNetV1 schedule's lr
  (LinearLR warm-up, then PolyLR to ``eta_min``) at iterations 0, 999,
  1000, 159999 and 160000;
- ``Runner.val`` of DDRNet-23-slim (cut to a test width) on a fabricated
  Cityscapes tree: aAcc and mIoU within 0.05 points of the JAX Runner's.

torch runs on one thread in every test here (``one_thread``): its CPU
autograd aborts the process when it runs multi-threaded after the XLA CPU
runtime has run, and six workers' threads oversubscribe the cores.  A
segmentor's JAX ``predict``, which runs once, is jitted: in a fresh worker
one whole-graph compile cost less than the forward op by op (the four
configs 12.9 s against 32.7).
"""
import jax
import jax.numpy as jnp
import numpy as np
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
from lednet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                     create_train_state, make_eval_step,
                                     make_train_step)
from lednet_tpu_torch.registry import MODELS
from test_torch_port_common import (REPO, _fill, _plain, jax_variables,
                                    load_port, nchw, nhwc, random_variables,
                                    rel_err)
from test_torch_port_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

DDRNET_SLIM = f'{REPO}/configs/ddrnet/ddrnet_23-slim_cityscapes-1024x1024.py'
DDRNET_23 = f'{REPO}/configs/ddrnet/ddrnet_23_cityscapes-1024x1024.py'
BISENETV1 = f'{REPO}/configs/bisenetv1/bisenetv1_r18-d32_cityscapes-1024x1024.py'
BISENETV1_R50 = (f'{REPO}/configs/bisenetv1/'
                 'bisenetv1_r50-d32_4xb4-160k_coco-stuff164k-512x512.py')
TOL_MODULE = 1e-5          # bricks, rel to the largest output
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit
METRIC_TOL = 0.05          # percentage points, port val against JAX val


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _labels(shape, n_classes, seed, ignored=0.05):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, n_classes, shape)
    return np.where(rng.random(shape) < ignored, 255, lbl).astype(np.int32)


def loss_variables(jmodel, shape, n_classes=2, seed=0):
    """(params, batch_stats) of a JAX segmentor initialised through
    ``loss``, so that its auxiliary heads have variables too (``__call__``
    runs the decode head only), filled from a numpy seed like
    ``random_variables``."""
    x = jnp.zeros(shape + (3,))
    lbl = jnp.zeros(shape[:3], jnp.int32)
    key = jax.random.PRNGKey(0)
    shapes = _plain(jax.eval_shape(lambda: jmodel.init(
        {'params': key, 'dropout': key}, x, lbl, method='loss')))
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        return {k: fill(v, path + (k,)) if isinstance(v, dict)
                else _fill(path + (k,), v.shape, rng).astype(np.float32)
                for k, v in tree.items()}
    return fill(shapes['params']), fill(shapes['batch_stats'])


def _apply(jmod, params, stats, *args, **kw):
    return jmod.apply(jax_variables(params, stats), *args, train=False, **kw)


def _hold(out, ref, tol=TOL_MODULE):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= tol


# ------------------------------------------------------------------ bricks
@pytest.mark.parametrize('in_ch,stride,downsample,act_out',
                         [(16, 1, False, False), (8, 2, True, True)])
def test_bottleneck_matches_jax(in_ch, stride, downsample, act_out):
    from lednet_tpu.models.layers import Bottleneck as JBottleneck
    from lednet_tpu_torch.models.layers import Bottleneck
    x = _normal((2, 12, 10, in_ch), seed=1)
    jmod = JBottleneck(in_ch, 8, stride=stride, downsample=downsample,
                       act_out=act_out)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=2)
    port = load_port(Bottleneck(in_ch, 8, stride=stride, downsample=downsample,
                                act_out=act_out), params, stats)
    with torch.no_grad():
        out = nhwc(port(nchw(x)))
    _hold(out, _apply(jmod, params, stats, jnp.asarray(x)))
    if not act_out:
        assert (out < 0).any()


@pytest.mark.parametrize('hw', [(16, 16), (5, 7)])
def test_dappm_matches_jax(hw):
    """At 16x16 the 17x17 pool (padding 8) sees mostly padding, which the
    divisor must count."""
    from lednet_tpu.models.ppm import DAPPM as JDAPPM
    from lednet_tpu_torch.models.ppm import DAPPM
    x = _normal((2,) + hw + (32,), seed=3, scale=2.0) + 1.0
    jmod = JDAPPM(32, 16, 24, num_scales=5)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=4)
    port = load_port(DAPPM(32, 16, 24, num_scales=5), params, stats)
    with torch.no_grad():
        out = nhwc(port(nchw(x)))
    _hold(out, _apply(jmod, params, stats, jnp.asarray(x)))


def test_batchnorm_one_value_per_channel_matches_jax():
    """A (1, C, 1, 1) map in training, which torch's BatchNorm refuses: the
    output and the running stats as the JAX package's BatchNorm gives
    them."""
    from lednet_tpu.models.layers import BatchNorm as JBatchNorm
    from lednet_tpu_torch.models.layers import BatchNorm
    x = _normal((1, 1, 1, 6), seed=26)
    jmod = JBatchNorm(use_running_average=False, momentum=0.9)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=27)
    ref, mutated = jmod.apply(jax_variables(params, stats), jnp.asarray(x),
                              mutable=['batch_stats'])
    port = BatchNorm(6)
    port.load_state_dict({'weight': torch.from_numpy(params['scale']),
                          'bias': torch.from_numpy(params['bias']),
                          'running_mean': torch.from_numpy(stats['mean']),
                          'running_var': torch.from_numpy(stats['var']),
                          'num_batches_tracked': torch.tensor(0)})
    out = port.train()(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-6)
    for mine, theirs in (('running_mean', 'mean'), ('running_var', 'var')):
        np.testing.assert_allclose(getattr(port, mine).numpy(),
                                   np.asarray(mutated['batch_stats'][theirs]),
                                   atol=1e-7, rtol=1e-6)


POOLS = {
    'max_3x3s2p1_odd': dict(kind='max', args=(3, 2, 1), hw=(9, 14)),
    'max_3x3s2p1_even': dict(kind='max', args=(3, 2, 1), hw=(8, 13)),
    'max_2x2s2p1': dict(kind='max', args=(2, 2, 1), hw=(7, 10)),
    'avg_17x17s8p8': dict(kind='avg', args=(17, 8, 8), hw=(16, 16)),
}


@pytest.mark.parametrize('name', sorted(POOLS))
def test_pools_match_jax(name):
    """All-negative inputs: a max pool padded with 0 instead of -inf would
    give 0 at the border; the average pool's divisor counts the padding."""
    from lednet_tpu.ops import pool as jpool
    from lednet_tpu_torch.ops import pool
    case = POOLS[name]
    x = -5.0 - np.abs(_normal((2,) + case['hw'] + (3,), seed=5))
    fn = 'max_pool2d' if case['kind'] == 'max' else 'avg_pool2d'
    ref = getattr(jpool, fn)(jnp.asarray(x), *case['args'])
    out = nhwc(getattr(pool, fn)(nchw(x), *case['args']))
    if case['kind'] == 'max':
        np.testing.assert_array_equal(out, np.asarray(ref))
    else:
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_ddrnet_matches_jax():
    from lednet_tpu.models.backbones.ddrnet import DDRNet as JDDRNet
    from lednet_tpu_torch.models.backbones.ddrnet import DDRNet
    x = _normal((1, 64, 96, 3), seed=6)
    jmod = JDDRNet(channels=8, ppm_channels=16)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=7)
    port = load_port(DDRNet(channels=8, ppm_channels=16), params, stats)
    with torch.no_grad():
        out = port(nchw(x))
    ref = _apply(jmod, params, stats, jnp.asarray(x))
    assert out[1].shape == (1, 32, 8, 12)
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


@pytest.mark.parametrize('part', ['predict', 'loss'])
def test_ddr_head_matches_jax(part):
    """predict at (60, 90), not 8x the 8x12 logit; the loss of the OHEM pair
    on (temp_context, final)-shaped features."""
    from lednet_tpu_torch.models.decode_heads.led_head import DDRHead
    cfg = dict(Config.fromfile(DDRNET_SLIM).model.decode_head, in_channels=32,
               channels=16, num_classes=3)
    jhead = JMODELS.build(dict(cfg))
    feats = (_normal((2, 8, 12, 16), seed=8), _normal((2, 8, 12, 32), seed=9))
    jfeats = tuple(jnp.asarray(f) for f in feats)
    params, stats = random_variables(jhead, jfeats, seed=10)
    head = load_port(DDRHead(**{k: v for k, v in cfg.items() if k != 'type'}),
                     params, stats)
    tfeats = tuple(nchw(f) for f in feats)
    if part == 'predict':
        ref = jhead.predict_by_feat(_apply(jhead, params, stats, jfeats,
                                           with_aux=False), (60, 90))
        with torch.no_grad():
            out = head.predict_by_feat(head(tfeats, with_aux=False), (60, 90))
            default = head.predict_by_feat(head(tfeats, with_aux=False))
        assert default.shape[-2:] == (64, 96)
        _hold(nhwc(out), ref)
        return
    lbl = _labels((2, 64, 96), 3, seed=11)
    logits = _apply(jhead, params, stats, jfeats)
    ref = jhead.loss_by_feat(logits, jnp.asarray(lbl))
    with torch.no_grad():
        out = head.loss_by_feat(tuple(nchw(np.asarray(l)) for l in logits),
                                torch.from_numpy(lbl).long())
    assert set(out) == set(ref) == {'loss_context', 'loss_spatial', 'acc_seg'}
    for k in ref:
        assert rel_err(out[k].numpy(), ref[k]) <= 1e-5, k


RESNETS = {
    'r18': (dict(type='ResNet', depth=18), (1, 64, 64)),
    'r50_v1c_d8': (dict(type='ResNetV1c', depth=50, stem_channels=16,
                        base_channels=8, strides=(1, 2, 1, 1),
                        dilations=(1, 1, 2, 4), contract_dilation=True),
                   (1, 48, 48)),
    'r18_odd_size': (dict(type='ResNet', depth=18, base_channels=16,
                          stem_channels=16), (2, 45, 51)),
}


@pytest.mark.parametrize('name', sorted(RESNETS))
def test_resnet_matches_jax(name):
    cfg, shape = RESNETS[name]
    x = _normal(shape + (3,), seed=12)
    jmod = JMODELS.build(dict(cfg))
    params, stats = random_variables(jmod, jnp.asarray(x), seed=13)
    port = load_port(MODELS.build(dict(cfg)), params, stats)
    with torch.no_grad():
        out = port(nchw(x))
    ref = _apply(jmod, params, stats, jnp.asarray(x))
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_bisenetv1_matches_jax():
    cfg = dict(Config.fromfile(BISENETV1).model.backbone)
    x = _normal((1, 64, 128, 3), seed=14)
    jmod = JMODELS.build(dict(cfg))
    params, stats = random_variables(jmod, jnp.asarray(x), seed=15)
    assert 'ResNet_0' in params        # flax's automatic name of the trunk
    port = load_port(MODELS.build(dict(cfg)), params, stats)
    with torch.no_grad():
        out = port(nchw(x))
    ref = _apply(jmod, params, stats, jnp.asarray(x))
    assert [tuple(o.shape) for o in out] == [(1, 256, 8, 16), (1, 128, 8, 16),
                                             (1, 128, 4, 8)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


@pytest.mark.parametrize('concat_input', [True, False])
def test_fcn_head_matches_jax(concat_input):
    """The input at ``in_index`` 1 of three maps; logits and the loss."""
    from lednet_tpu_torch.models.decode_heads.fcn_head import FCNHead
    cfg = dict(in_channels=16, channels=8, num_classes=3, num_convs=2,
               concat_input=concat_input, in_index=1, dropout_ratio=0.1)
    jhead = JMODELS.build(dict(cfg, type='FCNHead'))
    feats = [_normal((2, 16 // s, 24 // s, c), seed=16 + s)
             for s, c in ((1, 8), (2, 16), (4, 32))]
    jfeats = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jhead, jfeats, seed=20)
    head = load_port(FCNHead(**cfg), params, stats)
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    ref = _apply(jhead, params, stats, jfeats)
    _hold(nhwc(out), ref)
    lbl = _labels((2, 40, 60), 3, seed=21)
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_ce', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


def test_lednet_dappm_context_pool_matches_jax():
    from lednet_tpu.models.backbones.lednet import LEDNet as JLEDNet
    from lednet_tpu_torch.models.backbones.lednet import LEDNet
    x = _normal((1, 128, 128, 3), seed=22)
    jmod = JLEDNet(channels=8, ppm_channels=16, context_pool='dappm')
    params, stats = random_variables(jmod, jnp.asarray(x), seed=23)
    port = load_port(LEDNet(channels=8, ppm_channels=16, context_pool='dappm'),
                     params, stats)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        jax_variables(params, stats), jnp.asarray(x))
    with torch.no_grad():
        out = port(nchw(x), 'plain')
    for o, r in zip(out, ref):      # the JAX eval stem packs x1 (Packed2x2)
        _hold(nhwc(o), r.unpack() if hasattr(r, 'unpack') else r)
    with pytest.raises(ValueError, match='context_pool'):
        LEDNet(channels=8, context_pool='aspp')


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize('config', [DDRNET_SLIM, BISENETV1],
                         ids=['ddrnet_23-slim', 'bisenetv1_r18'])
def test_convert_maps_every_zoo_name(config):
    """The converted keys are the port's, the auxiliary heads and the
    inline trunk included; an automatic flax name the port has no module
    for raises."""
    jmodel = JMODELS.build(dict(JConfig.fromfile(config).model))
    params, stats = loss_variables(jmodel, (1, 64, 64))
    sd = flax_to_state_dict(params, stats)
    model = MODELS.build(dict(Config.fromfile(config).model))
    assert set(sd) == set(model.state_dict())
    if config == BISENETV1:
        assert {'_aux_heads_0', '_aux_heads_1'} <= set(params)
        np.testing.assert_array_equal(
            sd['backbone.backbone.layer4_1.conv2.conv.weight'].numpy(),
            params['_backbone']['ResNet_0']['layer4_1']['conv2']['conv']['kernel']
            .transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match='Dense_0'):
        flax_to_state_dict({'_backbone': {'Dense_0': {'kernel': np.zeros((1, 1, 2, 2))}}})


# ------------------------------------------------------------------ segmentors
def _segmentor_pair(config, shape, seed, extra=()):
    jcfg = JConfig.fromfile(config)
    jcfg.merge_from_dict(dict(extra))
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1, 64, 64),
                                   n_classes=jcfg.model.decode_head.num_classes,
                                   seed=seed)
    variables = jax_variables(params, stats)

    # one compile for the whole forward: at the tests' widths it costs less
    # than the forward op by op in a fresh worker
    jpredict = jax.jit(lambda v, x: jmodel.apply(v, x, method='predict'))

    def jax_logits(imgs):
        x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
        return np.asarray(jpredict(variables, x))
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(dict(extra))
    model = init_model(cfg, device='cpu')
    load_port(model, params, stats)
    return jax_logits, model


def _small_bisenet(config=BISENETV1, classes=3):
    """BiSeNetV1 at a test width (ResNet-18 trunk 16-128, context 32-128;
    ResNet-50 trunk 32-256, context 64-256), ``classes`` classes, every
    head's dropout 0."""
    model = Config.fromfile(config).model
    depth = model.backbone.backbone_cfg.depth
    base, expansion = (16, 1) if depth == 18 else (8, 4)
    context = tuple(base * expansion * 2 ** i for i in (1, 2, 3))
    aux = [dict(h, in_channels=context[0], channels=16, num_classes=classes,
                dropout_ratio=0.0) for h in model.auxiliary_head]
    return {'model.backbone.backbone_cfg': dict(type='ResNet', depth=depth,
                                                stem_channels=16,
                                                base_channels=base),
            'model.backbone.context_channels': context,
            # the fusion module takes the spatial path and the 1/8 context
            # concatenated, context_channels[1] of them
            'model.backbone.spatial_channels': (16, 16, 16, context[1] - context[0]),
            'model.backbone.out_channels': 64,
            'model.decode_head.in_channels': 64,
            'model.decode_head.channels': 32,
            'model.decode_head.num_classes': classes,
            'model.decode_head.dropout_ratio': 0.0,
            'model.auxiliary_head': aux,
            'model.data_preprocessor.size': (128, 128)}


SEGMENTORS = {'ddrnet_23-slim': (DDRNET_SLIM, (100, 156), {}),
              'ddrnet_23': (DDRNET_23, (128, 128), {}),
              'bisenetv1_r18': (BISENETV1, (96, 160), {}),
              'bisenetv1_r50_coco-stuff164k': (
                  BISENETV1_R50, (96, 128), _small_bisenet(BISENETV1_R50, 171))}


@pytest.mark.parametrize('name', list(SEGMENTORS))
def test_segmentor_predict_matches_jax(name):
    """The shipped config unchanged (full width, float32 input, 19
    classes), or BiSeNetV1 R-50's COCO-Stuff config at a test width with
    its 171 classes: ``predict`` of two seeded images, the eval step on
    the CPU too."""
    config, shape, extra = SEGMENTORS[name]
    jax_logits, model = _segmentor_pair(config, shape, seed=24, extra=extra)
    imgs = np.random.default_rng(25).integers(0, 256, (2,) + shape + (3,),
                                              dtype=np.uint8)
    ref = jax_logits(imgs)
    with torch.no_grad():
        x, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        assert x.dtype == torch.float32
        out = model.predict(x).numpy()
    classes = 171 if extra else 19
    assert out.shape == ref.shape == (2,) + shape + (classes,)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree
    step = make_eval_step(model, model.data_preprocessor)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


# ------------------------------------------------------------------ training
SMALL_DDRNET = {'model.backbone.channels': 8, 'model.backbone.ppm_channels': 16,
                'model.decode_head.in_channels': 32,
                'model.decode_head.channels': 16,
                'model.decode_head.num_classes': 3,
                'model.data_preprocessor.size': (128, 128)}


def _batch(seed=40, shape=(2, 120, 128)):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lbl = np.where(rng.random(shape) < 0.02, 255,
                   rng.integers(0, 3, shape)).astype(np.int32)
    return imgs, lbl


TRAIN = {'ddrnet_23-slim': (DDRNET_SLIM, SMALL_DDRNET),
         'ddrnet_23-slim_batch_1': (DDRNET_SLIM, SMALL_DDRNET),
         'bisenetv1_r18': (BISENETV1, _small_bisenet()),
         'bisenetv1_r50': (BISENETV1_R50, _small_bisenet(BISENETV1_R50))}
# The narrow ResNet-50 trunk's activations grow through its 16 residual
# blocks (the gradient norm is 100x ResNet-18's), and float32 rounding
# alone puts either package's step 4-8e-6 from the float64 step in loss
# and JAX's 1.1x phase 6's weight bound from it.  Its logs are held as
# ``chip_smoke.float32_bounds`` holds a float32 step on the card: within
# the larger of the bound and 3x the port's own float32 step's distance
# from its float64 step on the same inputs (``acc_seg``, an argmax, within
# one pixel at least); weights and stats within phase 6's bounds
OWN_ROUNDING = ('bisenetv1_r50',)


@pytest.mark.parametrize('name', list(TRAIN))
def test_train_step_matches_jax(name, one_thread):
    """One SGD step of the config (cut to a test width) in both packages
    from the same weights: DDRNet's OHEM pair (also at batch 1, where
    DAPPM's global branch normalizes one value per channel); BiSeNetV1's CE
    on the decode head and both auxiliary heads (``aux_0.*``, ``aux_1.*``),
    with a ResNet-18 trunk and with the ResNet-50 (bottleneck) trunk of the
    COCO-Stuff config and its LinearLR warm-up."""
    config, extra = TRAIN[name]
    jcfg = JConfig.fromfile(config)
    jcfg.merge_from_dict(extra)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    imgs, lbl = _batch(shape=(1 if name.endswith('batch_1') else 2, 120, 128))
    params, stats = loss_variables(jmodel, (1, 128, 128), n_classes=3, seed=41)
    jvars = jax_variables(params, stats)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                        batch_stats=jvars['batch_stats'],
                        opt_state=tx.init(jvars['params']))
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(extra)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    step = make_train_step(model, opt, model.data_preprocessor)
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs), torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == 1 and model.training
    own = {}
    if name in OWN_ROUNDING:
        model64 = init_model(cfg, device='cpu').double()
        model64.load_state_dict(flax_to_state_dict(params, stats))
        opt64, sched64 = build_optimizer(model64, cfg.optim_wrapper,
                                         cfg.param_scheduler)
        _, logs64 = make_train_step(model64, opt64, model64.data_preprocessor)(
            create_train_state(model64, opt64, sched64), torch.from_numpy(imgs),
            torch.from_numpy(lbl.astype(np.int64)))
        own = {k: 3 * abs(logs[k].item() - logs64[k].item()) for k in logs}
        own['grad_norm'] /= logs64['grad_norm'].item()
        one_pixel = 100.0 / int((lbl != 255).sum())    # acc_seg is an argmax
        own.update({k: max(v, 1.01 * one_pixel) for k, v in own.items()
                    if k.endswith('acc_seg')})

    state, jlogs = jmake_train_step(jmodel, tx, jpre)(state, jnp.asarray(imgs),
                                                      jnp.asarray(lbl))
    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    want_keys = ({f'{p}.{k}' for p in ('decode', 'aux_0', 'aux_1')
                  for k in ('loss_ce', 'acc_seg')} if name.startswith('bisenetv1')
                 else {'decode.loss_context', 'decode.loss_spatial',
                       'decode.acc_seg'})
    assert set(logs) - {'loss', 'grad_norm'} == keys == want_keys
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= max(
        1e-5, own.get('loss', 0.0))
    for k in keys:
        assert logs[k].item() == pytest.approx(
            float(jlogs[k]), rel=1e-4, abs=max(1e-5, own.get(k, 0.0))), k
    assert logs['grad_norm'].item() == pytest.approx(
        float(jlogs['grad_norm']), rel=max(1e-3, own.get('grad_norm', 0.0)))
    want = flax_to_state_dict(jax.device_get(state.params),
                              jax.device_get(state.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, ref in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        stat = k.endswith('running_mean') or k.endswith('running_var')
        np.testing.assert_allclose(
            got[k].numpy(), ref.numpy(), err_msg=k,
            **(dict(atol=1e-5, rtol=1e-4) if stat else dict(atol=1e-4, rtol=5e-3)))


def test_bisenetv1_lr_chain_matches_jax():
    """LinearLR (start_factor 0.1 over 1000 iterations), then PolyLR to
    eta_min 1e-4 at 160000."""
    cfg = Config.fromfile(BISENETV1)
    base = cfg.optim_wrapper.optimizer.lr
    lr = build_lr_schedule(cfg.param_scheduler, base)
    jlr = joptim.build_lr_schedule(JConfig.fromfile(BISENETV1).param_scheduler, base)
    for step in (0, 999, 1000, 159999, 160000):
        assert lr(step) == pytest.approx(float(jlr(step)), rel=1e-6, abs=1e-12), step
    assert lr(0) == pytest.approx(0.1 * base, rel=1e-6)
    assert lr(1000) == pytest.approx(base, rel=1e-6)
    assert lr(160000) == pytest.approx(1e-4, rel=1e-6)


# ------------------------------------------------------------------ runner
def test_ddrnet_runner_val_matches_jax(tmp_path, one_thread):
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu_torch.datasets.synthetic import make_cityscapes_tree
    from lednet_tpu_torch.engine.runner import Runner
    root = make_cityscapes_tree(str(tmp_path / 'cityscapes'), n_train=1,
                                n_val=3, size_hw=(128, 256), seed=1)
    options = dict(SMALL_DDRNET, **{
        f'{k}.dataset.data_root': root for k in
        ('train_dataloader', 'val_dataloader', 'test_dataloader')},
        **{'val_dataloader.num_workers': 2, 'val_batch_size': 1,
           'vis_backends': None})

    def config(cls):
        cfg = cls.fromfile(DDRNET_SLIM)
        cfg.merge_from_dict(options)
        cfg.val_dataloader.dataset.pipeline[1]['scale'] = (256, 128)
        return cfg
    jrunner = JRunner(config(JConfig), work_dir=str(tmp_path / 'jax'))
    params, stats = loss_variables(jrunner.model, (1, 128, 128), seed=42)
    variables = jax_variables(params, stats)
    # the eval step reads only the weights: no jitted init, no optimizer
    # state to compile
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.val()

    runner = Runner(config(Config), work_dir=str(tmp_path / 'port'),
                    device='cpu')
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    got = runner.val()
    assert 1.0 < want['aAcc'] < 95.0 and want['mIoU'] > 0.1   # not degenerate
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


def _decide(kind, x, labels):
    """The output of the op that decides ``kind``."""
    import torch.nn.functional as F
    from lednet_tpu_torch.models.losses import OhemCrossEntropy
    from lednet_tpu_torch.ops.pool import max_pool2d
    if kind == 'ohem':
        return OhemCrossEntropy(thres=0.7, min_kept=10)(x, labels)
    return F.relu(x) if kind == 'relu' else max_pool2d(x, 3, 2, 1)


def _decision(kind, x, labels):
    """The decision ``_decide`` makes on ``x``."""
    import torch.nn.functional as F
    from lednet_tpu_torch.models.losses import OhemCrossEntropy
    if kind == 'ohem':
        t, valid, p_gt = OhemCrossEntropy(thres=0.7, min_kept=10).threshold(
            x, labels)
        return valid & (p_gt < t)
    if kind == 'relu':
        return x > 0
    return F.max_pool2d(x, 3, 2, 1, return_indices=True)[1]


@pytest.mark.parametrize('kind', ['ohem', 'relu', 'max_pool'])
def test_chip_smoke_pins_decisions(kind):
    """``chip_smoke.decisions``, which phase 10 uses to hold a float32 train
    step: it records each call's decision (OHEM's kept pixels, the ReLU
    mask, the max pool's choice), counts the elements where a later call
    decides otherwise, and with ``pin`` follows the recorded decision."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 2, (2, 5, 6, 7)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, (2, 6, 7)))
    labels[0, 0, :3] = 255
    ref = _decide(kind, x, labels)
    kept = []
    with chip_smoke.decisions(kept):
        got = _decide(kind, x, labels)
    assert len(kept) == 1 and torch.equal(kept[0], _decision(kind, x, labels))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    moved = x + torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    own_out, own = _decide(kind, moved, labels), _decision(kind, moved, labels)
    if kind == 'ohem':
        pix = torch.nn.functional.cross_entropy(moved, labels.clamp_max(4),
                                                reduction='none')
        pinned = pix[kept[0]].mean()
    elif kind == 'relu':
        pinned = moved * kept[0]
    else:
        pinned = moved.flatten(2).gather(2, kept[0].flatten(2)).view_as(own_out)
    for pin in (False, True):
        flips = {}
        with chip_smoke.decisions(kept, flips, pin):
            got = _decide(kind, moved, labels)
        assert flips[kind] == int((own != kept[0]).sum()) > 0
        torch.testing.assert_close(got, pinned if pin else own_out,
                                   rtol=1e-6, atol=0)
    torch.testing.assert_close(_decide(kind, x, labels), ref, rtol=0, atol=0)
