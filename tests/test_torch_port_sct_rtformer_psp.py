"""PyTorch port: SCTNet, RTFormer, PSPNet / DeepLabV3+ heads and DSNet
against ``lednet_tpu`` on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- the bricks in eval mode, rel 1e-5 of the largest output: ``DAPPM`` with
  ``conv_bias`` and with a ``norm_cfg``; SCTNet's basic block,
  ``ConvolutionalAttention`` at in != 64 (a swapped bank axis fails),
  ``act_dn``'s two axes, ``CFBlock``, SCTNet narrow and ``SCTHead``;
  RTFormer's double norm (softmax over the tokens, not the keys), external
  and cross-resolution attention (the 12x12 pool of a map both larger and
  smaller than 12), ``ConvFFN``, both blocks and RTFormer narrow with and
  without ``layer3h_0``'s projection; ``adaptive_avg_pool2d`` where bins
  overlap or outnumber the input; ``PSPHead``, ``ASPPHead`` on a map wider
  than 2 * 36 + 1 and DeepLabV3+'s head with its c1 skip; ``MFACB``,
  ``SPASPP``, ``_SegHead`` and DSNet narrow in eval and train mode (its
  three outputs, and the BatchNorm stats after the train-mode forward);
- the SCTNet-B, RTFormer-Base / Slim, PSPNet R50-D8 and DeepLabV3+ R50-D8
  configs: built unchanged at full width, every flax leaf lands on a port
  key and none is left over; narrow copies give logits within 1e-4 x
  max|logit|, argmax agreement >= 99.9%, the CPU eval step equal to
  ``predict``;
- DSNet's config builds the module at full width (every leaf maps), and
  ``init_model`` and ``Runner`` refuse it: it is not a segmentor;
- one train step each of SCTNet (OHEM), RTFormer (OHEM on two heads) and
  DeepLabV3+ (CE, auxiliary FCN head), dropout and drop path 0: loss
  within 1e-5, every weight within atol 1e-4 / rtol 5e-3, the BatchNorm
  running stats within atol 1e-5 / rtol 1e-4 (the bounds of
  ``tests/test_torch_port_train.py``);
- ``convert.py``'s raw banks (``kv`` / ``kv3`` transposed as kernels,
  ``k`` / ``v`` kept, a bank of another rank raising) and
  ``init_weights``' draws for them and for flax's default-initialised
  convs.

torch runs on one thread in every test here (``one_thread``).  A JAX
brick's reference runs op by op, without ``jax.jit``; a segmentor's
``predict`` is jitted (one compile cost less than the forward op by op in
a fresh worker: 14.4 s against 40.0 for the five); the three train steps
are the JAX package's jitted step.
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
from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                     make_eval_step, make_train_step)
from lednet_tpu_torch.registry import MODELS
from test_torch_port_common import (REPO, jax_variables, load_port, nchw,
                                    nhwc, random_variables, rel_err)
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_bisenetv2_hrnet import _pair
from test_torch_port_zoo import _apply, _hold, _normal, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

CONFIGS = {
    'sctnet': f'{REPO}/configs/sctnet/sctnet-b_cityscapes-1024x1024.py',
    'rtformer_base': f'{REPO}/configs/rtformer/rtformer-base_cityscapes-1024x1024.py',
    'rtformer_slim': f'{REPO}/configs/rtformer/rtformer-slim_cityscapes-1024x1024.py',
    'pspnet': f'{REPO}/configs/pspnet/pspnet_r50-d8_cityscapes-512x1024.py',
    'deeplabv3plus': f'{REPO}/configs/deeplabv3plus/'
                     'deeplabv3plus_r50-d8_cityscapes-512x1024.py'}
DSNET = f'{REPO}/configs/dsnet/dsnet-s_cityscapes-1024x1024.py'
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


# narrow copies of the configs: every structural choice kept, widths cut
_R50_NARROW = {'model.backbone.stem_channels': 16,
               'model.backbone.base_channels': 8}   # stages 32, 64, 128, 256
NARROW = {
    'sctnet': {'model.backbone.base_channels': 12,   # 4c = 48, 8c = 96: not 64
               'model.backbone.spp_channels': 16,
               'model.backbone.drop_path_rate': 0.0,
               'model.decode_head.in_channels': 48,
               'model.decode_head.channels': 16,
               'model.decode_head.dropout_ratio': 0.0},
    'rtformer_base': {'model.backbone.base_channels': 8,
                      'model.backbone.high_channels': 24,   # != 2c: projected
                      'model.backbone.ppm_channels': 16,
                      'model.backbone.num_tokens': 20,
                      'model.decode_head.in_channels': 48,
                      'model.decode_head.channels': 16,
                      'model.auxiliary_head.in_channels': 24,
                      'model.auxiliary_head.channels': 8},
    'rtformer_slim': {'model.backbone.base_channels': 8,
                      'model.backbone.high_channels': 16,
                      'model.backbone.ppm_channels': 16,
                      'model.decode_head.in_channels': 32,
                      'model.decode_head.channels': 16,
                      'model.auxiliary_head.in_channels': 16,
                      'model.auxiliary_head.channels': 8},
    'pspnet': dict(_R50_NARROW, **{'model.decode_head.in_channels': 256,
                                   'model.decode_head.channels': 16,
                                   'model.auxiliary_head.in_channels': 128,
                                   'model.auxiliary_head.channels': 8}),
    'deeplabv3plus': dict(_R50_NARROW, **{
        'model.decode_head.in_channels': 256,
        'model.decode_head.channels': 16,
        'model.decode_head.c1_in_channels': 32,
        'model.decode_head.c1_channels': 8,
        'model.auxiliary_head.in_channels': 128,
        'model.auxiliary_head.channels': 8})}


def _configs(name, extra=None, classes=None):
    """The (JAX, port) configs of ``name``, with ``extra`` merged and the
    heads cut to ``classes``."""
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(CONFIGS[name])
        more = dict(extra or {})
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
def _no_dropout(name):
    extra = dict(NARROW[name], **{'model.data_preprocessor.size': (64, 64)})
    extra['model.decode_head.dropout_ratio'] = 0.0
    if name != 'sctnet':
        extra['model.auxiliary_head.dropout_ratio'] = 0.0
    if name == 'deeplabv3plus':
        extra.update(_DEEPLAB_R18)
    return extra


TRAIN = {'sctnet': ('decode',), 'rtformer_base': ('decode', 'aux'),
         'deeplabv3plus': ('decode', 'aux')}
# DeepLabV3+'s step over a ResNetV1c-18 trunk (stages 8-64): over the
# narrow R50 trunk's 16 bottlenecks float32 rounding grows toward the
# stem in both packages (seed 70: the port's float32 step 5.9e-4 from its
# float64 step at stem1's weights, 0.08% in the gradient norm; JAX's
# 2.0e-3 and 0.33%), past phase 6's bounds with nothing wrong in either.
# Over 18 layers both lie within 1.2e-5 of the float64 step.  The R50-D8
# trunk's forward is held by ``test_segmentor_predict_matches_jax``
_DEEPLAB_R18 = {'model.backbone.depth': 18,
                'model.decode_head.in_channels': 64,
                'model.decode_head.c1_in_channels': 8,
                'model.auxiliary_head.in_channels': 32}


@pytest.mark.parametrize('name', list(TRAIN))
def test_train_step_matches_jax(name):
    """One SGD step of the narrow config in both packages from the same
    weights and batch (4 x 64x64, 3 classes, dropout and drop path 0):
    SCTNet's OHEM on its one head, RTFormer's OHEM on the decode head at
    1.0 and the auxiliary head at 0.4, DeepLabV3+'s CE at 1.0 / 0.4 through
    its c1 skip (over ``_DEEPLAB_R18``).  Batch 4: a global pool's 1x1 map (DAPPM's last branch,
    ASPP's image pool) is BatchNormed over 4 values a channel."""
    jcfg, cfg = _configs(name, _no_dropout(name), classes=3)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    shape = (4, 64, 64)
    rng = np.random.default_rng(70)
    imgs = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lbl = np.where(rng.random(shape) < 0.02, 255,
                   rng.integers(0, 3, shape)).astype(np.int32)
    params, stats = loss_variables(jmodel, (1,) + shape[1:], n_classes=3,
                                   seed=71)
    before = flax_to_state_dict(params, stats)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    step = make_train_step(model, opt, model.data_preprocessor)
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs),
                        torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == 1 and model.training

    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    jvars = jax_variables(params, stats)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                         batch_stats=jvars['batch_stats'],
                         opt_state=tx.init(jvars['params']))
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))

    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    loss = 'loss_ce' if name == 'deeplabv3plus' else 'loss_ohem'
    assert set(logs) - {'loss', 'grad_norm'} == keys == {
        f'{h}.{k}' for h in TRAIN[name] for k in (loss, 'acc_seg')}
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    # acc_seg is an argmax of logits upsampled 8x: a near-tie of one 1/8
    # logit, within float32 rounding, decides up to an 8x8 block of pixels
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
    moved = stat_moved = 0.0
    for k, ref in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        stat = k.endswith('running_mean') or k.endswith('running_var')
        np.testing.assert_allclose(
            got[k].numpy(), ref.numpy(), err_msg=k,
            **(dict(atol=1e-5, rtol=1e-4) if stat else dict(atol=1e-4, rtol=5e-3)))
        diff = (got[k] - before[k]).abs().max().item()
        if stat:
            stat_moved = max(stat_moved, diff)
        else:
            moved = max(moved, diff)
    assert moved > 1e-4 and stat_moved > 1e-3


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', list(NARROW))
def test_segmentor_predict_matches_jax(name):
    """The narrow copy of the config (19 classes, float32 input):
    ``predict`` of two seeded images, the CPU eval step equal to it.  At
    128x192 SCTNet's and RTFormer's 1/32 map is 4x6 (RTFormer pools it to
    12x12: more bins than cells); at 72x104 the D8 trunk's 1/8 map is
    9x13, on which PSPNet's 3- and 6-bin pools overlap."""
    jcfg, cfg = _configs(name, NARROW[name])
    shape = (128, 192) if name != 'pspnet' else (72, 104)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1,) + shape, n_classes=19, seed=30)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    imgs = np.random.default_rng(31).integers(0, 256, (2,) + shape + (3,),
                                              dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    # one compile: at these widths it costs less than the forward op by op
    # in a fresh worker
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


def _full_width_leaves(jmodel, shape, method=None):
    """Every flax leaf of ``jmodel`` at its full width (shapes only, from
    ``jax.eval_shape``: nothing runs), converted."""
    x = jnp.zeros(shape + (3,))
    key = jax.random.PRNGKey(0)
    if method == 'loss':
        lbl = jnp.zeros(shape[:3], jnp.int32)
        tree = jax.eval_shape(lambda: jmodel.init(
            {'params': key, 'dropout': key}, x, lbl, method='loss'))
    else:
        tree = jax.eval_shape(lambda: jmodel.init(key, x))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   {k: dict(v) for k, v in tree.items()})
    return flax_to_state_dict(zeros['params'], zeros.get('batch_stats', {}))


@pytest.mark.parametrize('name', list(CONFIGS) + ['dsnet'])
def test_config_builds_and_every_leaf_maps(name):
    """The config unchanged, at full width: every converted flax leaf is a
    port key of the same shape, and none of the port's is left over."""
    if name == 'dsnet':
        jmodel = JMODELS.build(dict(JConfig.fromfile(DSNET).model))
        port = MODELS.build(dict(Config.fromfile(DSNET).model))
        sd = _full_width_leaves(jmodel, (1, 64, 64))
    else:
        jmodel = JMODELS.build(dict(JConfig.fromfile(CONFIGS[name]).model))
        port = init_model(CONFIGS[name], device='cpu')
        sd = _full_width_leaves(jmodel, (1, 64, 64), method='loss')
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    port.load_state_dict(sd)


def test_dsnet_is_a_module_not_a_segmentor(tmp_path):
    """DSNet's config builds the ``DSNet`` module; ``init_model`` and
    ``Runner`` raise on it, as the JAX package's fail on its missing
    ``loss``."""
    from lednet_tpu_torch.engine.runner import Runner
    from lednet_tpu_torch.models.backbones.dsnet import DSNet
    cfg = Config.fromfile(DSNET)
    assert isinstance(MODELS.build(dict(cfg.model)), DSNet)
    with pytest.raises(TypeError, match='DSNet is not a segmentor'):
        init_model(DSNET, device='cpu')
    with pytest.raises(TypeError, match='not a segmentor'):
        Runner(cfg, work_dir=str(tmp_path), device='cpu')


# ------------------------------------------------------------------ DSNet
NARROW_DSNET = dict(m=2, n=2, num_classes=5, planes=8)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_dsnet_matches_jax(train):
    """DSNet narrow at 96x128 (1/8 is 12x16): its three outputs, in eval
    mode within the bricks' 1e-5; in train mode at batch 4 (SPASPP's pooled
    branch is BatchNormed over one value per image) within the segmentors'
    1e-4, and the BatchNorm running stats after the forward.  Batch
    statistics through 68 BatchNorms round in float32 in both packages
    (seed 40, main output: the port 1.0e-5 from its float64 forward, JAX
    3.7e-5)."""
    from lednet_tpu.models.backbones.dsnet import DSNet as J
    from lednet_tpu_torch.models.backbones.dsnet import DSNet
    batch = 4 if train else 2
    x = _normal((batch, 96, 128, 3), seed=40)
    jmod = J(**NARROW_DSNET)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=41)
    port = load_port(DSNet(**NARROW_DSNET), params, stats)
    variables = jax_variables(params, stats)
    if train:
        ref, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                                  mutable=['batch_stats'])
        port.train()
    else:
        ref = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = port(nchw(x))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        assert o.shape == (batch, 5, 96, 128)
        _hold(nhwc(o), r, TOL_MODEL if train else 1e-5)
    if train:
        want = flax_to_state_dict(params, jax.device_get(mutated['batch_stats']))
        got = port.state_dict()
        for k in want:
            if k.endswith('running_mean') or k.endswith('running_var'):
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           atol=1e-5, rtol=1e-4, err_msg=k)
    single = DSNet(**dict(NARROW_DSNET, augment=False))
    single.load_state_dict({k: v for k, v in port.state_dict().items()
                            if not k.startswith('seghead')})
    with torch.no_grad():
        main = single.eval()(nchw(x))
    assert main.shape == (batch, 5, 96, 128)


@pytest.mark.parametrize('stride', [1, 2])
def test_mfacb_matches_jax(stride):
    from lednet_tpu.models.backbones.dsnet import MFACB as J
    from lednet_tpu_torch.models.backbones.dsnet import MFACB
    ref, out = _pair(J(8, 6, 12, stride, (2, 3, 5)),
                     MFACB(8, 6, 12, stride, (2, 3, 5)),
                     _normal((2, 13, 17, 8), seed=42), seed=43)
    _hold(nhwc(out), ref)


def test_spaspp_matches_jax():
    """On a 30x52 map, so that the dilation-24 taps land inside."""
    from lednet_tpu.models.backbones.dsnet import SPASPP as J
    from lednet_tpu_torch.models.backbones.dsnet import SPASPP
    ref, out = _pair(J(8, 6, 10), SPASPP(8, 6, 10),
                     _normal((2, 30, 52, 8), seed=44), seed=45)
    _hold(nhwc(out), ref)


def test_seg_head_matches_jax():
    """``conv1`` normalizes ``relu(x)`` (its input width), no activation
    after it; a ReLU, then the biased 1x1 ``conv2``."""
    from lednet_tpu.models.backbones.dsnet import _SegHead as J
    from lednet_tpu_torch.models.backbones.dsnet import _SegHead
    port = _SegHead(12, 8, 5)
    assert port.conv1.norm.bn.num_features == 12
    ref, out = _pair(J(12, 8, 5), port, _normal((2, 9, 11, 12), seed=46),
                     seed=47)
    _hold(nhwc(out), ref)


# ------------------------------------------------------------------ heads
def _head_pair(cfg, feats, seed):
    """(JAX logits, port logits, JAX head, port head) of a head config on
    ``feats`` (a list of NHWC maps, or one map)."""
    jhead = JMODELS.build(dict(cfg))
    jin = ([jnp.asarray(f) for f in feats] if isinstance(feats, list)
           else jnp.asarray(feats))
    params, stats = random_variables(jhead, jin, seed=seed)
    head = load_port(MODELS.build(dict(cfg)), params, stats)
    pin = [nchw(f) for f in feats] if isinstance(feats, list) else nchw(feats)
    with torch.no_grad():
        out = head(pin)
    return _apply(jhead, params, stats, jin), out, jhead, head


@pytest.mark.parametrize('hw', [(10, 13), (4, 5)], ids=['overlap', 'small'])
def test_psp_head_matches_jax(hw):
    """``PSPHead`` at pool scales (1, 2, 3, 6): at 10x13 the 3- and 6-bins
    overlap; at 4x5 six bins outnumber the rows; logits and loss."""
    cfg = dict(type='PSPHead', in_channels=16, channels=8, num_classes=5,
               in_index=1, dropout_ratio=0.0)
    feats = [_normal((2, 20, 26, 4), seed=50), _normal((2,) + hw + (16,), seed=51)]
    ref, out, jhead, head = _head_pair(cfg, feats, seed=52)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(53).integers(0, 5, (2, 40, 52)).astype(np.int32)
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_ce', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


@pytest.mark.parametrize('kind', ['aspp', 'separable', 'deeplabv3plus'])
def test_aspp_head_matches_jax(kind):
    """The ASPP head alone on a 74x76 map, wider than 2 * 36 + 1, so that
    every tap of the dilation-36 branch lands inside: plain dilated 3x3s,
    separable ones, and DeepLabV3+'s head on the backbone's tuple (its c1
    skip from the 148x152 first map, concatenated after the resized
    output)."""
    if kind == 'deeplabv3plus':
        cfg = dict(type='DepthwiseSeparableASPPHead', in_channels=12,
                   channels=8, num_classes=5, in_index=1, c1_in_channels=6,
                   c1_channels=4, dropout_ratio=0.0)
        feats = [_normal((1, 148, 152, 6), seed=54), _normal((1, 74, 76, 12), seed=55)]
    else:
        cfg = dict(type='ASPPHead', in_channels=12, channels=8, num_classes=5,
                   separable=kind == 'separable', dropout_ratio=0.0)
        feats = _normal((1, 74, 76, 12), seed=55)
    ref, out, _, head = _head_pair(cfg, feats, seed=56)
    want = (1, 5) + ((148, 152) if kind == 'deeplabv3plus' else (74, 76))
    assert tuple(out.shape) == want
    _hold(nhwc(out), ref)
    assert (type(head.aspp3).__name__ == '_SepConv') == (kind != 'aspp')


def test_sct_head_matches_jax():
    """Pre-activation ``conv1`` (BatchNorm over the 20 input channels), then
    ``bn2``, ReLU and ``cls``; logits and loss."""
    cfg = dict(Config.fromfile(CONFIGS['sctnet']).model.decode_head,
               in_channels=20, channels=8, num_classes=5, dropout_ratio=0.0)
    feats = [_normal((2, 9, 13, 20), seed=57), _normal((2, 9, 13, 10), seed=58)]
    ref, out, jhead, head = _head_pair(cfg, feats, seed=59)
    assert head.conv1.norm.bn.num_features == 20
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(60).integers(0, 5, (2, 72, 104)).astype(np.int32)
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_ohem', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


@pytest.mark.parametrize('hw,size', [((11, 13), 3), ((4, 5), 12),
                                     ((20, 14), 6)],
                         ids=['overlap', 'outnumber', 'mixed'])
def test_adaptive_avg_pool_matches_jax(hw, size):
    """torch's floor/ceil bins against the JAX package's averaging
    matrices, where bins overlap and where they outnumber the cells."""
    from lednet_tpu.ops.pool import adaptive_avg_pool2d as jpool
    from lednet_tpu_torch.ops.pool import adaptive_avg_pool2d
    x = _normal((2,) + hw + (3,), seed=61)
    ref = np.asarray(jpool(jnp.asarray(x), size))
    out = nhwc(adaptive_avg_pool2d(nchw(x), size))
    assert out.shape == ref.shape == (2, size, size, 3)
    assert np.abs(out - ref).max() <= 1e-6


# ------------------------------------------------------------------ SCTNet
@pytest.mark.parametrize('option', ['conv_bias', 'norm_cfg'])
def test_dappm_options_match_jax(option):
    """SCTNet's DAPPM (biased convs) and RTFormer's (its config's SyncBN,
    no momentum: 0.1 as by default), in train mode: outputs and stats."""
    from lednet_tpu.models.ppm import DAPPM as J
    from lednet_tpu_torch.models.ppm import DAPPM
    kw = (dict(conv_bias=True) if option == 'conv_bias'
          else dict(norm_cfg=dict(type='SyncBN', requires_grad=True)))
    x = _normal((2, 16, 24, 12), seed=62)
    jmod = J(12, 6, 10, num_scales=5, **kw)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=63)
    port = load_port(DAPPM(12, 6, 10, num_scales=5, **kw), params, stats)
    assert (port.process0.conv.bias is not None) == (option == 'conv_bias')
    assert (port.shortcut.conv.bias is not None) == (option == 'conv_bias')
    with torch.no_grad():
        _hold(nhwc(port(nchw(x))), _apply(jmod, params, stats, jnp.asarray(x)))
        port.train()
        out = port(nchw(x))
    ref, mutated = jmod.apply(jax_variables(params, stats), jnp.asarray(x),
                              train=True, mutable=['batch_stats'])
    _hold(nhwc(out), ref)
    want = flax_to_state_dict(params, jax.device_get(mutated['batch_stats']))
    for k, v in port.state_dict().items():
        if k.endswith('running_var') or k.endswith('running_mean'):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)


@pytest.mark.parametrize('cin,cout,stride,no_relu', [(8, 8, 1, True),
                                                      (8, 12, 2, False)],
                         ids=['same', 'down'])
def test_sct_basic_block_matches_jax(cin, cout, stride, no_relu):
    from lednet_tpu.models.backbones.sctnet import _SCTBasicBlock as J
    from lednet_tpu_torch.models.backbones.sctnet import _SCTBasicBlock
    port = _SCTBasicBlock(cin, cout, stride, no_relu)
    assert (port.down is None) == (stride == 1 and cin == cout)
    ref, out = _pair(J(cin, cout, stride, no_relu), port,
                     _normal((2, 11, 14, cin), seed=64), seed=65)
    _hold(nhwc(out), ref)
    assert (nhwc(out) < 0).any() == no_relu


@pytest.mark.parametrize('cin', [24, 96])
def test_convolutional_attention_matches_jax(cin):
    """At in != 64 the banks are not square: a bank loaded with its in and
    out axes swapped cannot load, and one transposed in its spatial axes
    gives other numbers."""
    from lednet_tpu.models.backbones.sctnet import ConvolutionalAttention as J
    from lednet_tpu_torch.models.backbones.sctnet import ConvolutionalAttention
    x = _normal((2, 9, 13, cin), seed=66)
    jmod = J(cin, cin)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=67)
    port = load_port(ConvolutionalAttention(cin, cin), params, stats)
    assert tuple(port.kv.shape) == (64, cin, 7, 1)
    assert tuple(port.kv3.shape) == (64, cin, 1, 7)
    np.testing.assert_array_equal(port.kv.detach().numpy()[:, :, :, 0],
                                  params['kv'][:, 0].transpose(2, 1, 0))
    with torch.no_grad():
        out = port(nchw(x))
    ref = _apply(jmod, params, stats, jnp.asarray(x))
    _hold(nhwc(out), ref)
    with torch.no_grad():
        port.kv.copy_(port.kv.flip(2))
        flipped = port(nchw(x))
    assert rel_err(nhwc(flipped), ref) > 1e-3


def test_act_dn_axes():
    """``act_dn`` on (B, 64, H, W): a softmax over the H*W positions of
    each channel, then each head's 8 channels divided by their sum + 1e-6."""
    from lednet_tpu_torch.models.backbones.sctnet import ConvolutionalAttention
    h = _normal((2, 64, 5, 7), seed=68, scale=3.0).astype(np.float64)
    flat = h.reshape(2, 8, 8, 35)
    e = np.exp(flat - flat.max(-1, keepdims=True))
    soft = e / e.sum(-1, keepdims=True)
    want = (soft / (soft.sum(2, keepdims=True) + 1e-6)).reshape(h.shape)
    got = ConvolutionalAttention(16, 16).act_dn(torch.from_numpy(h).float())
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_cfblock_matches_jax():
    """Attention then MLP (BatchNorm eps 1e-6, GELU exact), each added."""
    from lednet_tpu.models.backbones.sctnet import CFBlock as J
    from lednet_tpu_torch.models.backbones.sctnet import CFBlock
    port = CFBlock(32, 8, drop_path=0.1)
    assert port.mlp_norm.bn.eps == 1e-6
    ref, out = _pair(J(32, 8, 0.1), port, _normal((2, 7, 10, 32), seed=69),
                     seed=70)
    _hold(nhwc(out), ref)


def test_sctnet_matches_jax():
    """Narrow at 96x160: stages 12/24/48 to 1/16, 96 at 1/32 (3x5), both
    outputs at 1/8."""
    from lednet_tpu.models.backbones.sctnet import SCTNet as J
    from lednet_tpu_torch.models.backbones.sctnet import SCTNet
    kw = dict(base_channels=12, spp_channels=16, drop_path_rate=0.0)
    ref, out = _pair(J(**kw), SCTNet(**kw), _normal((1, 96, 160, 3), seed=71),
                     seed=72)
    assert [tuple(o.shape[1:]) for o in out] == [(48, 12, 20), (24, 12, 20)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


# ------------------------------------------------------------------ RTFormer
def test_double_norm_axis():
    """The port's double norm of transposed (..., m, n) logits, transposed
    back: a softmax over the tokens (JAX's axis -2), then L1 over the keys,
    equal to the JAX package's, and not to the softmax over the keys."""
    from lednet_tpu.models.backbones.rtformer import _double_norm
    from lednet_tpu_torch.models.backbones.rtformer import double_norm_t
    a = _normal((2, 3, 11, 7), seed=73, scale=2.0)
    ref = np.asarray(_double_norm(jnp.asarray(a)))
    out = double_norm_t(torch.from_numpy(a).transpose(-1, -2)).transpose(
        -1, -2).numpy()
    assert np.abs(out - ref).max() <= 1e-6
    keys_first = torch.softmax(torch.from_numpy(a), -1)
    keys_first = keys_first / (keys_first.sum(-2, keepdim=True) + 1e-6)
    assert np.abs(keys_first.numpy() - ref).max() > 1e-2


def test_external_attention_matches_jax():
    from lednet_tpu.models.backbones.rtformer import ExternalAttention as J
    from lednet_tpu_torch.models.backbones.rtformer import ExternalAttention
    port = ExternalAttention(32, 20, 4)
    assert tuple(port.k.shape) == (4, 8, 20) and tuple(port.v.shape) == (4, 20, 8)
    ref, out = _pair(J(32, 20, 4), port, _normal((2, 6, 9, 32), seed=74),
                     seed=75)
    _hold(nhwc(out), ref)


@pytest.mark.parametrize('low_hw', [(20, 26), (5, 7)], ids=['pool', 'upsample'])
def test_cross_resolution_attention_matches_jax(low_hw):
    """Keys and values from the low map pooled to 12x12: from 20x26 (bins
    overlap) and from 5x7 (bins outnumber the cells)."""
    from lednet_tpu.models.backbones.rtformer import CrossResolutionAttention as J
    from lednet_tpu_torch.models.backbones.rtformer import CrossResolutionAttention
    x_h = _normal((2, 10, 14, 16), seed=76)
    x_l = _normal((2,) + low_hw + (24,), seed=77)
    jmod = J(16, 12, 4)
    params, stats = random_variables(jmod, jnp.asarray(x_h), jnp.asarray(x_l),
                                     seed=78)
    port = load_port(CrossResolutionAttention(16, 24, 12, 4), params, stats)
    with torch.no_grad():
        out = port(nchw(x_h), nchw(x_l))
    _hold(nhwc(out), _apply(jmod, params, stats, jnp.asarray(x_h),
                            jnp.asarray(x_l)))


def test_conv_ffn_matches_jax():
    from lednet_tpu.models.backbones.rtformer import ConvFFN as J
    from lednet_tpu_torch.models.backbones.rtformer import ConvFFN
    port = ConvFFN(16)
    assert port.conv2.bias is None
    ref, out = _pair(J(16), port, _normal((2, 7, 9, 16), seed=79), seed=80)
    _hold(nhwc(out), ref)


@pytest.mark.parametrize('low_in,stride', [(16, 2), (32, 1)],
                         ids=['down', 'same'])
def test_rtformer_block_matches_jax(low_in, stride):
    from lednet_tpu.models.backbones.rtformer import RTFormerBlock as J
    from lednet_tpu_torch.models.backbones.rtformer import RTFormerBlock
    kw = dict(num_heads=4, num_tokens=12, cross_size=6, stride=stride)
    x_h = _normal((2, 16, 20, 24), seed=81)
    x_l = _normal((2, 8, 10, low_in) if stride == 2 else (2, 4, 5, low_in),
                  seed=82)
    jmod = J(low_in, 32, 24, **kw)
    params, stats = random_variables(jmod, jnp.asarray(x_h), jnp.asarray(x_l),
                                     seed=83)
    port = load_port(RTFormerBlock(low_in, 32, 24, **kw), params, stats)
    assert (port.down is None) == (stride == 1)
    with torch.no_grad():
        out = port(nchw(x_h), nchw(x_l))
    ref = _apply(jmod, params, stats, jnp.asarray(x_h), jnp.asarray(x_l))
    assert tuple(out[1].shape) == (2, 32, 4, 5)
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


@pytest.mark.parametrize('high', [16, 24], ids=['same', 'projected'])
def test_rtformer_matches_jax(high):
    """Narrow (base 8) at 128x96: ``layer3h_0`` projects only where
    ``high_channels`` != 2c; the 1/32 map is 4x3, pooled to 12x12."""
    from lednet_tpu.models.backbones.rtformer import RTFormer as J
    from lednet_tpu_torch.models.backbones.rtformer import RTFormer
    kw = dict(base_channels=8, high_channels=high, num_heads=4, num_tokens=16,
              ppm_channels=8)
    port = RTFormer(**kw)
    assert (port.layer3h_0.downsample_conv is None) == (high == 16)
    ref, out = _pair(J(**kw), port, _normal((1, 128, 96, 3), seed=84), seed=85)
    assert [tuple(o.shape[1:]) for o in out] == [(high, 16, 12),
                                                 (2 * high, 16, 12)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


# ------------------------------------------------------------------ bridge
def test_convert_raw_banks():
    """``kv`` / ``kv3`` (kh, kw, in, 64) become (64, in, kh, kw); ``k`` /
    ``v`` keep their layout; a bank of another rank raises, and so does an
    automatic flax name."""
    rng = np.random.default_rng(86)
    kv = rng.standard_normal((7, 1, 24, 64)).astype(np.float32)
    kv3 = rng.standard_normal((1, 7, 24, 64)).astype(np.float32)
    k = rng.standard_normal((8, 4, 144)).astype(np.float32)
    v = rng.standard_normal((8, 144, 4)).astype(np.float32)
    sd = flax_to_state_dict({'attn': {'kv': kv, 'kv3': kv3},
                             'low_attn': {'k': k, 'v': v}})
    np.testing.assert_array_equal(sd['attn.kv'].numpy(), kv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd['attn.kv3'].numpy(), kv3.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd['low_attn.k'].numpy(), k)
    np.testing.assert_array_equal(sd['low_attn.v'].numpy(), v)
    with pytest.raises(ValueError, match='bank'):
        flax_to_state_dict({'attn': {'kv': kv[0]}})
    with pytest.raises(ValueError, match='no port module'):
        flax_to_state_dict({'CFBlock_0': {'attn': {'kv': kv}}})


def test_init_weights_raw_banks():
    """SCTNet's banks truncated normal(0.001) at two deviations, RTFormer's
    token banks normal(0.02), flax's default-initialised convs (``cross_kv``,
    ``ConvFFN.conv2``, ``_SegHead.conv2``) LeCun normal, the rest of the
    convs kaiming-normal over fan_out; the same generator, the same draw."""
    from lednet_tpu_torch.models.backbones.dsnet import _SegHead
    from lednet_tpu_torch.models.backbones.rtformer import RTFormerBlock
    from lednet_tpu_torch.models.backbones.sctnet import CFBlock
    from lednet_tpu_torch.models.layers import init_weights
    mods = torch.nn.ModuleDict(dict(cf=CFBlock(96), rt=RTFormerBlock(64, 128, 64),
                                    seg=_SegHead(32, 48, 19)))
    init_weights(mods, torch.Generator().manual_seed(0))
    kv = mods.cf.attn.kv.detach()
    assert kv.abs().max() <= 0.002 and kv.std() == pytest.approx(
        0.001 * 0.8796, rel=0.05)
    for bank in (mods.rt.low_attn.k, mods.rt.low_attn.v):
        assert bank.std().item() == pytest.approx(0.02, rel=0.05)
    for conv in (mods.rt.high_attn.cross_kv, mods.rt.low_ffn.conv2,
                 mods.seg.conv2):
        fan_in = conv.weight[0].numel()
        assert conv.weight.std().item() == pytest.approx(fan_in ** -0.5, rel=0.1)
    w = mods.cf.mlp_conv1.weight
    assert w.std().item() == pytest.approx((2 / (w.shape[0] * 9)) ** 0.5, rel=0.05)
    again = torch.nn.ModuleDict(dict(cf=CFBlock(96), rt=RTFormerBlock(64, 128, 64),
                                     seg=_SegHead(32, 48, 19)))
    init_weights(again, torch.Generator().manual_seed(0))
    for a, b in zip(mods.parameters(), again.parameters()):
        assert torch.equal(a, b)
