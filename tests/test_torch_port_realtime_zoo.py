"""PyTorch port: the real-time Cityscapes zoo's next five families (ICNet
R-18 with its ``ICNeck``, Fast-SCNN, ERFNet, CGNet, MobileNetV3 + LR-ASPP)
against ``lednet_tpu`` on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- ``resize_bilinear(scale_factor=0.5)`` at 7x9 and 13x26, within 1e-6
  (at odd sizes the factor maps the coordinates, not the size ratio);
- ResNet-18's ceil-mode stem pool at an odd size, and ``stage_range``
  (0, 2) then (2, 4) equal to one full pass;
- the bricks in eval mode, rel 1e-5 of the largest output: ICNet narrow,
  the cascade feature fusion and ``ICNeck``; Fast-SCNN's inverted
  residual (with and without its residual), ``_PPM``, ``_StridedSep``,
  Fast-SCNN narrow and ``DepthwiseSeparableFCNHead``; ERFNet's
  ``DownsamplerBlock`` at an odd size (its pool resized to the conv's
  size), ``NonBottleneck1d`` (dilated), ``UpsamplerBlock`` (a random,
  so not symmetric, kernel: a missing flip fails) and ERFNet narrow;
  CGNet's context gate, its block with and without downsampling and CGNet
  narrow; MobileNetV3's SE block, its 'SAME' stem at an odd size and the
  'large' arch whole at an odd size; ``LRASPPHead`` on a map smaller than
  its 49-pixel pool;
- the five configs built unchanged (full width, 19 classes) at small
  inputs, ERFNet's odd and ICNet's deepest map 2x2: logits within 1e-4 x
  max|logit|, argmax agreement >= 99.9%, the CPU eval step equal to
  ``predict``, every converted key on a port key and none left over;
- one train step each of ICNet (its shared trunk entered twice, CE on the
  decode head and both auxiliary heads) and CGNet (class-weighted CE,
  Adam with decoupled weight decay), dropout 0: loss within 1e-5, every weight
  within atol 1e-4 / rtol 5e-3, the BatchNorm running stats within atol
  1e-5 / rtol 1e-4 (the bounds of ``tests/test_torch_port_train.py``);
- ``convert.py``: ERFNet's ``deconv`` flipped, UNet's not; a ``Dense`` of
  CGNet's gate to an ``nn.Linear``; ``_neck`` to ``neck``; a transposed
  conv or a 2-D kernel anywhere else raises.

torch runs on one thread in every test here (``one_thread``): its CPU
autograd aborts the process when it runs multi-threaded after the XLA CPU
runtime has run, and six workers' threads oversubscribe the cores.  A JAX
brick's reference runs op by op, without ``jax.jit``; each config's
``predict`` is jitted (one compile cost less than the forward op by op in
a fresh worker: 19.9 s against 64.8 for the five); the two train steps
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
from test_torch_port_common import (REPO, jax_variables, load_port, nchw,
                                    nhwc, random_variables, rel_err)
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_bisenetv2_hrnet import _pair
from test_torch_port_zoo import _apply, _hold, _normal, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

CONFIGS = {
    'icnet': f'{REPO}/configs/icnet/icnet_r18-d8_cityscapes-832x832.py',
    'fastscnn': f'{REPO}/configs/fastscnn/fast_scnn_cityscapes-512x1024.py',
    'erfnet': f'{REPO}/configs/erfnet/erfnet_cityscapes-512x1024.py',
    'cgnet': f'{REPO}/configs/cgnet/cgnet_cityscapes-680x680.py',
    'lraspp': f'{REPO}/configs/mobilenet_v3/lraspp_m-v3-d8_cityscapes-512x1024.py'}
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with.
# ------------------------------------------------------------------ training
def _small_icnet():
    """ICNet over a ResNet-18 of base width 16 (stages 16-128), the light
    branch at 8, the pyramid at 32, the neck and heads at 16, 3 classes
    (its heads have dropout 0 already)."""
    aux = [dict(h, in_channels=16, channels=16, num_classes=3)
           for h in Config.fromfile(CONFIGS['icnet']).model.auxiliary_head]
    return {'model.backbone.backbone_cfg': dict(type='ResNet', depth=18,
                                                stem_channels=16,
                                                base_channels=16),
            'model.backbone.light_branch_middle_channels': 8,
            'model.backbone.psp_out_channels': 32,
            'model.backbone.out_channels': (16, 32, 32),
            'model.neck.in_channels': (16, 32, 32),
            'model.neck.out_channels': 16,
            'model.decode_head.in_channels': 16,
            'model.decode_head.channels': 16,
            'model.decode_head.num_classes': 3,
            'model.auxiliary_head': aux,
            'model.data_preprocessor.size': (256, 256)}


# CGNet at widths (8, 16, 32) with (2, 3) blocks; its 19 classes stay, so
# that the config's 19 class weights apply
SMALL_CGNET = {'model.backbone.num_channels': (8, 16, 32),
               'model.backbone.num_blocks': (2, 3),
               'model.decode_head.in_channels': 64,
               'model.decode_head.channels': 64,
               'model.data_preprocessor.size': (64, 64)}

TRAIN = {'icnet': (CONFIGS['icnet'], _small_icnet(), (2, 256, 256), 3),
         'cgnet': (CONFIGS['cgnet'], SMALL_CGNET, (2, 64, 64), 19)}


@pytest.mark.parametrize('name', list(TRAIN))
def test_train_step_matches_jax(name):
    """One step of the config (cut to a test width) in both packages from
    the same weights and batch: ICNet's SGD step through its trunk entered
    twice (one set of BatchNorm running stats updated by both calls), the
    neck and CE at 1.0 / 0.4 / 0.4 on the decode head and both auxiliary
    heads; CGNet's Adam step (decoupled weight decay 5e-4, as the JAX
    package's) on the class-weighted CE.
    ICNet's 256x256 crops keep its deepest map at 2x2."""
    config, extra, shape, classes = TRAIN[name]
    jcfg = JConfig.fromfile(config)
    jcfg.merge_from_dict(extra)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    rng = np.random.default_rng(60)
    imgs = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lbl = np.where(rng.random(shape) < 0.02, 255,
                   rng.integers(0, classes, shape)).astype(np.int32)
    params, stats = loss_variables(jmodel, (1,) + shape[1:], n_classes=classes,
                                   seed=61)
    before = flax_to_state_dict(params, stats)
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(extra)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    # the JAX package's Adam decays decoupled: torch's AdamW for either type
    assert isinstance(opt.optimizer, torch.optim.AdamW if name == 'cgnet'
                      else torch.optim.SGD)
    step = make_train_step(model, opt, model.data_preprocessor)
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs), torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == 1 and model.training
    own = {}
    if name == 'icnet':
        # ICNet's float32 gradients round far: its trunk's deepest maps are
        # 2x2 and its pyramid's first BatchNorm normalizes 2 values per
        # channel.  Its gradient norm is held within 3x the port's own
        # float32 step's distance from its float64 step (at this seed
        # 1.5e-3 relative, JAX's 0.4e-3), as ``chip_smoke.float32_bounds``
        # holds a float32 step, and at least to 1e-3
        model64 = init_model(cfg, device='cpu').double()
        model64.load_state_dict(before)
        opt64, sched64 = build_optimizer(model64, cfg.optim_wrapper,
                                         cfg.param_scheduler)
        _, logs64 = make_train_step(model64, opt64, model64.data_preprocessor)(
            create_train_state(model64, opt64, sched64), torch.from_numpy(imgs),
            torch.from_numpy(lbl.astype(np.int64)))
        own['grad_norm'] = 3 * abs(logs['grad_norm'].item() /
                                   logs64['grad_norm'].item() - 1)

    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    jvars = jax_variables(params, stats)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                         batch_stats=jvars['batch_stats'],
                         opt_state=tx.init(jvars['params']))
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))

    heads = ('decode', 'aux_0', 'aux_1') if name == 'icnet' else ('decode',)
    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    assert set(logs) - {'loss', 'grad_norm'} == keys == {
        f'{h}.{k}' for h in heads for k in ('loss_ce', 'acc_seg')}
    tol = 1e-5
    if name == 'cgnet':
        # JAX's class-weighted CE sums 8,192 pixels weighted 2.6-10.4 in
        # float32 in an order that alone puts it 2.5e-5 from the float64
        # loss of its own logits at this seed (the port's sum: 2.5e-7): the
        # port is held to that float64 loss within 1e-5, and to JAX's loss
        # within 1e-5 plus JAX's own rounding
        exact = _float64_ce(jmodel, jax_variables(params, stats), jpre, imgs, lbl,
                            jcfg.model.decode_head.loss_decode.class_weight)
        assert abs(logs['loss'].item() - exact) <= 1e-5
        tol += abs(float(jlogs['loss']) - exact)
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= tol
    # acc_seg is an argmax of logits upsampled 8x: a near-tie of one 1/8
    # logit, within float32 rounding, decides up to an 8x8 block of pixels
    # (ICNet's decode head: 2 of 128,000 pixels at this seed)
    block = 64 * 100.0 / int((lbl != 255).sum())
    for k in keys:
        tol = dict(rel=0, abs=1.01 * block) if k.endswith('acc_seg') \
            else dict(rel=1e-4, abs=1e-5)
        assert logs[k].item() == pytest.approx(float(jlogs[k]), **tol), k
    assert logs['grad_norm'].item() == pytest.approx(
        float(jlogs['grad_norm']), rel=max(1e-3, own.get('grad_norm', 0.0)))
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
        moved = max(moved, (got[k] - before[k]).abs().max().item())
    assert moved > 1e-4
    if name == 'icnet':
        # the trunk's two calls ran in train mode: the first through the
        # stem and stages 1-2, the second through stages 3-4
        for bn in ('stem', 'layer1_0.conv1', 'layer4_1.conv2'):
            assert int(got[f'backbone.backbone.{bn}.norm.bn.'
                           'num_batches_tracked']) == 1, bn


def _float64_ce(jmodel, variables, jpre, imgs, lbl, class_weight):
    """The class-weighted CE of the JAX segmentor's train-mode decode
    logits (resized to the labels) on ``imgs``, summed in float64."""
    from lednet_tpu.ops.resize import resize_bilinear as jresize
    x, labels, _ = jpre(jnp.asarray(imgs), jnp.asarray(lbl), training=True)
    logits, _ = jmodel.apply(variables, x, True, mutable=['batch_stats'])
    logits = np.asarray(jresize(logits, lbl.shape[1:]), np.float64)
    labels = np.asarray(labels)
    valid = labels != 255
    safe = np.where(valid, labels, 0)
    logp = logits - logits.max(-1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    w = np.asarray(class_weight, np.float64)[safe] * valid
    nll = -np.take_along_axis(logp, safe[..., None], -1)[..., 0]
    return float((nll * w).sum() / w.sum())


# ------------------------------------------------------------------ configs
SEGMENTORS = {'icnet': (256, 256), 'fastscnn': (128, 256), 'erfnet': (100, 150),
              'cgnet': (96, 96), 'lraspp': (128, 128)}


@pytest.mark.parametrize('name', list(SEGMENTORS))
def test_segmentor_predict_matches_jax(name):
    """The config unchanged (full width, 19 classes, float32 input):
    ``predict`` of two seeded images, every converted key on a port key,
    the CPU eval step equal to it.  ERFNet's 100x150 takes its
    downsamplers' odd path (a 25x38 map pooled to 12x19, resized to the
    conv's 13x19); ICNet's 256x256 gives its trunk a ceil-mode pool of 64
    to 33 and a deepest map of 2x2; LR-ASPP's 1/8 map is 16x16, under
    the gate's 49."""
    config, shape = CONFIGS[name], SEGMENTORS[name]
    jcfg = JConfig.fromfile(config)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1,) + shape, n_classes=19, seed=30)
    model = init_model(config, device='cpu')
    sd = flax_to_state_dict(params, stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    imgs = np.random.default_rng(31).integers(0, 256, (2,) + shape + (3,),
                                              dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    # one compile: at these widths it costs less than the forward op by op
    # in a fresh worker
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method='predict'))(
        jax_variables(params, stats), x))
    with torch.no_grad():
        px, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        assert px.dtype == torch.float32
        out = model.predict(px).numpy()
    assert out.shape == ref.shape == (2,) + shape + (19,)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree
    step = make_eval_step(model, model.data_preprocessor)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize('hw', [(7, 9), (13, 26)])
def test_resize_scale_factor_matches_jax(hw):
    """At 7x9 the output is 3x4 and the source of output i is (i + 0.5) * 2
    - 0.5, not (i + 0.5) * 7 / 3 - 0.5 (what a size would give)."""
    from lednet_tpu.ops.resize import resize_bilinear as jresize
    from lednet_tpu_torch.ops.resize import resize_bilinear
    x = _normal((2,) + hw + (5,), seed=1)
    ref = np.asarray(jresize(jnp.asarray(x), scale_factor=0.5))
    out = resize_bilinear(nchw(x), scale_factor=0.5)
    assert out.shape[-2:] == (hw[0] // 2, hw[1] // 2)
    assert np.abs(nhwc(out) - ref).max() <= 1e-6
    by_size = resize_bilinear(nchw(x), (hw[0] // 2, hw[1] // 2))
    assert (np.abs(nhwc(by_size) - ref).max() > 1e-3) == (hw[0] % 2 == 1)


RESNET18 = dict(depth=18, stem_channels=8, base_channels=8)


@pytest.mark.parametrize('hw', [(45, 61), (64, 64)])
def test_resnet_ceil_maxpool_matches_jax(hw):
    """The stem's pool in ceil mode: at 45x61 the stem gives 23x31 and the
    pool 12x16 (the floor would give 12x16 too: the JAX package pads
    nothing); at 64x64, 32x32 pools to 17x17 where the floor gives 16x16."""
    from lednet_tpu.models.backbones.resnet import ResNet as J
    from lednet_tpu_torch.models.backbones.resnet import ResNet
    x = _normal((1,) + hw + (3,), seed=2)
    ref, out = _pair(J(**RESNET18, ceil_maxpool=True),
                     ResNet(**RESNET18, ceil_maxpool=True), x, seed=3)
    first = -(-(-(-hw[0] // 2) - 1) // 2) + 1
    assert out[0].shape[-2] == first
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_resnet_stage_range_matches_jax():
    """``stage_range`` (0, 2) then (2, 4) on its last output: each stage's
    map, unfiltered by ``out_indices``, equal to one full pass, and to the
    JAX package's two calls."""
    from lednet_tpu.models.backbones.resnet import ResNet as J
    from lednet_tpu_torch.models.backbones.resnet import ResNet
    x = _normal((2, 64, 96, 3), seed=4)
    jmod = J(**RESNET18, out_indices=(3,), ceil_maxpool=True)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=5)
    port = load_port(ResNet(**RESNET18, out_indices=(3,), ceil_maxpool=True),
                     params, stats)
    with torch.no_grad():
        full = port(nchw(x))
        low = port(nchw(x), stage_range=(0, 2))
        high = port(low[-1], stage_range=(2, 4))
    assert len(full) == 1 and len(low) == len(high) == 2
    assert torch.equal(high[-1], full[0])
    jlow = _apply(jmod, params, stats, jnp.asarray(x), stage_range=(0, 2))
    jhigh = _apply(jmod, params, stats, jlow[-1], stage_range=(2, 4))
    for o, r in zip(low + high, tuple(jlow) + tuple(jhigh)):
        _hold(nhwc(o), r)


# ------------------------------------------------------------------ ICNet
NARROW_ICNET = dict(backbone_cfg=dict(type='ResNet', depth=18, stem_channels=8,
                                      base_channels=8),
                    light_branch_middle_channels=8, psp_out_channels=16,
                    out_channels=(8, 16, 16))


def test_icnet_matches_jax():
    """A narrow ICNet at 200x136: the half image is 100x68, its stage-2 map
    13x9 resized by 0.5 to 6x4 (odd, the factor's coordinates), the deepest
    map 2x1 under pools of 1, 2, 3 and 6."""
    from lednet_tpu.models.backbones.icnet import ICNet as J
    from lednet_tpu_torch.models.backbones.icnet import ICNet
    x = _normal((1, 200, 136, 3), seed=6)
    ref, out = _pair(J(**NARROW_ICNET), ICNet(**NARROW_ICNET), x, seed=7)
    assert [tuple(o.shape[1:]) for o in out] == [(8, 25, 17), (16, 13, 9),
                                                 (16, 2, 1)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)
    with pytest.raises(ValueError, match='ResNet'):
        ICNet(dict(type='STDCNet'))


@pytest.mark.parametrize('part', ['cff', 'neck'])
def test_icneck_matches_jax(part):
    """The fusion's dilated ``conv_low`` and 1x1 ``conv_high`` (norms, no
    activation), ReLU after the sum; the neck's (low_24, low_12, x_12)."""
    from lednet_tpu.models.necks import ICNeck as J, _CascadeFeatureFusion as JC
    from lednet_tpu_torch.models.necks import ICNeck, _CascadeFeatureFusion
    maps = [_normal((2,) + hw + (c,), seed=8 + i) for i, (hw, c) in
            enumerate(zip([(25, 17), (13, 9), (7, 5)], (8, 12, 16)))]
    if part == 'cff':
        jmod, port = JC(16, 12, 10), _CascadeFeatureFusion(16, 12, 10)
        args = [jnp.asarray(maps[2]), jnp.asarray(maps[1])]
    else:
        jmod, port = J((8, 12, 16), 10), ICNeck((8, 12, 16), 10)
        args = [[jnp.asarray(m) for m in maps]]
    params, stats = random_variables(jmod, *args, seed=11)
    port = load_port(port, params, stats)
    with torch.no_grad():
        out = (port(nchw(maps[2]), nchw(maps[1])) if part == 'cff'
               else port([nchw(m) for m in maps]))
    ref = _apply(jmod, params, stats, *args)
    shapes = [(10, 13, 9)] * 2 if part == 'cff' else [(10, 13, 9), (10, 25, 17),
                                                       (10, 25, 17)]
    assert [tuple(o.shape[1:]) for o in out] == shapes
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


# ------------------------------------------------------------------ Fast-SCNN
@pytest.mark.parametrize('cin,cout,stride', [(8, 8, 1), (8, 12, 2)],
                         ids=['residual', 'stride2'])
def test_inverted_residual_matches_jax(cin, cout, stride):
    from lednet_tpu.models.backbones.fast_scnn import InvertedResidual as J
    from lednet_tpu_torch.models.backbones.fast_scnn import InvertedResidual
    relu = dict(type='ReLU')
    port = InvertedResidual(cin, cout, stride, act_cfg=relu)
    assert port.residual == (stride == 1)
    ref, out = _pair(J(cin, cout, stride, act_cfg=relu), port,
                     _normal((2, 11, 14, cin), seed=12), seed=13)
    _hold(nhwc(out), ref)


@pytest.mark.parametrize('which', ['ppm', 'strided_sep'])
def test_fast_scnn_parts_match_jax(which):
    """``_PPM``'s ``pool{s}`` convs on a 7x5 map; ``_StridedSep`` (the
    depthwise conv without activation) on an odd 13x9 map."""
    from lednet_tpu.models.backbones import fast_scnn as J
    from lednet_tpu_torch.models.backbones import fast_scnn as P
    if which == 'ppm':
        jmod, port, x = J._PPM(16, 4), P._PPM(16, 4), _normal((2, 7, 5, 16), seed=14)
    else:
        jmod, port = J._StridedSep(8, 12), P._StridedSep(8, 12)
        x = _normal((2, 13, 9, 8), seed=14)
    ref, out = _pair(jmod, port, x, seed=15)
    _hold(nhwc(out), ref)


NARROW_FASTSCNN = dict(downsample_dw_channels=(8, 12), global_in_channels=16,
                       global_block_channels=(16, 24, 32),
                       global_out_channels=32, higher_in_channels=16,
                       lower_in_channels=32, fusion_out_channels=32)


def test_fast_scnn_matches_jax():
    """Narrow, at 100x156: 1/8 is 13x20, 1/32 4x5."""
    from lednet_tpu.models.backbones.fast_scnn import FastSCNN as J
    from lednet_tpu_torch.models.backbones.fast_scnn import FastSCNN
    x = _normal((1, 100, 156, 3), seed=16)
    ref, out = _pair(J(**NARROW_FASTSCNN), FastSCNN(**NARROW_FASTSCNN), x, seed=17)
    assert [tuple(o.shape[1:]) for o in out] == [(16, 13, 20), (32, 4, 5),
                                                 (32, 13, 20)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_separable_fcn_head_matches_jax():
    """Two separable convs (norm and activation after the depthwise and the
    pointwise conv each), no ``conv_cat``; logits and loss."""
    from lednet_tpu_torch.models.decode_heads.fcn_head import \
        DepthwiseSeparableFCNHead
    cfg = dict(Config.fromfile(CONFIGS['fastscnn']).model.decode_head,
               in_channels=12, channels=8, num_classes=5, dropout_ratio=0.0)
    jhead = JMODELS.build(dict(cfg))
    feats = [_normal((2, 9, 13, 12), seed=18)]
    params, stats = random_variables(jhead, [jnp.asarray(f) for f in feats],
                                     seed=19)
    head = load_port(DepthwiseSeparableFCNHead(
        **{k: v for k, v in cfg.items() if k != 'type'}), params, stats)
    assert type(head.conv1.dw.conv).__name__ == 'Conv2d' and head.conv1.dw.conv.groups == 8
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    ref = _apply(jhead, params, stats, [jnp.asarray(f) for f in feats])
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(20).integers(0, 5, (2, 36, 52)).astype(np.int32)
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_ce', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


# ------------------------------------------------------------------ ERFNet
ERF_BRICKS = {'down_odd': ('DownsamplerBlock', (4, 12), (2, 13, 9, 4)),
              'down_even': ('DownsamplerBlock', (4, 12), (2, 12, 10, 4)),
              'non_bottleneck': ('NonBottleneck1d', (8, 3), (2, 11, 14, 8)),
              'upsampler': ('UpsamplerBlock', (12, 8), (2, 6, 7, 12))}


@pytest.mark.parametrize('name', list(ERF_BRICKS))
def test_erfnet_bricks_match_jax(name):
    """The downsampler at an odd size (a 13x9 map: the conv gives 7x5, the
    pool 6x4, resized bilinearly to 7x5) and an even one; the dilated
    non-bottleneck block; the upsampler, whose flax kernel (not symmetric)
    converts flipped, doubling 6x7 to 12x14."""
    from lednet_tpu.models.backbones import erfnet as J
    from lednet_tpu_torch.models.backbones import erfnet as P
    cls, args, shape = ERF_BRICKS[name]
    x = _normal(shape, seed=21)
    jmod = getattr(J, cls)(*args)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=22)
    port = load_port(getattr(P, cls)(*args), params, stats)
    assert port.bn.bn.eps == 1e-3 if name != 'non_bottleneck' else \
        port.bn1.bn.eps == 1e-3
    with torch.no_grad():
        out = port(nchw(x))
    ref = _apply(jmod, params, stats, jnp.asarray(x))
    if name == 'upsampler':
        k = params['deconv']['kernel']
        assert not np.allclose(k, k[::-1, ::-1], atol=1e-3)
        assert out.shape[-2:] == (12, 14)
    _hold(nhwc(out), ref)


NARROW_ERFNET = dict(enc_downsample_channels=(8, 16, 24),
                     enc_stage_non_bottlenecks=(2, 6),
                     enc_non_bottleneck_dilations=(2, 4, 8, 16),
                     dec_upsample_channels=(16, 8),
                     dec_stages_non_bottleneck=(1, 1),
                     dec_non_bottleneck_channels=(16, 8), dropout_ratio=0.0,
                     norm_cfg=dict(type='SyncBN', requires_grad=True))


def test_erfnet_matches_jax():
    """Narrow, at 52x76; 6 second-stage blocks asked, 4 built (one cycle
    of the four rates), as in the JAX package; BatchNorm eps 1e-3 whatever
    ``norm_cfg`` says."""
    from lednet_tpu.models.backbones.erfnet import ERFNet as J
    from lednet_tpu_torch.models.backbones.erfnet import ERFNet
    port = ERFNet(**NARROW_ERFNET)
    assert port.enc2 == [f'enc2_{i}' for i in range(4)]
    ref, out = _pair(J(**NARROW_ERFNET), port, _normal((1, 52, 76, 3), seed=23),
                     seed=24)
    assert out[0].shape[1:] == (8, 28, 40)
    _hold(nhwc(out[0]), ref[0])


# ------------------------------------------------------------------ CGNet
def test_global_context_extractor_matches_jax():
    """The gate's ``fc1`` / ``fc2`` are flax ``Dense`` layers, carried into
    ``nn.Linear`` by ``convert.py``."""
    from lednet_tpu.models.backbones.cgnet import GlobalContextExtractor as J
    from lednet_tpu_torch.models.backbones.cgnet import GlobalContextExtractor
    x = _normal((2, 5, 7, 16), seed=25)
    jmod = J(16, 4)
    params, _ = random_variables(jmod, jnp.asarray(x), seed=26)
    assert params['fc1']['kernel'].shape == (16, 4)
    # the Dense rule keys on the gate's own name, ``f_glo``
    port = GlobalContextExtractor(16, 4)
    port.load_state_dict({k.removeprefix('f_glo.'): v for k, v in
                          flax_to_state_dict({'f_glo': params}).items()})
    with torch.no_grad():
        out = port(nchw(x))
    _hold(nhwc(out), jmod.apply({'params': jax.tree_util.tree_map(
        jnp.asarray, params)}, jnp.asarray(x)))


@pytest.mark.parametrize('downsample', [False, True], ids=['skip', 'down'])
def test_context_guided_block_matches_jax(downsample):
    from lednet_tpu.models.backbones.cgnet import ContextGuidedBlock as J
    from lednet_tpu_torch.models.backbones.cgnet import ContextGuidedBlock
    cin = 12 if downsample else 16
    args = (cin, 16, 3, 4)
    ref, out = _pair(J(*args, downsample=downsample),
                     ContextGuidedBlock(*args, downsample=downsample),
                     _normal((2, 11, 9, cin), seed=27), seed=28)
    assert out.shape[1:] == ((16, 6, 5) if downsample else (16, 11, 9))
    _hold(nhwc(out), ref)


def test_cgnet_matches_jax():
    """Narrow, at 45x61: the stem's and the injected image pyramid's odd
    sizes (23x31, 12x16, 6x8)."""
    from lednet_tpu.models.backbones.cgnet import CGNet as J
    from lednet_tpu_torch.models.backbones.cgnet import CGNet
    kw = dict(num_channels=(8, 16, 32), num_blocks=(2, 2))
    ref, out = _pair(J(**kw), CGNet(**kw), _normal((1, 45, 61, 3), seed=29),
                     seed=30)
    assert [tuple(o.shape[1:]) for o in out] == [(11, 23, 31), (35, 12, 16),
                                                 (64, 6, 8)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


# ------------------------------------------------------------------ MobileNetV3
def test_se_block_matches_jax():
    """Biased 1x1 convs to make_divisible(c // 4, 8), the gate clip(g / 6
    + 0.5, 0, 1)."""
    from lednet_tpu.models.backbones.mobilenet import _SEBlock as J
    from lednet_tpu_torch.models.backbones.mobilenet_v3 import _SEBlock
    x = _normal((2, 5, 6, 72), seed=31, scale=3.0)
    jmod = J(72)
    params, _ = random_variables(jmod, jnp.asarray(x), seed=32)
    port = load_port(_SEBlock(72), params, {})
    assert port.fc1.out_channels == 24 and port.fc1.bias is not None
    with torch.no_grad():
        out = port(nchw(x))
    _hold(nhwc(out), jmod.apply({'params': jax.tree_util.tree_map(
        jnp.asarray, params)}, jnp.asarray(x)))


@pytest.mark.parametrize('n,pad', [(64, (0, 1)), (65, (1, 1))])
def test_same_pad(n, pad):
    from lednet_tpu_torch.models.backbones.mobilenet_v3 import MobileNetV3
    assert MobileNetV3.same_pad(n) == pad


MOBILENETS = {'large_odd': ((33, 47), (0, 1, 3, 16)),
              'large_even': ((64, 80), (0, 1, 3, 16))}


@pytest.mark.parametrize('name', list(MOBILENETS))
def test_mobilenet_v3_matches_jax(name):
    """The 'large' arch at out_indices (0, 1, 3, 16) (the 'SAME' stem,
    the LR-ASPP inputs): at 33x47 the stem's TF padding is (1, 1) each way,
    at 64x80 (0, 1); the deep stride-2 blocks run at stride 1, dilated."""
    from lednet_tpu.models.backbones.mobilenet import MobileNetV3 as J
    from lednet_tpu_torch.models.backbones.mobilenet_v3 import MobileNetV3
    hw, out_indices = MOBILENETS[name]
    kw = dict(arch='large', out_indices=out_indices)
    ref, out = _pair(J(**kw), MobileNetV3(**kw), _normal((1,) + hw + (3,), seed=33),
                     seed=34)
    eighth = tuple(-(-n // 8) for n in hw)
    assert tuple(out[-1].shape[1:]) == (960,) + eighth
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_mobilenet_v3_small_raises():
    """The JAX package's default arch 'small', which no config uses, is
    not ported: it raises, naming the arch."""
    from lednet_tpu_torch.models.backbones.mobilenet_v3 import MobileNetV3
    with pytest.raises(ValueError, match="'small'"):
        MobileNetV3(arch='small')
    with pytest.raises(ValueError, match="'small'"):
        MobileNetV3()


# the deepest (1/8) map: under the 49 pool, the gate pools the whole map
# (one cell); at 72x136, past the config's 64x128 crop map (a 1 x 4 gate),
# the stride (16, 20) windows give a 2 x 5 gate, resized back bilinearly
LRASPP_DEEPEST = {'one_cell': ((9, 13), (1, 1)),
                  'cells_2x5': ((72, 136), (2, 5))}


@pytest.mark.parametrize('name', list(LRASPP_DEEPEST))
def test_lraspp_head_matches_jax(name):
    """Inputs at 1/2, 1/4 and 1/8 (the deepest at LRASPP_DEEPEST's size):
    logits and loss."""
    from lednet_tpu_torch.models.decode_heads.lraspp_head import LRASPPHead
    cfg = dict(Config.fromfile(CONFIGS['lraspp']).model.decode_head,
               in_channels=(8, 12, 24), channels=16, branch_channels=(4, 8),
               num_classes=5, dropout_ratio=0.0)
    jhead = JMODELS.build(dict(cfg))
    (h, w), cells = LRASPP_DEEPEST[name]
    assert ((h - min(49, h)) // 16 + 1, (w - min(49, w)) // 20 + 1) == cells
    feats = [_normal((2, h * f, w * f, c), seed=35 + i) for i, (f, c) in
             enumerate(zip((4, 2, 1), (8, 12, 24)))]
    jfeats = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jhead, jfeats, seed=38)
    head = load_port(LRASPPHead(**{k: v for k, v in cfg.items() if k != 'type'}),
                     params, stats)
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    ref = _apply(jhead, params, stats, jfeats)
    assert out.shape == (2, 5, 4 * h, 4 * w)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(39).integers(0, 5, (2, 8 * h, 8 * w)).astype(np.int32)
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


# ------------------------------------------------------------------ convert
def test_convert_deconv_by_module():
    """A ``deconv`` beside ``bn`` (ERFNet's ``UpsamplerBlock``, flax's
    default (k, k, in, out) kernel) is flipped in both spatial axes and
    transposed (2, 3, 0, 1); beside ``norm`` (UNet's ``DeconvModule``,
    ``transpose_kernel=True``) it is transposed (3, 2, 0, 1); in any other
    module it raises."""
    k = np.arange(3 * 3 * 4 * 5, dtype=np.float32).reshape(3, 3, 4, 5)
    bn = {'bn': {'scale': np.ones(5), 'bias': np.zeros(5)}}
    erf = flax_to_state_dict({'_backbone': {'up0': {'deconv': {'kernel': k},
                                                    'bn': bn}}})
    np.testing.assert_array_equal(erf['backbone.up0.deconv.weight'].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    unet = flax_to_state_dict({'_backbone': {'up0': {'deconv': {'kernel': k},
                                                     'norm': bn}}})
    np.testing.assert_array_equal(unet['backbone.up0.deconv.weight'].numpy(),
                                  k.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match='transposed conv'):
        flax_to_state_dict({'_backbone': {'x': {'deconv': {'kernel': k}}}})


def test_convert_dense_and_neck():
    """CGNet's ``f_glo/fc{1,2}`` (flax ``Dense``, (in, out)) become
    ``nn.Linear`` weights (out, in); a 2-D kernel elsewhere raises; the
    segmentor's ``_neck`` becomes ``neck``."""
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    sd = flax_to_state_dict({'_backbone': {'level1_0': {'f_glo': {
        'fc1': {'kernel': w, 'bias': np.zeros(3)}}}}})
    np.testing.assert_array_equal(
        sd['backbone.level1_0.f_glo.fc1.weight'].numpy(), w.T)
    with pytest.raises(ValueError, match='2-D kernel'):
        flax_to_state_dict({'_decode_head': {'theta': {'kernel': w}}})
    conv = np.zeros((3, 3, 2, 4), np.float32)
    sd = flax_to_state_dict({'_neck': {'cff_24': {'conv_low': {'conv': {
        'kernel': conv}}}}})
    assert list(sd) == ['neck.cff_24.conv_low.conv.weight']
