"""PyTorch port: PIDNet-S/M/L and STDC1/STDC2, the rows of the paper's
speed table after DDRNet (``BASELINE.md``), against ``lednet_tpu`` on the
CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- the bricks in eval mode, rel 1e-5 of the largest output: a grouped
  ``ConvModule``; ``PAPPM`` (16x16, where the 17x17 pool sees mostly
  padding, and 5x7); ``PagFM`` with ``with_channel`` and ``after_relu``
  each way; ``Bag`` and ``LightBag``; ``PIDNet`` at c=8, light (S) and not
  (M/L), at 64x96 and at 100x156, where the 1/8 maps are ceil(in / 8);
  ``PIDHead`` predict and ``loss_by_feat`` with and without
  ``gt_edge_map``; ``STDCModule`` in 'cat' and 'add' at stride 1 and 2;
  ``STDCNet1`` and ``STDCNet2`` at narrow widths; ``STDCContextPathNet``
  at 100x156 (1/32 is 4x5, so every nearest upsampling is off a multiple);
  ``STDCHead``'s loss; ``DiceLoss`` with 255 pixels on 1 and on C channels
  (both eps forms); ``BoundaryLoss`` with 255 pixels;
- ``GenerateEdge`` bit-exact against the JAX transform (cv2's dilation)
  for edge widths 1-5 on random blocky labels with ignored regions and odd
  shapes, and PIDNet-S's train pipeline: the port's dataset item (seeded)
  gives the JAX dataset's ``gt_seg_map`` and ``gt_edge_map``;
- the five configs built unchanged (PIDNet-S/M/L, STDC1/STDC2; random
  init, their ``in1k-pre`` siblings differ by an ``init_cfg`` URL that
  neither package reads) at small inputs: logits within 1e-4 x max|logit|
  with argmax agreement >= 99.9%, and the CPU eval step equal to
  ``predict``; the converted keys are the port's (``STDCNet_0`` ->
  ``backbone``);
- one train step each of PIDNet-S (its four-term loss, with an edge map)
  and STDC1 (CE, two FCN auxiliary heads, STDCHead's BCE + Dice), dropout
  0 in every head: loss within 1e-5, every weight within atol 1e-4 / rtol
  5e-3, the BatchNorm running stats within atol 1e-5 / rtol 1e-4 (the
  bounds of ``tests/test_torch_port_train.py``);
- ``chip_smoke.decisions`` records and pins PIDHead's boundary gate.

torch runs on one thread in every test here (``one_thread``): its CPU
autograd aborts the process when it runs multi-threaded after the XLA CPU
runtime has run, and six workers' threads oversubscribe the cores.  A
segmentor's JAX ``predict``, which runs once, is jitted: in a fresh worker
one whole-graph compile cost less than the forward op by op (the five
configs 30.7 s against 62.5).
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
from test_torch_port_zoo import _apply, _hold, _labels, _normal, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

PIDNET = {v: f'{REPO}/configs/pidnet/pidnet-{v}_cityscapes-1024x1024.py'
          for v in 'sml'}
STDC = {v: f'{REPO}/configs/stdc/stdc{v}_cityscapes-512x1024.py' for v in '12'}
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


def _blocky_labels(shape, n_classes, seed, block=4, ignored=0.1):
    """(B, H, W) labels in blocks of ``block`` pixels (so that edges are
    sparse), with whole blocks at 255."""
    rng = np.random.default_rng(seed)
    coarse = (shape[0], -(-shape[1] // block), -(-shape[2] // block))
    lbl = np.where(rng.random(coarse) < ignored, 255,
                   rng.integers(0, n_classes, coarse))
    lbl = lbl.repeat(block, 1).repeat(block, 2)[:, :shape[1], :shape[2]]
    return np.ascontiguousarray(lbl).astype(np.int32)


def _pair(jmod, port, x, seed):
    """(JAX output, port output) of ``x`` (NHWC numpy) in eval mode."""
    params, stats = random_variables(jmod, jnp.asarray(x), seed=seed)
    port = load_port(port, params, stats)
    with torch.no_grad():
        out = port(nchw(x))
    return _apply(jmod, params, stats, jnp.asarray(x)), out


# ------------------------------------------------------------------ bricks
def test_grouped_conv_module_matches_jax():
    """A pre-activation 3x3 conv of 3 groups and a depthwise 3x3/s2 one."""
    from lednet_tpu.models.layers import ConvModule as JConvModule
    from lednet_tpu_torch.models.layers import ConvModule
    x = _normal((2, 9, 11, 12), seed=1)
    for kw in (dict(groups=3, order=('norm', 'act', 'conv'),
                    act_cfg=dict(type='ReLU')),
               dict(groups=12, stride=2)):
        ref, out = _pair(JConvModule(12, 12, 3, padding=1,
                                     norm_cfg=dict(type='BN'), **kw),
                         ConvModule(12, 12, 3, padding=1,
                                    norm_cfg=dict(type='BN'), **kw), x, seed=2)
        _hold(nhwc(out), ref)


@pytest.mark.parametrize('hw', [(16, 16), (5, 7)])
def test_pappm_matches_jax(hw):
    from lednet_tpu.models.ppm import PAPPM as JPAPPM
    from lednet_tpu_torch.models.ppm import PAPPM
    x = _normal((2,) + hw + (32,), seed=3, scale=2.0) + 1.0
    ref, out = _pair(JPAPPM(32, 16, 24, num_scales=5),
                     PAPPM(32, 16, 24, num_scales=5), x, seed=4)
    _hold(nhwc(out), ref)


@pytest.mark.parametrize('with_channel', [False, True])
@pytest.mark.parametrize('after_relu', [False, True])
def test_pagfm_matches_jax(with_channel, after_relu):
    """x_i at 1/2 of x_p's odd size: both upsamplings are off the grid."""
    from lednet_tpu.models.backbones.pidnet import PagFM as JPagFM
    from lednet_tpu_torch.models.backbones.pidnet import PagFM
    x_p = _normal((2, 13, 19, 16), seed=5)
    x_i = _normal((2, 7, 10, 16), seed=6)
    jmod = JPagFM(16, 8, after_relu=after_relu, with_channel=with_channel)
    params, stats = random_variables(jmod, jnp.asarray(x_p), jnp.asarray(x_i),
                                     seed=7)
    port = load_port(PagFM(16, 8, after_relu=after_relu,
                           with_channel=with_channel), params, stats)
    with torch.no_grad():
        out = port(nchw(x_p), nchw(x_i))
    _hold(nhwc(out), _apply(jmod, params, stats, jnp.asarray(x_p),
                            jnp.asarray(x_i)))


@pytest.mark.parametrize('name', ['Bag', 'LightBag'])
def test_bag_matches_jax(name):
    from lednet_tpu.models.backbones import pidnet as jpidnet
    from lednet_tpu_torch.models.backbones import pidnet
    feats = [_normal((2, 9, 13, 16), seed=8 + i) for i in range(3)]
    act = dict(type='ReLU') if name == 'Bag' else None
    jmod = getattr(jpidnet, name)(16, 12, act_cfg=act)
    jfeats = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jmod, *jfeats, seed=11)
    port = load_port(getattr(pidnet, name)(16, 12, act_cfg=act), params, stats)
    with torch.no_grad():
        out = port(*(nchw(f) for f in feats))
    _hold(nhwc(out), _apply(jmod, params, stats, *jfeats))


@pytest.mark.parametrize('light', [True, False], ids=['s', 'm_l'])
@pytest.mark.parametrize('hw', [(64, 96), (100, 156)])
def test_pidnet_matches_jax(light, hw):
    """c=8; at 100x156 the 1/8 maps are 13x20 (ceil), the 1/64 ones 2x3."""
    from lednet_tpu.models.backbones.pidnet import PIDNet as JPIDNet
    from lednet_tpu_torch.models.backbones.pidnet import PIDNet
    kw = dict(channels=8, ppm_channels=16, num_stem_blocks=2 if light else 3,
              num_branch_blocks=3 if light else 4)
    x = _normal((1,) + hw + (3,), seed=12)
    ref, out = _pair(JPIDNet(**kw), PIDNet(**kw), x, seed=13)
    assert out[1].shape == (1, 32, -(-hw[0] // 8), -(-hw[1] // 8))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


@pytest.mark.parametrize('part', ['predict', 'loss', 'loss_with_edges'])
def test_pid_head_matches_jax(part):
    """predict at (60, 90), not 8x the 8x12 logit; the loss of the config's
    four losses on (temp_p, out, temp_d)-shaped features, with and without
    an edge map (255s at the label's ignored blocks)."""
    from lednet_tpu_torch.models.decode_heads.pid_head import PIDHead
    cfg = dict(Config.fromfile(PIDNET['s']).model.decode_head, in_channels=32,
               channels=16, num_classes=3)
    for loss in cfg['loss_decode']:
        if 'min_kept' in loss:
            loss['min_kept'] = 2000
    jhead = JMODELS.build(dict(cfg))
    feats = (_normal((2, 8, 12, 16), seed=14), _normal((2, 8, 12, 32), seed=15),
             _normal((2, 8, 12, 16), seed=16))
    jfeats = tuple(jnp.asarray(f) for f in feats)
    params, stats = random_variables(jhead, jfeats, seed=17)
    params['d_cls_seg']['bias'] += 1.4      # the gate passes about half
    head = load_port(PIDHead(**{k: v for k, v in cfg.items() if k != 'type'}),
                     params, stats)
    tfeats = tuple(nchw(f) for f in feats)
    if part == 'predict':
        ref = jhead.predict_by_feat(_apply(jhead, params, stats, jfeats,
                                           with_aux=False), (60, 90))
        with torch.no_grad():
            out = head.predict_by_feat(head(tfeats, with_aux=False), (60, 90))
            default = head.predict_by_feat(head(tfeats[1]))
        assert default.shape[-2:] == (64, 96)
        _hold(nhwc(out), ref)
        return
    lbl = _blocky_labels((2, 64, 96), 3, seed=18)
    logits = _apply(jhead, params, stats, jfeats)
    tlogits = tuple(nchw(np.asarray(l)) for l in logits)
    jlabel, label = jnp.asarray(lbl), torch.from_numpy(lbl).long()
    keys = {'loss_sem_p', 'loss_sem_i', 'acc_seg'}
    if part == 'loss_with_edges':
        edges = np.stack([_generate_edge('jax', l, 4) for l in lbl]).astype(np.int32)
        edges[:, -5:] = 255                     # a padded band
        jlabel = dict(gt_seg_map=jlabel, gt_edge_map=jnp.asarray(edges))
        label = dict(gt_seg_map=label, gt_edge_map=torch.from_numpy(edges).long())
        keys |= {'loss_bd', 'loss_sem_bd'}
        gate = head.boundary_gate(tlogits[2])
        assert 0.1 < gate.float().mean() < 0.9
    ref = jhead.loss_by_feat(logits, jlabel)
    with torch.no_grad():
        out = head.loss_by_feat(tlogits, label)
    assert set(out) == set(ref) == keys
    for k in ref:
        assert rel_err(out[k].numpy(), ref[k]) <= 1e-5, k


STDC_MODULES = [(f, s) for f in ('cat', 'add') for s in (1, 2)]


@pytest.mark.parametrize('fusion,stride', STDC_MODULES,
                         ids=[f'{f}_s{s}' for f, s in STDC_MODULES])
def test_stdc_module_matches_jax(fusion, stride):
    """16 -> 32 channels at stride 2 and 32 -> 32 at 1, on an odd map."""
    from lednet_tpu.models.backbones.stdc import STDCModule as JSTDCModule
    from lednet_tpu_torch.models.backbones.stdc import STDCModule
    cin = 16 if stride == 2 else 32
    x = _normal((2, 13, 19, cin), seed=19)
    ref, out = _pair(JSTDCModule(cin, 32, stride, fusion_type=fusion),
                     STDCModule(cin, 32, stride, fusion_type=fusion), x, seed=20)
    _hold(nhwc(out), ref)


@pytest.mark.parametrize('stdc_type,final', [('STDCNet1', False),
                                             ('STDCNet2', True)])
def test_stdcnet_matches_jax(stdc_type, final):
    from lednet_tpu.models.backbones.stdc import STDCNet as JSTDCNet
    from lednet_tpu_torch.models.backbones.stdc import STDCNet
    kw = dict(stdc_type=stdc_type, channels=(8, 16, 32, 64, 128),
              with_final_conv=final)
    x = _normal((1, 64, 96, 3), seed=21)
    ref, out = _pair(JSTDCNet(**kw), STDCNet(**kw), x, seed=22)
    assert [o.shape[1] for o in out] == [32, 64, 1024 if final else 128]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_stdc_context_path_matches_jax():
    """The config's context path at narrow widths on 100x156: the STDCNet's
    maps are 13x20, 7x10, 4x5, so each nearest upsampling is 4x5 -> 7x10 ->
    13x20."""
    cfg = dict(Config.fromfile(STDC['1']).model.backbone)
    cfg['backbone_cfg'] = dict(cfg['backbone_cfg'],
                               channels=(8, 16, 32, 64, 128))
    cfg.update(last_in_channels=(128, 64), out_channels=32,
               ffm_cfg=dict(in_channels=64, out_channels=48, scale_factor=4))
    x = _normal((1, 100, 156, 3), seed=23)
    jmod = JMODELS.build(dict(cfg))
    params, stats = random_variables(jmod, jnp.asarray(x), seed=24)
    assert 'STDCNet_0' in params        # flax's automatic name of the trunk
    port = load_port(MODELS.build(dict(cfg)), params, stats)
    with torch.no_grad():
        out = port(nchw(x))
    ref = _apply(jmod, params, stats, jnp.asarray(x))
    assert [tuple(o.shape) for o in out] == [(1, 32, 13, 20), (1, 32, 7, 10),
                                             (1, 32, 13, 20), (1, 48, 13, 20)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_stdc_head_loss_matches_jax():
    """The config's STDCHead (sigmoid CE + Dice on the Laplacian boundary of
    the label, 255s included) on a 1/8 feature, label at 8x."""
    from lednet_tpu_torch.models.decode_heads.stdc_head import STDCHead
    cfg = dict(Config.fromfile(STDC['1']).model.auxiliary_head[2],
               in_channels=16, channels=8)
    jhead = JMODELS.build(dict(cfg))
    feats = [_normal((2, 9, 13, 16), seed=25)]
    params, stats = random_variables(jhead, [jnp.asarray(feats[0])], seed=26)
    head = load_port(STDCHead(**{k: v for k, v in cfg.items() if k != 'type'}),
                     params, stats)
    with torch.no_grad():
        out = head([nchw(feats[0])])
    ref = _apply(jhead, params, stats, [jnp.asarray(feats[0])])
    _hold(nhwc(out), ref)
    lbl = _blocky_labels((2, 72, 104), 19, seed=27)
    boundary = head.boundary_label(torch.from_numpy(lbl).long())
    assert 0.05 < boundary.float().mean() < 0.9
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_ce', 'loss_dice', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


@pytest.mark.parametrize('channels', [1, 4])
@pytest.mark.parametrize('naive', [False, True], ids=['vnet', 'naive'])
def test_dice_loss_matches_jax(channels, naive):
    """Labels with 255s (a zero target row, the prediction still counted)
    and, on 4 channels, a label of 4 (clamped to the dropped column)."""
    from lednet_tpu.models.losses.extra_losses import DiceLoss as JDiceLoss
    from lednet_tpu_torch.models.losses import DiceLoss
    pred = _normal((3, 9, 11, channels), seed=28, scale=2.0)
    lbl = _labels((3, 9, 11), channels + 1, seed=29, ignored=0.2)
    for kw in (dict(), dict(use_sigmoid=False), dict(reduction='none'),
               dict(loss_weight=0.5, eps=1e-2)):
        kw = dict(kw, naive_dice=naive)
        ref = JDiceLoss(**kw)(jnp.asarray(pred), jnp.asarray(lbl))
        out = DiceLoss(**kw)(nchw(pred), torch.from_numpy(lbl).long())
        assert out.shape == np.shape(ref)
        assert rel_err(out.numpy(), ref) <= 1e-6, kw


def test_boundary_loss_matches_jax():
    from lednet_tpu.models.losses.extra_losses import BoundaryLoss as JBoundaryLoss
    from lednet_tpu_torch.models.losses import BoundaryLoss
    pred = _normal((2, 9, 11, 1), seed=30, scale=3.0)
    gt = np.random.default_rng(31).choice([0, 1, 255], (2, 9, 11),
                                          p=[0.6, 0.3, 0.1]).astype(np.int32)
    ref = JBoundaryLoss(loss_weight=20.0)(jnp.asarray(pred), jnp.asarray(gt))
    out = BoundaryLoss(loss_weight=20.0)(nchw(pred), torch.from_numpy(gt).long())
    assert rel_err(out.numpy(), ref) <= 1e-6


# ------------------------------------------------------------------ data
def _generate_edge(which, seg, width):
    if which == 'jax':
        from lednet_tpu.datasets.transforms.transforms import GenerateEdge
        return GenerateEdge(edge_width=width)({'gt_seg_map': seg})['gt_edge_map']
    from lednet_tpu_torch.datasets.transforms import GenerateEdge
    return GenerateEdge(edge_width=width)({'gt_seg_map': seg})['gt_edge_map']


@pytest.mark.parametrize('width', [1, 2, 3, 4, 5])
def test_generate_edge_matches_cv2(width):
    """Random blocky labels with ignored blocks, odd shapes, one and a
    single-row map; even widths have cv2's off-centre anchor."""
    for i, shape in enumerate([(37, 53), (64, 96), (1, 17), (9, 1), (6, 6)]):
        seg = _blocky_labels((1,) + shape, 5, seed=40 + i, block=3)[0]
        seg = seg.astype(np.uint8)
        ref = _generate_edge('jax', seg, width)
        out = _generate_edge('port', seg, width)
        assert out.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(out, ref, err_msg=f'{shape}')
    lone = np.zeros((9, 10), np.uint8)
    lone[4, 5] = 1                          # one boundary pixel's window
    assert _generate_edge('port', lone, width).sum() == \
        _generate_edge('jax', lone, width).sum()


def test_pidnet_train_pipeline_matches_jax(tmp_path):
    """The PIDNet-S config's train pipeline (its crop cut to 256x256) on a
    fabricated Cityscapes tree: ``gt_seg_map`` and ``gt_edge_map`` of each
    seeded item as the JAX dataset's."""
    from lednet_tpu.datasets import basesegdataset as jds
    from lednet_tpu_torch.datasets import basesegdataset as ds
    from lednet_tpu_torch.datasets.synthetic import make_cityscapes_tree
    root = make_cityscapes_tree(str(tmp_path / 'cityscapes'), n_train=3,
                                n_val=1, size_hw=(128, 256), seed=5)
    pipeline = [dict(t) for t in Config.fromfile(PIDNET['s']).train_pipeline]
    assert [t['type'] for t in pipeline][-2:] == ['GenerateEdge', 'PackSegInputs']
    for t in pipeline:
        if t['type'] == 'RandomResize':
            t['scale'] = (512, 256)
        elif t['type'] == 'RandomCrop':
            t['crop_size'] = (256, 256)
    kw = dict(data_root=root, pipeline=pipeline,
              data_prefix=dict(img_path='leftImg8bit/train',
                               seg_map_path='gtFine/train'))
    jset, pset = jds.CityscapesDataset(**kw), ds.CityscapesDataset(**kw)
    for idx in range(len(pset)):
        np.random.seed(idx)
        want = jset[idx]
        got = pset.prepare(idx, np.random.RandomState(idx))
        for key in ('gt_seg_map', 'gt_edge_map'):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert 0.0 < got['gt_edge_map'].mean() < 1.0


# ------------------------------------------------------------------ segmentors
def _segmentor_pair(config, seed):
    jcfg = JConfig.fromfile(config)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1, 64, 64), seed=seed)
    variables = jax_variables(params, stats)

    # one compile for the whole forward: at the tests' widths it costs less
    # than the forward op by op in a fresh worker
    jpredict = jax.jit(lambda v, x: jmodel.apply(v, x, method='predict'))

    def jax_logits(imgs):
        x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
        return np.asarray(jpredict(variables, x))
    model = init_model(config, device='cpu')
    sd = flax_to_state_dict(params, stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return jax_logits, model


SEGMENTORS = {'pidnet-s': (PIDNET['s'], (100, 156)),
              'pidnet-m': (PIDNET['m'], (64, 96)),
              'pidnet-l': (PIDNET['l'], (64, 96)),
              'stdc1': (STDC['1'], (100, 156)),
              'stdc2': (STDC['2'], (64, 128))}


@pytest.mark.parametrize('name', sorted(SEGMENTORS))
def test_segmentor_predict_matches_jax(name):
    """The shipped config unchanged (full width, float32 input, 19
    classes): ``predict`` of two seeded images, the eval step on the CPU
    too."""
    config, shape = SEGMENTORS[name]
    jax_logits, model = _segmentor_pair(config, seed=32)
    imgs = np.random.default_rng(33).integers(0, 256, (2,) + shape + (3,),
                                              dtype=np.uint8)
    ref = jax_logits(imgs)
    with torch.no_grad():
        x, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        assert x.dtype == torch.float32
        out = model.predict(x).numpy()
    assert out.shape == ref.shape == (2,) + shape + (19,)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree
    step = make_eval_step(model, model.data_preprocessor)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


def test_in1k_configs_build_as_their_base():
    """The ``stdc*_in1k-pre`` configs differ from theirs by an ``init_cfg``
    that neither package reads: the same modules, nothing downloaded."""
    for v in '12':
        pre = init_model(f'{REPO}/configs/stdc/stdc{v}_in1k-pre_cityscapes-'
                         '512x1024.py', device='cpu')
        base = init_model(STDC[v], device='cpu')
        assert pre.cfg.model.backbone.backbone_cfg.init_cfg['type'] == 'Pretrained'
        for (k, a), (k2, b) in zip(pre.state_dict().items(),
                                   base.state_dict().items()):
            assert k == k2 and torch.equal(a, b), k


def test_convert_raises_for_other_automatic_names():
    with pytest.raises(ValueError, match='STDCNet_1'):
        flax_to_state_dict({'_backbone': {'STDCNet_1': {
            'stage0': {'conv': {'kernel': np.zeros((3, 3, 3, 8))}}}}})


# ------------------------------------------------------------------ training
def _small_pidnet():
    return {'model.backbone.channels': 8, 'model.backbone.ppm_channels': 16,
            'model.decode_head.in_channels': 32,
            'model.decode_head.channels': 16,
            'model.decode_head.num_classes': 3,
            'model.decode_head.dropout_ratio': 0.0,
            'model.data_preprocessor.size': (128, 128)}


def _small_stdc():
    """STDC1 at a test width (8-128), 3 classes, every head's dropout 0."""
    model = Config.fromfile(STDC['1']).model
    aux = [dict(h, in_channels=32, channels=16, dropout_ratio=0.0,
                **({} if h['type'] == 'STDCHead' else {'num_classes': 3}))
           for h in model.auxiliary_head]
    return {'model.backbone.backbone_cfg.channels': (8, 16, 32, 64, 128),
            'model.backbone.last_in_channels': (128, 64),
            'model.backbone.out_channels': 32,
            'model.backbone.ffm_cfg': dict(in_channels=64, out_channels=48,
                                           scale_factor=4),
            'model.decode_head.in_channels': 48,
            'model.decode_head.channels': 32,
            'model.decode_head.num_classes': 3,
            'model.decode_head.dropout_ratio': 0.0,
            'model.auxiliary_head': aux,
            'model.data_preprocessor.size': (128, 128)}


@pytest.mark.parametrize('name', ['pidnet-s', 'stdc1'])
def test_train_step_matches_jax(name, one_thread):
    """One SGD step of the config (cut to a test width) in both packages
    from the same weights: PIDNet-S's four losses on a label and its edge
    map; STDC1's CE on the decode head and two FCN auxiliary heads and
    STDCHead's sigmoid CE + Dice (``aux_{0,1,2}.*``)."""
    config, extra = ((PIDNET['s'], _small_pidnet()) if name == 'pidnet-s'
                     else (STDC['1'], _small_stdc()))
    jcfg = JConfig.fromfile(config)
    jcfg.merge_from_dict(extra)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    rng = np.random.default_rng(40)
    imgs = rng.integers(0, 256, (2, 120, 128, 3), dtype=np.uint8)
    lbl = _blocky_labels((2, 120, 128), 3, seed=41, ignored=0.05)
    params, stats = loss_variables(jmodel, (1, 128, 128), n_classes=3, seed=42)
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
    jlabel, label = jnp.asarray(lbl), torch.from_numpy(lbl.astype(np.int64))
    if name == 'pidnet-s':
        edges = np.stack([_generate_edge('port', l.astype(np.uint8), 4)
                          for l in lbl]).astype(np.int32)
        jlabel = dict(gt_seg_map=jlabel, gt_edge_map=jnp.asarray(edges))
        label = dict(gt_seg_map=label,
                     gt_edge_map=torch.from_numpy(edges.astype(np.int64)))
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs), label)
    assert tstate.step == 1 and model.training

    state, jlogs = jmake_train_step(jmodel, tx, jpre)(state, jnp.asarray(imgs),
                                                      jlabel)
    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    want_keys = ({f'decode.{k}' for k in ('loss_sem_p', 'loss_sem_i', 'loss_bd',
                                          'loss_sem_bd', 'acc_seg')}
                 if name == 'pidnet-s' else
                 {'decode.loss_ce', 'decode.acc_seg', 'aux_2.loss_dice'} |
                 {f'aux_{i}.{k}' for i in range(3) for k in ('loss_ce', 'acc_seg')})
    assert set(logs) - {'loss', 'grad_norm'} == keys == want_keys
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    # a pixel accuracy is an argmax: one pixel whose top two logits tie
    # within rounding may fall either way (STDC1's first FCN head: one)
    one_pixel = 100.0 / int((lbl != 255).sum())
    for k in keys:
        tol = dict(rel=0, abs=1.01 * one_pixel) if k.endswith('acc_seg') \
            else dict(rel=1e-4, abs=1e-5)
        assert logs[k].item() == pytest.approx(float(jlogs[k]), **tol), k
    assert logs['grad_norm'].item() == pytest.approx(float(jlogs['grad_norm']),
                                                     rel=1e-3)
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


def test_chip_smoke_pins_the_boundary_gate():
    """``chip_smoke.decisions`` records PIDHead's boundary gate (the pixels
    whose ``sigmoid(d) > 0.8`` keep their label in the fourth loss), counts
    where a later call decides otherwise, and with ``pin`` follows the
    recorded gate."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    from lednet_tpu_torch.models.decode_heads.pid_head import PIDHead
    head = PIDHead(32, 8, 3)
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.normal(1.4, 1.0, (2, 1, 6, 7)).astype(np.float32))
    kept = []
    with chip_smoke.decisions(kept):
        gate = head.boundary_gate(d)
    assert len(kept) == 1 and torch.equal(kept[0], gate)
    assert torch.equal(gate, torch.sigmoid(d[:, 0]) > 0.8)
    moved = d + torch.from_numpy(rng.normal(0, 1, d.shape).astype(np.float32))
    own = head.boundary_gate(moved)
    for pin in (False, True):
        flips = {}
        with chip_smoke.decisions(kept, flips, pin):
            got = head.boundary_gate(moved)
        assert flips['gate'] == int((own != gate).sum()) > 0
        assert torch.equal(got, gate if pin else own)
