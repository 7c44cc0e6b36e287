"""PyTorch port: the cascade segmentor (``CascadeEncoderDecoder``) with
OCRNet's ``OCRHead`` and PointRend's ``PointHead`` against ``lednet_tpu``
on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- the bricks in eval mode, rel 1e-5 of the largest output: OCR's
  ``SelfAttentionBlock`` (2 normed query/key convs, scaled product, float32
  softmax over the keys, normed ``out_project``), ``OCRHead`` with the
  previous logits at its own size, at another size (resized) and absent
  (zeros), its logits and loss; ``point_sample`` at points within half a
  pixel of every border (the clamped form, not mmcv's zero padding);
  ``PointHead``'s eval subdivision where k is below H*W, with the k-th and
  (k+1)-th uncertainties apart, and its ties broken as ``jax.lax.top_k``
  breaks them; its training points given the JAX head's
  own candidates (``jax.random.uniform`` recorded), the MLP at them, and
  ``loss_point`` at JAX's coordinates with ignored labels;
- the OCRNet HR18 and PointRend R50 configs: built unchanged at full
  width, every flax leaf lands on a port key and none is left over
  (``_heads_{i}`` -> ``decode_heads.{i}``); narrow copies give logits
  within 1e-4 x max|logit| with argmax agreement >= 99.9%, the CPU eval
  step equal to ``predict``;
- one train step of each, keyed ``decode_0.*`` / ``decode_1.*``: OCRNet
  (CE 0.4 and 1.0) and PointRend over a ResNetV1c-18 trunk with the
  training points fed from the JAX forward under the step's ``dropout``
  key; loss within 1e-5, every weight within atol 1e-4 / rtol 5e-3, the
  BatchNorm running stats within atol 1e-5 / rtol 1e-4;
- ``Runner.val`` on a cascade (a narrow OCRNet on a fabricated Cityscapes
  tree) against the JAX cascade's ``predict`` scored by the JAX package's
  IoU (its own ``Runner.val`` reads ``decode_head`` as a dict and raises
  on the cascade's list; given the last head's config it runs), aAcc and
  mIoU within 0.05 points;
- ``convert.py``'s 1-D point kernels at in != out, and the options the
  port does not take raising ``NotImplementedError``.

torch runs on one thread in every test here (``one_thread``).  A JAX
brick's reference runs op by op, without ``jax.jit``; a segmentor's
``predict`` is jitted (one compile cost less than the forward op by op in
a fresh worker: 10.7 s against 31.0); the train steps are the JAX
package's jitted step.
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
from test_torch_port_sct_rtformer_psp import _full_width_leaves
from test_torch_port_zoo import _apply, _hold, _normal, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

CONFIGS = {'ocrnet': f'{REPO}/configs/ocrnet/ocrnet_hr18_cityscapes-512x1024.py',
           'pointrend': f'{REPO}/configs/point_rend/'
                        'pointrend_r50_cityscapes-512x1024.py'}
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit
METRIC_TOL = 0.05          # percentage points, port val against JAX val


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


# narrow copies of the configs: every structural choice kept, widths cut
def _narrow_hrnet(blocks=1):
    """HRNet at widths 8-64, one module per stage, ``blocks`` per branch."""
    widths = (8, 16, 32, 64)
    stage = lambda s, kind: dict(num_modules=1, num_branches=s, block=kind,
                                 num_blocks=(blocks,) * s,
                                 num_channels=widths[:s])
    return dict(stage1=dict(stage(1, 'BOTTLENECK'), num_channels=(16,)),
                stage2=stage(2, 'BASIC'), stage3=stage(3, 'BASIC'),
                stage4=stage(4, 'BASIC'))


def _heads(name, classes=19, dropout=None):
    """The config's two heads cut to a test width (a list replaces the
    list: ``--cfg-options`` take no index)."""
    first, second = Config.fromfile(CONFIGS[name]).model.decode_head
    if name == 'ocrnet':
        first = dict(first, in_channels=[8, 16, 32, 64], channels=24)
        second = dict(second, in_channels=[8, 16, 32, 64], channels=16,
                      ocr_channels=8)
    else:
        first = dict(first, in_channels=256, channels=16)
        second = dict(second, in_channels=32, channels=16)
    heads = [dict(first, num_classes=classes), dict(second, num_classes=classes)]
    if dropout is not None:
        heads[0]['dropout_ratio'] = dropout
    return heads


_R50_NARROW = {'model.backbone.stem_channels': 16,
               'model.backbone.base_channels': 8}   # stages 32, 64, 128, 256
NARROW = {'ocrnet': {'model.backbone.extra': _narrow_hrnet(),
                     'model.decode_head': _heads('ocrnet')},
          'pointrend': dict(_R50_NARROW, **{'model.decode_head':
                                            _heads('pointrend')})}


def _configs(name, extra):
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(CONFIGS[name])
        cfg.merge_from_dict(dict(extra))
        out.append(cfg)
    return out


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with.
# ------------------------------------------------------------------ training
# PointRend's step over a ResNetV1c-18 trunk (stages 8-64): over the narrow
# R50 trunk's 16 bottlenecks float32 rounding alone moves the stem past
# the bounds in both packages (``test_torch_port_sct_rtformer_psp.py``'s
# DeepLabV3+ note); the R50 trunk's forward is held by the predict test
TRAIN = {
    'ocrnet': {'model.backbone.extra': _narrow_hrnet(),
               'model.decode_head': _heads('ocrnet', 3),
               'model.data_preprocessor.size': (128, 128)},
    'pointrend': {'model.backbone.stem_channels': 16,
                  'model.backbone.base_channels': 8,
                  'model.backbone.depth': 18,
                  'model.decode_head': [
                      dict(h, in_channels=w) for h, w in
                      zip(_heads('pointrend', 3, dropout=0.0), (64, 8))],
                  'model.data_preprocessor.size': (64, 64)}}


def _jax_point_coords(jmodel, variables, jpre, imgs, lbl):
    """The training points of the JAX PointRend step at state step 0: its
    forward under the step's ``dropout`` key, ``fold_in(PRNGKey(42), 0)``
    (``lednet_tpu/engine/state.py``), with PointHead's outputs captured."""
    x, y, _ = jpre(jnp.asarray(imgs), jnp.asarray(lbl), training=True)
    _, state = jmodel.apply(
        variables, x, y, method='loss', mutable=['batch_stats', 'intermediates'],
        rngs={'dropout': jax.random.fold_in(jax.random.PRNGKey(42), 0)},
        capture_intermediates=lambda mdl, method: mdl.name == '_heads_1')
    return np.array(state['intermediates']['_heads_1']['__call__'][0][2])


@pytest.mark.parametrize('name', list(TRAIN))
def test_train_step_matches_jax(name):
    """One SGD step of the narrow config in both packages from the same
    weights and batch (3 classes; PointRend's coarse FCN dropout 0): OCRNet
    at 2 x 128x128 (CE 0.4 on the FCN stage, 1.0 on OCR), PointRend at 4 x
    64x64 with PointHead's 2048 points fed from the JAX forward under the
    step's own key (``train_points`` replaced on the instance; the coarse
    stage's CE and ``loss_point``)."""
    jcfg, cfg = _configs(name, TRAIN[name])
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    shape = (2, 128, 128) if name == 'ocrnet' else (4, 64, 64)
    rng = np.random.default_rng(90)
    imgs = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lbl = np.where(rng.random(shape) < 0.02, 255,
                   rng.integers(0, 3, shape)).astype(np.int32)
    params, stats = loss_variables(jmodel, (1,) + shape[1:], n_classes=3,
                                   seed=91)
    jvars = jax_variables(params, stats)
    # a copy: the JAX step donates its state, whose buffers may alias the
    # numpy arrays that flax_to_state_dict's tensors share
    before = {k: v.clone() for k, v in flax_to_state_dict(params, stats).items()}
    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    if name == 'pointrend':
        coords = torch.from_numpy(_jax_point_coords(jmodel, jvars, jpre, imgs, lbl))
        assert tuple(coords.shape) == (4, 2048, 2)
        model.decode_heads[1].train_points = lambda coarse: coords
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
    second = ({'decode_1.loss_ce', 'decode_1.acc_seg'} if name == 'ocrnet'
              else {'decode_1.loss_point'})
    assert set(logs) - {'loss', 'grad_norm'} == keys == {
        'decode_0.loss_ce', 'decode_0.acc_seg'} | second
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    # acc_seg is an argmax of upsampled logits: a near-tie of one low
    # resolution logit decides a block of pixels (1/4: 4x4, 1/32: 32x32)
    block = (16 if name == 'ocrnet' else 1024) * 100.0 / int((lbl != 255).sum())
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
        if k.startswith('decode_heads.1.') and not stat:
            moved = max(moved, (got[k] - before[k]).abs().max().item())
    assert moved > 1e-4          # the second stage learned something


# ------------------------------------------------------------------ runner
def test_runner_val_on_a_cascade_matches_jax(tmp_path):
    """``Runner.val`` of a narrow OCRNet on three 128x256 val frames of a
    fabricated Cityscapes tree (resized to 256x512 by the test pipeline)
    predicts with the last stage.  The JAX ``Runner.val`` raises on the
    cascade's list of heads; with the last head's config in its place
    (the model already built) it runs the JAX cascade's ``predict`` and
    scores it with the JAX package's IoU: aAcc and mIoU within 0.05
    points."""
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu_torch.datasets.synthetic import make_cityscapes_tree
    from lednet_tpu_torch.engine.runner import Runner
    root = make_cityscapes_tree(str(tmp_path / 'cityscapes'), n_train=1,
                                n_val=3, size_hw=(128, 256), seed=3)
    options = dict(NARROW['ocrnet'], **{
        f'{k}.dataset.data_root': root for k in
        ('train_dataloader', 'val_dataloader', 'test_dataloader')},
        **{'val_dataloader.num_workers': 2, 'val_batch_size': 1,
           'vis_backends': None})

    def config(cls):
        cfg = cls.fromfile(CONFIGS['ocrnet'])
        cfg.merge_from_dict(options)
        cfg.val_dataloader.dataset.pipeline[1]['scale'] = (256, 128)
        return cfg
    jrunner = JRunner(config(JConfig), work_dir=str(tmp_path / 'jax'))
    params, stats = loss_variables(jrunner.model, (1, 128, 128), seed=92)
    variables = jax_variables(params, stats)
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    with pytest.raises(AttributeError):
        jrunner.val()
    jrunner.cfg.model['decode_head'] = jrunner.cfg.model['decode_head'][-1]
    want = jrunner.val()

    runner = Runner(config(Config), work_dir=str(tmp_path / 'port'),
                    device='cpu')
    assert type(runner.model).__name__ == 'CascadeEncoderDecoder'
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    got = runner.val()
    assert 1.0 < want['aAcc'] < 95.0 and want['mIoU'] > 0.1   # not degenerate
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', list(NARROW))
def test_segmentor_predict_matches_jax(name):
    """The narrow copy of the config (19 classes, float32 input):
    ``predict`` of two seeded 96x160 images through both stages, the CPU
    eval step equal to it.  PointRend's coarse map is 3x5, so each
    subdivision step takes every point (k = H*W)."""
    jcfg, cfg = _configs(name, NARROW[name])
    shape = (96, 160)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1,) + shape, n_classes=19, seed=93)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    imgs = np.random.default_rng(94).integers(0, 256, (2,) + shape + (3,),
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


@pytest.mark.parametrize('name', list(CONFIGS))
def test_config_builds_and_every_leaf_maps(name):
    """The config unchanged, at full width: every converted flax leaf is a
    port key of the same shape, and none of the port's is left over;
    ``decode_head`` is the last stage."""
    jmodel = JMODELS.build(dict(JConfig.fromfile(CONFIGS[name]).model))
    port = init_model(CONFIGS[name], device='cpu')
    sd = _full_width_leaves(jmodel, (1, 64, 64), method='loss')
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    port.load_state_dict(sd)
    assert port.decode_head is port.decode_heads[1]
    assert type(port.decode_head).__name__ == ('OCRHead' if name == 'ocrnet'
                                               else 'PointHead')
    assert not any(k.startswith('decode_head.') for k in want)


# ------------------------------------------------------------------ OCR
def test_self_attention_block_matches_jax():
    """OCR's form on 9x11 queries and 5 region keys (a 5x1 map)."""
    from lednet_tpu.models.decode_heads.context_heads import \
        SelfAttentionBlock as J
    from lednet_tpu_torch.models.decode_heads.ocr_head import SelfAttentionBlock
    kw = dict(key_in_channels=12, query_in_channels=12, channels=8,
              out_channels=12, key_query_num_convs=2, key_query_norm=True,
              value_out_num_convs=1, value_out_norm=True, matmul_norm=True,
              with_out=True)
    q = _normal((2, 9, 11, 12), seed=95)
    k = _normal((2, 5, 1, 12), seed=96, scale=3.0)
    jmod = J(**kw)
    params, stats = random_variables(jmod, jnp.asarray(q), jnp.asarray(k),
                                     seed=97)
    port = load_port(SelfAttentionBlock(**kw), params, stats)
    with torch.no_grad():
        out = port(nchw(q), nchw(k))
    _hold(nhwc(out), _apply(jmod, params, stats, jnp.asarray(q), jnp.asarray(k)))


@pytest.mark.parametrize('prev', ['same', 'resized', 'none'])
def test_ocr_head_matches_jax(prev):
    """OCRHead over two levels (resize_concat) with the previous stage's
    logits at its 12x14 size, at 6x7 (resized to 12x14) or absent (zeros):
    logits and loss."""
    from lednet_tpu.models.decode_heads.uper_ocr import OCRHead as J
    cfg = dict(in_channels=[6, 10], in_index=(0, 1),
               input_transform='resize_concat', channels=16, ocr_channels=8,
               num_classes=5, dropout_ratio=-1)
    feats = [_normal((2, 12, 14, 6), seed=98), _normal((2, 6, 7, 10), seed=99)]
    hw = {'same': (12, 14), 'resized': (6, 7), 'none': None}[prev]
    logits = None if hw is None else _normal((2,) + hw + (5,), seed=100,
                                              scale=2.0)
    jhead = J(**cfg)
    jin = [jnp.asarray(f) for f in feats]
    jprev = None if logits is None else jnp.asarray(logits)
    params, stats = random_variables(jhead, jin, jprev, seed=101)
    head = load_port(MODELS.build(dict(cfg, type='OCRHead')), params, stats)
    with torch.no_grad():
        out = head([nchw(f) for f in feats],
                   None if logits is None else nchw(logits))
    ref = _apply(jhead, params, stats, jin, jprev)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(102).integers(0, 5, (2, 48, 56)).astype(np.int32)
    lbl[0, :4] = 255
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_ce', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


def test_unported_options_raise():
    from lednet_tpu_torch.models.decode_heads.ocr_head import SelfAttentionBlock
    base = dict(key_in_channels=8, query_in_channels=8, channels=4,
                out_channels=8, key_query_norm=True, value_out_norm=True)
    for extra, word in ((dict(key_pool_scales=(1, 3)), 'key_pool_scales'),
                        (dict(share_key_query=True), 'share_key_query'),
                        (dict(key_query_norm=False), 'key_query_norm')):
        with pytest.raises(NotImplementedError, match=word):
            SelfAttentionBlock(**dict(base, **extra))
    with pytest.raises(NotImplementedError, match='scale'):
        MODELS.build(dict(type='OCRHead', in_channels=8, channels=8,
                          num_classes=3, scale=2))
    with pytest.raises(NotImplementedError, match='sampler'):
        MODELS.build(dict(type='PointHead', in_channels=8, channels=8,
                          num_classes=3, sampler=dict(type='OHEMPixelSampler')))
    with pytest.raises(ValueError, match='cascade'):
        MODELS.build(dict(type='CascadeEncoderDecoder', num_stages=2,
                          backbone=dict(type='ResNetV1c', depth=18),
                          decode_head=dict(type='FCNHead', in_channels=8,
                                           channels=8, num_classes=3)))


# ------------------------------------------------------------------ PointRend
def test_point_sample_at_the_borders():
    """Points within half a pixel of every border (and on it): the JAX
    package's clamped bilinear sample, which differs there from mmcv's
    zero-padded one."""
    from lednet_tpu.models.decode_heads.point_setr_heads import \
        point_sample as jsample
    from lednet_tpu_torch.models.decode_heads.point_head import point_sample
    H, W = 5, 7
    feat = _normal((2, H, W, 3), seed=103)
    rng = np.random.default_rng(104)
    edge_x = np.concatenate([[0.0, 1.0], rng.uniform(0, 0.5 / W, 6),
                             1 - rng.uniform(0, 0.5 / W, 6)])
    edge_y = np.concatenate([[0.0, 1.0], rng.uniform(0, 0.5 / H, 6),
                             1 - rng.uniform(0, 0.5 / H, 6)])
    inner = rng.uniform(0, 1, 14)
    xs = np.concatenate([edge_x, inner, edge_x])
    ys = np.concatenate([inner, edge_y, edge_y])
    coords = np.stack([xs, ys], -1).astype(np.float32)[None].repeat(2, 0)
    ref = np.asarray(jsample(jnp.asarray(feat), jnp.asarray(coords)))
    out = point_sample(nchw(feat), torch.from_numpy(coords))
    assert tuple(out.shape) == (2, 3, coords.shape[1])
    got = out.permute(0, 2, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    zeros = torch.nn.functional.grid_sample(
        nchw(feat), torch.from_numpy(coords * 2 - 1).unsqueeze(1),
        padding_mode='zeros', align_corners=False).squeeze(2)
    assert np.abs(zeros.permute(0, 2, 1).numpy() - ref).max() > 1e-2


def _point_head_pair(seed, **kw):
    """(JAX head, port head, params, fine (2, 24, 32, 6), coarse logits
    (2, 6, 8, 5)) of a narrow PointHead, both on the same weights."""
    from lednet_tpu.models.decode_heads.point_setr_heads import PointHead as J
    from lednet_tpu_torch.models.decode_heads.point_head import PointHead
    cfg = dict(in_channels=6, channels=10, num_classes=5, in_index=0, **kw)
    jhead = J(**cfg)
    fine = _normal((2, 24, 32, 6), seed=seed)
    coarse = _normal((2, 6, 8, 5), seed=seed + 1, scale=2.0)
    params, _ = random_variables(jhead, [jnp.asarray(fine)],
                                 jnp.asarray(coarse), seed=seed + 2)
    head = load_port(PointHead(**cfg), params, {})
    return jhead, head, params, fine, coarse


def _rows(points):
    """(P, 2) points in (x, y) order, for comparing sets of points."""
    points = np.asarray(points)
    return points[np.lexsort((points[:, 1], points[:, 0]))]


def test_point_head_subdivision_matches_jax():
    """Eval on a 6x8 coarse map, 50 points a step: 12x16 (k = 50 of 192),
    then 24x32 (50 of 768).  Each step's 50th and 51st uncertainties are
    apart (no tie for ``topk`` to break otherwise than ``lax.top_k``);
    the refined logits, the last step's point logits and coordinates."""
    jhead, head, params, fine, coarse = _point_head_pair(
        105, subdivision_num_points=50)
    gaps = []
    top = head.top_uncertain

    def recording(unc, k):
        s = unc.sort(dim=1, descending=True).values
        gaps.append((s[:, k - 1] - s[:, k]).min().item())
        return top(unc, k)
    head.top_uncertain = recording
    with torch.no_grad():
        refined, point_logits, coords = head([nchw(fine)], nchw(coarse))
    ref = jhead.apply({'params': params}, [jnp.asarray(fine)],
                      jnp.asarray(coarse))
    assert len(gaps) == 2 and min(gaps) > 1e-4, gaps
    assert tuple(refined.shape) == (2, 5, 24, 32)
    _hold(nhwc(refined), ref[0])
    for b in range(2):
        pts, jpts = coords.numpy()[b], np.asarray(ref[2])[b]
        order = np.lexsort((pts[:, 1], pts[:, 0]))
        jorder = np.lexsort((jpts[:, 1], jpts[:, 0]))
        np.testing.assert_array_equal(pts[order], jpts[jorder])
        _hold(point_logits.numpy()[b][:, order].T[None],
              np.asarray(ref[1])[b][jorder][None])


def test_point_head_training_points_match_jax(monkeypatch):
    """The train-time selection given the JAX head's own candidates: its
    6144 uniform candidates and 512 fresh points (``jax.random.uniform``
    recorded during its forward) through ``select_points`` give JAX's 2048
    coordinates exactly (the 1536th and 1537th uncertainties apart), and
    the MLP at them JAX's point logits; the coarse logits pass through."""
    jhead, head, params, fine, coarse = _point_head_pair(106)
    drawn = []
    uniform = jax.random.uniform

    def recorded(*args, **kwargs):
        out = uniform(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out
    monkeypatch.setattr(jax.random, 'uniform', recorded)
    ref, _ = jhead.apply({'params': params}, [jnp.asarray(fine)],
                         jnp.asarray(coarse), train=True,
                         rngs={'dropout': jax.random.PRNGKey(7)},
                         mutable=['batch_stats'])
    monkeypatch.undo()
    cand, fresh = drawn
    assert cand.shape == (2, 6144, 2) and fresh.shape == (2, 512, 2)
    head.train()
    unc = head.uncertainty(torch.from_numpy(np.array(
        _sample_jax(coarse, cand)).transpose(0, 2, 1)))
    s = unc.sort(dim=1, descending=True).values
    assert (s[:, 1535] - s[:, 1536]).min().item() > 1e-5
    coords = head.select_points(nchw(coarse), torch.from_numpy(cand),
                                torch.from_numpy(fresh))
    for b in range(2):
        np.testing.assert_array_equal(_rows(coords.numpy()[b]),
                                      _rows(np.asarray(ref[2])[b]))
    np.testing.assert_array_equal(coords.numpy()[:, 1536:], fresh)
    head.train_points = lambda c: torch.from_numpy(np.asarray(ref[2]))
    with torch.no_grad():
        out = head([nchw(fine)], nchw(coarse))
    assert torch.equal(out[0], nchw(coarse))
    _hold(out[1].permute(0, 2, 1).numpy(), ref[1])


def _sample_jax(feat, coords):
    from lednet_tpu.models.decode_heads.point_setr_heads import point_sample
    return point_sample(jnp.asarray(feat), jnp.asarray(coords))


def test_point_selection_breaks_ties_as_jax():
    """Uncertainties with exact ties (points sampled in a clamped border
    share a value): ``top_uncertain`` keeps the indices ``jax.lax.top_k``
    keeps, in its order, ties to the lower index."""
    from lednet_tpu_torch.models.decode_heads.point_head import PointHead
    rng = np.random.default_rng(111)
    unc = rng.integers(-6, 0, (3, 200)).astype(np.float32) / 4
    head = PointHead(in_channels=4, channels=8, num_classes=3)
    for k in (1, 37, 200):
        want = np.asarray(jax.lax.top_k(jnp.asarray(unc), k)[1])
        got = head.top_uncertain(torch.from_numpy(unc), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_point_loss_matches_jax():
    """``loss_point`` at JAX's coordinates (nearest label by truncation,
    some at the last row and column) on a 40x56 label map with ignored
    pixels: CE over the valid points over their number."""
    from lednet_tpu.models.decode_heads.point_setr_heads import PointHead as J
    from lednet_tpu_torch.models.decode_heads.point_head import PointHead
    rng = np.random.default_rng(107)
    coords = rng.uniform(0, 1, (2, 300, 2)).astype(np.float32)
    coords[:, :10] = 1.0 - rng.uniform(0, 1e-3, (2, 10, 2))
    coords[:, 10:20] = np.arange(10)[None, :, None] / np.array([56, 40])
    point_logits = _normal((2, 300, 5), seed=108, scale=2.0)
    lbl = rng.integers(0, 5, (2, 40, 56)).astype(np.int32)
    lbl[:, :, 50:] = 255
    jhead = J(in_channels=6, channels=10, num_classes=5)
    want = jhead.loss_by_feat((None, jnp.asarray(point_logits),
                               jnp.asarray(coords)), jnp.asarray(lbl))
    head = PointHead(in_channels=6, channels=10, num_classes=5)
    got = head.loss_by_feat((None, torch.from_numpy(point_logits).permute(0, 2, 1),
                             torch.from_numpy(coords)),
                            torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_point'}
    assert rel_err(got['loss_point'].numpy(), want['loss_point']) <= 1e-6


# ------------------------------------------------------------------ bridge
def test_convert_point_kernels_and_cascade_heads():
    """PointHead's (1, in, out) kernels at in != out become ``nn.Conv1d``'s
    (out, in, 1); a 3-D kernel elsewhere raises; ``_heads_{i}`` are
    ``decode_heads.{i}``; the MLP draws LeCun normal weights."""
    from lednet_tpu_torch.models.decode_heads.point_head import PointHead
    from lednet_tpu_torch.models.layers import init_weights
    rng = np.random.default_rng(109)
    k = rng.standard_normal((1, 275, 256)).astype(np.float32)
    sd = flax_to_state_dict({'_heads_1': {'fc0': {'kernel': k,
                                                  'bias': np.zeros(256)}}})
    assert sorted(sd) == ['decode_heads.1.fc0.bias', 'decode_heads.1.fc0.weight']
    w = sd['decode_heads.1.fc0.weight'].numpy()
    assert w.shape == (256, 275, 1)
    np.testing.assert_array_equal(w[:, :, 0], k[0].T)
    with pytest.raises(ValueError, match='3-D kernel'):
        flax_to_state_dict({'_heads_1': {'theta': {'kernel': k}}})
    head = PointHead(in_channels=256, channels=256, num_classes=19)
    assert tuple(head.fc0.weight.shape) == (256, 275, 1)
    assert tuple(head.fc_seg.weight.shape) == (19, 275, 1)
    init_weights(head, torch.Generator().manual_seed(0))
    assert head.fc1.weight.std().item() == pytest.approx(275 ** -0.5, rel=0.05)
    assert not head.fc1.bias.any()


def test_chip_smoke_pins_the_point_selection():
    """``chip_smoke.decisions`` records PointHead's training points as the
    set of candidates kept, counts the candidates a later call keeps
    otherwise, and with ``pin`` keeps the recorded set, in candidate
    order."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    from lednet_tpu_torch.models.decode_heads.point_head import PointHead
    head = PointHead(in_channels=4, channels=8, num_classes=3, num_points=8)
    unc = torch.from_numpy(np.random.default_rng(110).normal(0, 1, (2, 24)))
    kept = []
    with chip_smoke.decisions(kept):
        first = head.top_uncertain(unc, 6)
    want = torch.zeros(2, 24, dtype=torch.bool).scatter_(
        1, torch.topk(unc, 6, dim=1).indices, True)
    assert len(kept) == 1 and torch.equal(kept[0], want)
    assert torch.equal(first, torch.topk(unc, 6, dim=1).indices.sort(1).values)
    moved = unc.clone()
    moved[0, first[0, 0]] = -10.0          # one kept candidate falls out
    flips = {}
    with chip_smoke.decisions(kept, flips, pin=True):
        pinned = head.top_uncertain(moved, 6)
    assert flips == {'points': 2} and torch.equal(pinned, first)
