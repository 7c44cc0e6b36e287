"""PyTorch port: the ViT segmenters (SETR naive / PUP / MLA, Segmenter,
DPT, the MLN UPerNet), the ViT's dropout and stochastic depth, and the
semantic FPN (``FPN``, ``FPNHead``, PointRend over it) against
``lednet_tpu`` on the CPU.

The eight ``configs/_base_/models`` files are composed as
mmsegmentation's top-level configs of their families compose them
(``chip_smoke.VIT_FPN``, ``chip_smoke.compose_base``: dataset, schedule,
runtime, the crop as the preprocessor's size, the dataset's classes) into
the test's ``tmp_path``, and both packages read the same file.  Each test
feeds the same numpy inputs (``numpy.random.default_rng(seed)``) through
the JAX module and its port after ``lednet_tpu_torch.convert`` has carried
the same random flax weights and BatchNorm running stats across (every
norm scale drawn near 1, ``_norm_scales``), and holds them together:

- the bricks in eval mode, rel 1e-5 of the largest output: the ViT at the
  shipped rates (0.1); ``SETRUPHead`` naive and PUP; ``MLANeck``,
  ``SETRMLAHead`` and ``FCNHead`` with ``num_convs=0``; the Segmenter
  head; ``DPTHead`` with readout ``project`` and ``ignore`` on a 3 x 5
  grid (``resize3`` rounds 3 x 5 to 2 x 3, the fusion resizes);
  ``MultiLevelNeck``; ``FPN`` at odd sizes with nearest upsampling (and
  bilinear); ``FPNHead``;
- the dropout laws in training, which cannot match JAX's stream: eval,
  and rate 0, are the identity (the ViT's forward at rate 0.1 in eval
  equal to its forward at rate 0); a fixed torch seed gives the same
  output twice; ``DropPath`` keeps whole samples scaled by 1 / keep; the
  kept fraction lies within a binomial bound; the sum is preserved in
  expectation;
- the eight files build in both packages at full width with equal leaf
  maps (``jax.eval_shape``, nothing run);
- narrow copies of each: ``predict`` (Segmenter's slide, PointRend's
  subdivision) within 1e-4 x max|logit| with argmax agreement >= 99.9%,
  the CPU eval step equal to it;
- one train step each of SETR-MLA (its four auxiliary heads), Segmenter,
  DPT and PointRend-FPN, the drop rates zeroed, within phase 6's bounds
  (loss 1e-5; weights atol 1e-4 / rtol 5e-3; BatchNorm stats atol 1e-5 /
  rtol 1e-4);
- ``Runner.val`` of the narrow Segmenter (slide) on a fabricated ADE20K
  tree, aAcc and mIoU within 0.05 points of the JAX Runner's.

``pointrend_r50.py`` gives its PointHead ``in_index=[0]``, which the JAX
head indexes the outputs with and raises; the JAX side here reads it with
``input_transform='multiple_select'``, as mmseg's PointHead does and the
port does on its own (ROADMAP, gaps on the reference's side).

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
from test_torch_port_common import (REPO, _fill, _plain, jax_variables,
                                    load_port, nchw, nhwc, random_variables,
                                    rel_err)
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_knet_mask2former import _norm_scales
from test_torch_port_ocr_pointrend import _jax_point_coords
from test_torch_port_sct_rtformer_psp import _full_width_leaves
from test_torch_port_zoo import _normal

pytestmark = pytest.mark.usefixtures('one_thread')

ENTRIES = {e[1][:-3]: e for e in chip_smoke.VIT_FPN}
TOL_BRICK = 1e-5           # modules, rel to the largest output
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit
METRIC_TOL = 0.05          # percentage points, port val against JAX val


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


def _hold(out, ref, tol=TOL_BRICK):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= tol, rel_err(out, ref)


def _brick(jmod, port, jin, tin, seed, **kw):
    """(port output, JAX output) of a brick in eval on the same weights."""
    params, stats = random_variables(jmod, jin, seed=seed, **kw)
    params = _norm_scales(params, seed)
    load_port(port, params, stats)
    with torch.no_grad():
        out = port(tin)
    return out, jmod.apply(jax_variables(params, stats), jin, train=False, **kw)


# ------------------------------------------------------------ composition
def _vit(embed_dims=32, num_layers=4, num_heads=4, **kw):
    """Options that narrow the ViT trunk, every structural choice kept."""
    return dict({'model.backbone.embed_dims': embed_dims,
                 'model.backbone.num_layers': num_layers,
                 'model.backbone.num_heads': num_heads}, **kw)


def _heads(cfg, key, **changes):
    """The config's head list ``key`` with ``changes`` in every entry (a
    list replaces the list)."""
    return [dict(h, **changes) for h in cfg.model[key]]


def narrow(name, cfg):
    """Options that cut the composed config ``cfg`` of ``name`` to a test
    width: the ViT 32 wide (4 heads) and 3-4 layers deep, ResNet-50's
    stages 32-256 wide, the heads 8-32."""
    vit = _vit(**{'model.backbone.out_indices': (0, 1, 2, 3)})
    if name in ('setr_naive', 'setr_pup'):
        return dict(vit, **{
            'model.decode_head.in_channels': 32,
            'model.decode_head.channels': 16,
            'model.auxiliary_head': _heads(cfg, 'auxiliary_head',
                                           in_channels=32, channels=16)})
    if name == 'setr_mla':
        return dict(vit, **{
            'model.neck.in_channels': [32] * 4, 'model.neck.out_channels': 16,
            'model.decode_head.in_channels': (16,) * 4,
            'model.decode_head.channels': 32,
            'model.decode_head.mla_channels': 8,
            'model.auxiliary_head': _heads(cfg, 'auxiliary_head',
                                           in_channels=16, channels=16)})
    if name == 'segmenter_vit-b16_mask':
        return dict(_vit(num_layers=3, **{'model.backbone.out_indices': (2,)}),
                    **{'model.decode_head.in_channels': 32,
                       'model.decode_head.channels': 32,
                       'model.decode_head.embed_dims': 32,
                       'model.decode_head.num_heads': 4})
    if name == 'dpt_vit-b16':
        return dict(vit, **{
            'model.decode_head.in_channels': (32,) * 4,
            'model.decode_head.channels': 16,
            'model.decode_head.embed_dims': 32,
            'model.decode_head.post_process_channels': [8, 16, 24, 32]})
    if name == 'upernet_vit-b16_ln_mln':
        return dict(vit, **{
            'model.neck.in_channels': [32] * 4, 'model.neck.out_channels': 16,
            'model.decode_head.in_channels': [16] * 4,
            'model.decode_head.channels': 16,
            'model.auxiliary_head.in_channels': 16,
            'model.auxiliary_head.channels': 8})
    r50 = {'model.backbone.stem_channels': 16, 'model.backbone.base_channels': 8,
           'model.neck.in_channels': [32, 64, 128, 256],
           'model.neck.out_channels': 16}
    if name == 'fpn_r50':
        return dict(r50, **{'model.decode_head.in_channels': [16] * 4,
                            'model.decode_head.channels': 8})
    fpn, point = cfg.model.decode_head
    return dict(r50, **{'model.decode_head': [
        dict(fpn, in_channels=[16] * 4, channels=8),
        dict(point, in_channels=[16], channels=16)]})


def _configs(tmp_path, name, extra=None):
    """(JAX config, port config) of the composed file of ``name``, the
    options ``extra`` (or the narrow ones) merged; the JAX PointHead reads
    ``in_index=[0]`` as ``'multiple_select'``."""
    path = chip_smoke.compose_base(str(tmp_path), ENTRIES[name])
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(path)
        cfg.merge_from_dict(narrow(name, cfg) if extra is None else extra)
        out.append(cfg)
    if name == 'pointrend_r50':
        heads = list(out[0].model.decode_head)
        heads[1] = dict(heads[1], input_transform='multiple_select')
        out[0].model['decode_head'] = heads
    return out


def _seeded(jmodel, shape, seed):
    """(params, batch_stats) of a JAX segmentor initialised through
    ``loss`` (so that its auxiliary heads have variables), filled from a
    numpy seed like ``random_variables``, every norm scale near 1; a model
    without BatchNorm (Segmenter) has no stats."""
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
    return (_norm_scales(fill(shapes['params']), seed),
            fill(shapes.get('batch_stats', {})))


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with.
# ------------------------------------------------------------------ training
def _zeroed(name, cfg):
    """The narrow options with every drop rate 0 (two RNG streams cannot
    drop the same units) and 3 classes."""
    extra = narrow(name, cfg)
    if cfg.model.backbone.type == 'VisionTransformer':
        for key in ('drop_rate', 'attn_drop_rate', 'drop_path_rate'):
            extra[f'model.backbone.{key}'] = 0.0
    if name == 'segmenter_vit-b16_mask':
        extra['model.decode_head.drop_path_rate'] = 0.0
    if name == 'pointrend_r50':
        # a ResNetV1c-18 trunk: over the narrow R50's 16 bottlenecks
        # float32 rounding alone moves the stem past the bounds in both
        # packages (test_torch_port_ocr_pointrend.py's note)
        extra.update({'model.backbone.depth': 18,
                      'model.neck.in_channels': [8, 16, 32, 64]})
        extra['model.decode_head'] = [dict(h, num_classes=3)
                                      for h in extra['model.decode_head']]
        return extra
    extra['model.decode_head.num_classes'] = 3
    extra['model.decode_head.dropout_ratio'] = 0.0
    if name == 'setr_mla':
        extra['model.auxiliary_head'] = [dict(h, num_classes=3)
                                         for h in extra['model.auxiliary_head']]
    return extra


TRAIN = {'setr_mla': (2, 64, 64), 'segmenter_vit-b16_mask': (2, 64, 64),
         'dpt_vit-b16': (2, 64, 64), 'pointrend_r50': (4, 64, 64)}


@pytest.mark.parametrize('name', list(TRAIN))
def test_train_step_matches_jax(tmp_path, name):
    """One SGD step of the narrow composed config in both packages from the
    same weights and batch, 3 classes, every drop rate 0: SETR-MLA with
    its four auxiliary FCN heads (``num_convs=0``), Segmenter, DPT at 2 x
    64x64, PointRend-FPN at 4 x 64x64 over a ResNetV1c-18 trunk with
    PointHead's 2048 points fed from the JAX forward under the step's own
    key.  Loss within 1e-5, every weight within atol 1e-4 / rtol 5e-3, the
    BatchNorm running stats within atol 1e-5 / rtol 1e-4."""
    shape = TRAIN[name]
    probe = Config.fromfile(chip_smoke.compose_base(str(tmp_path), ENTRIES[name]))
    extra = _zeroed(name, probe)
    extra['model.data_preprocessor.size'] = shape[1:]
    jcfg, cfg = _configs(tmp_path, name, extra)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    rng = np.random.default_rng(220)
    imgs = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lbl = rng.integers(0, 3, (shape[0], shape[1] // 8, shape[2] // 8))
    lbl = lbl.repeat(8, 1).repeat(8, 2)
    lbl = np.where(rng.random(shape) < 0.02, 255, lbl).astype(np.int32)
    params, stats = _seeded(jmodel, (1,) + shape[1:], 221)
    jvars = jax_variables(params, stats)
    # a copy: the JAX step donates its state, whose buffers may alias the
    # numpy arrays that flax_to_state_dict's tensors share
    before = {k: v.clone() for k, v in flax_to_state_dict(params, stats).items()}
    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    if name == 'pointrend_r50':
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
    assert set(logs) - {'loss', 'grad_norm'} == keys
    if name == 'setr_mla':
        assert {f'aux_{i}.loss_ce' for i in range(4)} <= keys
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    # acc_seg is an argmax of upsampled logits: a near-tie of one low
    # resolution logit decides a block of pixels
    block = 256 * 100.0 / int((lbl != 255).sum())
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


# ------------------------------------------------------------------ runner
def test_runner_val_segmenter_slide_matches_jax(tmp_path):
    """``Runner.val`` of the narrow Segmenter composition in slide mode
    (crop 64, stride 48) on two 128x256 val frames of a fabricated ADE20K
    tree (the test pipeline's resize set to keep them: 3 x 5 crops), aAcc
    and mIoU within 0.05 points of the JAX Runner's."""
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu_torch.datasets.synthetic import make_ade20k_tree
    from lednet_tpu_torch.engine.runner import Runner
    name = 'segmenter_vit-b16_mask'
    root = make_ade20k_tree(str(tmp_path / 'ade'), n_train=1, n_val=2,
                            sizes_hw=((128, 256),), seed=222)
    probe = Config.fromfile(chip_smoke.compose_base(str(tmp_path), ENTRIES[name]))
    options = dict(narrow(name, probe), **{
        f'{k}.dataset.data_root': root for k in
        ('train_dataloader', 'val_dataloader', 'test_dataloader')},
        **{'val_dataloader.num_workers': 2, 'val_batch_size': 1,
           'vis_backends': None,
           'model.test_cfg': dict(mode='slide', crop_size=(64, 64),
                                  stride=(48, 48))})
    jcfg, cfg = _configs(tmp_path, name, options)
    for c in (jcfg, cfg):
        c.val_dataloader.dataset.pipeline[1]['scale'] = (256, 128)
    jrunner = JRunner(jcfg, work_dir=str(tmp_path / 'jax'))
    assert jrunner.test_mode == 'slide'
    params, stats = _seeded(jrunner.model, (1, 64, 64), 223)
    variables = jax_variables(params, stats)
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.val()

    runner = Runner(cfg, work_dir=str(tmp_path / 'port'), device='cpu')
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    step = runner.eval_step()
    assert step.mode == 'slide'
    shapes = []
    forward = step.forward
    step.forward = lambda x: shapes.append(tuple(x.shape)) or forward(x)
    got = runner.val()
    assert shapes == [(1, 128, 256, 3)] * 2
    assert want['aAcc'] > 0.1 and want['mIoU'] > 0.01      # not degenerate
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


# ------------------------------------------------------------------ configs
PREDICT = {'setr_naive': (96, 160), 'setr_pup': (96, 160),
           'setr_mla': (96, 160), 'segmenter_vit-b16_mask': (512, 704),
           'dpt_vit-b16': (96, 160), 'upernet_vit-b16_ln_mln': (96, 160),
           'fpn_r50': (96, 160), 'pointrend_r50': (96, 160)}


@pytest.mark.parametrize('name', list(PREDICT))
def test_segmentor_predict_matches_jax(tmp_path, name):
    """The narrow copy of the composed config (its classes, float32 input):
    ``predict`` of seeded images (two; one for Segmenter, whose 512x704
    frame takes two overlapping 512 crops at stride 480), the CPU eval
    step equal to it.  PointRend's second subdivision step takes the 8196
    most uncertain of 15,360 points."""
    jcfg, cfg = _configs(tmp_path, name)
    shape = PREDICT[name]
    n = 1 if name == 'segmenter_vit-b16_mask' else 2
    classes = ENTRIES[name][4]
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = _seeded(jmodel, (1, 64, 64), 224)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    mode = model.test_cfg.get('mode', 'whole')
    method = 'predict_slide' if mode == 'slide' else 'predict'
    imgs = np.random.default_rng(225).integers(0, 256, (n,) + shape + (3,),
                                               dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method=method))(
        jax_variables(params, stats), x))
    with torch.no_grad():
        px, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        out = getattr(model, method)(px).numpy()
    assert out.shape == ref.shape == (n,) + shape + (classes,)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree
    step = make_eval_step(model, model.data_preprocessor, mode)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


@pytest.mark.parametrize('name', list(ENTRIES))
def test_base_model_builds_and_every_leaf_maps(name):
    """The ``_base_/models`` file unchanged, at full width (ViT-L for
    SETR): every converted flax leaf is a port key of the same shape, and
    none of the port's is left over."""
    path = f'{REPO}/configs/_base_/models/{name}.py'
    jcfg = JConfig.fromfile(path)
    if name == 'pointrend_r50':
        heads = list(jcfg.model.decode_head)
        heads[1] = dict(heads[1], input_transform='multiple_select')
        jcfg.model['decode_head'] = heads
    sd = _full_width_leaves(JMODELS.build(dict(jcfg.model)), (1, 64, 64),
                            method='loss')
    want = init_model(path, device='cpu').state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k


# ------------------------------------------------------------------ bricks
@pytest.mark.parametrize('kw', [
    dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1),
    dict(drop_rate=0.1, output_cls_token=True, out_indices=(1, 3)),
], ids=['rates', 'cls-token'])
def test_vit_eval_at_shipped_rates_matches_jax(kw):
    """The ViT in eval with the shipped rates (0.1): its outputs at a
    resized (bilinear) position grid, and with ``output_cls_token`` the
    (grid, cls) pairs, as the JAX ViT gives them; the same forward as at
    rate 0."""
    from lednet_tpu.models.backbones.vit import VisionTransformer as J
    from lednet_tpu_torch.models.backbones.vit import VisionTransformer
    kw = dict(kw)
    cfg = dict(img_size=64, patch_size=8, embed_dims=24, num_layers=4,
               num_heads=4, out_indices=kw.pop('out_indices', (0, 1, 2, 3)),
               interpolate_mode='bilinear', **kw)
    x = _normal((2, 40, 56, 3), seed=226)
    port = VisionTransformer(**cfg)
    out, ref = _brick(J(**cfg), port, jnp.asarray(x), nchw(x), seed=227)
    for o, r in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(ref)):
        o = o.numpy()
        _hold(np.moveaxis(o, 1, -1) if o.ndim == 4 else o, r)
    zero = VisionTransformer(**dict(cfg, drop_rate=0.0, attn_drop_rate=0.0,
                                    drop_path_rate=0.0))
    zero.load_state_dict(port.state_dict())
    with torch.no_grad():
        again = zero.eval()(nchw(x))
    for o, z in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(again)):
        assert torch.equal(o, z)


@pytest.mark.parametrize('form', ['naive', 'pup'])
def test_setr_up_head_matches_jax(form):
    """SETR's naive head (one 1x1 stage at x4) and PUP's (four 3x3 stages at
    x2) on a 3x5 grid, the LayerNorm first; logits and loss."""
    from lednet_tpu.models.decode_heads.context_heads import SETRUPHead as J
    stages = dict(num_convs=1, kernel_size=1, up_scale=4) if form == 'naive' \
        else dict(num_convs=4, kernel_size=3, up_scale=2)
    cfg = dict(in_channels=12, channels=8, num_classes=5, in_index=1,
               dropout_ratio=0.0, norm_cfg=dict(type='SyncBN'), **stages)
    feats = [_normal((2, 3, 5, 12), seed=228 + i) for i in range(2)]
    head = MODELS.build(dict(cfg, type='SETRUPHead'))
    out, ref = _brick(J(**cfg), head, [jnp.asarray(f) for f in feats],
                      [nchw(f) for f in feats], seed=230)
    up = stages['up_scale'] ** stages['num_convs']
    assert tuple(out.shape) == (2, 5, 3 * up, 5 * up)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(231).integers(0, 5, (2, 96, 160))
    want = J(**cfg).loss_by_feat(ref, jnp.asarray(lbl.astype(np.int32)))
    got = head.loss_by_feat(out, torch.from_numpy(lbl))
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= TOL_BRICK, k


def test_mla_neck_and_head_match_jax():
    """``MLANeck`` (LayerNorm, 1x1, the top-down sum, deepest first) on four
    3x5 levels, ``SETRMLAHead`` on its outputs, and ``FCNHead`` with
    ``num_convs=0`` and ``concat_input=False`` (setr_mla.py's auxiliary
    heads: the classifier of the level alone)."""
    from lednet_tpu.models.decode_heads.fcn_head import FCNHead as JFCN
    from lednet_tpu.models.decode_heads.point_setr_heads import SETRMLAHead as JH
    from lednet_tpu.models.necks import MLANeck as JN
    feats = [_normal((2, 3, 5, 12), seed=232 + i) for i in range(4)]
    ncfg = dict(in_channels=[12] * 4, out_channels=8,
                norm_cfg=dict(type='SyncBN'), act_cfg=dict(type='ReLU'))
    neck = MODELS.build(dict(ncfg, type='MLANeck'))
    outs, refs = _brick(JN(**ncfg), neck, [jnp.asarray(f) for f in feats],
                        [nchw(f) for f in feats], seed=236)
    for o, r in zip(outs, refs):
        _hold(nhwc(o), r)
    # deepest first: out0 convolves the deepest level alone
    hcfg = dict(in_channels=(8,) * 4, channels=16, num_classes=5,
                mla_channels=4, dropout_ratio=0.0, norm_cfg=dict(type='SyncBN'))
    head = MODELS.build(dict(hcfg, type='SETRMLAHead'))
    out, ref = _brick(JH(**hcfg), head, list(refs), list(outs), seed=237)
    assert tuple(out.shape) == (2, 5, 12, 20)
    _hold(nhwc(out), ref)
    fcfg = dict(in_channels=8, channels=8, num_classes=5, in_index=2,
                num_convs=0, kernel_size=1, concat_input=False,
                dropout_ratio=0.0)
    fcn = MODELS.build(dict(fcfg, type='FCNHead'))
    out, ref = _brick(JFCN(**fcfg), fcn, list(refs), list(outs), seed=238)
    assert set(dict(fcn.named_children())) == {'cls'}
    _hold(nhwc(out), ref)


def test_segmenter_head_matches_jax():
    """The mask transformer on a 3x5 grid: class embeddings after the
    patches, two blocks (stochastic depth 0.1, the class default, idle in
    eval), the normalised projections, ``mask_norm``; masks and loss."""
    from lednet_tpu.models.decode_heads.point_setr_heads import \
        SegmenterMaskTransformerHead as J
    cfg = dict(in_channels=16, channels=16, num_classes=7, num_layers=2,
               num_heads=4, embed_dims=24, dropout_ratio=0.0)
    x = _normal((2, 3, 5, 16), seed=239)
    head = MODELS.build(dict(cfg, type='SegmenterMaskTransformerHead'))
    assert head.b1_drop_path.rate == pytest.approx(0.1)
    out, ref = _brick(J(**cfg), head, [jnp.asarray(x)], [nchw(x)], seed=240)
    assert tuple(out.shape) == (2, 7, 3, 5)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(241).integers(0, 7, (2, 48, 80))
    want = J(**cfg).loss_by_feat(ref, jnp.asarray(lbl.astype(np.int32)))
    got = head.loss_by_feat(out, torch.from_numpy(lbl))
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= TOL_BRICK, k


@pytest.mark.parametrize('readout', ['project', 'ignore'])
def test_dpt_head_matches_jax(readout):
    """DPT on four (3x5 grid, cls) pairs: the readout, ``resize0`` /
    ``resize1`` (transposed, to 12x20 and 6x10: the kernel mapping on a
    non-square map), ``resize3`` (3x5 -> 2x3), the fusion's resizes of the
    residuals (3x5 to 4x6, 6x10 to 8x12, 12x20 to 16x24), its
    align_corners x2: logits at 32x48."""
    from lednet_tpu.models.decode_heads.point_setr_heads import DPTHead as J
    cfg = dict(in_channels=(12,) * 4, channels=8, num_classes=5,
               embed_dims=12, post_process_channels=[4, 6, 8, 10],
               readout_type=readout, norm_cfg=dict(type='SyncBN'),
               dropout_ratio=0.0)
    feats = [(_normal((2, 3, 5, 12), seed=242 + i),
              _normal((2, 12), seed=246 + i)) for i in range(4)]
    head = MODELS.build(dict(cfg, type='DPTHead'))
    out, ref = _brick(J(**cfg), head,
                      [(jnp.asarray(f), jnp.asarray(c)) for f, c in feats],
                      [(nchw(f), torch.from_numpy(c)) for f, c in feats],
                      seed=250)
    assert tuple(out.shape) == (2, 5, 32, 48)
    _hold(nhwc(out), ref)
    assert ('readout0.weight' in head.state_dict()) == (readout == 'project')


def test_multi_level_neck_matches_jax():
    """The MLN neck (no norm, no activation: biased convs) at scales 4, 2,
    1, 0.5 on a 3x5 grid: 0.5 rounds 3x5 down to 1x2."""
    from lednet_tpu.models.necks import MultiLevelNeck as J
    cfg = dict(in_channels=[12] * 4, out_channels=8, scales=[4, 2, 1, 0.5])
    feats = [_normal((2, 3, 5, 12), seed=251 + i) for i in range(4)]
    neck = MODELS.build(dict(cfg, type='MultiLevelNeck'))
    assert neck.conv0.norm is None and neck.conv0.conv.bias is not None
    outs, refs = _brick(J(**cfg), neck, [jnp.asarray(f) for f in feats],
                        [nchw(f) for f in feats], seed=255)
    assert [tuple(o.shape[-2:]) for o in outs] == [(12, 20), (6, 10), (3, 5),
                                                    (1, 2)]
    for o, r in zip(outs, refs):
        _hold(nhwc(o), r)


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_fpn_matches_jax(mode):
    """FPN over four levels of odd sizes (25x19, 13x10, 7x5, 4x3), the
    top-down path upsampling by ``mode`` (nearest: the legacy rounding),
    ``start_level`` 1 (``lateral{1,2,3}``, ``fpn{0,1,2}``), ``num_outs``
    2."""
    from lednet_tpu.models.necks import FPN as J
    cfg = dict(in_channels=[4, 6, 8, 10], out_channels=8, num_outs=2,
               start_level=1, upsample_cfg=dict(mode=mode))
    sizes = [(25, 19), (13, 10), (7, 5), (4, 3)]
    feats = [_normal((2, h, w, c), seed=256 + i)
             for i, ((h, w), c) in enumerate(zip(sizes, cfg['in_channels']))]
    fpn = MODELS.build(dict(cfg, type='FPN'))
    assert {n for n, _ in fpn.named_children()} == {
        'lateral1', 'lateral2', 'lateral3', 'fpn0', 'fpn1', 'fpn2'}
    outs, refs = _brick(J(**cfg), fpn, [jnp.asarray(f) for f in feats],
                        [nchw(f) for f in feats], seed=260)
    assert len(outs) == len(refs) == 2
    for o, r in zip(outs, refs):
        _hold(nhwc(o), r)


def test_fpn_head_matches_jax():
    """FPNHead at strides 4-32 on FPN-sized maps of a 50x38 input (13x10,
    7x5, 4x3, 2x2): 1, 1, 2, 3 convs, the upsampled levels resized to the
    first; logits and loss."""
    from lednet_tpu.models.decode_heads.fpn_sct_heads import FPNHead as J
    cfg = dict(in_channels=[6] * 4, channels=8, num_classes=5,
               dropout_ratio=-1, norm_cfg=dict(type='SyncBN'))
    feats = [_normal((2, h, w, 6), seed=261 + i)
             for i, (h, w) in enumerate([(13, 10), (7, 5), (4, 3), (2, 2)])]
    head = MODELS.build(dict(cfg, type='FPNHead'))
    assert head.lengths == [1, 1, 2, 3]
    out, ref = _brick(J(**cfg), head, [jnp.asarray(f) for f in feats],
                      [nchw(f) for f in feats], seed=265)
    assert tuple(out.shape) == (2, 5, 13, 10)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(266).integers(0, 5, (2, 52, 40))
    want = J(**cfg).loss_by_feat(ref, jnp.asarray(lbl.astype(np.int32)))
    got = head.loss_by_feat(out, torch.from_numpy(lbl))
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= TOL_BRICK, k


# ------------------------------------------------------------------ dropout
def _vit_pair(**rates):
    from lednet_tpu_torch.models.backbones.vit import VisionTransformer
    cfg = dict(img_size=32, patch_size=8, embed_dims=16, num_layers=3,
               num_heads=2, out_indices=(2,))
    vit = VisionTransformer(**cfg, **rates)
    zero = VisionTransformer(**cfg)
    torch.manual_seed(267)
    for p in vit.parameters():
        torch.nn.init.normal_(p, std=0.2)
    zero.load_state_dict(vit.state_dict())
    return vit, zero


def test_dropout_identity_in_eval_and_at_rate_zero():
    """In eval the ViT at the shipped rates is its rate-0 forward exactly;
    at rate 0 in training it is that forward too (no module draws)."""
    vit, zero = _vit_pair(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
    x = torch.from_numpy(_normal((2, 3, 32, 32), seed=268))
    with torch.no_grad():
        want = zero.eval()(x)[0]
        assert torch.equal(vit.eval()(x)[0], want)
        state = torch.random.get_rng_state()
        assert torch.equal(zero.train()(x)[0], want)
        assert torch.equal(torch.random.get_rng_state(), state)
    assert not any(isinstance(m, (torch.nn.Dropout,)) or
                   type(m).__name__ == 'DropPath' for m in zero.modules())


def test_dropout_same_seed_same_output():
    """A fixed torch seed gives the same training forward twice; another
    seed gives another."""
    vit, _ = _vit_pair(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
    vit.train()
    x = torch.from_numpy(_normal((4, 3, 32, 32), seed=269))
    outs = []
    for seed in (5, 5, 6):
        torch.manual_seed(seed)
        with torch.no_grad():
            outs.append(vit(x)[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_drop_path_keeps_whole_samples():
    """``DropPath`` at rate 0.3 keeps each sample whole, scaled by 1 / 0.7,
    or zeroes it; the ViT's block ``i`` takes ``0.1 * i / (L - 1)``."""
    from lednet_tpu_torch.models.layers import DropPath
    drop = DropPath(0.3).train()
    torch.manual_seed(270)
    x = torch.rand(256, 3, 4, 5) + 0.5
    y = drop(x)
    kept = (y != 0).flatten(1)
    assert (kept.all(1) | ~kept.any(1)).all()          # whole samples
    k = kept.all(1)
    torch.testing.assert_close(y[k], x[k] / 0.7, rtol=1e-6, atol=0)
    vit, _ = _vit_pair(drop_path_rate=0.1)
    assert vit.b0_drop_path is None
    assert [getattr(vit, f'b{i}_drop_path').rate for i in (1, 2)] == \
        pytest.approx([0.05, 0.1])


def test_dropout_kept_fraction_within_binomial_bound():
    """Of n units at rate p, the kept count lies within 5 standard
    deviations of n (1 - p), for ``nn.Dropout`` in the ViT's MLP and for
    ``DropPath`` over samples."""
    from lednet_tpu_torch.models.layers import DropPath
    p = 0.1
    vit, _ = _vit_pair(drop_rate=p)
    torch.manual_seed(271)
    units = vit.drop.train()(torch.ones(200_000))
    samples = DropPath(p).train()(torch.ones(20_000, 1, 1))
    for y in (units, samples):
        n = y.numel()
        kept = (y != 0).sum().item()
        assert abs(kept - n * (1 - p)) <= 5 * (n * p * (1 - p)) ** 0.5, kept


def test_dropout_preserves_the_sum_in_expectation():
    """The mean over many draws of a dropped map's sum is the map's sum,
    within 5 standard errors, for dropout, DropPath and the ViT's
    attention dropout (the probabilities' row sums)."""
    from lednet_tpu_torch.models.backbones.vit import _MHSA
    from lednet_tpu_torch.models.layers import DropPath, attention
    torch.manual_seed(272)
    x = torch.rand(64, 8) + 0.5
    for layer in (torch.nn.Dropout(0.1).train(), DropPath(0.1).train()):
        sums = torch.stack([layer(x).sum() for _ in range(2000)])
        err = (sums.mean() - x.sum()).abs()
        assert err <= 5 * sums.std() / 2000 ** 0.5, (layer, err)
    q = torch.randn(2, 2, 16, 4)
    drop = torch.nn.Dropout(0.1).train()
    ones = torch.ones(2, 2, 16, 1)
    rows = torch.stack([attention(q, q, ones, dropout=drop) for _ in range(2000)])
    mean = rows.mean(0)
    assert ((mean - 1).abs() <= 5 * rows.std(0) / 2000 ** 0.5 + 1e-6).all()
    attn = _MHSA(8, 2, attn_drop=0.1).eval()
    assert attn.attn_drop is not None and attn.proj_drop is None
