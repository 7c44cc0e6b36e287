"""PyTorch port: slide inference (``predict_slide``, the eval step's slide
mode) and the configs that use it, UNet-S5-D16 on DRIVE and HRNet on Pascal
Context, against ``lednet_tpu`` on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- ``_slide_grid``: the same crop origins, in the same order, exactly, over
  a table of shapes (an exact fit, one crop, a remainder row and column, a
  crop equal to the image, the DRIVE frame and a Pascal Context frame);
- ``predict_slide`` within 1e-4 x max|logit| (argmax agreement >= 99.9%):
  a narrow UNet (``base_channels`` 8, 3 stages) on 2 x 70x90 with crop 32
  and stride 21, so that the crops overlap unevenly; HRNet-W18-Small's
  Pascal Context-59 config at full width on 1 x 128x160, its ``test_cfg``
  overridden to crop 96 and stride 64 (2 x 2 crops); the CPU eval step in
  slide mode equal to ``predict_slide``;
- a crop larger than the image raises in both packages (JAX's
  ``dynamic_slice``: ``TypeError``; the port: ``ValueError`` naming both
  sizes), and so does ``inference_model`` on a 500x375 Pascal Context
  frame (resized to 520x390, padded to 416 < 480);
- the UNet bricks in eval mode, rel 1e-5 of the largest output:
  ``BasicConvBlock`` with a dilation; ``InterpConv`` bilinear, nearest and
  ``conv_first``; ``DeconvModule`` (flax's transposed kernel lands on
  ``ConvTranspose2d``'s unflipped); ``UNet`` with the DRIVE config's
  structure, with a stage that does not downsample (the 1x1 up-path) and
  with a stride-2 stage;
- the DRIVE config and the twelve HRNet Pascal Context configs build
  unchanged and every converted key lands on a port key, none left over
  (no forward, nothing compiled); HRNet's six ADE20K configs build,
  convert and predict at 64x64;
- ``PascalContextDataset``, ``PascalContextDataset59`` and
  ``DRIVEDataset`` list and load the items the JAX package's datasets give
  on fabricated trees;
- ``Runner.val`` of the narrow UNet in slide mode on a fabricated DRIVE
  tree: mDice, aAcc and mIoU within 0.05 points of the JAX Runner's;
- one SGD step of the narrow UNet with its auxiliary head, dropout 0: loss
  within 1e-5, every weight within atol 1e-4 / rtol 5e-3, the BatchNorm
  running stats within atol 1e-5 / rtol 1e-4.

torch runs on one thread in every test here (``one_thread``).  A JAX
reference that runs once runs op by op, without ``jax.jit``, except the
train step and the JAX Runner's val, which are jitted.
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
from lednet_tpu_torch.apis import inference_model, init_model
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import flax_to_state_dict
from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                     make_eval_step, make_train_step)
from lednet_tpu_torch.registry import MODELS
from test_torch_port_common import REPO, jax_variables, nhwc, rel_err
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_bisenetv2_hrnet import _pair
from test_torch_port_zoo import _hold, _normal, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

DRIVE = f'{REPO}/configs/unet/fcn_unet_s5-d16_drive-64x64.py'
PASCAL = {f'{v}-{it}-{ds}': (f'{REPO}/configs/hrnet/fcn_{v}_4xb4-{it}_'
                             f'pascal-context{"-59" if ds == "59" else ""}-480x480.py')
          for v in ('hr18', 'hr18s', 'hr48') for it in ('40k', '80k')
          for ds in ('60', '59')}
ADE = {f'{v}-{it}': f'{REPO}/configs/hrnet/fcn_{v}_4xb4-{it}_ade20k-512x512.py'
       for v in ('hr18', 'hr18s', 'hr48') for it in ('80k', '160k')}
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit
METRIC_TOL = 0.05          # percentage points, port val against JAX val
# a narrow UNet: base_channels 8, 3 stages (8, 16, 32 channels), the FCN
# head on the last decoder map and the auxiliary head on the one before
NARROW = {'model.backbone.base_channels': 8,
          'model.backbone.num_stages': 3,
          'model.backbone.strides': (1, 1, 1),
          'model.backbone.enc_num_convs': (2, 2, 2),
          'model.backbone.dec_num_convs': (2, 2),
          'model.backbone.downsamples': (True, True),
          'model.backbone.enc_dilations': (1, 1, 1),
          'model.backbone.dec_dilations': (1, 1),
          'model.decode_head.in_channels': 8,
          'model.decode_head.in_index': 2,
          'model.decode_head.channels': 8,
          'model.auxiliary_head.in_channels': 16,
          'model.auxiliary_head.in_index': 1,
          'model.auxiliary_head.channels': 8}


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


def _cfgs(config, extra=()):
    """(JAX config, port config) of ``config`` with ``extra`` merged."""
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(config)
        cfg.merge_from_dict(dict(extra))
        out.append(cfg)
    return out


def _pair_models(config, extra=(), seed=0, shape=(1, 64, 64)):
    """(JAX segmentor, its preprocessor, variables; port model with the
    same weights) of ``config`` with ``extra``."""
    jcfg, cfg = _cfgs(config, extra)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, shape,
                                   n_classes=jcfg.model.decode_head.num_classes,
                                   seed=seed)
    model = init_model(cfg, device='cpu')
    sd = flax_to_state_dict(params, stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return jmodel, jpre, jax_variables(params, stats), model


def _hold_logits(out, ref):
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with.
# ------------------------------------------------------------------ training
def test_train_step_matches_jax():
    """One SGD step of the narrow UNet (FCN head and auxiliary FCN head,
    both with dropout 0) on 2 x 64x64, 2 classes: the heads' CE (the
    auxiliary weighted 0.4), from the same weights and batch."""
    extra = dict(NARROW, **{'model.decode_head.dropout_ratio': 0.0,
                            'model.auxiliary_head.dropout_ratio': 0.0})
    jmodel, jpre, jvars, model = _pair_models(DRIVE, extra, seed=60)
    jcfg, cfg = _cfgs(DRIVE, extra)
    rng = np.random.default_rng(61)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    lbl = np.where(rng.random((2, 64, 64)) < 0.02, 255,
                   rng.integers(0, 2, (2, 64, 64))).astype(np.int32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    step = make_train_step(model, opt, model.data_preprocessor)
    state, logs = step(create_train_state(model, opt, sched),
                       torch.from_numpy(imgs), torch.from_numpy(lbl.astype(np.int64)))
    assert state.step == 1 and model.training
    logs = {k: float(v) for k, v in logs.items()}

    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                         batch_stats=jvars['batch_stats'],
                         opt_state=tx.init(jvars['params']))
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))
    jlogs = {k: float(v) for k, v in jlogs.items()}

    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    assert set(logs) - {'loss', 'grad_norm'} == keys == {
        f'{h}.{k}' for h in ('decode', 'aux') for k in ('loss_ce', 'acc_seg')}
    assert abs(logs['loss'] - jlogs['loss']) <= 1e-5
    one_pixel = 100.0 / int((lbl != 255).sum())
    for k in keys:
        tol = dict(rel=0, abs=1.01 * one_pixel) if k.endswith('acc_seg') \
            else dict(rel=1e-4, abs=1e-5)
        assert logs[k] == pytest.approx(jlogs[k], **tol), k
    assert logs['grad_norm'] == pytest.approx(jlogs['grad_norm'], rel=1e-3)
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
    assert moved > 1e-4


# ------------------------------------------------------------------ val
@pytest.fixture(scope='module')
def drive_tree(tmp_path_factory):
    from lednet_tpu_torch.datasets.synthetic import make_drive_tree
    return make_drive_tree(str(tmp_path_factory.mktemp('drive')), n_train=1,
                           n_val=2, size_hw=(96, 80), seed=62)


def test_runner_val_matches_jax(drive_tree, tmp_path):
    """``Runner.val`` of the narrow UNet in slide mode (crop 64, stride 42)
    on the tree's two 96x80 val frames (the test pipeline's resize set to
    (96, 80), which keeps them; padded to the 128 bucket: 3 x 3 crops),
    with ``iou_metrics`` set to mIoU and mDice: mDice, aAcc and mIoU within
    0.05 points of the JAX Runner's."""
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu_torch.engine.runner import Runner
    options = dict(NARROW, **{f'{k}.dataset.data_root': drive_tree for k in
                              ('train_dataloader', 'val_dataloader',
                               'test_dataloader')})
    options.update({'val_dataloader.num_workers': 2, 'val_batch_size': 1,
                    'vis_backends': None,
                    'val_evaluator.iou_metrics': ['mIoU', 'mDice']})

    def config(cls):
        cfg = cls.fromfile(DRIVE)
        cfg.merge_from_dict(options)
        cfg.val_dataloader.dataset.pipeline[1]['scale'] = (96, 80)
        return cfg
    jrunner = JRunner(config(JConfig), work_dir=str(tmp_path / 'jax'))
    assert jrunner.test_mode == 'slide'
    params, stats = loss_variables(jrunner.model, (1, 64, 64), seed=63)
    variables = jax_variables(params, stats)
    # the eval step reads only the weights: no init, no optimizer state
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.val()

    runner = Runner(config(Config), work_dir=str(tmp_path / 'port'),
                    device='cpu')
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    step = runner.eval_step()
    assert step.mode == 'slide'
    shapes = []
    forward = step.forward
    step.forward = lambda x: shapes.append(tuple(x.shape)) or forward(x)
    got = runner.val()
    assert shapes == [(1, 128, 128, 3)] * 2
    assert 0 < want['aAcc'] < 100 and 0 < want['mDice'] < 100
    for key in ('mDice', 'aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


# ------------------------------------------------------------------ predict
def test_narrow_unet_predict_slide_matches_jax():
    """The narrow UNet in slide mode, crop 32 and stride 21 on 2 x 70x90:
    crops at rows 0, 21, 38 and columns 0, 21, 42, 58 (the last of each
    clamped), 12 per image, overlapping unevenly; the CPU eval step in slide
    mode equal to ``predict_slide``."""
    extra = dict(NARROW, **{'model.test_cfg': dict(
        mode='slide', crop_size=(32, 32), stride=(21, 21))})
    jmodel, jpre, jvars, model = _pair_models(DRIVE, extra, seed=64)
    imgs = np.random.default_rng(65).integers(0, 256, (2, 70, 90, 3),
                                              dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    ref = np.asarray(jmodel.apply(jvars, x, method='predict_slide'))
    with torch.no_grad():
        px, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        out = model.predict_slide(px).numpy()
    assert out.shape == (2, 70, 90, 2)
    _hold_logits(out, ref)
    step = make_eval_step(model, model.data_preprocessor, mode='slide')
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


def test_hrnet_pascal_context_predict_slide_matches_jax():
    """HRNet-W18-Small's Pascal Context-59 config at full width (59
    classes), ``test_cfg`` overridden to crop 96 and stride 64 (from 480 /
    320) so that 1 x 128x160 takes 2 x 2 crops."""
    config = PASCAL['hr18s-40k-59']
    extra = {'model.test_cfg': dict(mode='slide', crop_size=(96, 96),
                                    stride=(64, 64))}
    jmodel, jpre, jvars, model = _pair_models(config, extra, seed=66)
    imgs = np.random.default_rng(67).integers(0, 256, (1, 128, 160, 3),
                                              dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    ref = np.asarray(jmodel.apply(jvars, x, method='predict_slide'))
    with torch.no_grad():
        px, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        out = model.predict_slide(px).numpy()
    assert out.shape == (1, 128, 160, 59)
    _hold_logits(out, ref)


@pytest.mark.parametrize('name', sorted(ADE))
def test_hrnet_ade20k_config_predicts_as_jax(name):
    """HRNet's ADE20K configs unchanged (full width, 150 classes, whole
    mode): they build, every converted key lands on a port key, and
    ``predict`` of a seeded 64x64 image holds to JAX's; the CPU eval step
    equals it."""
    jmodel, jpre, jvars, model = _pair_models(ADE[name], seed=68)
    assert model.test_cfg.get('mode', 'whole') == 'whole'
    imgs = np.random.default_rng(69).integers(0, 256, (1, 64, 64, 3),
                                              dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    ref = np.asarray(jmodel.apply(jvars, x, method='predict'))
    with torch.no_grad():
        px, _, _ = model.data_preprocessor(torch.from_numpy(imgs))
        out = model.predict(px).numpy()
    assert out.shape == (1, 64, 64, 150)
    _hold_logits(out, ref)
    step = make_eval_step(model, model.data_preprocessor)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


def test_crop_larger_than_image_raises():
    """A 32x32 crop on a 24x40 image: JAX's ``dynamic_slice`` raises a
    ``TypeError``, the port a ``ValueError`` naming both sizes, in
    ``predict_slide`` and in the eval step; ``inference_model`` of
    HRNet-W18-Small's Pascal Context-59 config on a 500x375 frame (the
    test pipeline resizes it to 520x390, which ``inference_model`` pads to
    a multiple of 32: 416 rows, 544 columns, fewer rows than the 480 crop)
    raises the same way, before any conv runs."""
    extra = dict(NARROW, **{'model.test_cfg': dict(
        mode='slide', crop_size=(32, 32), stride=(21, 21))})
    jmodel, jpre, jvars, model = _pair_models(DRIVE, extra, seed=70)
    imgs = np.random.default_rng(71).integers(0, 256, (1, 24, 40, 3),
                                              dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    with pytest.raises(TypeError, match='slice_sizes'):
        jmodel.apply(jvars, x, method='predict_slide')
    with torch.no_grad(), pytest.raises(ValueError, match='32x32.*24x40'):
        model.predict_slide(model.data_preprocessor(torch.from_numpy(imgs))[0])
    step = make_eval_step(model, model.data_preprocessor, mode='slide')
    with pytest.raises(ValueError, match='32x32.*24x40'):
        step(torch.from_numpy(imgs))
    pascal = init_model(PASCAL['hr18s-40k-59'], device='cpu')
    frame = np.random.default_rng(72).integers(0, 256, (375, 500, 3),
                                               dtype=np.uint8)
    with pytest.raises(ValueError, match='480x480.*416x544'):
        inference_model(pascal, frame)


# ------------------------------------------------------------------ grid
GRIDS = {'exact': ((96, 128), (32, 32), (32, 32)),
         'one_crop': ((20, 30), (32, 32), (21, 21)),
         'remainder': ((70, 90), (32, 32), (21, 21)),
         'equal': ((64, 64), (64, 64), (42, 42)),
         'drive': ((608, 576), (64, 64), (42, 42)),
         'pascal': ((500, 500), (480, 480), (320, 320))}


@pytest.mark.parametrize('name', sorted(GRIDS))
def test_slide_grid_matches_jax(name):
    from lednet_tpu.models.segmentors.encoder_decoder import _slide_grid as J
    from lednet_tpu_torch.models.segmentors.encoder_decoder import _slide_grid
    (H, W), crop, stride = GRIDS[name]
    got = _slide_grid(H, W, crop, stride)
    assert got == J(H, W, crop, stride)
    n = {'exact': 12, 'one_crop': 1, 'remainder': 12, 'equal': 1,
         'drive': 196, 'pascal': 4}[name]
    assert len(got) == n
    assert all(0 <= y <= max(H - crop[0], 0) and 0 <= x <= max(W - crop[1], 0)
               for y, x in got)


def test_slide_accumulate_counts_visits():
    """Each crop added in grid order and divided by its visit count: crops
    of constant value v_i average to the mean of the crops that cover a
    pixel."""
    from lednet_tpu_torch.models.segmentors.encoder_decoder import (
        EncoderDecoder, _slide_grid)
    starts = _slide_grid(70, 90, (32, 32), (21, 21))
    vals = torch.arange(1.0, len(starts) + 1)
    crops = vals.view(-1, 1, 1, 1).expand(len(starts), 3, 32, 32)
    out = EncoderDecoder.slide_accumulate(crops, starts, (70, 90))
    want = np.zeros((70, 90))
    count = np.zeros((70, 90))
    for v, (y, x) in zip(vals.numpy(), starts):
        want[y:y + 32, x:x + 32] += v
        count[y:y + 32, x:x + 32] += 1
    assert count.min() >= 1 and count.max() == 4
    np.testing.assert_allclose(out[0, 0].numpy(), want / count, rtol=1e-6)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', ['drive'] + sorted(PASCAL))
def test_config_builds_and_converts(name):
    """The config unchanged: ``init_model`` builds it in slide mode with its
    crop and stride; every flax key of the JAX segmentor (its auxiliary
    head too) lands on a port key and none is left over.  No forward."""
    config = DRIVE if name == 'drive' else PASCAL[name]
    model = init_model(config, device='cpu')
    crop, stride, classes = (((64, 64), (42, 42), 2) if name == 'drive' else
                             ((480, 480), (320, 320), int(name[-2:])))
    assert model.test_cfg == dict(mode='slide', crop_size=crop, stride=stride)
    assert model.decode_head.cls.conv_seg.out_channels == classes
    assert len(model.dataset_meta['classes']) == classes
    jmodel = JMODELS.build(dict(JConfig.fromfile(config).model))
    params, stats = loss_variables(jmodel, (1, 64, 64), n_classes=classes)
    sd = flax_to_state_dict(params, stats)
    assert set(sd) == set(MODELS.build(dict(Config.fromfile(config).model))
                          .state_dict())
    if name == 'drive':
        assert 'aux_heads.0.conv0.conv.weight' in sd
        np.testing.assert_array_equal(
            sd['backbone.up3.conv.conv.weight'].numpy(),
            params['_backbone']['up3']['conv']['conv']['kernel']
            .transpose(3, 2, 0, 1))


# ------------------------------------------------------------------ data
@pytest.fixture(scope='module')
def pascal_tree(tmp_path_factory):
    from lednet_tpu_torch.datasets.synthetic import make_pascal_context_tree
    return make_pascal_context_tree(str(tmp_path_factory.mktemp('pascal')),
                                    n_train=2, n_val=2,
                                    sizes_hw=((75, 100), (100, 75)), seed=73)


DATASETS = {'PascalContextDataset': 'pascal', 'PascalContextDataset59': 'pascal',
            'DRIVEDataset': 'drive'}


@pytest.mark.parametrize('name', sorted(DATASETS))
def test_dataset_matches_jax(name, pascal_tree, drive_tree):
    """The port's dataset lists the tree's items as the JAX package's does
    (Pascal Context by its ``ann_file``, DRIVE by its ``_manual1.png``
    suffix) and loads the same images and labels (the 59-class set: label
    0 as 255, x as x - 1), with the same classes and palette."""
    from lednet_tpu.datasets import more_datasets as jds
    import lednet_tpu_torch.datasets as pds
    from lednet_tpu_torch.datasets import imageio
    if DATASETS[name] == 'pascal':
        kw = dict(data_root=pascal_tree,
                  data_prefix=dict(img_path='JPEGImages',
                                   seg_map_path='SegmentationClassContext'),
                  ann_file='ImageSets/SegmentationContext/val.txt')
    else:
        kw = dict(data_root=drive_tree,
                  data_prefix=dict(img_path='images/validation',
                                   seg_map_path='annotations/validation'))
    kw['pipeline'] = [dict(type='LoadImageFromFile'), dict(type='LoadAnnotations')]
    pset, jset = getattr(pds, name)(**kw), getattr(jds, name)(**kw)
    assert len(pset) == len(jset) == 2
    assert pset.metainfo['classes'] == jset.metainfo['classes']
    assert pset.metainfo['palette'] == jset.metainfo['palette']
    for idx in range(len(pset)):
        got, want = pset[idx], jset[idx]
        assert got['img_path'] == want['img_path']
        assert got['seg_map_path'] == want['seg_map_path']
        np.testing.assert_array_equal(got['img'], want['img'])
        np.testing.assert_array_equal(got['gt_seg_map'], want['gt_seg_map'])
        raw = imageio.imread(got['seg_map_path'], 'unchanged')
        if name == 'PascalContextDataset59':
            np.testing.assert_array_equal(
                got['gt_seg_map'], np.where(raw == 0, 255, raw.astype(np.int32) - 1))
        else:
            np.testing.assert_array_equal(got['gt_seg_map'], raw)
        if name == 'DRIVEDataset':
            assert got['seg_map_path'].endswith('_manual1.png')
            assert set(np.unique(raw)) == {0, 1}


# ------------------------------------------------------------------ bricks
def test_basic_conv_block_matches_jax():
    """Three convs at stride 2 and dilation 2: the first carries the
    stride, undilated; the others the dilation."""
    from lednet_tpu.models.backbones.unet import BasicConvBlock as J
    from lednet_tpu_torch.models.backbones.unet import BasicConvBlock
    x = _normal((2, 13, 17, 6), seed=1)
    ref, out = _pair(J(6, 8, num_convs=3, stride=2, dilation=2),
                     BasicConvBlock(6, 8, num_convs=3, stride=2, dilation=2),
                     x, seed=2)
    assert out.shape == (2, 8, 7, 9)
    _hold(nhwc(out), ref)


INTERP = {'bilinear': dict(),
          'nearest': dict(upsample_cfg=dict(scale_factor=2, mode='nearest')),
          'conv_first': dict(conv_first=True, kernel_size=3, padding=1)}


@pytest.mark.parametrize('name', sorted(INTERP))
def test_interp_conv_matches_jax(name):
    from lednet_tpu.models.backbones.unet import InterpConv as J
    from lednet_tpu_torch.models.backbones.unet import InterpConv
    x = _normal((2, 7, 9, 6), seed=3)
    ref, out = _pair(J(6, 5, **INTERP[name]), InterpConv(6, 5, **INTERP[name]),
                     x, seed=4)
    assert out.shape == (2, 5, 14, 18)
    _hold(nhwc(out), ref)


def test_deconv_module_matches_jax():
    """flax ``ConvTranspose`` (``transpose_kernel=True``, padding k - 1 - p)
    against ``ConvTranspose2d`` (padding p) with the kernel converted by
    the plain (3, 2, 0, 1) transpose: no spatial flip."""
    from lednet_tpu.models.backbones.unet import DeconvModule as J
    from lednet_tpu_torch.models.backbones.unet import DeconvModule
    x = _normal((2, 7, 9, 6), seed=5)
    ref, out = _pair(J(6, 5), DeconvModule(6, 5), x, seed=6)
    assert out.shape == (2, 5, 14, 18)
    _hold(nhwc(out), ref)


UNETS = {
    'drive': (dict(base_channels=4), (2, 32, 48)),
    'no_downsample': (dict(base_channels=4, num_stages=4,
                           enc_num_convs=(2, 1, 2, 2), dec_num_convs=(1, 2, 2),
                           downsamples=(True, False, True),
                           enc_dilations=(1, 1, 2, 1),
                           dec_dilations=(1, 2, 1)), (2, 24, 40)),
    'stride2_deconv': (dict(base_channels=4, num_stages=4,
                            strides=(1, 2, 1, 1),
                            downsamples=(False, True, True),
                            upsample_cfg=dict(type='DeconvModule')),
                       (2, 32, 48)),
}


@pytest.mark.parametrize('name', sorted(UNETS))
def test_unet_matches_jax(name):
    """UNet at base_channels 4: the DRIVE config's structure (5 stages,
    four pools, InterpConv); a stage that does not downsample (the decoder
    takes the 1x1 ConvModule there), with dilations; a stride-2 stage (no
    pool before it) with DeconvModule upsamplers.  Every output, deepest
    first."""
    from lednet_tpu.models.backbones.unet import UNet as J
    from lednet_tpu_torch.models.backbones.unet import UNet
    kw, shape = UNETS[name]
    x = _normal(shape + (3,), seed=7)
    ref, out = _pair(J(**kw), UNet(**kw), x, seed=8)
    stages = kw.get('num_stages', 5)
    assert len(out) == len(ref) == stages
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)
    port = UNet(**kw)
    kinds = {n: type(m).__name__ for n, m in port.named_children()
             if n.startswith('up')}
    if name == 'no_downsample':
        assert kinds['up1'] == 'ConvModule' and kinds['up0'] == 'InterpConv'
    if name == 'stride2_deconv':
        assert port.pool_before == [False, False, True, True]
        assert set(kinds.values()) == {'DeconvModule'}
