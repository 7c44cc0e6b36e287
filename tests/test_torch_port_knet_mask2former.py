"""PyTorch port: K-Net (``IterativeDecodeHead``) and MaskFormer /
Mask2Former (``MaskFormerHead``, ``Mask2FormerHead``, the deformable pixel
decoder, the point-sampled mask losses) against ``lednet_tpu`` on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX function or module and its port after
``lednet_tpu_torch.convert`` has carried the same random flax weights
across, and holds them together:

- ``point_sample_nhw`` at and beyond the borders (zero padding) within
  1e-6, against ``F.grid_sample`` too; the uncertain points given JAX's
  own candidates (``jax.random.uniform`` recorded), exact ties included,
  equal; ``sampled_mask_bce_dice``'s values and gradients at the same
  points within 1e-5;
- the bricks in eval mode, rel 1e-5 of the largest output: the gated
  ``KernelUpdator``, a ``KernelUpdateHead`` stage, ``_DecoderLayer``
  (unmasked, masked, with an all-False mask row), ``MSDeformAttn`` with
  random offsets that take samples outside the maps, and
  ``bilinear_sample`` against ``F.grid_sample``;
- the matchers: the Hungarian on random costs with absent classes (cost
  1e6, ties), and the greedy fallback, equal to JAX's;
- ``IterativeDecodeHead`` with empty groups (the JAX package's seeded
  weights: few pixels pass the hard mask, zero rows into a LayerNorm) and
  filled ones (``seg_kernel`` scaled up): eval logits, the training tuple,
  the ``s{i}.loss_ce`` values and the gradients;
- ``MaskFormerHead`` and ``Mask2FormerHead`` (FPN and deformable pixel
  decoders): forward, the Hungarian assignment (equal), the three losses
  at JAX's recorded points and ``predict_by_feat``, rel 1e-4;
- both configs: built unchanged at full width, every flax leaf maps;
  narrow copies' ``predict`` within 1e-4 x max|logit| with argmax
  agreement >= 99.9%; one AdamW train step each against JAX's, gradient
  clipping engaged; K-Net's ``Runner.val`` against JAX's within 0.05
  points;
- the ``chip_smoke`` hooks that pin the heads' discrete decisions, and
  the options the port refuses.

torch runs on one thread in every test here (``one_thread``).  A JAX
reference of a whole head or segmentor, a loss or a gradient is jitted
(one compile); the bricks' run op by op; the train steps are the JAX
package's jitted step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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

CONFIGS = {'knet': f'{REPO}/configs/knet/knet_s3_fcn_r50-d8_cityscapes-512x1024.py',
           'mask2former': f'{REPO}/configs/mask2former/'
                          'mask2former_r50_cityscapes-512x1024.py'}
TOL_MODEL = 1e-4           # whole heads and segmentors, rel to the largest output
METRIC_TOL = 0.05          # percentage points, port val against JAX val


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


@pytest.fixture
def jax_hungarian(monkeypatch):
    """The JAX MaskFormer loss matches by scipy's Hungarian.  Its probe of
    host callbacks (``maskformer_head.py:77``) runs at the first match and
    answers False for the process when that match is traced (in
    ``jax.eval_shape`` or a jitted step: the probe's result is then a
    tracer, and blocking on it raises), after which every match is the
    greedy one; the port always matches by the Hungarian."""
    import lednet_tpu.models.decode_heads.maskformer_head as jmf
    monkeypatch.setattr(jmf, '_HOST_CALLBACKS', True)


def _norm_scales(tree, seed):
    """``tree`` with every norm's ``scale`` drawn as 1 + 0.1 x N(0, 1).
    ``random_variables`` draws a LayerNorm's or GroupNorm's scale as 0.1 x
    N(0, 1): through a head's chain of LayerNorms that shrinks what tells
    one kernel or query from another to rounding (K-Net's last logits
    differed across classes by 1e-5 of their size)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                if k == 'scale' else v for k, v in t.items()}
    return walk(tree)


def _jit_apply(module, **kwargs):
    """``module.apply(variables, *args, **kwargs)`` jitted: one compile.  At
    these narrow widths a compile costs less than the same forward run op
    by op in a fresh process (Mask2Former's narrow ``predict`` 3.5 s
    against 23)."""
    return jax.jit(lambda variables, *args: module.apply(variables, *args,
                                                         **kwargs))


def _grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


def _hold_grads(got, jgrads, tol):
    """Port gradients (a ``named_parameters`` dict) against JAX's (a flax
    params tree), each within ``tol`` of the largest over all."""
    want = flax_to_state_dict(jax.device_get(jgrads))
    assert set(got) == set(want)
    scale = max(np.abs(v.numpy()).max() for v in want.values())
    for k, ref in want.items():
        err = np.abs(got[k].numpy() - ref.numpy()).max()
        assert err <= tol * scale, (k, err, scale)


# narrow copies of the configs: every structural choice kept, widths cut
_R50_NARROW = {'model.backbone.stem_channels': 16,
               'model.backbone.base_channels': 8}   # stages 32, 64, 128, 256


def _head(name, widths, classes=19, **extra):
    """The config's head at a test width."""
    head = dict(Config.fromfile(CONFIGS[name]).model.decode_head)
    head.update(num_classes=classes, **extra)
    if name == 'knet':
        head.update(in_channels=widths[-1], channels=16, num_heads=2,
                    feedforward_channels=32)
    else:
        head.update(in_channels=list(widths), channels=16, feat_channels=16,
                    num_queries=12, num_transformer_decoder_layers=2,
                    num_heads=2)
    return head


NARROW = {name: dict(_R50_NARROW, **{'model.decode_head': _head(
    name, (32, 64, 128, 256))}) for name in CONFIGS}


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
# the steps run over a ResNetV1c-18 trunk (stages 8-64): over the narrow
# R50 trunk's 16 bottlenecks float32 rounding alone moves the stem past
# the bounds in both packages (``test_torch_port_sct_rtformer_psp.py``'s
# DeepLabV3+ note); the R50 trunk's forward is held by the predict test
TRAIN = {name: {'model.backbone.stem_channels': 16,
                'model.backbone.base_channels': 8,
                'model.backbone.depth': 18,
                'model.decode_head': _head(name, (8, 16, 32, 64), classes=3,
                                           dropout_ratio=0.0),
                'model.data_preprocessor.size': (64, 64)} for name in CONFIGS}


def _record_points(monkeypatch):
    """Record the points of the JAX package's sampled mask losses, inside
    its jitted step too (a debug callback), into a list."""
    import lednet_tpu.ops.point_loss as jpoint
    drawn = []
    uncertain = jpoint.uncertain_point_coords

    def recorded(*args, **kwargs):
        out = uncertain(*args, **kwargs)
        jax.debug.callback(lambda c: drawn.append(np.array(c)), out)
        return out
    monkeypatch.setattr(jpoint, 'uncertain_point_coords', recorded)
    return drawn


@pytest.mark.parametrize('name', list(TRAIN))
def test_train_step_matches_jax(name, monkeypatch, jax_hungarian):
    """One AdamW step of the narrow config (ResNetV1c-18 trunk, 3 classes,
    dropout 0) in both packages from the same weights and a 4 x 64x64
    batch: K-Net's four stages' CE, Mask2Former's CE, mask BCE and Dice
    (its 12544 points a mask recorded in the JAX step and fed to the
    port).  The configs clip the gradient norm (K-Net at 1.0, Mask2Former
    at 0.01), and the clip is engaged here.  Loss within 1e-5, BatchNorm
    running stats within atol 1e-5 / rtol 1e-4, the updates by the AdamW
    rule of ``test_torch_port_segformer_swin.py``."""
    jcfg, cfg = _configs(name, TRAIN[name])
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    rng = np.random.default_rng(240)
    imgs = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    lbl = rng.integers(0, 3, (4, 8, 8)).repeat(8, 1).repeat(8, 2)
    lbl = np.where(rng.random((4, 64, 64)) < 0.05, 255, lbl).astype(np.int32)
    params, stats = loss_variables(jmodel, (1, 64, 64), n_classes=3, seed=241)
    params = _norm_scales(params, 241)
    # a copy: the JAX step donates its state, whose buffers may alias the
    # numpy arrays that flax_to_state_dict's tensors share
    before = {k: v.clone() for k, v in flax_to_state_dict(params, stats).items()}

    drawn = _record_points(monkeypatch)
    tx, jsched = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    jvars = jax_variables(params, stats)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                         batch_stats=jvars['batch_stats'],
                         opt_state=tx.init(jvars['params']))
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))
    jax.effects_barrier()
    monkeypatch.undo()

    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    if name == 'mask2former':
        assert len(drawn) == 1 and drawn[0].shape == (4 * 3, 12544, 2)
        coords = torch.from_numpy(drawn[0])
        model.decode_head.train_points = lambda m: coords
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    step = make_train_step(model, opt, model.data_preprocessor)
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs),
                        torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == 1 and model.training

    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    assert set(logs) - {'loss', 'grad_norm'} == keys == (
        {f'decode.s{i}.{k}' for i in range(4) for k in ('loss_ce', 'acc_seg')}
        if name == 'knet' else
        {f'decode.{k}' for k in ('loss_cls', 'loss_mask', 'loss_dice')})
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    # acc_seg is an argmax of logits upsampled 8x: a near-tie of one logit
    # decides an 8x8 block of pixels
    block = 64 * 100.0 / int((lbl != 255).sum())
    for k in keys:
        tol = dict(rel=0, abs=1.01 * block) if k.endswith('acc_seg') \
            else dict(rel=1e-4, abs=1e-5)
        assert logs[k].item() == pytest.approx(float(jlogs[k]), **tol), k
    assert logs['grad_norm'].item() == pytest.approx(float(jlogs['grad_norm']),
                                                     rel=1e-3)
    assert logs['grad_norm'].item() > 1.5 * cfg.optim_wrapper.clip_grad.max_norm
    want = flax_to_state_dict(jax.device_get(jstate.params),
                              jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    grads = {k: p.grad.abs() for k, p in model.named_parameters()}
    scale = max(g.max().item() for g in grads.values())
    lr, moved = sched(0), 0.0
    for k, ref in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        if k.endswith('running_mean') or k.endswith('running_var'):
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(), err_msg=k,
                                       atol=1e-5, rtol=1e-4)
            continue
        # AdamW's first step moves each weight by about +-lr whatever |g|
        # (``test_torch_port_segformer_swin.py``): the updates are held,
        # within 1e-6 where |g| is above 1e-3 of the largest, within 2 lr
        # (a flipped sign) elsewhere
        upd, jupd = got[k] - before[k], ref - before[k]
        clear = grads[k] > 1e-3 * scale
        if clear.any():
            assert (upd - jupd)[clear].abs().max().item() <= 1e-6, k
        assert (upd - jupd).abs().max().item() <= 2.02 * lr, k
        if k.startswith('decode_head.'):
            moved = max(moved, upd.abs().max().item())
    assert moved > 0.5 * lr


# ------------------------------------------------------------------ runner
def test_runner_val_matches_jax(tmp_path):
    """``Runner.val`` of a narrow K-Net (ResNetV1c-18 trunk, 19 classes) on
    three 128x256 val frames of a fabricated Cityscapes tree (resized to
    256x512 by the test pipeline) against the JAX ``Runner.val`` on the
    same weights: aAcc and mIoU within 0.05 points."""
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu_torch.datasets.synthetic import make_cityscapes_tree
    from lednet_tpu_torch.engine.runner import Runner
    root = make_cityscapes_tree(str(tmp_path / 'cityscapes'), n_train=1,
                                n_val=3, size_hw=(128, 256), seed=4)
    # the train steps' ResNetV1c-18 trunk: what is held is the val loop
    trunk = {k: v for k, v in TRAIN['knet'].items() if k.startswith('model.backbone')}
    options = dict(trunk, **{'model.decode_head': _head('knet', (8, 16, 32, 64))}, **{
        f'{k}.dataset.data_root': root for k in
        ('train_dataloader', 'val_dataloader', 'test_dataloader')},
        **{'val_dataloader.num_workers': 2, 'val_batch_size': 1,
           'vis_backends': None})

    def config(cls):
        cfg = cls.fromfile(CONFIGS['knet'])
        cfg.merge_from_dict(options)
        cfg.val_dataloader.dataset.pipeline[1]['scale'] = (256, 128)
        return cfg
    jrunner = JRunner(config(JConfig), work_dir=str(tmp_path / 'jax'))
    params, stats = loss_variables(jrunner.model, (1, 64, 64), seed=242)
    params = _norm_scales(params, 242)
    variables = jax_variables(params, stats)
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.val()
    runner = Runner(config(Config), work_dir=str(tmp_path / 'port'), device='cpu')
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    got = runner.val()
    assert 1.0 < want['aAcc'] < 95.0 and want['mIoU'] > 0.1   # not degenerate
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', list(NARROW))
def test_segmentor_predict_matches_jax(name):
    """The narrow copy of the config (R50 trunk at stages 32-256, 19
    classes; Mask2Former's trunk at strides (1, 2, 2, 2), K-Net's D8):
    ``predict`` of two seeded 64x96 images, the CPU eval step equal to it
    (Mask2Former's tuple reaches ``predict_by_feat`` inside the step)."""
    jcfg, cfg = _configs(name, NARROW[name])
    shape = (64, 96)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1,) + shape, n_classes=19, seed=243)
    params = _norm_scales(params, 243)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    imgs = np.random.default_rng(244).integers(0, 256, (2,) + shape + (3,),
                                               dtype=np.uint8)
    x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    ref = np.asarray(_jit_apply(jmodel, method='predict')(
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


@pytest.mark.parametrize('name', list(CONFIGS) + ['msdeform'])
def test_config_builds_and_every_leaf_maps(name):
    """The config unchanged (and Mask2Former with
    ``pixel_decoder='msdeform'``), at full width: every converted flax
    leaf is a port key of the same shape, and none of the port's is left
    over."""
    config = CONFIGS['mask2former' if name == 'msdeform' else name]
    options = ({'model.decode_head.pixel_decoder': 'msdeform'}
               if name == 'msdeform' else {})
    jcfg = JConfig.fromfile(config)
    jcfg.merge_from_dict(options)
    jmodel = JMODELS.build(dict(jcfg.model))
    port = init_model(config, device='cpu', cfg_options=options)
    # no auxiliary head: ``__call__`` creates every variable
    sd = _full_width_leaves(jmodel, (1, 64, 64))
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    port.load_state_dict(sd)
    assert type(port.decode_head).__name__ == (
        'IterativeDecodeHead' if name == 'knet' else 'Mask2FormerHead')


# ------------------------------------------------------------------ points
def test_point_sample_nhw_at_and_beyond_the_borders():
    """Points on, within half a pixel of and past every border: the zero
    padded bilinear sample of the JAX package (and of ``F.grid_sample``
    with zeros)."""
    from lednet_tpu.ops.point_loss import point_sample_nhw as jsample
    from lednet_tpu_torch.ops.point_loss import point_sample_nhw
    H, W = 5, 7
    maps = _normal((3, H, W), seed=200)
    rng = np.random.default_rng(201)
    edge_x = np.concatenate([[0.0, 1.0, -0.05, 1.05], rng.uniform(0, 0.5 / W, 6),
                             1 - rng.uniform(0, 0.5 / W, 6)])
    edge_y = np.concatenate([[0.0, 1.0, -0.05, 1.05], rng.uniform(0, 0.5 / H, 6),
                             1 - rng.uniform(0, 0.5 / H, 6)])
    inner = rng.uniform(0, 1, 16)
    coords = np.stack([np.concatenate([edge_x, inner, edge_x]),
                       np.concatenate([inner, edge_y, edge_y])], -1)
    coords = coords.astype(np.float32)[None].repeat(3, 0)
    ref = np.asarray(jsample(jnp.asarray(maps), jnp.asarray(coords)))
    out = point_sample_nhw(torch.from_numpy(maps), torch.from_numpy(coords))
    assert tuple(out.shape) == (3, coords.shape[1])
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= 1e-6 * scale
    grid = F.grid_sample(torch.from_numpy(maps)[:, None],
                         torch.from_numpy(coords * 2 - 1)[:, :, None],
                         padding_mode='zeros', align_corners=False)[:, 0, :, 0]
    assert np.abs(grid.numpy() - ref).max() <= 1e-6 * scale


def _record_uniform(monkeypatch):
    """Record every ``jax.random.uniform`` draw (as numpy) into a list."""
    drawn = []
    uniform = jax.random.uniform

    def recorded(*args, **kwargs):
        out = uniform(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out
    monkeypatch.setattr(jax.random, 'uniform', recorded)
    return drawn


def test_uncertain_points_match_jax(monkeypatch):
    """``uncertain_point_coords`` given JAX's 3 x 60 candidates and 15
    fresh points of each of two masks: the 45 kept equal to JAX's, in its
    order.  The first mask is 0 on its left half, so more than 45
    candidates sample exactly 0 and tie (kept in index order, as
    ``jax.lax.top_k`` keeps them); on the second the 45th and 46th
    uncertainties are apart."""
    from lednet_tpu.ops.point_loss import uncertain_point_coords as juncertain
    from lednet_tpu_torch.models.decode_heads.point_head import PointHead
    from lednet_tpu_torch.ops.point_loss import (point_sample_nhw,
                                                 uncertain_point_coords)
    logit = _normal((2, 12, 16), seed=202, scale=3.0)
    logit[0, :, :9] = 0.0
    drawn = _record_uniform(monkeypatch)
    ref = np.asarray(juncertain(jax.random.PRNGKey(3), jnp.asarray(logit), 60))
    monkeypatch.undo()
    cand, fresh = drawn
    assert cand.shape == (2, 180, 2) and fresh.shape == (2, 15, 2)
    vals = point_sample_nhw(torch.from_numpy(logit), torch.from_numpy(cand))
    assert int((vals[0] == 0).sum()) > 45
    s = (-vals[1].abs()).sort(descending=True).values
    assert (s[44] - s[45]).item() > 1e-6
    head = PointHead(in_channels=4, channels=8, num_classes=3)
    out = uncertain_point_coords(torch.from_numpy(logit), torch.from_numpy(cand),
                                 torch.from_numpy(fresh), 45, head.top_uncertain)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampled_mask_bce_dice_matches_jax(monkeypatch):
    """BCE and Dice of four 9x11 masks at 40 given points (some on and
    within half a pixel of the borders), and their gradients in the
    logits, within 1e-5."""
    import lednet_tpu.ops.point_loss as jpoint
    from lednet_tpu_torch.ops.point_loss import sampled_mask_bce_dice
    rng = np.random.default_rng(203)
    logit = _normal((4, 9, 11), seed=204, scale=2.0)
    gt = (rng.random((4, 9, 11)) < 0.4).astype(np.float32)
    coords = rng.uniform(0, 1, (4, 40, 2)).astype(np.float32)
    coords[:, :4] = [[0.0, 0.5], [1.0, 0.2], [0.01, 0.99], [0.97, 0.0]]
    monkeypatch.setattr(jpoint, 'uncertain_point_coords',
                        lambda *a, **k: jnp.asarray(coords))

    def total(m):
        bce, dice = jpoint.sampled_mask_bce_dice(
            jax.random.PRNGKey(0), m, jnp.asarray(gt), 40)
        return bce.sum() + 2 * dice.sum(), (bce, dice)
    (_, (jbce, jdice)), jgrad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(logit))
    m = torch.from_numpy(logit).requires_grad_()
    bce, dice = sampled_mask_bce_dice(m, torch.from_numpy(gt),
                                      torch.from_numpy(coords))
    (bce.sum() + 2 * dice.sum()).backward()
    for got, want in ((bce, jbce), (dice, jdice), (m.grad, jgrad)):
        assert rel_err(got.detach().numpy(), want) <= 1e-5


# ------------------------------------------------------------------ K-Net
def test_kernel_updator_matches_jax():
    from lednet_tpu.models.decode_heads.knet_head import KernelUpdator as J
    from lednet_tpu_torch.models.decode_heads.knet_head import KernelUpdator
    upd, ker = _normal((2, 5, 12), seed=205), _normal((2, 5, 12), seed=206)
    jmod = J(12, 8)
    params, _ = random_variables(jmod, jnp.asarray(upd), jnp.asarray(ker),
                                 seed=207)
    params = _norm_scales(params, 207)
    port = load_port(KernelUpdator(12, 8), params, {})
    with torch.no_grad():
        out = port(torch.from_numpy(upd), torch.from_numpy(ker))
    _hold(out.numpy(), jmod.apply({'params': params}, jnp.asarray(upd),
                                  jnp.asarray(ker)))


def test_kernel_update_head_matches_jax():
    """One stage on 16 channels, 5 kernels, 2 heads and 2 mask FCs: the
    hard masks (most pixels grouped, some not; no softmax within 1e-4 of
    0.5), the new masks and kernels."""
    from lednet_tpu.models.decode_heads.knet_head import KernelUpdateHead as J
    from lednet_tpu_torch.models.decode_heads.knet_head import KernelUpdateHead
    x = _normal((2, 6, 7, 16), seed=208)
    kernels = _normal((2, 5, 16), seed=209)
    masks = _normal((2, 6, 7, 5), seed=210, scale=3.0)
    soft = torch.from_numpy(masks).softmax(-1)
    assert 0.5 < (soft > 0.5).any(-1).double().mean() < 1.0
    assert (soft - 0.5).abs().min() > 1e-4
    kw = dict(in_channels=16, num_heads=2, feedforward_channels=24,
              num_mask_fcs=2)
    jmod = J(**kw)
    args = (jnp.asarray(x), jnp.asarray(kernels), jnp.asarray(masks))
    params, _ = random_variables(jmod, *args, seed=211)
    params = _norm_scales(params, 211)
    port = load_port(KernelUpdateHead(**kw), params, {})
    with torch.no_grad():
        new_mask, new_kernels = port(nchw(x), torch.from_numpy(kernels),
                                     nchw(masks))
    ref_mask, ref_kernels = jmod.apply({'params': params}, *args)
    _hold(nhwc(new_mask), ref_mask)
    _hold(new_kernels.numpy(), ref_kernels)


KNET_HEAD = dict(in_channels=12, channels=16, num_classes=19, num_stages=2,
                 num_convs=2, num_heads=2, feedforward_channels=24,
                 num_mask_fcs=1, dropout_ratio=0.0)


@pytest.mark.parametrize('groups', ['empty', 'filled'])
def test_iterative_decode_head_matches_jax(groups):
    """The head on a 2 x 8x10 map of 12 channels, 19 classes, 2 stages.
    'empty': the JAX package's own initial weights (zero biases), under
    which the stage-0 softmax passes 0.5 almost nowhere, so the grouped
    features are 0 and their LayerNorm sees rows of zero variance;
    'filled': random weights with ``seg_kernel`` x 30, most pixels grouped.
    Eval logits, the training tuple (BatchNorm on batch statistics), the
    ``s{i}.loss_ce`` values on labels at 16x20 and the gradients of their
    sum."""
    from lednet_tpu.models.decode_heads.knet_head import IterativeDecodeHead as J
    feats = [_normal((2, 8, 10, 12), seed=212)]
    jin = [jnp.asarray(f) for f in feats]
    jhead = J(**KNET_HEAD)
    if groups == 'empty':
        variables = jax.device_get(jax.jit(jhead.init)(jax.random.PRNGKey(4), jin))
        params = jax.tree_util.tree_map(np.asarray, dict(variables['params']))
        stats = jax.tree_util.tree_map(np.asarray, dict(variables['batch_stats']))
    else:
        params, stats = random_variables(jhead, jin, seed=213)
        params = _norm_scales(params, 213)
        params['seg_kernel'] = params['seg_kernel'] * 30
    head = load_port(MODELS.build(dict(KNET_HEAD, type='IterativeDecodeHead')),
                     params, stats)
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    _hold(nhwc(out), _jit_apply(jhead, train=False)(jax_variables(params, stats),
                                                    jin))

    lbl = np.random.default_rng(214).integers(0, 19, (2, 16, 20)).astype(np.int32)
    lbl[0, :3] = 255

    def losses(p):
        stages, _ = jhead.apply({'params': p, 'batch_stats': stats}, jin,
                                train=True, mutable=['batch_stats'])
        out = jhead.loss_by_feat(stages, jnp.asarray(lbl))
        return sum(v for k, v in out.items() if 'loss' in k), (stages, out)
    # one compile: op by op, the backward's hundreds of small ops compile
    # one by one
    (_, (jstages, jlosses)), jgrads = jax.jit(
        jax.value_and_grad(losses, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    head.train()
    stages = head([nchw(f) for f in feats])
    assert isinstance(stages, tuple) and len(stages) == 3
    grouped = head.kernel_update_head0.hard_mask(stages[0].detach())
    share = grouped.any(1).double().mean().item()
    assert share < 0.05 if groups == 'empty' else share > 0.5
    for got, want in zip(stages, jstages):
        _hold(nhwc(got.detach()), want)
    got = head.loss_by_feat(stages, torch.from_numpy(lbl).long())
    assert set(got) == set(jlosses) == {f's{i}.{k}' for i in range(3)
                                        for k in ('loss_ce', 'acc_seg')}
    for k in jlosses:
        assert rel_err(got[k].detach().numpy(), jlosses[k]) <= 1e-5, k
    sum(v for k, v in got.items() if 'loss' in k).backward()
    _hold_grads(_grads(head), jgrads, 1e-4)


# ------------------------------------------------------------------ MaskFormer
@pytest.mark.parametrize('mask', ['none', 'masked', 'empty_row'])
def test_decoder_layer_matches_jax(mask):
    """A decoder layer of 16 channels and 2 heads: 6 queries over 10
    memory tokens, unmasked, masked at random (about half True), and
    masked with one query's row all False (every logit -1e9: a uniform
    softmax in both)."""
    from lednet_tpu.models.decode_heads.maskformer_head import _DecoderLayer as J
    from lednet_tpu_torch.models.decode_heads.maskformer_head import _DecoderLayer
    queries, memory = _normal((2, 6, 16), seed=215), _normal((2, 10, 16), seed=216)
    attn_mask = None
    if mask != 'none':
        attn_mask = np.random.default_rng(217).random((2, 6, 10)) < 0.5
        attn_mask[:, :, 0] = True
        if mask == 'empty_row':
            attn_mask[1, 2] = False
    jmod = J(16, 2, masked_attn=mask != 'none')
    jargs = (jnp.asarray(queries), jnp.asarray(memory),
             None if attn_mask is None else jnp.asarray(attn_mask))
    params, _ = random_variables(jmod, *jargs, seed=218)
    params = _norm_scales(params, 218)
    port = load_port(_DecoderLayer(16, 2, masked_attn=mask != 'none'), params, {})
    with torch.no_grad():
        out = port(torch.from_numpy(queries), torch.from_numpy(memory),
                   None if attn_mask is None else torch.from_numpy(attn_mask))
    _hold(out.numpy(), jmod.apply({'params': params}, *jargs))


def test_msdeform_attn_and_sample_match_jax():
    """``bilinear_sample`` at points in and past a 7x9 map against JAX's and
    ``F.grid_sample`` (zeros), within 1e-6; ``MSDeformAttn`` over three
    levels (6x8, 3x4, 2x2; 16 channels, 2 heads, 3 points) with random
    ``sampling_offsets`` (scaled so that a quarter or more of the samples
    fall outside their map and are zero padded), within 1e-5."""
    from lednet_tpu.models.decode_heads.deform_pixel_decoder import \
        MSDeformAttn as J
    from lednet_tpu.models.decode_heads.deform_pixel_decoder import \
        bilinear_sample as jsample
    from lednet_tpu_torch.models.decode_heads.deform_pixel_decoder import (
        MSDeformAttn, bilinear_sample)
    v = _normal((2, 7, 9, 4), seed=219)
    pts = np.random.default_rng(220).uniform(-0.1, 1.1, (2, 25, 2)).astype(np.float32)
    ref = np.asarray(jsample(jnp.asarray(v), jnp.asarray(pts)))
    out = bilinear_sample(torch.from_numpy(v), torch.from_numpy(pts)).numpy()
    grid = F.grid_sample(nchw(v), torch.from_numpy(pts * 2 - 1)[:, :, None],
                         padding_mode='zeros', align_corners=False)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-6 * scale
    assert np.abs(grid[..., 0].permute(0, 2, 1).numpy() - ref).max() <= 1e-6 * scale

    shapes = ((6, 8), (3, 4), (2, 2))
    maps = [_normal((2, h, w, 16), seed=221 + i) for i, (h, w) in enumerate(shapes)]
    nq = sum(h * w for h, w in shapes)
    query = _normal((2, nq, 16), seed=224)
    ref_pts = np.random.default_rng(225).uniform(0, 1, (2, nq, 2)).astype(np.float32)
    jmod = J(16, 2, 3, 3)
    jargs = (jnp.asarray(query), [jnp.asarray(m) for m in maps], jnp.asarray(ref_pts))
    params, _ = random_variables(jmod, *jargs, seed=226)
    params['sampling_offsets']['kernel'] = params['sampling_offsets']['kernel'] * 3
    port = load_port(MSDeformAttn(16, 2, 3, 3), params, {})
    with torch.no_grad():
        off = port.sampling_offsets(torch.from_numpy(query)).view(2, nq, 2, 3, 3, 2)
        xy = [torch.from_numpy(ref_pts)[:, :, None, None] +
              torch.stack([off[:, :, :, lv, :, 0] / w, off[:, :, :, lv, :, 1] / h], -1)
              for lv, (h, w) in enumerate(shapes)]
        outside = torch.stack([((c < 0) | (c > 1)).any(-1) for c in xy])
        assert outside.double().mean() > 0.25
        out = port(torch.from_numpy(query), [torch.from_numpy(m) for m in maps],
                   torch.from_numpy(ref_pts))
    _hold(out.numpy(), jmod.apply({'params': params}, *jargs))


def test_matchers_match_jax():
    """The Hungarian on (3, 12, 7) random costs, two or three classes of
    each image absent (their column 1e6: the columns tie), and the greedy
    fallback on the same, equal to the JAX package's."""
    from lednet_tpu.models.decode_heads.maskformer_head import (
        _greedy_assign, _hungarian)
    from lednet_tpu_torch.models.decode_heads.maskformer_head import (
        greedy_assign, hungarian)
    rng = np.random.default_rng(227)
    cost = rng.normal(0, 1, (3, 12, 7)).astype(np.float32)
    for b, absent in enumerate(([1, 4], [0, 5, 6], [2, 3])):
        cost[b][:, absent] = 1e6
    want = _hungarian(cost)
    got = hungarian(cost)
    np.testing.assert_array_equal(got, want)
    assert all(len(set(row)) == 7 for row in got)
    np.testing.assert_array_equal(
        greedy_assign(torch.from_numpy(cost)).numpy(),
        np.asarray(_greedy_assign(jnp.asarray(cost))))


MF_HEAD = dict(in_channels=[8, 12, 16, 20], channels=16, feat_channels=16,
               num_queries=10, num_transformer_decoder_layers=2, num_heads=2,
               num_classes=5, in_index=[0, 1, 2, 3])
MF_CASES = {'maskformer': dict(type='MaskFormerHead'),
            'mask2former': dict(type='Mask2FormerHead', num_points=48),
            'mask2former-msdeform': dict(type='Mask2FormerHead', num_points=48,
                                         pixel_decoder='msdeform')}


def _mask_labels():
    """(2, 64, 64) labels: image 0 of classes 0-2, image 1 of 1, 3 and 4
    (so each image lacks some of the 5), in 8x8 blocks, some ignored."""
    rng = np.random.default_rng(230)
    blocks = np.stack([rng.choice([0, 1, 2], (8, 8)), rng.choice([1, 3, 4], (8, 8))])
    lbl = blocks.repeat(8, 1).repeat(8, 2).astype(np.int32)
    lbl[rng.random(lbl.shape) < 0.05] = 255
    return lbl


@pytest.mark.parametrize('case', list(MF_CASES))
def test_maskformer_heads_match_jax(case, monkeypatch, jax_hungarian):
    """The head over four levels (16x16 ... 2x2; 10 queries, 16 channels,
    2 decoder layers, 5 classes): class and mask logits; with masked
    attention no mask logit within 1e-5 of the 0.5 threshold's 0; the
    Hungarian assignment equal to JAX's (each image lacks classes); the
    three losses (Mask2Former's at the points JAX's jitted loss drew, 48 a
    mask) and
    ``predict_by_feat`` at 64x64, within 1e-4 x the largest."""
    import lednet_tpu.models.decode_heads.maskformer_head as jmf
    import lednet_tpu.ops.point_loss as jpoint
    cfg = dict(MF_HEAD, **MF_CASES[case])
    shapes = ((16, 16), (8, 8), (4, 4), (2, 2))
    feats = [_normal((2, h, w, c), seed=231 + i)
             for i, ((h, w), c) in enumerate(zip(shapes, cfg['in_channels']))]
    jin = [jnp.asarray(f) for f in feats]
    jhead = JMODELS.build(dict(cfg))
    params, stats = random_variables(jhead, jin, seed=235)
    params = _norm_scales(params, 235)
    head = load_port(MODELS.build(dict(cfg)), params, stats)
    margins = []
    if cfg['type'] == 'Mask2FormerHead':
        decide = head.attention_mask

        def attention_mask(interm):
            margins.append(interm.abs().min().item())
            return decide(interm)
        head.attention_mask = attention_mask
    with torch.no_grad():
        cls_logits, mask_logits = head([nchw(f) for f in feats])
    ref = _jit_apply(jhead, train=False)(jax_variables(params, stats), jin)
    assert len(margins) == (2 if cfg['type'] == 'Mask2FormerHead' else 0)
    assert min(margins, default=1.0) > 1e-5
    _hold(cls_logits.numpy(), ref[0], TOL_MODEL)
    _hold(mask_logits.numpy(), ref[1], TOL_MODEL)

    lbl = _mask_labels()
    recorded = {}
    hungarian = jmf._hungarian

    def jhungarian(cost):
        recorded['assign'] = hungarian(cost)
        return recorded['assign']
    monkeypatch.setattr(jmf, '_hungarian', jhungarian)
    drawn = _record_points(monkeypatch)
    # one compile: op by op, the loss's many small ops compile one by one
    want = jax.jit(jhead.loss_by_feat)(ref, jnp.asarray(lbl))
    jax.effects_barrier()
    monkeypatch.undo()
    assign = head.assign
    got_assign = []
    head.assign = lambda cost: got_assign.append(assign(cost)) or got_assign[-1]
    if 'num_points' in MF_CASES[case]:
        assert len(drawn) == 1 and drawn[0].shape == (2 * 5, 48, 2)
        coords = torch.from_numpy(drawn[0])
        head.train_points = lambda m: coords
    got = head.loss_by_feat((cls_logits, mask_logits), torch.from_numpy(lbl).long())
    np.testing.assert_array_equal(got_assign[0].numpy(), recorded['assign'])
    assert set(got) == set(want) == {'loss_cls', 'loss_mask', 'loss_dice'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= TOL_MODEL, k
    sem = head.predict_by_feat((cls_logits, mask_logits), (64, 64))
    _hold(nhwc(sem), jhead.predict_by_feat(ref, (64, 64)), TOL_MODEL)


# ------------------------------------------------------------------ rules
def test_unported_options_raise():
    """The options the JAX heads accept and never read raise
    ``NotImplementedError``; an unknown pixel decoder ``ValueError``."""
    knet = dict(KNET_HEAD, type='IterativeDecodeHead')
    for extra, word in ((dict(kernel_generate_head=dict(type='FCNHead')),
                         'kernel_generate_head'),
                        (dict(kernel_update_head=[dict()]), 'kernel_update_head')):
        with pytest.raises(NotImplementedError, match=word):
            MODELS.build(dict(knet, **extra))
    for extra, word in ((dict(act_cfg=dict(type='ReLU')), 'act_cfg'),
                        (dict(loss_decode=dict(type='CrossEntropyLoss')),
                         'loss_decode'),
                        (dict(sampler=dict(type='OHEMPixelSampler')), 'sampler'),
                        (dict(input_transform='resize_concat'),
                         'input_transform')):
        with pytest.raises(NotImplementedError, match=word):
            MODELS.build(dict(MF_HEAD, type='Mask2FormerHead', **extra))
    with pytest.raises(ValueError, match='pixel_decoder'):
        MODELS.build(dict(MF_HEAD, type='MaskFormerHead', pixel_decoder='fpn2'))


def test_convert_and_init_of_the_new_leaves():
    """``seg_kernel`` (1, 1, C, N) becomes the 1x1 classifier's (N, C, 1,
    1); a Dense kernel (in, out) of the new heads ``nn.Linear``'s (out,
    in); ``query_embed`` and ``level_embed`` keep their layout.  The port's
    own initialisation: ``seg_kernel`` kaiming (fan_out), ``seg_bias`` and
    ``sampling_offsets`` 0, ``query_embed`` truncated normal 0.02,
    ``level_embed`` normal 1, as the JAX package's initialisers."""
    from lednet_tpu_torch.models.layers import init_weights
    rng = np.random.default_rng(250)
    seg = rng.standard_normal((1, 1, 16, 5)).astype(np.float32)
    dense = rng.standard_normal((16, 48)).astype(np.float32)
    query = rng.standard_normal((1, 10, 16)).astype(np.float32)
    sd = flax_to_state_dict({'_decode_head': {
        'seg_kernel': seg, 'kernel_update_head0': {'kernel_update_conv': {
            'dynamic_layer': {'kernel': dense}}},
        'query_embed': query,
        'pixel_decoder': {'enc0': {'attn': {'sampling_offsets': {'kernel': dense}}}}}})
    np.testing.assert_array_equal(sd['decode_head.seg_kernel'].numpy()[:, :, 0, 0],
                                  seg[0, 0].T)
    for k in ('decode_head.kernel_update_head0.kernel_update_conv.dynamic_layer.weight',
              'decode_head.pixel_decoder.enc0.attn.sampling_offsets.weight'):
        np.testing.assert_array_equal(sd[k].numpy(), dense.T)
    np.testing.assert_array_equal(sd['decode_head.query_embed'].numpy(), query)

    gen = torch.Generator().manual_seed(0)
    knet = MODELS.build(dict(KNET_HEAD, type='IterativeDecodeHead', channels=64))
    init_weights(knet, gen)
    assert knet.seg_kernel.std().item() == pytest.approx((2 / 19) ** 0.5, rel=0.1)
    assert not knet.seg_bias.any()
    m2f = MODELS.build(dict(MF_HEAD, type='Mask2FormerHead', feat_channels=64,
                            num_queries=100, pixel_decoder='msdeform'))
    init_weights(m2f, gen)
    assert m2f.query_embed.std().item() == pytest.approx(0.02 * 0.88, rel=0.1)
    assert m2f.query_embed.abs().max().item() <= 0.04
    assert m2f.pixel_decoder.level_embed.std().item() == pytest.approx(1.0, rel=0.2)
    assert not m2f.pixel_decoder.enc0.attn.sampling_offsets.weight.any()


def test_chip_smoke_pins_the_heads_decisions():
    """``chip_smoke.decisions`` records K-Net's hard masks, Mask2Former's
    attention masks, its Hungarian assignment and its kept points, counts
    where a later call decides otherwise, and with ``pin`` returns the
    recorded decisions."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    from lednet_tpu_torch.models.decode_heads.knet_head import KernelUpdateHead
    knet = KernelUpdateHead(16, 2, 24)
    m2f = MODELS.build(dict(MF_HEAD, type='Mask2FormerHead'))
    g = torch.Generator().manual_seed(251)
    masks = torch.randn((2, 5, 4, 6), generator=g) * 3
    interm = torch.randn((2, 10, 12), generator=g)
    cost = torch.rand((2, 10, 5), generator=g)
    unc = torch.randn((3, 24), generator=g)

    def call(m, i, c, u):
        return (knet.hard_mask(m), m2f.attention_mask(i), m2f.assign(c),
                m2f.top_uncertain(u, 6))
    kept = []
    with chip_smoke.decisions(kept):
        first = call(masks, interm, cost, unc)
    assert len(kept) == 4
    assert torch.equal(first[2], m2f.assign(cost))
    moved = (-masks, -interm, cost.flip(1), -unc)
    flips = {}
    with chip_smoke.decisions(kept, flips, pin=True):
        pinned = call(*moved)
    assert set(flips) == {'hard_mask', 'attn_mask', 'matching', 'points'}
    assert all(v > 0 for v in flips.values()), flips
    for a, b in zip(pinned, first):
        assert torch.equal(a, b)
    with chip_smoke.decisions(kept, {}, pin=False):
        own = call(*moved)
    assert not torch.equal(own[0], first[0]) and not torch.equal(own[2], first[2])
