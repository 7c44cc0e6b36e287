"""PyTorch port: the training slice and the eval step against ``lednet_tpu``
on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX function and its port and holds them together: the losses
(``CrossEntropyLoss`` softmax and sigmoid, class weights, ``avg_non_ignore``:
rel 1e-6; ``OhemCrossEntropy``: its k-th order statistic bit-exact, the loss
rel 1e-6, with all pixels ignored, ``min_kept`` above the valid count and
ties at the threshold), ``accuracy`` (exact), the preprocessor's training
padding (exact), the lr schedules (rel 1e-6), the paramwise lr and decay
multipliers (exact), ``LEDHead.loss_by_feat`` (rel 1e-5), and one whole
train step of the flagship config cut to a test size (LEDNet channels 8,
ppm 32, head 32->16, 3 classes, B=2, 120x128 images padded to 128x128) with
its OHEM losses and with ``CrossEntropyLoss``: loss within 1e-5 absolute,
every weight within atol 1e-4 / rtol 5e-3 and the BatchNorm running stats
within atol 1e-5 / rtol 1e-4 (the bounds ``tests/test_train_parity.py``
holds ``lednet_tpu`` to torch).  At this size ``min_kept`` (131072) exceeds
the valid pixels, so OHEM's k is n_valid - 1 and its threshold is
max(largest valid p_gt, 0.9): the selection does not hinge on near-ties.
The deepest maps (1/64) are 2x2: at 64x64 they are 1x1, each of their
BatchNorms sees two values per channel, and float32 rounding alone moves
their running stats by more than the 1e-5 bound.

torch's multi-threaded CPU autograd aborts the process when it runs after
the XLA CPU runtime has run in it, and six workers' threads oversubscribe
the cores, so every test here runs under the ``one_thread`` fixture (one
torch thread, restored after).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from lednet_tpu.config import Config as JConfig
from lednet_tpu.engine import optim as joptim
from lednet_tpu.engine.state import TrainState as JTrainState
from lednet_tpu.engine.state import make_train_step as jmake_train_step
from lednet_tpu.models.losses import cross_entropy as jce
from lednet_tpu.registry import MODELS as JMODELS
from lednet_tpu_torch.apis import init_model
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import _children, _param_entry, flax_to_state_dict
from lednet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                     create_train_state, make_eval_step,
                                     make_train_step, param_multipliers)
from lednet_tpu_torch.models.losses import cross_entropy as ce
from lednet_tpu_torch.registry import MODELS
from test_torch_port_common import (FLAGSHIP, REPO, jax_variables,
                                    random_variables, rel_err)
from test_torch_port_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

SMALL = {'model.backbone.channels': 8, 'model.backbone.ppm_channels': 32,
         'model.decode_head.in_channels': 32, 'model.decode_head.channels': 16,
         'model.decode_head.num_classes': 3,
         'model.data_preprocessor.size': (64, 64)}
TRAIN = dict(SMALL, **{'model.data_preprocessor.size': (128, 128)})
CE_PAIR = [dict(type='CrossEntropyLoss', loss_weight=1.0),
           dict(type='CrossEntropyLoss', loss_weight=0.4)]


def _logits(shape, seed, scale=3.0):
    """(B, H, W, C) float32 logits for JAX and their NCHW torch copy."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _labels(shape, n_classes, seed, ignored=0.05):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, n_classes, shape)
    return np.where(rng.random(shape) < ignored, 255, lbl).astype(np.int32)


# ------------------------------------------------------------ losses
CE_CASES = {
    'mean': dict(),
    'avg_non_ignore': dict(avg_non_ignore=True),
    'class_weight': dict(class_weight=[0.5, 1.0, 2.0, 1.5]),
    'sum': dict(reduction='sum', loss_weight=0.4),
    'sigmoid_multi': dict(use_sigmoid=True),
    'sigmoid_multi_non_ignore': dict(use_sigmoid=True, avg_non_ignore=True),
}


@pytest.mark.parametrize('case', sorted(CE_CASES))
def test_cross_entropy_matches_jax(case):
    kw = CE_CASES[case]
    logits, tlogits = _logits((2, 12, 10, 4), seed=1)
    lbl = _labels((2, 12, 10), 4, seed=2)
    ref = jce.CrossEntropyLoss(**kw)(jnp.asarray(logits), jnp.asarray(lbl))
    out = ce.CrossEntropyLoss(**kw)(tlogits, torch.from_numpy(lbl))
    assert rel_err(out.numpy(), ref) <= 1e-6


def test_cross_entropy_per_pixel_and_binary_single_logit():
    logits, tlogits = _logits((2, 9, 7, 4), seed=3)
    lbl = _labels((2, 9, 7), 4, seed=4)
    ref = jce.CrossEntropyLoss(reduction='none')(jnp.asarray(logits), jnp.asarray(lbl))
    out = ce.CrossEntropyLoss(reduction='none')(tlogits, torch.from_numpy(lbl))
    assert rel_err(out.numpy(), ref) <= 1e-6
    one, tone = _logits((2, 9, 7, 1), seed=5)
    blbl = _labels((2, 9, 7), 2, seed=6)
    ref = jce.CrossEntropyLoss(use_sigmoid=True)(jnp.asarray(one), jnp.asarray(blbl))
    out = ce.CrossEntropyLoss(use_sigmoid=True)(tone, torch.from_numpy(blbl))
    assert rel_err(out.numpy(), ref) <= 1e-6


def test_take_class_out_of_range_labels_give_zero():
    values = torch.arange(24, dtype=torch.float32).view(2, 3, 4) + 1
    labels = torch.tensor([[0, 2, 3, -1], [1, 7, 2, 0]])
    out = ce.take_class(values, labels)
    ref = jce.take_class(jnp.asarray(values.numpy().transpose(0, 2, 1)),
                         jnp.asarray(labels.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 2] == 0 and out[0, 3] == 0 and out[1, 1] == 0


@pytest.mark.parametrize('k', [0, 1, 57, 298, 299])
def test_kth_smallest_bit_exact(k):
    rng = np.random.default_rng(k)
    p = rng.random(300).astype(np.float32)
    p[::7] = p[3]                       # ties
    p[::11] = 2.0                       # ignored pixels
    ref = np.asarray(jce._kth_smallest(jnp.asarray(p), k))
    out = ce._kth_smallest(torch.from_numpy(p), torch.tensor(k))
    assert out.view(torch.int32).item() == ref.view(np.int32)
    assert out.item() == np.sort(p)[k]


OHEM_CASES = {
    # name: (thres, min_kept, ignored share, logit scale / quantized, extra)
    'min_kept_below_valid': (0.7, 50, 0.05, 3.0, {}),
    'min_kept_above_valid': (0.9, 131072, 0.05, 3.0, {}),
    'threshold_from_kth': (0.05, 120, 0.05, 6.0, {}),
    'ties_at_threshold': (0.05, 100, 0.05, 'quantized', {}),
    'all_ignored': (0.7, 50, 1.0, 3.0, {}),
    'class_weight': (0.7, 50, 0.05, 3.0, dict(class_weight=[0.5, 2.0, 1.0])),
}


@pytest.mark.parametrize('case', sorted(OHEM_CASES))
def test_ohem_matches_jax(case):
    thres, min_kept, ignored, scale, extra = OHEM_CASES[case]
    shape = (2, 12, 10, 3)
    if scale == 'quantized':
        # logits in {0, 1, 2}: many pixels share each p_gt, also the k-th
        q = np.random.default_rng(7).integers(0, 3, shape).astype(np.float32)
        logits, tlogits = q, torch.from_numpy(np.ascontiguousarray(q.transpose(0, 3, 1, 2)))
    else:
        logits, tlogits = _logits(shape, seed=8, scale=scale)
    lbl = _labels(shape[:3], 3, seed=9, ignored=ignored)
    kw = dict(thres=thres, min_kept=min_kept, loss_weight=0.4, **extra)
    ref = jce.OhemCrossEntropy(**kw)(jnp.asarray(logits), jnp.asarray(lbl))
    loss = ce.OhemCrossEntropy(**kw)
    out = loss(tlogits, torch.from_numpy(lbl))
    if ignored == 1.0:
        assert float(ref) == 0.0 and out.item() == 0.0
    else:
        assert rel_err(out.numpy(), ref) <= 1e-6
    # the threshold: the JAX order statistic of the port's probabilities
    threshold, valid, p_gt = loss.threshold(tlogits, torch.from_numpy(lbl))
    p_flat = torch.where(valid, p_gt, 2.0).reshape(-1).numpy()
    n_valid = int(valid.sum())
    k = min(min_kept, max(n_valid - 1, 0), p_flat.size - 1)
    kth = np.asarray(jce._kth_smallest(jnp.asarray(p_flat), k))
    assert threshold.item() == max(float(kth), np.float32(thres))
    if case == 'ties_at_threshold':
        assert (p_gt[valid] == threshold).sum() > 1     # strict < drops them all


def test_accuracy_matches_jax():
    logits, tlogits = _logits((2, 12, 10, 5), seed=10)
    lbl = _labels((2, 12, 10), 5, seed=11, ignored=0.2)
    ref = jce.accuracy(jnp.asarray(logits), jnp.asarray(lbl))
    out = ce.accuracy(tlogits, torch.from_numpy(lbl))
    assert out.item() == float(ref)


def test_losses_registered():
    import lednet_tpu_torch.models  # noqa: F401
    for name in ('CrossEntropyLoss', 'OhemCrossEntropy'):
        assert name in MODELS


# ------------------------------------------------------------ preprocessor
@pytest.mark.parametrize('labels', ['tensor', 'dict', 'none'])
def test_preprocessor_training_padding_matches_jax(labels):
    from lednet_tpu_torch.models.data_preprocessor import SegDataPreProcessor
    cfg = dict(Config.fromfile(FLAGSHIP).model.data_preprocessor,
               size=(40, 48), pad_val=7, seg_pad_val=250)
    jpre = JMODELS.build(dict(JConfig.fromfile(FLAGSHIP).model.data_preprocessor,
                              size=(40, 48), pad_val=7, seg_pad_val=250))
    pre = SegDataPreProcessor(**cfg)
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (2, 33, 48, 3), dtype=np.uint8)
    seg = rng.integers(0, 19, (2, 33, 48)).astype(np.int32)
    edge = rng.integers(0, 2, (2, 33, 48)).astype(np.int32)
    lbl = {'tensor': seg, 'dict': dict(gt_seg_map=seg, gt_edge_map=edge),
           'none': None}[labels]
    jx, jl, jpad = jpre(jnp.asarray(imgs), None if lbl is None else
                        jax.tree_util.tree_map(jnp.asarray, lbl), training=True)
    tl = None if lbl is None else jax.tree_util.tree_map(torch.from_numpy, lbl)
    x, tlbl, pad = pre(torch.from_numpy(imgs), tl, training=True)
    assert pad == jpad == (7, 0)
    assert x.dtype == torch.float32 and x.shape == (2, 40, 48, 3)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    if labels == 'tensor':
        np.testing.assert_array_equal(tlbl.numpy(), np.asarray(jl))
    elif labels == 'dict':
        assert set(tlbl) == set(jl)
        for k in jl:
            np.testing.assert_array_equal(tlbl[k].numpy(), np.asarray(jl[k]))
        assert (tlbl['gt_seg_map'][:, 33:] == 250).all()
        assert (tlbl['gt_edge_map'][:, 33:] == 0).all()


# ------------------------------------------------------------ optimizer
SCHEDULES = {
    'flagship': (None, 120000),
    'poly_eta_min': ([dict(type='PolyLR', eta_min=1e-4, power=0.9, begin=0,
                           end=80000, by_epoch=False)], 80000),
    'poly_ratio': ([dict(type='PolyLRRatio', eta_min_ratio=0.1, power=1.0,
                         begin=0, end=1000)], 1000),
    'warmup_then_poly': ([dict(type='LinearLR', start_factor=1e-6, begin=0,
                               end=150),
                          dict(type='PolyLR', power=1.0, begin=150, end=1500,
                               eta_min=0.0)], 1500),
    'constant_then_multistep': ([dict(type='ConstantLR', factor=0.5, begin=0,
                                      end=10),
                                 dict(type='MultiStepLR', gamma=0.1,
                                      milestones=[30, 60])], 90),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    sched, end = SCHEDULES[name]
    if sched is None:
        sched = JConfig.fromfile(FLAGSHIP).param_scheduler
    jlr = joptim.build_lr_schedule(sched, 0.01)
    lr = build_lr_schedule(sched, 0.01)
    if name == 'flagship':
        assert lr(0) == pytest.approx(0.01, rel=1e-7)   # the base lr first
    for step in (0, 1, 9, 10, 31, end // 2, end - 1, end, end + 5):
        assert lr(step) == pytest.approx(float(jlr(step)), rel=1e-6, abs=1e-12), step


PARAMWISE = {
    'custom_keys': dict(custom_keys={'backbone': dict(lr_mult=0.1),
                                     'decode_head.head': dict(lr_mult=2.0,
                                                              decay_mult=0.5),
                                     'norm': dict(decay_mult=0.0)}),
    'default_rules': dict(norm_decay_mult=0.0, bias_decay_mult=0.25,
                          dwconv_decay_mult=0.5, flat_decay_mult=0.75,
                          bias_lr_mult=2.0),
    'bias_falls_through': dict(bias_decay_mult=0.0, flat_decay_mult=0.3),
    'force_defaults': dict(custom_keys={'spatial1': dict(decay_mult=2.0,
                                                         lr_mult=3.0)},
                           bias_decay_mult=0.0, bias_lr_mult=1.5,
                           force_default_settings=True),
    'layer_decay': dict(decay_rate=0.8, num_layers=4, decay_type='layer_wise'),
    'stage_wise': dict(decay_rate=0.7, num_layers=6, decay_type='stage_wise'),
}


@pytest.fixture(scope='module')
def small_led():
    """The flagship cut to SMALL in both packages, with random flax
    variables."""
    import lednet_tpu
    lednet_tpu.register_all_modules()
    jcfg = JConfig.fromfile(FLAGSHIP)
    jcfg.merge_from_dict(SMALL)
    jmodel = JMODELS.build(dict(jcfg.model))
    params, stats = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)),
                                     seed=3, train=False)
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(SMALL)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    return dict(params=params, model=model, cfg=cfg)


@pytest.mark.parametrize('name', sorted(PARAMWISE))
def test_paramwise_multipliers_match_jax(small_led, name):
    cfg = PARAMWISE[name]
    params = small_led['params']
    mults = param_multipliers(small_led['model'], cfg)
    decay = joptim._decay_mult_fn(cfg, params)
    ones = jtu.tree_map(jnp.ones_like, params)
    lr_tx = joptim.layer_decay_scale(cfg) if 'decay_rate' in cfg \
        else joptim.paramwise_lr_scale(cfg)
    lr_tree, _ = lr_tx.update(ones, lr_tx.init(params), params)
    flat = jtu.tree_flatten_with_path(params)[0]
    lr_flat = dict(jtu.tree_flatten_with_path(lr_tree)[0])
    names = set()
    for path, leaf in flat:
        keys = tuple(str(getattr(k, 'key', k)) for k in path)
        name_, _ = _param_entry(keys, np.asarray(leaf),
                                _children(params, keys[:-2]))
        names.add(name_)
        lr_mult, decay_mult = mults[name_]
        assert decay_mult == decay(path, leaf), name_
        jlr = np.unique(np.asarray(lr_flat[path]))
        assert jlr.size == 1 and np.float32(lr_mult) == jlr[0], name_
    assert names == set(mults)
    assert len({m for m in mults.values()}) > 1


def test_optimizer_groups_carry_multipliers(small_led):
    model = small_led['model']
    opt, sched = build_optimizer(
        model, dict(optimizer=dict(type='SGD', lr=0.01, momentum=0.9,
                                   weight_decay=5e-4),
                    paramwise_cfg=PARAMWISE['default_rules']))
    mults = param_multipliers(model, PARAMWISE['default_rules'])
    by_id = {id(p): n for n, p in model.named_parameters()}
    seen = 0
    for g in opt.param_groups:
        for p in g['params']:
            lr_mult, decay_mult = mults[by_id[id(p)]]
            assert g['lr_mult'] == lr_mult
            assert g['weight_decay'] == pytest.approx(5e-4 * decay_mult)
            seen += 1
    assert seen == len(by_id) and sched(0) == 0.01


@pytest.mark.parametrize('otype', ['SGD_nesterov', 'SGD_clip_value', 'Adam',
                                   'AdamW_clip'])
def test_optimizer_update_matches_optax(otype, one_thread):
    """Three updates on identical gradients: SGD with nesterov, SGD with
    elementwise clipping, and Adam / AdamW (both with decoupled decay),
    AdamW with global-norm clipping."""
    import optax
    rng = np.random.default_rng(13)
    shapes = {'w': (4, 3), 'b': (4,)}
    w0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: 3 * rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    opt_cfg = {'SGD_nesterov': dict(type='SGD', lr=0.1, momentum=0.9,
                                    nesterov=True, weight_decay=1e-2),
               'SGD_clip_value': dict(type='SGD', lr=0.1, momentum=0.9,
                                      weight_decay=1e-2),
               'Adam': dict(type='Adam', lr=0.1, weight_decay=1e-2),
               'AdamW_clip': dict(type='AdamW', lr=0.1, weight_decay=0.05)}[otype]
    ow = dict(optimizer=opt_cfg,
              clip_grad={'AdamW_clip': dict(max_norm=1.0),
                         'SGD_clip_value': dict(clip_value=2.0)}.get(otype))
    sched = [dict(type='PolyLR', power=0.9, begin=0, end=5)]
    tx, _ = joptim.build_optimizer(dict(ow), sched)
    jparams = {k: jnp.asarray(v) for k, v in w0.items()}
    jstate = tx.init(jparams)
    mod = torch.nn.Module()
    for k, v in w0.items():
        mod.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt, lr = build_optimizer(mod, dict(ow), sched)
    for i, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, v in g.items():
            getattr(mod, k).grad = torch.from_numpy(v.copy())
        norm = opt.step(lr(i))
        assert norm.item() == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
    for k in shapes:
        np.testing.assert_allclose(getattr(mod, k).detach().numpy(),
                                   np.asarray(jparams[k]), atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------ head and step
@pytest.mark.parametrize('losses', ['ohem', 'ce'])
def test_led_head_loss_by_feat_matches_jax(losses):
    head_cfg = dict(Config.fromfile(FLAGSHIP).model.decode_head,
                    in_channels=32, channels=16, num_classes=3)
    if losses == 'ce':
        head_cfg['loss_decode'] = CE_PAIR
    jhead = JMODELS.build(dict(head_cfg))
    import lednet_tpu_torch.models  # noqa: F401
    head = MODELS.build(dict(head_cfg))
    B, H, W, C = 2, 64, 64, 3
    feats = [_logits((B, H // s, W // s, C), seed=20 + s) for s in (8, 8, 2, 4)]
    lbl = _labels((B, H, W), C, seed=30)
    ref = jhead.loss_by_feat(tuple(jnp.asarray(f[0]) for f in feats),
                             jnp.asarray(lbl))
    out = head.loss_by_feat(tuple(f[1] for f in feats),
                            dict(gt_seg_map=torch.from_numpy(lbl)))
    assert set(out) == set(ref) == {'loss_context', 'loss_spatial', 'acc_seg'}
    for k in ref:
        assert rel_err(out[k].numpy(), ref[k]) <= 1e-5, k


def _batch(seed=40, shape=(2, 120, 128)):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lbl = np.where(rng.random(shape) < 0.02, 255,
                   rng.integers(0, 3, shape)).astype(np.int32)
    return imgs, lbl


def _port_training(cfg, state_dict):
    model = init_model(cfg, device='cpu')
    model.load_state_dict(state_dict)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    return model, opt, sched


@pytest.mark.parametrize('losses', ['ohem', 'ce'])
def test_train_step_matches_jax(losses, one_thread):
    """One SGD + poly step of the flagship config (cut to SMALL) in both
    packages from the same weights: the config's OHEM losses, and
    ``CrossEntropyLoss`` in their place."""
    import lednet_tpu
    lednet_tpu.register_all_modules()
    extra = dict(TRAIN)
    if losses == 'ce':
        extra['model.decode_head.loss_decode'] = CE_PAIR
    jcfg = JConfig.fromfile(FLAGSHIP)
    jcfg.merge_from_dict(extra)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    imgs, lbl = _batch()
    params, stats = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)),
                                     seed=4, train=False)
    jvars = jax_variables(params, stats)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                        batch_stats=jvars['batch_stats'],
                        opt_state=tx.init(jvars['params']))
    sd0 = flax_to_state_dict(params, stats)

    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(extra)
    model, opt, sched = _port_training(cfg, sd0)
    step = make_train_step(model, opt, model.data_preprocessor)
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs), torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == 1 and model.training

    state, jlogs = jmake_train_step(jmodel, tx, jpre)(state, jnp.asarray(imgs),
                                                      jnp.asarray(lbl))
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    for k in ('decode.loss_context', 'decode.loss_spatial', 'decode.acc_seg'):
        assert logs[k].item() == pytest.approx(float(jlogs[k]), rel=1e-4, abs=1e-5), k
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


def test_amp_train_step_close_to_float32(one_thread):
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(dict(TRAIN, **{'model.decode_head.loss_decode': CE_PAIR}))
    base = init_model(cfg, device='cpu').state_dict()
    imgs, lbl = _batch(seed=41)
    losses = []
    for amp in (False, True):
        model, opt, sched = _port_training(cfg, base)
        step = make_train_step(model, opt, model.data_preprocessor, amp=amp)
        _, logs = step(create_train_state(model, opt, sched),
                       torch.from_numpy(imgs), torch.from_numpy(lbl.astype(np.int64)))
        assert all(torch.isfinite(v).all() for v in logs.values())
        losses.append(logs['loss'].item())
    assert abs(losses[1] - losses[0]) <= 5e-2 * abs(losses[0])


def test_loss_needs_train_mode(small_led):
    model = small_led['model'].eval()
    with pytest.raises(RuntimeError, match='train mode'):
        model.loss(torch.zeros(1, 64, 64, 3), torch.zeros(1, 64, 64, dtype=torch.long))


# ------------------------------------------------------------ eval step
def test_eval_step_on_cpu_equals_predict(small_led):
    model = small_led['model'].eval()
    imgs = torch.from_numpy(np.random.default_rng(50).integers(
        0, 256, (2, 64, 96, 3), dtype=np.uint8))
    step = make_eval_step(model, model.data_preprocessor)
    with torch.no_grad():
        x, _, _ = model.data_preprocessor(imgs)
        ref = model.predict(x)
    model.train()
    out = step(imgs)
    assert model.training                  # the step restores the mode
    model.eval()
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert step.captures == 0              # a CPU model runs eagerly
    # slide mode runs eagerly too and equals predict_slide: 64x64 crops at
    # columns 0 and 32
    saved = model.test_cfg
    model.test_cfg = dict(mode='slide', crop_size=(64, 64), stride=(42, 42))
    try:
        slide = make_eval_step(model, model.data_preprocessor, mode='slide')
        with torch.no_grad():
            ref = model.predict_slide(x)
        out = slide(imgs)
    finally:
        model.test_cfg = saved
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert out.shape == ref.shape == (2, 64, 96, 3) and slide.captures == 0
    with pytest.raises(ValueError, match='unknown eval mode'):
        make_eval_step(model, mode='tiles')


def test_eval_step_weights_key_sees_every_change(small_led, one_thread):
    """The key that selects the graphs changes after an optimizer step, a
    ``load_state_dict``, a replaced parameter and a swapped buffer, and
    copies of the model get a step of their own with no graph."""
    import copy
    cfg = small_led['cfg']
    model, opt, sched = _port_training(cfg, small_led['model'].state_dict())
    step = make_eval_step(model, model.data_preprocessor)
    k0 = step.weights_key()
    assert step.weights_key() == k0
    train = make_train_step(model, opt, model.data_preprocessor)
    imgs, lbl = _batch(seed=42, shape=(2, 56, 64))
    train(create_train_state(model, opt, sched), torch.from_numpy(imgs),
          torch.from_numpy(lbl.astype(np.int64)))
    k1 = step.weights_key()
    assert k1 != k0
    model.load_state_dict(small_led['model'].state_dict())
    k2 = step.weights_key()
    assert k2 != k1
    model.decode_head.cls.conv_seg.bias = torch.nn.Parameter(
        model.decode_head.cls.conv_seg.bias.detach().clone())
    k3 = step.weights_key()
    assert k3 != k2
    # a buffer swapped in place of another, as ``Module._apply`` does
    bn = next(m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
    bn._buffers['running_mean'] = bn.running_mean.clone()
    assert step.weights_key() != k3
    model._eval_step = step
    twin = copy.deepcopy(model)
    assert twin._eval_step.model is twin and twin._eval_step._graphs == {}


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` where there is no card."""
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_capture(step, inputs, device):
    step.captures += 1
    return inputs.clone(), _FakeGraph(), torch.full((1,), float(step.captures))


def test_replay_launch_accounting(monkeypatch):
    """A wrapper counts the launches it makes (one recorded into a graph
    among them); a replay calls no op and counts nothing, and a device
    trace counts the kernels that ran by function name."""
    from torch.autograd import DeviceType
    from lednet_tpu_torch.engine.state import EvalStep
    from lednet_tpu_torch.ops import kernels
    saved = kernels.launch_counts()
    monkeypatch.setattr(EvalStep, '_capture', _fake_capture)
    try:
        kernels.reset_launch_counts()
        step = EvalStep(torch.nn.Conv2d(3, 4, 3))
        for _ in range(3):
            step._replay(torch.zeros(1, 8, 8, 3), torch.device('cpu'))
        graph = step._graphs[((1, 8, 8, 3), torch.float32)][1]
        assert graph.replays == 3 and step.captures == 1
        assert set(kernels.launch_counts().values()) == {0}
        assert not hasattr(kernels, 'add_launches')

        class Event:
            def __init__(self, key, count, device_type=DeviceType.CUDA):
                self.key, self.count, self.device_type = key, count, device_type
        events = [Event('void lednet::sesp_reduce_kernel<2>(lednet::ReduceArgs)', 11),
                  Event('void lednet::sesp_fused_kernel<4>(lednet::FusedArgs)', 10),
                  Event('void lednet::sesp_fused_kernel<2>(lednet::FusedArgs)', 1),
                  Event('void lednet::basic_block_kernel<32>(float const*)', 2),
                  Event('lednet::normalize_kernel', 5, DeviceType.CPU),
                  Event('sm80_xmma_fprop_implicit_gemm', 39)]
        assert kernels.device_launches(events) == {
            'normalize_image': 0, 'stem_convs': 0, 'basic_pair': 2,
            'sesp_block': 22, 'sesp_pyramid': 0}
    finally:
        for op in kernels.KERNELS:
            op.launches = saved[op.__name__]


def test_eval_step_keeps_the_last_graphs(monkeypatch):
    """The step keeps the graphs of the MAX_GRAPHS shapes used last and drops
    the least recently used one, freeing it (the pool the graphs share goes
    with the last of them); changed weights drop every graph."""
    import gc
    import weakref
    from lednet_tpu_torch.engine import state as engine_state
    monkeypatch.setattr(engine_state.EvalStep, '_capture', _fake_capture)
    model = torch.nn.Conv2d(3, 4, 3)
    step = engine_state.EvalStep(model)
    cpu = torch.device('cpu')
    n = engine_state.MAX_GRAPHS
    shapes = [(1, 8 + i, 8, 3) for i in range(n + 2)]
    for shape in shapes[:n]:
        step._replay(torch.zeros(shape), cpu)
    first = weakref.ref(step._graphs[(shapes[0], torch.float32)][1])
    second = weakref.ref(step._graphs[(shapes[1], torch.float32)][1])
    out = step._replay(torch.zeros(shapes[0]), cpu)    # used again: kept
    assert out.item() == 1.0
    for shape in shapes[n:]:
        step._replay(torch.zeros(shape), cpu)
    gc.collect()
    assert len(step._graphs) == n and step.captures == n + 2
    assert (shapes[0], torch.float32) in step._graphs and first() is not None
    assert (shapes[1], torch.float32) not in step._graphs and second() is None
    with torch.no_grad():
        model.weight.add_(1.0)
    step._replay(torch.zeros(shapes[0]), cpu)
    assert len(step._graphs) == 1 and step.captures == n + 3


def test_device_constants_outlive_many_shapes():
    """The device constants that a captured graph reads (SEAM's Laplacian,
    the nearest-resize and reflect-pad indices) stay alive and unchanged
    however many other shapes come after them."""
    from lednet_tpu_torch.models import getb, seam
    from lednet_tpu_torch.ops import resize
    cpu = torch.device('cpu')
    caches = [(resize._nearest_index, lambda i: (7 + i, 5)),
              (getb._reflect_device_index, lambda i: (5 + i, 3))]
    for fn, args in caches:
        assert fn.cache_info().maxsize is None
        first = fn(*args(0), cpu)
        values = first.clone()
        for i in range(1, 100):
            fn(*args(i), cpu)
        assert fn(*args(0), cpu) is first
        assert torch.equal(first, values)
    assert seam._laplacian.cache_info().maxsize is None
    lap = seam._laplacian(torch.float32, cpu)
    for dtype in (torch.float64, torch.float16, torch.bfloat16):
        seam._laplacian(dtype, cpu)
    assert seam._laplacian(torch.float32, cpu) is lap


def test_engine_runs_without_jax():
    """A train step and an eval step of the port in a process where JAX,
    flax and the JAX package cannot be imported."""
    code = '''
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'lednet_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
from lednet_tpu_torch.apis import init_model
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                     make_eval_step, make_train_step)
cfg = Config.fromfile('configs/LED_Net/lednet_80k_cityscapes-1024x1024.py')
cfg.merge_from_dict({'model.backbone.channels': 8, 'model.backbone.ppm_channels': 32,
    'model.decode_head.in_channels': 32, 'model.decode_head.channels': 16,
    'model.decode_head.num_classes': 3, 'model.data_preprocessor.size': (32, 32)})
model = init_model(cfg, device='cpu')
opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
step = make_train_step(model, opt, model.data_preprocessor)
imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
state, logs = step(create_train_state(model, opt, sched), imgs,
                   torch.randint(0, 3, (2, 32, 32)))
assert state.step == 1 and torch.isfinite(logs['loss'])
out = make_eval_step(model, model.data_preprocessor)(imgs)
assert out.shape == (2, 32, 32, 3)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'lednet_tpu')]
print(bad)
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == '[]'
