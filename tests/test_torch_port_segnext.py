"""PyTorch port: SegNeXt (MSCAN-T/S/B/L, LightHamHead, ADE20K), the last row
of the paper's speed table (``BASELINE.md``), against ``lednet_tpu`` on the
CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- the bricks, rel 1e-5 of the largest output: exact GELU; ``Norm2d``'s
  GroupNorm (32 groups, clamped to a divisor of the channels) and
  LayerNorm over the channels; ``DropPath`` (the identity at rate 0 and in
  eval; in training whole samples kept and scaled by 1 / keep, or zeroed,
  drawn from torch's default generator); ``MSCAAttention``, ``MSCABlock``
  and a narrow ``MSCAN`` at 100x156 (its strips and stage maps off every
  multiple) in eval; ``_nmf`` at the eval and train step counts, from the
  ones start and from a given ``bases0``; ``Hamburger`` in eval and in
  training; ``LightHamHead`` (logits and loss);
- the T config built unchanged (full width, 150 classes) at 64x64:
  ``predict`` within 1e-4 x max|logit| with argmax agreement >= 99.9%,
  the CPU eval step equal to it; the four configs build with the papers'
  parameter counts and every converted key lands on a port key, none
  left over;
- one AdamW step of a narrow SegNeXt (dropout and ``drop_path_rate`` 0:
  two RNG streams cannot drop the same samples) past the ``LinearLR``
  warm-up, at the same state step in both packages: loss within 1e-5,
  every weight within atol 1e-4 / rtol 5e-3, the BatchNorm running stats
  within atol 1e-5 / rtol 1e-4, ``grad_norm`` within rel 1e-3 (the bounds
  of ``tests/test_torch_port_zoo.py``), and the update far above float32's
  resolution of the weights;
- ``ADE20KDataset``: label 0 becomes 255 and x becomes x - 1, as the JAX
  package's dataset gives them; ``Runner.val`` of a narrow SegNeXt on a
  fabricated ADE20K tree with two val shapes of different aspect: aAcc and
  mIoU over the 150 classes within 0.05 points of the JAX Runner's.

torch runs on one thread in every test here (``one_thread``): its
CPU autograd aborts the process when it runs multi-threaded after the XLA
CPU runtime has run, and six workers' threads oversubscribe the cores.  A
brick's JAX reference runs op by op, without ``jax.jit``; the full-width
``predict`` (one compile cost 5.8 s against 14.5 op by op in a fresh
worker), the narrow train step and the Runner's val are jitted.
"""
import dataclasses

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

SEGNEXT = {v: f'{REPO}/configs/segnext/segnext_mscan-{v}_ade20k-512x512.py'
           for v in 'tsbl'}
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit
METRIC_TOL = 0.05          # percentage points, port val against JAX val
# a narrow SegNeXt: MSCAN (8, 16, 24, 32) x (1, 1, 2, 1), the head at 16
# channels and a 32-channel Hamburger of rank 4
NARROW = {'model.backbone.embed_dims': (8, 16, 24, 32),
          'model.backbone.depths': (1, 1, 2, 1),
          'model.decode_head.in_channels': (16, 24, 32),
          'model.decode_head.channels': 16,
          'model.decode_head.ham_channels': 32,
          'model.decode_head.ham_kwargs': dict(MD_R=4)}
NARROW_MSCAN = dict(embed_dims=(8, 16, 24, 32), depths=(1, 1, 2, 1),
                    mlp_ratios=(4, 4, 4, 4), drop_path_rate=0.1)


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with, so heavy tests started last
# compete for the cores at the end of the run, and two side by side run
# one after the other on one worker.
# ------------------------------------------------------------------ training
def _narrow_cfg(cls, extra=()):
    cfg = cls.fromfile(SEGNEXT['t'])
    cfg.merge_from_dict(dict(NARROW, **dict(extra)))
    return cfg


def test_train_step_matches_jax():
    """One AdamW step of a narrow SegNeXt, 3 classes, batch 2 of 64x64,
    dropout and stochastic depth 0, at state step 2000: past the LinearLR
    warm-up (at step 0 the lr is 6e-11 and the step moves no weight by
    more than float32's resolution), in the PolyLR."""
    extra = {'model.backbone.drop_path_rate': 0.0,
             'model.decode_head.dropout_ratio': 0.0,
             'model.decode_head.num_classes': 3,
             'model.data_preprocessor.size': (64, 64)}
    start = 2000
    jcfg = _narrow_cfg(JConfig, extra)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    rng = np.random.default_rng(24)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    lbl = np.where(rng.random((2, 64, 64)) < 0.05, 255,
                   rng.integers(0, 3, (2, 64, 64))).astype(np.int32)
    params, stats = loss_variables(jmodel, (1, 64, 64), n_classes=3, seed=25)
    before = flax_to_state_dict(params, stats)

    cfg = _narrow_cfg(Config, extra)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(before)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    step = make_train_step(model, opt, model.data_preprocessor)
    state = dataclasses.replace(create_train_state(model, opt, sched), step=start)
    tstate, logs = step(state, torch.from_numpy(imgs),
                        torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == start + 1 and model.training

    tx, jsched = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    assert float(jsched(start)) == pytest.approx(sched(start), rel=1e-6)
    assert sched(start) > 1e4 * sched(0)
    jvars = jax_variables(params, stats)
    jstate = JTrainState(step=jnp.asarray(start, jnp.int32),
                         params=jvars['params'], batch_stats=jvars['batch_stats'],
                         opt_state=tx.init(jvars['params']))
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))

    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    assert set(logs) - {'loss', 'grad_norm'} == keys == {'decode.loss_ce',
                                                         'decode.acc_seg'}
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    for k in keys:
        assert logs[k].item() == pytest.approx(float(jlogs[k]), rel=1e-4,
                                               abs=1e-5), k
    assert logs['grad_norm'].item() == pytest.approx(float(jlogs['grad_norm']),
                                                     rel=1e-3)
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
    # AdamW's first update moves a weight by about the lr (6e-5 here)
    assert moved > 0.5 * sched(start)


# ------------------------------------------------------------------ configs
# parameters of the papers' rows (SegNeXt, table 3): 4.3M, 13.9M, 27.6M, 48.9M
PARAMS_M = {'t': 4.3, 's': 13.9, 'b': 27.6, 'l': 48.9}


@pytest.mark.parametrize('variant', sorted(SEGNEXT))
def test_config_builds_and_converts(variant):
    """``init_model`` builds the config unchanged; its parameter count
    rounds to the paper's; every flax key of the JAX segmentor lands on a
    port key and none is left over, the names kept as they are
    (``layer_scale_{1,2}``, ``stage_norm{i}``, ``down_norm{i}``, the
    Hamburger's ``ham_in`` / ``ham_out``, ``squeeze``, ``align``)."""
    config = SEGNEXT[variant]
    model = init_model(config, device='cpu')
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e6, 1) == PARAMS_M[variant], n
    jmodel = JMODELS.build(dict(JConfig.fromfile(config).model))
    params, stats = loss_variables(jmodel, (1, 64, 64))
    sd = flax_to_state_dict(params, stats)
    assert set(sd) == set(MODELS.build(dict(Config.fromfile(config).model))
                          .state_dict())
    backbone, head = params['_backbone'], params['_decode_head']
    for key, leaf in (
            ('backbone.s2_b0.layer_scale_1', backbone['s2_b0']['layer_scale_1']),
            ('backbone.stage_norm3.weight', backbone['stage_norm3']['scale']),
            ('backbone.down_norm1.bn.running_var',
             stats['_backbone']['down_norm1']['bn']['var']),
            ('decode_head.hamburger.ham_in.bias', head['hamburger']['ham_in']['bias']),
            ('decode_head.hamburger.ham_out.norm.gn.weight',
             head['hamburger']['ham_out']['norm']['gn']['scale']),
            ('decode_head.squeeze.norm.gn.bias', head['squeeze']['norm']['gn']['bias']),
            ('decode_head.align.conv.weight',
             head['align']['conv']['kernel'].transpose(3, 2, 0, 1))):
        np.testing.assert_array_equal(sd[key].numpy(), leaf)


def test_segnext_t_predict_matches_jax():
    """The T config unchanged (full width, 150 classes, float32 input):
    ``predict`` of two seeded 64x64 images, the eval step on the CPU
    too."""
    config = SEGNEXT['t']
    jcfg = JConfig.fromfile(config)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = loss_variables(jmodel, (1, 64, 64), seed=22)
    model = init_model(config, device='cpu')
    sd = flax_to_state_dict(params, stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    imgs = np.random.default_rng(23).integers(0, 256, (2, 64, 64, 3),
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
    assert out.shape == ref.shape == (2, 64, 64, 150)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= TOL_MODEL
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree
    step = make_eval_step(model, model.data_preprocessor)
    np.testing.assert_array_equal(step(torch.from_numpy(imgs)).numpy(), out)


# ------------------------------------------------------------------ data
@pytest.fixture(scope='module')
def ade_tree(tmp_path_factory):
    from lednet_tpu_torch.datasets.synthetic import make_ade20k_tree
    return make_ade20k_tree(str(tmp_path_factory.mktemp('ade')), n_train=1,
                            n_val=3, sizes_hw=((96, 128), (144, 96)), seed=26)


def test_ade20k_dataset_reduces_zero_label(ade_tree):
    """The port's ``ADE20KDataset`` lists the tree's ``.jpg`` / ``.png``
    pairs as the JAX package's does, reads label 0 as 255 and x as x - 1,
    and has its 150 classes and palette."""
    from lednet_tpu.datasets import basesegdataset as jds
    from lednet_tpu.datasets import metainfo as jmeta
    from lednet_tpu_torch.datasets import ADE20KDataset, imageio
    kw = dict(data_root=ade_tree,
              data_prefix=dict(img_path='images/validation',
                               seg_map_path='annotations/validation'),
              pipeline=[dict(type='LoadImageFromFile'),
                        dict(type='LoadAnnotations')])
    pset, jset = ADE20KDataset(**kw), jds.ADE20KDataset(**kw)
    assert len(pset) == len(jset) == 3
    assert pset.metainfo['classes'] == jmeta.ADE20K_CLASSES
    assert pset.metainfo['palette'] == jmeta.ADE20K_PALETTE
    shapes = set()
    for idx in range(len(pset)):
        got, want = pset[idx], jset[idx]
        raw = imageio.imread(got['seg_map_path'], 'unchanged')
        assert raw.min() == 0 and raw.max() > 100
        np.testing.assert_array_equal(
            got['gt_seg_map'], np.where(raw == 0, 255, raw.astype(np.int32) - 1))
        np.testing.assert_array_equal(got['gt_seg_map'], want['gt_seg_map'])
        np.testing.assert_array_equal(got['img'], want['img'])
        shapes.add(got['img'].shape)
    assert shapes == {(96, 128, 3), (144, 96, 3)}


def test_runner_val_matches_jax(ade_tree, tmp_path):
    """``Runner.val`` of a narrow SegNeXt (150 classes) on the tree's three
    val images, 96x128 and 144x96 resized to fit (256, 128) with their
    ratio kept (128x171, 192x128) and padded to the 128 bucket: two shapes
    of different aspect; aAcc and mIoU within 0.05 points of the JAX
    Runner's."""
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu_torch.engine.runner import Runner
    options = {f'{k}.dataset.data_root': ade_tree for k in
               ('train_dataloader', 'val_dataloader', 'test_dataloader')}
    options.update({'val_dataloader.num_workers': 2, 'val_batch_size': 1,
                    'vis_backends': None})

    def config(cls):
        cfg = _narrow_cfg(cls, options)
        cfg.val_dataloader.dataset.pipeline[1]['scale'] = (256, 128)
        return cfg
    jrunner = JRunner(config(JConfig), work_dir=str(tmp_path / 'jax'))
    params, stats = loss_variables(jrunner.model, (1, 64, 64), seed=27)
    variables = jax_variables(params, stats)
    # the eval step reads only the weights: no init, no optimizer state
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.val()

    runner = Runner(config(Config), work_dir=str(tmp_path / 'port'),
                    device='cpu')
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    shapes = []
    step = runner.eval_step()
    forward = step.forward
    step.forward = lambda x: shapes.append(tuple(x.shape)) or forward(x)
    got = runner.val()
    assert sorted(set(shapes)) == [(1, 128, 256, 3), (1, 256, 128, 3)]
    assert want['aAcc'] > 0.1 and want['mIoU'] > 0.01      # not degenerate
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


# ------------------------------------------------------------------ bricks
def test_gelu_matches_jax():
    import flax.linen as fnn
    from lednet_tpu_torch.models.layers import build_activation
    x = _normal((2, 6, 7, 5), seed=1, scale=3.0)
    gelu = build_activation(dict(type='GELU'))
    assert isinstance(gelu, torch.nn.GELU) and gelu.approximate == 'none'
    _hold(nhwc(gelu(nchw(x))), fnn.gelu(jnp.asarray(x), approximate=False))
    with pytest.raises(ValueError, match='Swish'):
        build_activation(dict(type='Swish'))


NORMS = {'gn_clamped': (dict(type='GN', num_groups=32), 24, 8),
         'gn_32': (dict(type='GN', num_groups=32), 64, 32),
         'ln': (dict(type='LN'), 12, None)}


@pytest.mark.parametrize('name', sorted(NORMS))
def test_norm2d_matches_jax(name):
    """GroupNorm halves 32 groups until they divide the width (24 -> 8) as
    the JAX package does; the input sits on an offset of 3, where a
    variance taken as E[x^2] - E[x]^2 and a two-pass one part."""
    from lednet_tpu.models.layers import Norm2d as J
    from lednet_tpu_torch.models.layers import Norm2d
    cfg, c, groups = NORMS[name]
    x = _normal((2, 9, 13, c), seed=2) + 3.0
    ref, out = _pair(J(cfg), Norm2d(cfg, c), x, seed=3)
    port = Norm2d(cfg, c)
    if groups is not None:
        assert port.gn.num_groups == groups
    _hold(nhwc(out), ref)
    with pytest.raises(ValueError, match='IN'):
        Norm2d(dict(type='IN'), c)


def test_drop_path():
    """The identity at rate 0 and in eval (as the JAX package's); in
    training each sample is kept whole, scaled by 1 / keep, or zeroed, the
    mask from torch's default generator (one seed governs it and the heads'
    dropout)."""
    from lednet_tpu.models.layers import DropPath as J
    from lednet_tpu_torch.models.layers import DropPath
    x = torch.from_numpy(_normal((400, 3, 4, 5), seed=4)) + 5.0
    assert DropPath(0.0).train()(x) is x
    assert DropPath(0.3).eval()(x) is x
    jx = jnp.asarray(nhwc(x))
    np.testing.assert_array_equal(np.asarray(J(0.3).apply({}, jx, train=False)),
                                  nhwc(x))
    drop = DropPath(0.25).train()
    torch.manual_seed(5)
    out = drop(x)
    torch.manual_seed(5)
    assert torch.equal(drop(x), out)
    kept = out.flatten(1).ne(0).all(1)
    assert torch.equal(out.flatten(1).eq(0).all(1), ~kept)
    torch.testing.assert_close(out[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert 0.65 < kept.double().mean() < 0.85


def test_msca_attention_matches_jax():
    """A 13x17 map: the 1x21 and 21x1 strips reach past both borders."""
    from lednet_tpu.models.backbones.mscan import MSCAAttention as J
    from lednet_tpu_torch.models.backbones.mscan import MSCAAttention
    x = _normal((2, 13, 17, 8), seed=6)
    jmod = J(8)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=7)
    port = load_port(MSCAAttention(8), params, stats)
    with torch.no_grad():
        out = port(nchw(x))
    _hold(nhwc(out), jmod.apply(jax_variables(params, stats), jnp.asarray(x)))


def test_msca_block_matches_jax():
    from lednet_tpu.models.backbones.mscan import MSCABlock as J
    from lednet_tpu_torch.models.backbones.mscan import MSCABlock
    x = _normal((2, 11, 14, 8), seed=8)
    ref, out = _pair(J(8, 4.0, drop_path=0.2), MSCABlock(8, 4.0, drop_path=0.2),
                     x, seed=9)
    _hold(nhwc(out), ref)


def test_mscan_matches_jax():
    """At 100x156 the four stage maps are 25x39, 13x20, 7x10 and 4x5."""
    from lednet_tpu.models.backbones.mscan import MSCAN as J
    from lednet_tpu_torch.models.backbones.mscan import MSCAN
    x = _normal((1, 100, 156, 3), seed=10)
    ref, out = _pair(J(**NARROW_MSCAN), MSCAN(**NARROW_MSCAN), x, seed=11)
    assert [tuple(o.shape[1:]) for o in out] == [
        (8, 25, 39), (16, 13, 20), (24, 7, 10), (32, 4, 5)]
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


# ------------------------------------------------------------------ head
@pytest.mark.parametrize('case', ['eval', 'train', 'bases0'])
def test_nmf_matches_jax(case):
    """Seven updates (eval) or six (train) from the ones start, and seven
    from a given positive ``bases0``."""
    from lednet_tpu.models.decode_heads.ham_head import _nmf as jnmf
    from lednet_tpu_torch.models.decode_heads.ham_head import _nmf
    rng = np.random.default_rng(12)
    x = np.abs(rng.standard_normal((2, 16, 60))).astype(np.float32)
    steps = 6 if case == 'train' else 7
    bases0 = None
    if case == 'bases0':
        b = rng.uniform(0.1, 1.0, (2, 16, 4)).astype(np.float32)
        bases0 = b / np.sqrt((b ** 2).sum(1, keepdims=True))
    ref = jnmf(jnp.asarray(x), 4, steps,
               bases0=None if bases0 is None else jnp.asarray(bases0))
    out = _nmf(torch.from_numpy(x), 4, steps,
               bases0=None if bases0 is None else torch.from_numpy(bases0))
    assert out.shape == (2, 16, 60) and (out >= 0).all()
    assert rel_err(out.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_hamburger_matches_jax(train):
    """48 channels: GroupNorm's 32 groups clamp to 16 of 3 channels; in
    training the NMF runs six updates from the ones start in both."""
    from lednet_tpu.models.decode_heads.ham_head import Hamburger as J
    from lednet_tpu_torch.models.decode_heads.ham_head import Hamburger
    x = _normal((2, 9, 13, 48), seed=13)
    jmod = J(48, md_r=4)
    params, stats = random_variables(jmod, jnp.asarray(x), seed=14)
    port = load_port(Hamburger(48, md_r=4), params, stats).train(train)
    assert port.ham_out.norm.gn.num_groups == 16
    with torch.no_grad():
        out = port(nchw(x))
    ref = jmod.apply(jax_variables(params, stats), jnp.asarray(x), train=train)
    _hold(nhwc(out), ref)


def test_light_ham_head_matches_jax():
    """Inputs 1-3 of four maps (25x39, 13x20, 7x10, 4x5) resized to the
    first selected and concatenated; the logits and the loss."""
    from lednet_tpu_torch.models.decode_heads.ham_head import LightHamHead
    cfg = dict(Config.fromfile(SEGNEXT['t']).model.decode_head,
               in_channels=[8, 12, 16], channels=16, ham_channels=32,
               ham_kwargs=dict(MD_R=4), num_classes=5)
    jhead = JMODELS.build(dict(cfg))
    feats = [_normal((2,) + hw + (c,), seed=15 + i) for i, (hw, c) in
             enumerate(zip([(25, 39), (13, 20), (7, 10), (4, 5)], (4, 8, 12, 16)))]
    jfeats = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jhead, jfeats, seed=19)
    head = load_port(LightHamHead(**{k: v for k, v in cfg.items() if k != 'type'}),
                     params, stats)
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    ref = _apply(jhead, params, stats, jfeats)
    assert out.shape == (2, 5, 13, 20)
    _hold(nhwc(out), ref)
    lbl = np.random.default_rng(20).integers(0, 5, (2, 52, 80))
    lbl = np.where(np.random.default_rng(21).random(lbl.shape) < 0.1, 255,
                   lbl).astype(np.int32)
    want = jhead.loss_by_feat(ref, jnp.asarray(lbl))
    got = head.loss_by_feat(out, torch.from_numpy(lbl).long())
    assert set(got) == set(want) == {'loss_ce', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k
