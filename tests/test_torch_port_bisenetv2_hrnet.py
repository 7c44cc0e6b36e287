"""PyTorch port: BiSeNetV2 (with its OHEM pixel sampler and its bfloat16
train step) and HRNet-W18 / W18-Small / W48, the rows of the paper's speed
table after STDC (``BASELINE.md``), against ``lednet_tpu`` on the CPU.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX module and its port after ``lednet_tpu_torch.convert`` has
carried the same random flax weights and BatchNorm running stats across,
and holds them together:

- the bricks in eval mode, rel 1e-5 of the largest output:
  ``_DWSeparable`` with and without the pointwise norm; ``StemBlock``;
  ``GELayer`` at stride 1 and 2, same and changed width; ``CEBlock``;
  ``BiSeNetV2`` at narrow widths at 64x96 and at 100x156 (the BGA's
  resizes land off a multiple); ``_Fuse`` of 2, 3 and 4 branches at odd
  sizes; ``HRNet`` narrow (widths 4-16, one module per stage) and its
  expansion-4 stage 1 with and without the downsample; HRNet's
  ``FCNHead`` (``resize_concat`` of the four branches, a 1x1 conv, no
  dropout);
- ``OHEMPixelSampler``, both branches (``thresh`` and top-k), with ignored
  pixels, tied losses at the cut and fewer valid pixels than
  ``min_kept * B``: the weights equal exactly; ``FCNHead.loss_by_feat``
  with a sampler within 1e-5; a ``TypeError`` raised inside a loss is not
  taken for a loss that takes no weight;
- the configs built unchanged (BiSeNetV2; HRNet-W18, W18-Small, W48) at
  small inputs: logits within 1e-4 x max|logit| with argmax agreement
  >= 99.9%, and the CPU eval step equal to ``predict``; every converted
  key lands on a port key and none is left over; each family's schedule
  and batch siblings build the same model as their base;
- one train step each of BiSeNetV2 ``-ohem-`` (the sampler on all five
  heads) and HRNet-W18 (its widths, one module per stage), dropout 0 in
  every head: loss within 1e-5, every weight within atol 1e-4 / rtol
  5e-3, the BatchNorm running stats within atol 1e-5 / rtol 1e-4 (the
  bounds of ``tests/test_torch_port_train.py``);
- the bfloat16 train step (``make_train_step(amp=True)``, the ``-amp-``
  config's ``bf16 = True``) against the JAX step's, within the bound
  stated at ``test_bf16_train_step_matches_jax``;
- ``chip_smoke.decisions`` records and pins the sampler's keep mask.

torch runs on one thread in every test here (``one_thread``): its CPU
autograd aborts the process when it runs multi-threaded after the XLA CPU
runtime has run, and six workers' threads oversubscribe the cores.  A JAX
reference that runs once (a brick) runs op by op, without ``jax.jit``; a
segmentor's ``predict`` is jitted: in a fresh worker one whole-graph
compile cost less than the forward op by op (BiSeNetV2 7.1 s against
16.3, HRNet-W18-Small 12.0 against 20.1; W18 and W48 about even).
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
from test_torch_port_zoo import _apply, _hold, _normal, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

BISENETV2 = f'{REPO}/configs/bisenetv2/bisenetv2_cityscapes-1024x1024.py'
BISENETV2_OHEM = (f'{REPO}/configs/bisenetv2/'
                  'bisenetv2_fcn_4xb4-ohem-160k_cityscapes-1024x1024.py')
BISENETV2_AMP = (f'{REPO}/configs/bisenetv2/'
                 'bisenetv2_fcn_4xb4-amp-160k_cityscapes-1024x1024.py')
HRNET = {v: f'{REPO}/configs/hrnet/fcn_{v}_4xb2-80k_cityscapes-512x1024.py'
         for v in ('hr18', 'hr18s', 'hr48')}
TOL_MODEL = 1e-4           # whole segmentors, rel to the largest logit


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    import lednet_tpu.structures.sampler  # noqa: F401  (registers OHEMPixelSampler)
    lednet_tpu.register_all_modules()


def _pair(jmod, port, x, seed):
    """(JAX output, port output) of ``x`` (NHWC numpy) in eval mode."""
    params, stats = random_variables(jmod, jnp.asarray(x), seed=seed)
    port = load_port(port, params, stats)
    with torch.no_grad():
        out = port(nchw(x))
    return _apply(jmod, params, stats, jnp.asarray(x)), out


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with, so heavy tests started last
# compete for the cores at the end of the run, and two side by side run
# one after the other on one worker.
# ------------------------------------------------------------------ training
def _small_bisenetv2(config=BISENETV2_OHEM):
    """The config at its widths, 3 classes, every head's dropout 0."""
    model = Config.fromfile(config).model
    aux = [dict(h, num_classes=3, dropout_ratio=0.0)
           for h in model.auxiliary_head]
    return {'model.decode_head.num_classes': 3,
            'model.decode_head.dropout_ratio': 0.0,
            'model.auxiliary_head': aux,
            'model.data_preprocessor.size': (128, 128)}


def _small_hrnet():
    """HRNet-W18 at its widths with one module per stage and two blocks
    per branch, 3 classes."""
    extra = Config.fromfile(HRNET['hr18']).model.backbone.extra
    return {'model.backbone.extra': dict(
                stage1=dict(extra.stage1, num_blocks=(2,)),
                **{f'stage{s}': dict(extra[f'stage{s}'], num_modules=1,
                                     num_blocks=(2,) * (s))
                   for s in (2, 3, 4)}),
            'model.decode_head.num_classes': 3,
            'model.data_preprocessor.size': (128, 128)}


def _jax_state(jcfg, params, stats):
    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    jvars = jax_variables(params, stats)
    return tx, JTrainState(step=jnp.asarray(0, jnp.int32),
                           params=jvars['params'],
                           batch_stats=jvars['batch_stats'],
                           opt_state=tx.init(jvars['params']))


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 120, 128, 3), dtype=np.uint8)
    lbl = np.where(rng.random((n, 120, 128)) < 0.02, 255,
                   rng.integers(0, 3, (n, 120, 128))).astype(np.int32)
    return imgs, lbl


def _steps(config, extra, n, amps=(False,), seed=50):
    """One step of the JAX package and one of the port from the same
    weights and batch, for each ``amp``: {(package, amp): (logs as floats,
    the state_dict after)}, and the weights before."""
    jcfg = JConfig.fromfile(config)
    jcfg.merge_from_dict(extra)
    jmodel = _jax_model(jcfg)
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    imgs, lbl = _batch(n, seed)
    params, stats = loss_variables(jmodel, (1, 128, 128), n_classes=3,
                                   seed=seed + 1)
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(extra)
    before = flax_to_state_dict(params, stats)
    runs = {}
    for amp in amps:
        model = init_model(cfg, device='cpu')
        model.load_state_dict(before)
        opt, sched = build_optimizer(model, cfg.optim_wrapper,
                                     cfg.param_scheduler)
        step = make_train_step(model, opt, model.data_preprocessor, amp=amp)
        tstate, logs = step(create_train_state(model, opt, sched),
                            torch.from_numpy(imgs),
                            torch.from_numpy(lbl.astype(np.int64)))
        assert tstate.step == 1 and model.training
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
        runs['port', amp] = ({k: float(v) for k, v in logs.items()},
                             {k: v.clone() for k, v in model.state_dict().items()})
    for amp in amps:
        tx, state = _jax_state(jcfg, params, stats)
        state, jlogs = jmake_train_step(jmodel, tx, jpre, amp=amp)(
            state, jnp.asarray(imgs), jnp.asarray(lbl))
        runs['jax', amp] = ({k: float(v) for k, v in jlogs.items()},
                            flax_to_state_dict(jax.device_get(state.params),
                                               jax.device_get(state.batch_stats)))
    return runs, before, lbl


def test_chip_smoke_pins_the_sampler_mask():
    """``chip_smoke.decisions`` records each ``OHEMPixelSampler``'s keep
    mask, counts where a later call keeps other pixels, and with ``pin``
    keeps the recorded ones."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    from lednet_tpu_torch.structures import OHEMPixelSampler
    sampler = OHEMPixelSampler(thresh=0.7, min_kept=5)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(0, 2, (2, 4, 6, 7)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, (2, 6, 7)))
    labels[0, 0, :3] = 255
    kept = []
    with chip_smoke.decisions(kept):
        weights = sampler.sample(logits, labels)
    assert len(kept) == 1 and torch.equal(kept[0], weights.bool())
    assert torch.equal(weights, sampler.keep_mask(logits, labels).float())
    moved = logits + torch.from_numpy(rng.normal(0, 1, logits.shape)
                                      .astype(np.float32))
    own = sampler.keep_mask(moved, labels)
    for pin in (False, True):
        flips = {}
        with chip_smoke.decisions(kept, flips, pin):
            got = sampler.sample(moved, labels)
        assert flips['sampler'] == int((own != kept[0]).sum()) > 0
        assert torch.equal(got.bool(), kept[0] if pin else own)


BF16_U = 2.0 ** -8          # bfloat16's unit roundoff (8 significand bits)


def _update_distance(a, b, before, stats):
    """|a - b| over |b - before|, each the L2 norm over every weight (or
    every BatchNorm running stat) of the model: how far two steps' updates
    lie apart, as a share of the update."""
    diff = upd = 0.0
    for k, v in b.items():
        if k.endswith('num_batches_tracked') or ('running' in k) != stats:
            continue
        diff += (a[k].double() - v.double()).square().sum().item()
        upd += (v.double() - before[k].double()).square().sum().item()
    return (diff / upd) ** 0.5


@pytest.mark.parametrize('batch', [4, 2])
def test_bf16_train_step_matches_jax(batch, one_thread):
    """The ``-amp-`` config's step (``bf16 = True``: ``amp=True`` in both
    packages) at its widths, 3 classes, dropout 0, at the config's batch of
    4 and at 2, where the context block's BatchNorms see two values per
    channel and their backward is almost all rounding.

    The bound.  Every bfloat16 op rounds to within ``BF16_U`` = 2^-8 of its
    value.  The loss, one rounding of a sum of float32 per-pixel CE terms
    of bfloat16 logits, is held within ``BF16_U`` of JAX's, relatively.
    The step's update is a deep chain of such roundings, and what they do
    to it is measured on the same inputs: ``D``, the JAX bfloat16 step's
    distance from the JAX float32 step (the L2 norm of the difference of
    the weights, of the BatchNorm running stats, over that of their
    update; |difference| of ``grad_norm``).  Two steps that each round
    every op differently lie within ``2 D`` of each other, so the port's
    bfloat16 step is held within ``2 D`` of JAX's bfloat16 step in each.

    Measured when the port ran the step under ``torch.autocast``: at batch
    2 its ``grad_norm`` was 14.43 against JAX's 11.77 (``2 D`` = 0.245),
    the context block's 1x1 conv moved 34.7x its float32 update from
    JAX's; autocast ran BatchNorm's backward in bfloat16.  The port now
    casts every parameter and the input to bfloat16 inside the loss and
    normalizes in float32, as JAX does (ROADMAP Queue 3).

    That amp is on: the port's bfloat16 loss is not its float32 loss, its
    update lies farther from its float32 step's than the port's float32
    step lies from JAX's by over 10x, and the master weights and their
    gradients stay float32 (``_steps``)."""
    runs, before, _ = _steps(BISENETV2_AMP, _small_bisenetv2(BISENETV2_AMP),
                             batch, amps=(False, True))
    (plogs, p16), (jlogs, j16) = runs['port', True], runs['jax', True]
    (plogs32, p32), (jlogs32, j32) = runs['port', False], runs['jax', False]
    assert abs(plogs['loss'] - jlogs['loss']) <= BF16_U * abs(jlogs['loss'])
    d_gn = abs(jlogs['grad_norm'] - jlogs32['grad_norm'])
    assert abs(plogs['grad_norm'] - jlogs['grad_norm']) <= 2 * d_gn
    for stats in (False, True):
        d = _update_distance(j16, j32, before, stats)
        assert _update_distance(p16, j16, before, stats) <= 2 * d, stats
    assert plogs['loss'] != plogs32['loss']
    assert _update_distance(p16, p32, before, False) > \
        10 * _update_distance(p32, j32, before, False)


@pytest.mark.parametrize('name', ['bisenetv2-ohem', 'hr18'])
def test_train_step_matches_jax(name, one_thread):
    """One SGD step of the config (dropout 0, 3 classes; HRNet-W18 one
    module per stage) in both packages from the same weights and batch
    (BiSeNetV2: 4 images, HRNet: 2): BiSeNetV2's
    CE on the decode head and four booster heads, each weighted by its
    ``OHEMPixelSampler`` (``aux_{0..3}.*``); HRNet's CE on the
    ``resize_concat`` head."""
    config, extra = ((BISENETV2_OHEM, _small_bisenetv2()) if name != 'hr18'
                     else (HRNET['hr18'], _small_hrnet()))
    # BiSeNetV2 at its config's batch of 4: the context block's BatchNorms
    # see one value per image, and at 2 float32 rounding alone moves their
    # running variance past the bound
    runs, _, lbl = _steps(config, extra, 4 if name != 'hr18' else 2)
    (logs, got), (jlogs, want) = runs['port', False], runs['jax', False]
    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    heads = ['decode'] + ([f'aux_{i}' for i in range(4)] if name != 'hr18' else [])
    assert set(logs) - {'loss', 'grad_norm'} == keys == {
        f'{h}.{k}' for h in heads for k in ('loss_ce', 'acc_seg')}
    assert abs(logs['loss'] - jlogs['loss']) <= 1e-5
    one_pixel = 100.0 / int((lbl != 255).sum())
    for k in keys:
        tol = dict(rel=0, abs=1.01 * one_pixel) if k.endswith('acc_seg') \
            else dict(rel=1e-4, abs=1e-5)
        assert logs[k] == pytest.approx(jlogs[k], **tol), k
    assert logs['grad_norm'] == pytest.approx(jlogs['grad_norm'], rel=1e-3)
    assert set(got) == set(want)
    for k, ref in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        stat = k.endswith('running_mean') or k.endswith('running_var')
        np.testing.assert_allclose(
            got[k].numpy(), ref.numpy(), err_msg=k,
            **(dict(atol=1e-5, rtol=1e-4) if stat else dict(atol=1e-4, rtol=5e-3)))


# ------------------------------------------------------------------ configs
def _jax_model(jcfg):
    """The JAX segmentor of ``jcfg`` with its heads' sampler configs built
    into samplers first: the JAX package's ``default_loss_by_feat`` builds
    a sampler from a ``dict``, but inside a bound flax module the config
    is a ``FrozenDict``, and the loss raises (ROADMAP Queue 3)."""
    model = dict(jcfg.model)

    def built(head):
        head = dict(head)
        if isinstance(head.get('sampler'), dict):
            head['sampler'] = JMODELS.build(dict(head['sampler']))
        return head
    model['decode_head'] = built(model['decode_head'])
    if model.get('auxiliary_head'):
        model['auxiliary_head'] = [built(h) for h in model['auxiliary_head']]
    return JMODELS.build(model)


def _segmentor_pair(config, seed):
    jcfg = JConfig.fromfile(config)
    jmodel = _jax_model(jcfg)
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


SEGMENTORS = {'bisenetv2': (BISENETV2_OHEM, (100, 156)),
              'hr18': (HRNET['hr18'], (100, 156)),
              'hr18s': (HRNET['hr18s'], (64, 128)),
              'hr48': (HRNET['hr48'], (64, 96))}


@pytest.mark.parametrize('name', sorted(SEGMENTORS))
def test_segmentor_predict_matches_jax(name):
    """The shipped config unchanged (full width, float32 input, 19
    classes): ``predict`` of two seeded images, the eval step on the CPU
    too."""
    config, shape = SEGMENTORS[name]
    jax_logits, model = _segmentor_pair(config, seed=40)
    imgs = np.random.default_rng(41).integers(0, 256, (2,) + shape + (3,),
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


FAMILIES = {
    'bisenetv2': (BISENETV2, [
        'bisenetv2_fcn_4xb8-160k_cityscapes-1024x1024.py',
        'bisenetv2_fcn_4xb4-ohem-160k_cityscapes-1024x1024.py',
        'bisenetv2_fcn_4xb4-amp-160k_cityscapes-1024x1024.py']),
    **{v: (HRNET[v], [f'fcn_{v}_4xb2-{n}_cityscapes-512x1024.py'
                      for n in ('40k', '160k')]
           + (['fcn_hr18_cityscapes-512x1024.py'] if v == 'hr18' else []))
       for v in HRNET},
}


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_siblings_build_as_their_base(family):
    """The schedule, batch, OHEM and amp siblings of a config build the
    same modules from the same seed (BiSeNetV2's ``-ohem-`` adds only the
    samplers, ``-amp-`` only ``bf16``); HRNet-W18-Small and W48 have the
    depths and widths of their papers' rows."""
    base, siblings = FAMILIES[family]
    folder = base.rsplit('/', 1)[0]
    ref = init_model(base, device='cpu',
                     generator=torch.Generator().manual_seed(0))
    for name in siblings:
        model = init_model(f'{folder}/{name}', device='cpu',
                           generator=torch.Generator().manual_seed(0))
        a, b = model.state_dict(), ref.state_dict()
        assert list(a) == list(b), name
        for k in b:
            assert torch.equal(a[k], b[k]), (name, k)
        samplers = [type(h.sampler).__name__ for h in
                    [model.decode_head, *model.aux_heads]]
        assert set(samplers) == ({'OHEMPixelSampler'} if '-ohem-' in name
                                 else {'NoneType'}), name
        assert bool(model.cfg.get('bf16', False)) == ('-amp-' in name), name
    if family != 'bisenetv2':
        widths = {'hr18': 18, 'hr18s': 18, 'hr48': 48}[family]
        blocks = {'hr18': 4, 'hr18s': 2, 'hr48': 4}[family]
        names = dict(ref.backbone.named_children())
        assert ref.backbone.s4_m0_b3_0.conv1.conv.out_channels == 8 * widths
        assert f's4_m0_b0_{blocks - 1}' in names and \
            f's4_m0_b0_{blocks}' not in names
        assert ref.decode_head.conv0.conv.out_channels == 15 * widths


@pytest.mark.parametrize('name', ['bisenetv2', 'hr18'])
def test_convert_maps_every_name(name):
    """Every flax key of the config's segmentor (its auxiliary heads too)
    lands on a port key, and no port key is left over; the names the
    backbones give their modules explicitly come through as they are."""
    config = BISENETV2 if name == 'bisenetv2' else HRNET['hr18']
    jmodel = JMODELS.build(dict(JConfig.fromfile(config).model))
    params, stats = loss_variables(jmodel, (1, 64, 64))
    sd = flax_to_state_dict(params, stats)
    model = MODELS.build(dict(Config.fromfile(config).model))
    assert set(sd) == set(model.state_dict())
    if name == 'bisenetv2':
        assert {f'_aux_heads_{i}' for i in range(4)} <= set(params)
        key = ('stage4_0', 'shortcut', 'pw', 'conv', 'kernel')
        probe = 'backbone.stage4_0.shortcut.pw.conv.weight'
        assert 'backbone.ce_block.gap_norm.bn.running_var' in sd
        assert 'backbone.detail_dwconv.pw.conv.bias' in sd
    else:
        key = ('s4_m2_fuse', 'f3_0_2', 'conv', 'kernel')
        probe = 'backbone.s4_m2_fuse.f3_0_2.conv.weight'
        assert 'backbone.layer1_0.downsample_norm.bn.running_mean' in sd
    leaf = params['_backbone']
    for part in key:
        leaf = leaf[part]
    np.testing.assert_array_equal(sd[probe].numpy(), leaf.transpose(3, 2, 0, 1))


# ------------------------------------------------------------------ BiSeNetV2
@pytest.mark.parametrize('pw_norm', [True, False])
def test_dw_separable_matches_jax(pw_norm):
    from lednet_tpu.models.backbones.bisenetv2 import _DWSeparable as J
    from lednet_tpu_torch.models.backbones.bisenetv2 import _DWSeparable
    x = _normal((2, 9, 13, 12), seed=1)
    ref, out = _pair(J(12, 20, stride=2, pw_norm=pw_norm),
                     _DWSeparable(12, 20, stride=2, pw_norm=pw_norm), x, seed=2)
    _hold(nhwc(out), ref)


def test_stem_block_matches_jax():
    """An odd input: the strided pair and the 3x3/s2 max pool (padded with
    -inf) meet at ceil(in / 4)."""
    from lednet_tpu.models.backbones.bisenetv2 import StemBlock as J
    from lednet_tpu_torch.models.backbones.bisenetv2 import StemBlock
    x = _normal((2, 37, 45, 3), seed=3)
    ref, out = _pair(J(3, 16), StemBlock(3, 16), x, seed=4)
    assert out.shape == (2, 16, 10, 12)
    _hold(nhwc(out), ref)


GE_LAYERS = [(8, 8, 1), (8, 12, 1), (8, 12, 2), (12, 12, 2)]


@pytest.mark.parametrize('cin,cout,stride', GE_LAYERS,
                         ids=[f'{a}_{b}_s{s}' for a, b, s in GE_LAYERS])
def test_ge_layer_matches_jax(cin, cout, stride):
    """Stride 1 (one expanded depthwise conv) and 2 (two), the identity and
    the depthwise-separable shortcut."""
    from lednet_tpu.models.backbones.bisenetv2 import GELayer as J
    from lednet_tpu_torch.models.backbones.bisenetv2 import GELayer
    x = _normal((2, 11, 14, cin), seed=5)
    ref, out = _pair(J(cin, cout, 6, stride), GELayer(cin, cout, 6, stride),
                     x, seed=6)
    _hold(nhwc(out), ref)


def test_ce_block_matches_jax():
    """``gap_norm``: eval BatchNorm of the 1x1 global average."""
    from lednet_tpu.models.backbones.bisenetv2 import CEBlock as J
    from lednet_tpu_torch.models.backbones.bisenetv2 import CEBlock
    x = _normal((2, 5, 7, 16), seed=7) + 0.5
    ref, out = _pair(J(16, 16), CEBlock(16, 16), x, seed=8)
    _hold(nhwc(out), ref)


NARROW_BISENETV2 = dict(detail_channels=(8, 8, 16),
                        semantic_channels=(4, 8, 12, 16), bga_channels=16)


@pytest.mark.parametrize('hw', [(64, 96), (100, 156)])
def test_bisenetv2_matches_jax(hw):
    """All five outputs; at 100x156 the 1/8 maps are 13x20 and the 1/32 ones
    4x5, so both BGA upsamplings land off a multiple."""
    from lednet_tpu.models.backbones.bisenetv2 import BiSeNetV2 as J
    from lednet_tpu_torch.models.backbones.bisenetv2 import BiSeNetV2
    x = _normal((1,) + hw + (3,), seed=9)
    ref, out = _pair(J(**NARROW_BISENETV2), BiSeNetV2(**NARROW_BISENETV2),
                     x, seed=10)
    assert [o.shape[1] for o in out] == [16, 4, 8, 12, 16]
    assert out[0].shape[-2:] == (-(-hw[0] // 8), -(-hw[1] // 8))
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


# ------------------------------------------------------------------ HRNet
@pytest.mark.parametrize('n', [2, 3, 4])
def test_fuse_matches_jax(n):
    """Branches at 1/1 .. 1/2^(n-1) of an odd 13x19 map (7x10, 4x5, 2x3):
    every upsampling is off a multiple, and the 4-branch fusion has chains
    of one, two and three strided convs."""
    from lednet_tpu.models.backbones.hrnet import _Fuse as J
    from lednet_tpu_torch.models.backbones.hrnet import _Fuse
    chans = (4, 8, 12, 16)[:n]
    sizes = [(13, 19), (7, 10), (4, 5), (2, 3)][:n]
    xs = [_normal((2,) + hw + (c,), seed=11 + i)
          for i, (hw, c) in enumerate(zip(sizes, chans))]
    jmod = J(chans)
    jxs = [jnp.asarray(x) for x in xs]
    params, stats = random_variables(jmod, jxs, seed=15)
    port = load_port(_Fuse(chans), params, stats)
    with torch.no_grad():
        out = port([nchw(x) for x in xs])
    ref = _apply(jmod, params, stats, jxs)
    assert len(out) == len(ref) == n
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


NARROW_HRNET = {
    'narrow': dict(
        stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                    num_blocks=(2,), num_channels=(8,)),
        stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                    num_blocks=(1, 1), num_channels=(4, 8)),
        stage3=dict(num_modules=1, num_branches=3, block='BASIC',
                    num_blocks=(1, 1, 1), num_channels=(4, 8, 12)),
        stage4=dict(num_modules=2, num_branches=4, block='BASIC',
                    num_blocks=(1, 2, 1, 1), num_channels=(4, 8, 12, 16))),
    # 16 x 4 = 64, the stem's width: no downsample in stage 1; stage 2
    # keeps branch 0's width (no transition conv there)
    'stage1_64': dict(
        stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                    num_blocks=(2,), num_channels=(16,)),
        stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                    num_blocks=(1, 1), num_channels=(64, 8))),
}


@pytest.mark.parametrize('name', sorted(NARROW_HRNET))
def test_hrnet_matches_jax(name):
    """At 100x156: the branches are 25x39, 13x20, 7x10 and 4x5."""
    from lednet_tpu.models.backbones.hrnet import HRNet as J
    from lednet_tpu_torch.models.backbones.hrnet import HRNet
    extra = NARROW_HRNET[name]
    x = _normal((1, 100, 156, 3), seed=16)
    ref, out = _pair(J(extra=extra), HRNet(extra=extra), x, seed=17)
    port = HRNet(extra=extra)
    assert (port.layer1_0.downsample_conv is None) == (name == 'stage1_64')
    assert ('t2_0' in dict(port.named_children())) == (name == 'narrow')
    assert len(out) == len(ref) == len(extra)
    for o, r in zip(out, ref):
        _hold(nhwc(o), r)


def test_hrnet_fcn_head_matches_jax():
    """HRNet's head: ``resize_concat`` of the four branches (each upsampled
    to the first's odd size), a 1x1 conv to ``channels``, no dropout."""
    from lednet_tpu_torch.models.decode_heads.fcn_head import FCNHead
    cfg = dict(Config.fromfile(HRNET['hr18']).model.decode_head,
               in_channels=[4, 8, 12, 16], channels=40, num_classes=5)
    jhead = JMODELS.build(dict(cfg))
    feats = [_normal((2,) + hw + (c,), seed=18 + i) for i, (hw, c) in
             enumerate(zip([(25, 39), (13, 20), (7, 10), (4, 5)], (4, 8, 12, 16)))]
    jfeats = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jhead, jfeats, seed=22)
    head = load_port(FCNHead(**{k: v for k, v in cfg.items() if k != 'type'}),
                     params, stats)
    assert head.conv0.conv.kernel_size == (1, 1)
    assert isinstance(head.cls.dropout, torch.nn.Identity)
    with torch.no_grad():
        out = head([nchw(f) for f in feats])
    _hold(nhwc(out), _apply(jhead, params, stats, jfeats))


# ------------------------------------------------------------------ sampler
def _sampler_case(branch, case):
    """(logits NHWC, labels, min_kept, the tied pixels' flat indices or
    None) of a sampler case on 2 x 9 x 11 x 4: logits on a coarse grid
    (distinct losses differ by far more than the two softmaxes' rounding),
    labels with ignored pixels:

    - 'ignored': 15% of the labels at 255;
    - 'ties': a group of 30 pixels with one logit vector and label whose
      value (the top-k branch: the largest loss; the threshold branch: a
      probability above ``thresh``, most pixels easier still) sits at the
      cut, so that which of them are kept is decided by the tie rule;
    - 'few_valid': 90% ignored, fewer valid pixels than ``min_kept * B``.
    """
    rng = np.random.default_rng(30 + ['ignored', 'ties', 'few_valid'].index(case))
    shape = (2, 9, 11)
    logits = rng.integers(-3, 4, shape + (4,)).astype(np.float32) * 0.5
    labels = rng.integers(0, 4, shape)
    ignored = {'ignored': 0.15, 'ties': 0.05, 'few_valid': 0.9}[case]
    labels = np.where(rng.random(shape) < ignored, 255, labels)
    min_kept, group = 20, None
    if case == 'ties':
        flat_l = logits.reshape(-1, 4)
        flat_y = labels.reshape(-1)
        group = rng.choice(np.flatnonzero(flat_y != 255), 30, replace=False)
        if branch == 'topk':
            flat_l[group] = (5.0, 0.0, 0.0, 0.0)
            flat_y[group] = 3
            min_kept = 8                      # 16 of the 30 at the top
        else:
            # most pixels easy (p_gt about 0.97), 10 hard ones, the group
            # at p_gt = e^2.5 / (e^2.5 + 3), about 0.80, in between
            easy = flat_y != 255
            flat_l[easy] = 0.0
            flat_l[easy, np.where(easy, flat_y, 0)[easy]] = 4.5
            hard = np.setdiff1d(np.flatnonzero(easy), group)[:10]
            flat_l[hard] = 0.0
            flat_l[hard, (flat_y[hard] + 1) % 4] = 3.0
            flat_l[group] = 0.0
            flat_l[group, flat_y[group]] = 2.5
            min_kept = 10                     # k = 20: the group's 10th
    return logits, labels.astype(np.int32), min_kept, group


SAMPLER_CASES = [(b, c) for b in ('thresh', 'topk')
                 for c in ('ignored', 'ties', 'few_valid')]


@pytest.mark.parametrize('branch,case', SAMPLER_CASES,
                         ids=[f'{b}-{c}' for b, c in SAMPLER_CASES])
def test_ohem_pixel_sampler_matches_jax(branch, case):
    from lednet_tpu.structures.sampler import OHEMPixelSampler as J
    from lednet_tpu_torch.structures import OHEMPixelSampler
    logits, labels, min_kept, group = _sampler_case(branch, case)
    thresh = 0.7 if branch == 'thresh' else None
    ref = np.asarray(J(thresh=thresh, min_kept=min_kept).sample(
        jnp.asarray(logits), jnp.asarray(labels)))
    sampler = OHEMPixelSampler(thresh=thresh, min_kept=min_kept)
    got = sampler.sample(nchw(logits), torch.from_numpy(labels).long())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    valid = labels != 255
    assert not got.numpy()[~valid].any()
    n_kept, n_valid = int(got.sum()), int(valid.sum())
    if case == 'few_valid':
        assert n_valid < 2 * min_kept
        if branch == 'topk':
            assert n_kept == n_valid
    else:
        assert 0 < n_kept < n_valid
    if case == 'ties':
        in_group = got.numpy().reshape(-1)[np.sort(group)]
        if branch == 'topk':
            # the cut falls inside the group: its first 16 pixels are kept
            np.testing.assert_array_equal(in_group, [1] * 16 + [0] * 14)
        else:
            # the threshold is the group's own probability: none of it is
            # kept, the 10 harder pixels are
            assert not in_group.any() and n_kept == 10


@pytest.mark.parametrize('thresh', [0.7, None], ids=['thresh', 'topk'])
def test_fcn_head_loss_with_sampler_matches_jax(thresh):
    """The ``-ohem-`` config's first auxiliary head (narrowed) with the
    sampler: CE of the kept pixels over all pixels, ``acc_seg``."""
    from lednet_tpu_torch.models.decode_heads.fcn_head import FCNHead
    cfg = dict(Config.fromfile(BISENETV2_OHEM).model.auxiliary_head[0],
               num_classes=4, in_index=0)
    cfg['sampler'] = dict(cfg['sampler'], thresh=thresh, min_kept=500)
    jhead = JMODELS.build(dict(cfg))
    feats = _normal((2, 9, 12, 16), seed=35)
    params, stats = random_variables(jhead, [jnp.asarray(feats)], seed=36)
    params['cls']['conv_seg']['kernel'] *= 8.0     # confident enough to drop some
    head = load_port(FCNHead(**{k: v for k, v in cfg.items() if k != 'type'}),
                     params, stats)
    logits = _apply(jhead, params, stats, [jnp.asarray(feats)])
    lbl = np.random.default_rng(37).integers(0, 4, (2, 36, 48))
    lbl = np.where(np.random.default_rng(38).random(lbl.shape) < 0.1, 255,
                   lbl).astype(np.int32)
    want = jhead.loss_by_feat(logits, jnp.asarray(lbl))
    with torch.no_grad():
        tlogits = nchw(np.asarray(logits))
        got = head.loss_by_feat(tlogits, torch.from_numpy(lbl).long())
        kept = head.sampler.sample(
            torch.nn.functional.interpolate(tlogits, (36, 48), mode='bilinear'),
            torch.from_numpy(lbl).long())
    assert 0.1 < kept.mean() < (lbl != 255).mean() - 0.05
    assert set(got) == set(want) == {'loss_ce', 'acc_seg'}
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


def test_sampler_weight_goes_to_losses_that_take_it():
    """A loss that takes no ``weight`` is called without it; a ``TypeError``
    raised inside a loss that takes one propagates (the JAX package would
    call it again without the weight)."""
    from lednet_tpu_torch.models.decode_heads.base import default_loss_by_feat
    from lednet_tpu_torch.structures import OHEMPixelSampler
    logits = torch.randn(1, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    label = torch.zeros(1, 4, 5, dtype=torch.long)
    seen = {}

    class NoWeight:
        loss_name = 'loss_a'

        def __call__(self, logits, labels, ignore_index=255):
            seen['a'] = True
            return logits.sum()

    class Broken:
        loss_name = 'loss_b'

        def __call__(self, logits, labels, weight=None, ignore_index=255):
            seen['b'] = weight
            raise TypeError('a fault inside the loss')

    sampler = OHEMPixelSampler(thresh=0.7, min_kept=2)
    out = default_loss_by_feat(logits, label, [NoWeight()], False, 255, sampler)
    assert seen == {'a': True} and set(out) == {'loss_a', 'acc_seg'}
    with pytest.raises(TypeError, match='inside the loss'):
        default_loss_by_feat(logits, label, [Broken()], False, 255, sampler)
    assert seen['b'].shape == (1, 4, 5)
