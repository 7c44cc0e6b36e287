"""PyTorch port: SAN ViT-B16 (``MultimodalEncoderDecoder``,
``VisionTransformer``, ``CLIPTextEncoder`` with its BPE tokenizer,
``SideAdapterCLIPHead``) against ``lednet_tpu`` on the CPU, and the
segmentors' ``pretrained`` / ``init_cfg``.

Each test feeds the same numpy inputs (``numpy.random.default_rng(seed)``)
through the JAX function or module and its port after
``lednet_tpu_torch.convert`` has carried the same random flax weights
across (every norm scale drawn near 1, ``_norm_scales``), and holds them
together:

- the tokenizer: the ids of all 361 ``'vild'`` x Cityscapes prompts equal,
  and the port reading its own copy of the merges table;
- the text encoder (``'simple'`` and ``'vild'`` over 3 classes) and the
  ViT (``out_origin`` with ``final_norm``; a resized ``pos_embed`` with
  ``pre_norm``; an input that takes the corner pad), rel 1e-5;
- ``resize_jax_bicubic`` up and anti-aliased down within 1e-6 of
  ``jax.image.resize``, ``resize_jax_nearest`` bit for bit on labels with
  255;
- ``SideAdapterNetwork``, ``RecWithAttnbias`` (biases max-pooled from
  twice CLIP's grid) and ``MLPMaskDecoder``, rel 1e-5;
- ``SideAdapterCLIPHead.loss_by_feat`` on the same outputs and labels,
  point-sampled (the JAX points fed to the port) and dense: every loss
  term within 1e-5, the Hungarian assignments equal;
- a narrow copy of the config (``out_origin=True``): ``predict`` within
  1e-4 x max|score| with argmax agreement >= 99.9%, the CPU eval step
  equal to it; one AdamW step with the gradient clip engaged against the
  JAX step (loss, logs, the updates by the AdamW rule of
  ``test_torch_port_segformer_swin.py``);
- the config at full width: every flax leaf of its three subtrees maps
  (``jax.eval_shape``, nothing compiled); unchanged, it raises in both
  packages (four CLIP features fused, three given), and so does an input
  whose side-adapter grid is no whole multiple of CLIP's;
- the six ``_base_/models`` files that set ``pretrained`` or ``init_cfg``
  on the segmentor build in both packages, the port's ``state_dict``
  equal in keys and shapes to the converted JAX tree.

torch runs on one thread in every test here (``one_thread``).  A JAX
segmentor's ``predict`` and train step are jitted (one compile); the
bricks run op by op.
"""
import gzip
import os

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
from test_torch_port_common import (REPO, jax_variables, random_variables,
                                    rel_err)
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_knet_mask2former import (_jit_apply, _norm_scales,
                                              jax_hungarian)  # noqa: F401
from test_torch_port_sct_rtformer_psp import _full_width_leaves

pytestmark = pytest.mark.usefixtures('one_thread')

CONFIG = f'{REPO}/configs/san/san-vit-b16_cityscapes-512x512.py'
OUT_ORIGIN = {'model.image_encoder.out_origin': True}
TOL_BRICK = 1e-5           # modules, rel to the largest output
TOL_MODEL = 1e-4           # the segmentor's scores, rel to the largest
TOL_LOSS = 1e-5


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    import lednet_tpu.structures  # noqa: F401  (registers the JAX samplers)
    lednet_tpu.register_all_modules()


# a narrow copy of the config: every structural choice kept (the corner
# pad, the resized position embeddings, four fusions, a deep-supervision
# tap, the max-pool of the biases), widths cut
NARROW = dict(OUT_ORIGIN, **{
    'model.image_encoder.embed_dims': 48, 'model.image_encoder.num_layers': 3,
    'model.image_encoder.num_heads': 4, 'model.image_encoder.out_indices': (0, 1, 2),
    'model.text_encoder.embed_dims': 32, 'model.text_encoder.num_layers': 2,
    'model.text_encoder.num_heads': 4, 'model.text_encoder.output_dims': 24,
    'model.decode_head.clip_channels': 48, 'model.decode_head.embed_dims': 32,
    'model.decode_head.num_queries': 12, 'model.decode_head.num_encode_layer': 4,
    'model.decode_head.num_san_heads': 4, 'model.decode_head.rec_num_heads': 4,
    'model.decode_head.out_dims': 24, 'model.decode_head.deep_supervision_idxs': (3,),
})


def _configs(extra, path=CONFIG):
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(path)
        cfg.merge_from_dict(dict(extra))
        out.append(cfg)
    return out


def _record_points(monkeypatch):
    """Record the mask logits and the points of every sampled mask loss of
    the JAX package, inside its jitted step too (a debug callback), as
    (logits, points) pairs: the two taps' calls may run in either order."""
    import lednet_tpu.ops.point_loss as jpoint
    drawn = []
    uncertain = jpoint.uncertain_point_coords

    def recorded(rng, mask_logit, *args, **kwargs):
        out = uncertain(rng, mask_logit, *args, **kwargs)
        jax.debug.callback(lambda m, c: drawn.append((np.array(m), np.array(c))),
                           mask_logit, out)
        return out
    monkeypatch.setattr(jpoint, 'uncertain_point_coords', recorded)
    return drawn


def _feed_points(head, drawn):
    """The port head's loss points: the JAX points recorded for the mask
    logits nearest the port's own."""
    def points(mask_logit):
        m = mask_logit.detach().double().numpy()
        errs = [np.abs(m - rec).max() if rec.shape == m.shape else np.inf
                for rec, _ in drawn]
        i = int(np.argmin(errs))
        assert errs[i] <= 1e-3 * np.abs(m).max(), errs
        return torch.from_numpy(drawn[i][1]).to(mask_logit.dtype)
    head.train_points = points


def _record_assignments(monkeypatch, head):
    """The Hungarian assignments of the JAX package and of the port
    ``head``, each in call order."""
    import lednet_tpu.models.decode_heads.maskformer_head as jmf
    jax_assign, port_assign = [], []
    hungarian = jmf._hungarian

    def jax_rec(cost):
        out = hungarian(cost)
        jax_assign.append(out)
        return out
    monkeypatch.setattr(jmf, '_hungarian', jax_rec)
    assign = head.assign

    def port_rec(cost):
        out = assign(cost)
        port_assign.append(out.numpy())
        return out
    head.assign = port_rec
    return jax_assign, port_assign


# The heaviest tests come first, and no two of them side by side where
# that can be helped: pytest-xdist hands the tests out in file order, two
# at a time to each worker to start with.
# ------------------------------------------------------------------ training
TRAIN = dict(NARROW, **{'model.decode_head.num_classes': 3,
                        'model.text_encoder.vocabulary': ['road', 'car', 'sky'],
                        'model.text_encoder.templates': 'simple',
                        'model.data_preprocessor.size': (128, 128)})


def test_train_step_matches_jax(monkeypatch, jax_hungarian):
    """One AdamW step of the narrow config (3 classes, ``'simple'``
    templates) in both packages from the same weights on a 2 x 128x128
    batch: the CE, mask BCE and Dice of both taps (their 12,544 points a
    mask recorded in the JAX step and fed to the port), the Hungarian
    assignments equal.  The config clips the gradient norm at 0.01, and
    the clip is engaged.  Each loss term within 1e-4 relative or 1e-5,
    the total within 1e-5 of its size, the updates by the AdamW rule of
    ``test_torch_port_segformer_swin.py``."""
    jcfg, cfg = _configs(TRAIN)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    rng = np.random.default_rng(310)
    imgs = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    lbl = rng.integers(0, 3, (2, 8, 8)).repeat(16, 1).repeat(16, 2)
    lbl = np.where(rng.random((2, 128, 128)) < 0.05, 255, lbl).astype(np.int32)
    params, stats = random_variables(jmodel, jnp.zeros((1, 128, 128, 3)), seed=311)
    params = _norm_scales(params, 311)
    # a copy: the JAX step donates its state
    before = {k: v.clone() for k, v in flax_to_state_dict(params, stats).items()}

    drawn = _record_points(monkeypatch)
    model = init_model(cfg, device='cpu')
    jax_assign, port_assign = _record_assignments(monkeypatch, model.decode_head)
    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    jvars = jax_variables(params, stats)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                         batch_stats=jvars['batch_stats'],
                         opt_state=tx.init(jvars['params']))
    jstate, jlogs = jmake_train_step(jmodel, tx, jpre)(
        jstate, jnp.asarray(imgs), jnp.asarray(lbl))
    jax.effects_barrier()

    model.load_state_dict(before)
    assert len(drawn) == 2 and drawn[0][1].shape == (2 * 3, 12544, 2)
    _feed_points(model.decode_head, drawn)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    step = make_train_step(model, opt, model.data_preprocessor)
    tstate, logs = step(create_train_state(model, opt, sched),
                        torch.from_numpy(imgs),
                        torch.from_numpy(lbl.astype(np.int64)))
    assert tstate.step == 1 and model.training

    assert len(jax_assign) == len(port_assign) == 2
    for got in port_assign:       # the taps' order may differ
        assert any(np.array_equal(got, want) for want in jax_assign)
    keys = {k for k in jlogs if k not in ('loss', 'grad_norm')}
    assert set(logs) - {'loss', 'grad_norm'} == keys == {
        f'decode.{p}{k}' for p in ('', 'd0.')
        for k in ('loss_cls', 'loss_mask', 'loss_dice')}
    # the seeded model's loss is about 40 (its mask BCE 20), where
    # float32's spacing is 3.8e-6: the total is held within 1e-5 of its size
    jloss = float(jlogs['loss'])
    assert abs(logs['loss'].item() - jloss) <= TOL_LOSS * max(1.0, abs(jloss))
    for k in keys:
        assert logs[k].item() == pytest.approx(float(jlogs[k]), rel=1e-4,
                                               abs=TOL_LOSS), k
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
        # AdamW's first step moves each weight by about +-lr whatever |g|:
        # the updates are held within 1e-6 where |g| is above 1e-3 of the
        # largest, within 2 lr (a flipped sign) elsewhere
        upd, jupd = got[k] - before[k], ref - before[k]
        clear = grads[k] > 1e-3 * scale
        if clear.any():
            assert (upd - jupd)[clear].abs().max().item() <= 1e-6, k
        assert (upd - jupd).abs().max().item() <= 2.02 * lr, k
        moved = max(moved, upd.abs().max().item())
    assert moved > 0.5 * lr


# ------------------------------------------------------------------ segmentor
def test_segmentor_predict_matches_jax():
    """The narrow copy of the config (19 classes, ``'vild'`` templates: 361
    prompts): ``predict`` of two seeded 128x128 images (the ViT on 64x64, a
    4x4 CLIP grid under the side adapter's 8x8), the CPU eval step equal
    to it."""
    jcfg, cfg = _configs(NARROW)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    shape = (128, 128)
    params, stats = random_variables(jmodel, jnp.zeros((1,) + shape + (3,)),
                                     seed=320)
    params = _norm_scales(params, 320)
    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    imgs = np.random.default_rng(321).integers(0, 256, (2,) + shape + (3,),
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


# ------------------------------------------------------------------ bricks
def _outs(rng, B, Q, n_cls, hw):
    """Seeded head outputs: ([mask logits], [class logits]) of two taps."""
    masks = [rng.standard_normal((B, Q) + hw).astype(np.float32) * 3
             for _ in range(2)]
    logits = [rng.standard_normal((B, Q, n_cls + 1)).astype(np.float32)
              for _ in range(2)]
    return masks, logits


@pytest.mark.parametrize('num_points', [12544, 0])
def test_loss_terms_match_jax(num_points, monkeypatch, jax_hungarian):
    """``loss_by_feat`` of the same two taps' outputs (2 images, 12
    queries, 5 classes, 16x20 masks) against 64x80 labels with 255 and an
    absent class: with the sampled points (the JAX ones fed to the port)
    and dense; every term within 1e-5, the assignments equal."""
    from lednet_tpu.models.decode_heads.san_head import \
        SideAdapterCLIPHead as JHead
    from lednet_tpu_torch.models.decode_heads.san_head import SideAdapterCLIPHead
    kw = dict(num_classes=5, clip_channels=16, embed_dims=16, num_queries=12,
              num_encode_layer=2, num_san_heads=2, rec_num_heads=2,
              out_dims=8, train_cfg=dict(num_points=num_points))
    jhead = JHead(**kw)
    head = SideAdapterCLIPHead(**kw)
    rng = np.random.default_rng(330)
    masks, logits = _outs(rng, 2, 12, 5, (16, 20))
    lbl = rng.integers(0, 4, (2, 8, 10)).repeat(8, 1).repeat(8, 2)
    lbl = np.where(rng.random((2, 64, 80)) < 0.1, 255, lbl).astype(np.int32)
    drawn = _record_points(monkeypatch)
    jax_assign, port_assign = _record_assignments(monkeypatch, head)
    ref = jax.jit(lambda m, c, l: jhead.apply(
        {}, (m, c), l, method='loss_by_feat',
        rngs={'dropout': jax.random.PRNGKey(3)}))(
            [jnp.asarray(m) for m in masks], [jnp.asarray(c) for c in logits],
            jnp.asarray(lbl))
    jax.effects_barrier()
    if num_points:
        assert len(drawn) == 2
        _feed_points(head, drawn)
    else:
        assert not drawn
    got = head.loss_by_feat(([torch.from_numpy(m) for m in masks],
                             [torch.from_numpy(c) for c in logits]),
                            torch.from_numpy(lbl.astype(np.int64)))
    assert set(got) == set(ref) == {f'{p}{k}' for p in ('', 'd0.')
                                    for k in ('loss_cls', 'loss_mask', 'loss_dice')}
    for k, v in got.items():
        assert abs(v.item() - float(ref[k])) <= TOL_LOSS, (k, v, ref[k])
        assert v.item() > 0
    assert len(jax_assign) == len(port_assign) == 2
    for got_a in port_assign:
        assert any(np.array_equal(got_a, want) for want in jax_assign)


def _brick(jmod, port, params, *args, port_args=None):
    """Apply ``jmod`` (op by op) and the port on the same weights."""
    port.load_state_dict(flax_to_state_dict(params, {}))
    port.eval()
    ref = jmod.apply({'params': params}, *args)
    with torch.no_grad():
        out = port(*(port_args if port_args is not None else args))
    return out, ref


def _hold(out, ref, tol=TOL_BRICK):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= tol, rel_err(out, ref)


def _clip_features(rng, B, C, grid, n=4):
    """n seeded CLIP features: (NHWC grid, cls) for JAX, (NCHW, cls) for
    the port."""
    feats = [(rng.standard_normal((B,) + grid + (C,)).astype(np.float32),
              rng.standard_normal((B, C)).astype(np.float32)) for _ in range(n)]
    jfeats = [(jnp.asarray(f), jnp.asarray(c)) for f, c in feats]
    pfeats = [(torch.from_numpy(f).permute(0, 3, 1, 2), torch.from_numpy(c))
              for f, c in feats]
    return jfeats, pfeats


def test_side_adapter_network_matches_jax():
    """``SideAdapterNetwork`` on a 2 x 96x128 image (a 6x8 side grid, so
    the 40x40 position embedding is resized down, anti-aliased) with four
    CLIP features on a 3x4 grid: every tap's masks and biases."""
    from lednet_tpu.models.decode_heads.san_head import \
        SideAdapterNetwork as JSAN
    from lednet_tpu_torch.models.decode_heads.san_head import SideAdapterNetwork
    kw = dict(clip_channels=16, embed_dims=16, num_queries=6,
              num_encode_layer=3, num_heads=2, fusion_index=(0, 1, 2, 3),
              decoder_heads=2, decoder_layers=3, decoder_channels=8)
    rng = np.random.default_rng(340)
    image = rng.standard_normal((2, 96, 128, 3)).astype(np.float32)
    jfeats, pfeats = _clip_features(rng, 2, 16, (3, 4))
    jmod = JSAN(**kw)
    params, _ = random_variables(jmod, jnp.asarray(image), jfeats, (2,))
    params = _norm_scales(params, 341)
    port = SideAdapterNetwork(**kw)
    (masks, biases), (jmasks, jbiases) = _brick(
        jmod, port, params, jnp.asarray(image), jfeats, (2,),
        port_args=(torch.from_numpy(image).permute(0, 3, 1, 2), pfeats, (2,)))
    assert len(masks) == len(jmasks) == 2
    for m, jm in zip(masks, jmasks):
        _hold(m, jm)
    for b, jb in zip(biases, jbiases):
        assert len(b) == len(jb) == 3
        for x, jx in zip(b, jb):
            _hold(x, jx)


def test_rec_with_attnbias_matches_jax():
    """``RecWithAttnbias`` with biases on twice CLIP's grid (max-pooled by
    2) and on CLIP's grid itself, one per layer and one for all."""
    from lednet_tpu.models.decode_heads.san_head import \
        RecWithAttnbias as JRec
    from lednet_tpu_torch.models.decode_heads.san_head import RecWithAttnbias
    kw = dict(sos_token_num=5, num_layers=2, embed_dims=16, num_heads=2,
              out_dims=8)
    rng = np.random.default_rng(350)
    _, pfeats = _clip_features(rng, 2, 16, (3, 4), n=1)
    feat = (jnp.asarray(pfeats[0][0].permute(0, 2, 3, 1).numpy()),
            jnp.asarray(pfeats[0][1].numpy()))
    jmod = JRec(**kw)
    for grid, n in (((6, 8), 2), ((3, 4), 1)):
        biases = [rng.standard_normal((2, 2, 5) + grid).astype(np.float32) * 2
                  for _ in range(n)]
        params, _ = random_variables(jmod, [jnp.asarray(b) for b in biases], feat)
        params = _norm_scales(params, 351)
        port = RecWithAttnbias(**kw)
        out, ref = _brick(jmod, port, params, [jnp.asarray(b) for b in biases],
                          feat, port_args=([torch.from_numpy(b) for b in biases],
                                           pfeats[0]))
        _hold(out, ref)


def test_mlp_mask_decoder_matches_jax():
    """``MLPMaskDecoder``: the masks and every layer's per-head biases."""
    from lednet_tpu.models.decode_heads.san_head import \
        MLPMaskDecoder as JDecoder
    from lednet_tpu_torch.models.decode_heads.san_head import MLPMaskDecoder
    rng = np.random.default_rng(360)
    query = rng.standard_normal((2, 5, 12)).astype(np.float32)
    x = rng.standard_normal((2, 3, 4, 12)).astype(np.float32)
    jmod = JDecoder(total_heads=2, total_layers=3, embed_channels=8,
                    mlp_channels=10)
    params, _ = random_variables(jmod, jnp.asarray(query), jnp.asarray(x))
    port = MLPMaskDecoder(12, total_heads=2, total_layers=3, embed_channels=8,
                          mlp_channels=10)
    (mask, biases), (jmask, jbiases) = _brick(
        jmod, port, params, jnp.asarray(query), jnp.asarray(x),
        port_args=(torch.from_numpy(query), torch.from_numpy(x)))
    _hold(mask, jmask)
    assert len(biases) == len(jbiases) == 3
    for b, jb in zip(biases, jbiases):
        _hold(b, jb)


VIT_CASES = {
    # the config's choices: out_origin with final_norm, the pos_embed grid
    # resized (16x16 -> 4x5)
    'out_origin': (dict(img_size=(64, 64), out_origin=True, final_norm=True,
                        output_cls_token=True, out_indices=(0, 2)), (2, 64, 80)),
    # pre_norm, a grid that takes the corner pad (70x90 -> 80x96), no cls output
    'corner_pad': (dict(img_size=64, pre_norm=True, out_indices=(1, 2),
                        interpolate_mode='bilinear'), (2, 70, 90)),
}


@pytest.mark.parametrize('case', list(VIT_CASES))
def test_vit_matches_jax(case):
    from lednet_tpu.models.backbones.vit import VisionTransformer as JViT
    from lednet_tpu_torch.models.backbones.vit import VisionTransformer
    extra, (B, H, W) = VIT_CASES[case]
    kw = dict(patch_size=16, embed_dims=24, num_layers=3, num_heads=3, **extra)
    x = np.random.default_rng(370).standard_normal((B, H, W, 3)).astype(np.float32)
    jmod = JViT(**kw)
    params, _ = random_variables(jmod, jnp.asarray(x))
    params = _norm_scales(params, 371)
    port = VisionTransformer(**kw)
    outs, refs = _brick(jmod, port, params, jnp.asarray(x),
                        port_args=(torch.from_numpy(x).permute(0, 3, 1, 2),))
    n = len(kw['out_indices']) + kw.get('out_origin', False)
    assert len(outs) == len(refs) == n
    for out, ref in zip(outs, refs):
        if kw.get('output_cls_token'):
            (out, cls), (ref, jcls) = out, ref
            _hold(cls, jcls)
        _hold(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize('templates', ['simple', 'vild'])
def test_text_encoder_matches_jax(templates):
    """The class embeddings of 3 classes (and the background one)."""
    from lednet_tpu.models.text_encoder import CLIPTextEncoder as JText
    from lednet_tpu_torch.models.text_encoder import CLIPTextEncoder
    kw = dict(vocabulary=['road', 'traffic light', 'sky'], templates=templates,
              embed_dims=32, num_layers=2, num_heads=4, output_dims=16)
    jmod = JText(**kw)
    params, _ = random_variables(jmod)
    params = _norm_scales(params, 380)
    port = CLIPTextEncoder(**kw)
    out, ref = _brick(jmod, port, params)
    assert out.shape == (4, 16)
    _hold(out, ref)
    np.testing.assert_allclose(out.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_tokenizer_matches_jax_and_reads_its_own_table(monkeypatch):
    """The ids of every ``'vild'`` template filled with every Cityscapes
    class (361 prompts) equal the JAX package's; the port reads its own
    copy of the merges table, byte for byte the JAX package's, and
    ``CLIP_BPE_PATH`` overrides it."""
    from lednet_tpu.models.text_encoder import tokenizer as jtok
    from lednet_tpu_torch.models.text_encoder import tokenizer as ptok
    from lednet_tpu_torch.models.text_encoder.clip_text_encoder import \
        PREDEFINED_TEMPLATES
    classes = Config.fromfile(CONFIG).cityscapes_classes
    prompts = [t.format(c) for t in PREDEFINED_TEMPLATES['vild'] for c in classes]
    assert len(prompts) == 361
    got, want = ptok.tokenize(prompts), jtok.tokenize(prompts)
    assert got.dtype == want.dtype and got.shape == (361, 77)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ptok.tokenize('a photo of a cat')[0, :7],
                                  [49406, 320, 1125, 539, 320, 2368, 49407])
    own = os.path.join(REPO, 'lednet_tpu_torch', 'models', 'text_encoder', 'data',
                       'bpe_simple_vocab_16e6.txt.gz')
    assert os.path.realpath(ptok._BUNDLED_BPE) == own
    with gzip.open(own, 'rt') as f, gzip.open(jtok._BUNDLED_BPE, 'rt') as g:
        assert f.read() == g.read()
    monkeypatch.setenv('CLIP_BPE_PATH', '/nonexistent/merges.txt.gz')
    with pytest.raises(FileNotFoundError):
        ptok.tokenize('a photo')


def test_resize_jax_helpers_match_jax_image_resize():
    """Bicubic up and anti-aliased down (the side adapter's 40x40 position
    grid to 32 and 8) within 1e-6 of ``jax.image.resize``; nearest on
    labels holding 255 bit for bit."""
    from lednet_tpu_torch.ops.resize import resize_jax_bicubic, resize_jax_nearest
    rng = np.random.default_rng(390)
    for (h, w), size in (((40, 40), (32, 32)), ((40, 40), (8, 8)),
                         ((40, 40), (64, 128)), ((7, 9), (3, 20))):
        x = rng.standard_normal((1, h, w, 6)).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + size + (6,),
                                          'bicubic'))
        got = resize_jax_bicubic(torch.from_numpy(x).permute(0, 3, 1, 2), size)
        assert np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max() <= \
            1e-6 * np.abs(ref).max()
    lbl = rng.integers(0, 19, (2, 37, 53))
    lbl[rng.random(lbl.shape) < 0.1] = 255
    for size in ((16, 16), (9, 40), (100, 7)):
        ref = np.asarray(jax.image.resize(jnp.asarray(lbl.astype(np.float32))[..., None],
                                          (2,) + size + (1,), 'nearest'))[..., 0]
        got = resize_jax_nearest(torch.from_numpy(lbl), size)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


# ------------------------------------------------------------------ configs
def test_config_builds_and_every_leaf_maps():
    """The config with ``out_origin=True``, at full width (159.5 M
    parameters): every flax leaf of ``_image_encoder``, ``_text_encoder``
    and ``_decode_head`` converts to a port key of the same shape, and
    none of the port's is left over."""
    jcfg, _ = _configs(OUT_ORIGIN)
    jmodel = JMODELS.build(dict(jcfg.model))
    port = init_model(CONFIG, device='cpu', cfg_options=OUT_ORIGIN)
    sd = _full_width_leaves(jmodel, (1, 64, 64))
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    assert {k.split('.')[0] for k in sd} == {'image_encoder', 'text_encoder',
                                            'decode_head'}
    assert sum(p.numel() for p in port.parameters()) == 159465392
    port.load_state_dict(sd)


@pytest.mark.parametrize('rate', ['drop_rate', 'attn_drop_rate',
                                  'drop_path_rate'])
def test_vit_refuses_unported_drop_rates(rate):
    """A nonzero dropout or stochastic-depth rate, which no config the
    port builds sets, raises rather than running without it."""
    from lednet_tpu_torch.models.backbones.vit import VisionTransformer
    with pytest.raises(NotImplementedError, match=rate):
        VisionTransformer(embed_dims=24, num_layers=1, num_heads=3, **{rate: 0.1})


def test_unchanged_config_raises_in_both_packages():
    """As shipped, the config's side adapter fuses four CLIP features and
    its ViT gives three: the JAX package raises ``IndexError`` at its first
    forward, the port ``ValueError`` naming both at construction."""
    jmodel = JMODELS.build(dict(JConfig.fromfile(CONFIG).model))
    with pytest.raises(IndexError):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 64, 64, 3))))
    with pytest.raises(ValueError, match=r'fusion_index.*gives 3'):
        init_model(CONFIG, device='cpu')


def _jax_segmentor(jcfg):
    """The JAX segmentor of ``jcfg`` with its heads' sampler configs built
    into samplers first (inside a bound flax module a sampler config is a
    ``FrozenDict``, which the JAX loss cannot build: ROADMAP, Gaps on the
    reference's side); ``auxiliary_head`` a head or a list."""
    model = dict(jcfg.model)

    def built(head):
        head = dict(head)
        if isinstance(head.get('sampler'), dict):
            head['sampler'] = JMODELS.build(dict(head['sampler']))
        return head
    model['decode_head'] = built(model['decode_head'])
    aux = model.get('auxiliary_head')
    if isinstance(aux, dict):
        model['auxiliary_head'] = built(aux)
    elif aux:
        model['auxiliary_head'] = [built(h) for h in aux]
    return JMODELS.build(model)


def test_side_grid_off_the_clip_grid_raises_in_both_packages():
    """A 112x128 input: the side adapter's grid is 7x8, CLIP's (on 56x64,
    padded to 64x64) 4x4, and 7 is no whole multiple of 4: the JAX
    package's reshape raises, and so does the port, naming both grids."""
    jcfg, cfg = _configs(NARROW)
    jmodel = JMODELS.build(dict(jcfg.model))
    x = jnp.zeros((1, 112, 128, 3))
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x))
    model = init_model(cfg, device='cpu')
    with pytest.raises(ValueError, match='grid 7x8 is not a whole multiple '
                                         "of CLIP's 4x4"):
        model.predict(torch.zeros(1, 112, 128, 3))


BASE_MODELS = ('bisenetv2', 'erfnet_fcn', 'segformer_mit-b0', 'stdc',
               'upernet_r50', 'upernet_swin')


@pytest.mark.parametrize('name', BASE_MODELS)
def test_base_model_with_pretrained_builds(name):
    """``configs/_base_/models/<name>.py``, whose segmentor sets
    ``pretrained`` (a path or None): both packages build it, the port on
    random weights; its ``state_dict`` has the keys and shapes that
    ``convert.py`` makes of the JAX tree (``jax.eval_shape`` of ``loss``,
    which creates the auxiliary heads' variables too; STDC's samplers built
    first, :func:`_jax_segmentor`)."""
    path = f'{REPO}/configs/_base_/models/{name}.py'
    jcfg, cfg = _configs({}, path)
    assert 'pretrained' in cfg.model
    jmodel = _jax_segmentor(jcfg)
    port = init_model(cfg, device='cpu')
    sd = _full_width_leaves(jmodel, (1, 64, 64), method='loss')
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
