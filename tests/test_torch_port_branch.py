"""PyTorch port: the Apple Branch config end to end on the CPU, against
``lednet_tpu`` on the same weights.

The config is ``configs/LED_Net/lednet_80k_branch-512x1024.py`` at the
widths of ``configs/LED_Net/_verify_tiny.py`` (LEDNet channels 16, ppm 32,
head 64 -> 16; 2 classes), on fabricated trees (``make_branch_tree``) of
JPEG frames: 56x88 for the comparisons with JAX (every view pads to
128x128 or 128x256, two JAX compiles), and 80x120 plus one 120x90 portrait
frame stored on its side with EXIF orientation 6 for the CLIs.  Its dataset reads ``.png`` images by default (the
fork's ``PascalVOCDataset``); the tree's photos are ``.jpg``, so every run
sets ``img_suffix='.jpg'`` beside ``data_root``.

- ``Runner.test`` without and with test-time augmentation (``--tta``: the
  config's 6 scales x 2 flips) gives aAcc and mIoU within 0.05 points of
  the JAX ``Runner.test`` (the bound of ``tests/test_torch_port_runner.py``);
  the test ``Resize`` is cut from scale (2048, 512) to (128, 64) so that
  the JAX side compiles few shapes.  Both run the preprocessor's
  ``out_dtype`` as float32, as ``tests/test_torch_port_model.py`` does: with
  bfloat16 the JAX package's CPU stem casts its folded weights and
  activations to bfloat16 (``lednet.py:115-116,143``), which moves its
  logits by up to 4% here and the comparison would measure that rounding
  (measured: on float32 input the two models agree to 5e-7).
- One train step of the config's OHEM x2 + SGD + poly, on a batch of two
  96x96 crops that the preprocessor pads to its ``size`` (cut from
  (512, 1024) to (128, 256): as there, more than half of each label map is
  the 255 pad) with ``min_kept`` cut in proportion (131072 x 65536 /
  1048576 = 8192, below the 18432 valid pixels, so OHEM keeps a k-th order
  statistic of the valid ones): loss within 1e-5, weights and BN stats
  within the bounds of ``tests/test_torch_port_train.py``.
- The train and test CLIs (``--tta`` included) in a subprocess with cv2,
  PIL and JAX blocked: 2 steps at the config's batch of 2, 96x96 crops
  padded to (128, 256) as above; the test CLI gives the step-2 val, and
  finite metrics with ``--tta``.

torch's multi-threaded CPU autograd aborts after XLA has run in the process,
so every test here runs torch on one thread.
"""
import json
import os
import os.path as osp
import subprocess
import sys

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
from lednet_tpu_torch.apis import init_model
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import flax_to_state_dict
from lednet_tpu_torch.datasets.synthetic import branch_frame, make_branch_tree
from lednet_tpu_torch.engine import build_optimizer, create_train_state, make_train_step
from lednet_tpu_torch.engine.runner import Runner
from test_torch_port_common import REPO, jax_variables, random_variables
from test_torch_port_common import conv_depthwise, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

BRANCH = osp.join(REPO, 'configs/LED_Net/lednet_80k_branch-512x1024.py')
METRIC_TOL = 0.05         # percentage points, port test against JAX test
TINY = {'model.backbone.channels': 16, 'model.backbone.ppm_channels': 32,
        'model.decode_head.in_channels': 64, 'model.decode_head.channels': 16,
        'val_batch_size': 1, 'vis_backends': None,
        'train_dataloader.num_workers': 2, 'val_dataloader.num_workers': 2}
LOADERS = ('train_dataloader', 'val_dataloader', 'test_dataloader')


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return make_branch_tree(str(tmp_path_factory.mktemp('branch')), n_train=2,
                            n_val=3, size_hw=(80, 120), portrait_hw=(120, 90),
                            seed=5)


@pytest.fixture(scope='module')
def small_tree(tmp_path_factory):
    return make_branch_tree(str(tmp_path_factory.mktemp('small')), n_train=1,
                            n_val=3, size_hw=(56, 88), seed=5)


def branch_cfg(root, config_cls=Config, tta=False, **overrides):
    cfg = config_cls.fromfile(BRANCH)
    opts = dict(TINY, **overrides)
    for key in LOADERS:
        opts[f'{key}.dataset.data_root'] = root
        opts[f'{key}.dataset.img_suffix'] = '.jpg'
    cfg.merge_from_dict(opts)
    for key in ('val_dataloader', 'test_dataloader'):
        cfg[key].dataset.pipeline[1]['scale'] = (128, 64)     # Resize
    if tta:
        cfg['test_dataloader']['dataset']['pipeline'] = cfg['tta_pipeline']
    return cfg


@pytest.mark.parametrize('tta', [False, True])
def test_runner_test_matches_jax(small_tree, tmp_path, tta, conv_depthwise):
    import lednet_tpu
    from lednet_tpu.engine.runner import Runner as JRunner
    lednet_tpu.register_all_modules()
    f32 = {'model.data_preprocessor.out_dtype': 'float32'}
    jrunner = JRunner(branch_cfg(small_tree, JConfig, tta, **f32),
                      work_dir=str(tmp_path / 'jax'))
    params, stats = random_variables(jrunner.model, jnp.zeros((1, 64, 64, 3)),
                                     seed=2, train=False)
    variables = jax_variables(params, stats)
    # the eval step reads only the weights: no optimizer state to compile
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.test()

    runner = Runner(branch_cfg(small_tree, tta=tta, **f32),
                    work_dir=str(tmp_path / 'port'), device='cpu')
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    runner.init_state()
    got = runner.test()
    assert 10.0 < want['aAcc'] < 90.0 and want['mIoU'] > 5.0   # not degenerate
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


def test_padded_branch_train_step_matches_jax(one_thread, conv_depthwise):
    import lednet_tpu
    lednet_tpu.register_all_modules()
    jcfg = JConfig.fromfile(BRANCH)
    cfg = Config.fromfile(BRANCH)
    for c in (jcfg, cfg):
        c.merge_from_dict(dict(TINY, **{'model.data_preprocessor.size': (128, 256)}))
        c.model.decode_head.loss_decode = [dict(h, min_kept=8192) for h in
                                           c.model.decode_head.loss_decode]
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    tx, _ = joptim.build_optimizer(jcfg.optim_wrapper, jcfg.param_scheduler)
    rng = np.random.default_rng(8)
    frames = [branch_frame(rng, (96, 96)) for _ in range(2)]
    imgs = np.stack([f[0] for f in frames])
    lbl = np.stack([f[1] for f in frames]).astype(np.int32)
    assert 0.01 < lbl.mean() < 0.5           # both classes, branch the sparse one
    params, stats = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)),
                                     seed=6, train=False)
    jvars = jax_variables(params, stats)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=jvars['params'],
                        batch_stats=jvars['batch_stats'],
                        opt_state=tx.init(jvars['params']))

    model = init_model(cfg, device='cpu')
    model.load_state_dict(flax_to_state_dict(params, stats))
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    assert [l.min_kept for l in model.decode_head.losses] == [8192, 8192]
    step = make_train_step(model, opt, model.data_preprocessor)
    _, padded, _ = model.data_preprocessor(torch.from_numpy(imgs),
                                           torch.from_numpy(lbl.astype(np.int64)),
                                           training=True)
    assert padded.shape == (2, 128, 256) and (padded == 255).float().mean() > 0.5
    tstate, logs = step(create_train_state(model, opt, sched), torch.from_numpy(imgs),
                        torch.from_numpy(lbl.astype(np.int64)))
    state, jlogs = jmake_train_step(jmodel, tx, jpre)(state, jnp.asarray(imgs),
                                                      jnp.asarray(lbl))
    assert abs(logs['loss'].item() - float(jlogs['loss'])) <= 1e-5
    for k in ('decode.loss_context', 'decode.loss_spatial', 'decode.acc_seg'):
        assert logs[k].item() == pytest.approx(float(jlogs[k]), rel=1e-4, abs=1e-5), k
    want = flax_to_state_dict(jax.device_get(state.params),
                              jax.device_get(state.batch_stats))
    got = model.state_dict()
    for k, ref in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        stat = k.endswith('running_mean') or k.endswith('running_var')
        np.testing.assert_allclose(
            got[k].numpy(), ref.numpy(), err_msg=k,
            **(dict(atol=1e-5, rtol=1e-4) if stat else dict(atol=1e-4, rtol=5e-3)))


def test_branch_clis_run_without_cv2_pil_or_jax(tree, tmp_path):
    work = str(tmp_path / 'cli')
    cfg_path = str(tmp_path / 'branch_tiny.py')
    cfg = branch_cfg(tree, **{'model.data_preprocessor.size': (128, 256)})
    cfg.train_dataloader.dataset.pipeline[2]['crop_size'] = (96, 96)   # Fused...
    cfg.dump(cfg_path)
    code = f'''
import runpy, sys
for name in ('cv2', 'PIL', 'jax', 'flax', 'lednet_tpu'):
    sys.modules[name] = None
sys.argv = ['torch_port_train.py', {cfg_path!r}, '--work-dir', {work!r},
            '--device', 'cpu', '--cfg-options', 'train_cfg.max_iters=2',
            'train_cfg.val_interval=2', 'default_hooks.checkpoint.interval=2',
            'default_hooks.logger.interval=1']
runpy.run_path('tools/torch_port_train.py', run_name='__main__')
for extra in ([], ['--tta']):
    sys.argv = ['torch_port_test.py', {cfg_path!r}, {work + '/iter_2.pth'!r},
                '--work-dir', {work!r}, '--device', 'cpu'] + extra
    runpy.run_path('tools/torch_port_test.py', run_name='__main__')
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    losses = [float(l.split(' loss: ')[1].split()[0]) for l in lines if ' loss: ' in l]
    assert len(losses) == 2 and np.isfinite(losses).all()
    val = [l for l in lines if l.startswith('val @ 2: ')]
    results = [json.loads(l) for l in lines if l.startswith('{"aAcc"')]
    assert len(val) == 1 and len(results) == 2
    assert str(results[0]) == val[0][len('val @ 2: '):]       # test == val at 2
    assert all(np.isfinite(v) for v in results[1].values())   # --tta
    with open(osp.join(work, 'test_results.json')) as f:
        assert json.load(f) == results[1]
