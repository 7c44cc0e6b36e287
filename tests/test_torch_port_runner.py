"""PyTorch port: the ``Runner``, checkpoints and the train/test CLIs on the
CPU, and the port's val against ``lednet_tpu``'s.

The model is the flagship config cut to a test size (LEDNet channels 8, ppm
32, head 32 -> 16, the config's 19 classes, bf16 eval input as configured),
on a fabricated Cityscapes tree of 128x256 frames, train crops of 128x128
(the 1/64 maps stay 2x2), val images resized by the config's keep-ratio
``Resize`` to scale (256, 128).

- train 3 steps -> ``iter_3.pth`` and ``last_checkpoint`` -> val -> resume
  to 6 (step, lr and momentum come back) -> ``test`` on ``iter_6.pth`` equal
  to the last val exactly;
- SIGTERM during training saves a resumable checkpoint;
- ``init_model`` reads the Runner's ``.pth`` and its ``dataset_meta``, and
  recovers the classes from the config's dataset when a file has none;
- ``inference_model`` on a PNG path and on a 1280x720 array with cv2 and
  PIL blocked;
- the two CLIs in a subprocess with cv2, PIL and JAX blocked;
- the JAX Runner's ``init_state()`` + ``val()`` against the port Runner's
  ``val()`` on the same weights (``convert.py``) and val tree: aAcc and mIoU
  within 0.05 points.

torch's multi-threaded CPU autograd aborts after XLA has run in the process,
so every test here runs torch on one thread.
"""
import json
import os
import os.path as osp
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lednet_tpu.config import Config as JConfig
from lednet_tpu_torch.apis import inference_model, init_model
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import flax_to_state_dict
from lednet_tpu_torch.datasets import imageio
from lednet_tpu_torch.datasets.synthetic import make_cityscapes_tree
from lednet_tpu_torch.engine.checkpoint import find_latest_checkpoint
from lednet_tpu_torch.engine.runner import Runner
from test_torch_port_common import (FLAGSHIP, REPO, jax_variables,
                                    random_variables)
from test_torch_port_common import conv_depthwise, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

METRIC_TOL = 0.05         # percentage points, port val against JAX val
SMALL = {'model.backbone.channels': 8, 'model.backbone.ppm_channels': 32,
         'model.decode_head.in_channels': 32, 'model.decode_head.channels': 16,
         'model.data_preprocessor.size': (128, 128),
         'train_dataloader.batch_size': 2, 'train_dataloader.num_workers': 2,
         'val_dataloader.num_workers': 2, 'test_dataloader.num_workers': 2,
         'train_cfg.max_iters': 3, 'train_cfg.val_interval': 3,
         'default_hooks.checkpoint.interval': 3,
         'default_hooks.logger.interval': 1, 'vis_backends': None}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return make_cityscapes_tree(str(tmp_path_factory.mktemp('cityscapes')),
                                n_train=4, n_val=3, size_hw=(128, 256), seed=1)


def tiny_cfg(root, config_cls=Config, **overrides):
    cfg = config_cls.fromfile(FLAGSHIP)
    cfg.merge_from_dict(dict(SMALL, **{f'{k}.dataset.data_root': root for k in
                                       ('train_dataloader', 'val_dataloader',
                                        'test_dataloader')}, **overrides))
    pipeline = cfg.train_dataloader.dataset.pipeline
    pipeline[2]['scale'] = (256, 128)           # RandomResize
    pipeline[3]['crop_size'] = (128, 128)       # RandomCrop
    for key in ('val_dataloader', 'test_dataloader'):
        cfg[key].dataset.pipeline[1]['scale'] = (256, 128)      # Resize
    return cfg


def _scalars(work_dir):
    with open(osp.join(work_dir, 'vis_data', 'scalars.json')) as f:
        return [json.loads(line) for line in f]


def test_train_val_checkpoint_resume_test(tree, tmp_path, capsys):
    work = str(tmp_path / 'work')
    runner = Runner(tiny_cfg(tree), work_dir=work, device='cpu')
    state = runner.train()
    assert state.step == 3
    assert sorted(os.listdir(work)) == ['iter_3.pth', 'last_checkpoint', 'vis_data']
    assert find_latest_checkpoint(work) == osp.join(work, 'iter_3.pth')
    logs = _scalars(work)
    assert [r['step'] for r in logs] == [1, 2, 3, 3]
    assert all(np.isfinite(r['loss']) for r in logs[:3])
    val3 = {k[4:]: v for k, v in logs[3].items() if k.startswith('val/')}
    assert set(val3) == {'aAcc', 'mIoU', 'mAcc'}
    assert runner.val() == val3
    momentum = [s['momentum_buffer'].clone()
                for s in state.optimizer.optimizer.state.values()]

    resumed = Runner(tiny_cfg(tree, **{'train_cfg.max_iters': 6}),
                     work_dir=work, device='cpu', seed=1)
    resumed.init_state()
    restored = []
    step_fn = resumed.state.optimizer.step

    def first_step(lr):             # the first update after the resume
        if not restored:
            restored.append((resumed.state.step, lr, [
                s['momentum_buffer'].clone()
                for s in resumed.state.optimizer.optimizer.state.values()]))
        return step_fn(lr)
    resumed.state.optimizer.step = first_step
    capsys.readouterr()
    assert resumed.train(resume=True).step == 6
    out = capsys.readouterr().out
    lr3 = state.lr_schedule(3)
    assert f'at step 3 (iter 3), lr {lr3:.6e}' in out
    assert restored[0][:2] == (3, lr3)
    for a, b in zip(restored[0][2], momentum):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    val6 = {k[4:]: v for k, v in _scalars(work)[-1].items() if k.startswith('val/')}
    assert _scalars(work)[-1]['step'] == 6 and set(val6) == set(val3)

    tester = Runner(tiny_cfg(tree), work_dir=str(tmp_path / 'test'), device='cpu',
                    seed=7)
    assert tester.test(osp.join(work, 'iter_6.pth')) == val6
    assert tester.dataset_meta['classes'][0] == 'road'


def test_sigterm_saves_a_resumable_checkpoint(tree, tmp_path):
    work = str(tmp_path / 'preempt')
    runner = Runner(tiny_cfg(tree, **{'train_cfg.max_iters': 50,
                                      'default_hooks.checkpoint.interval': 1000,
                                      'train_cfg.val_interval': 0}),
                    work_dir=work, device='cpu')
    console = runner.logger.console

    def console_then_term(step, *args, **kwargs):
        console(step, *args, **kwargs)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    runner.logger.console = console_then_term
    before = signal.getsignal(signal.SIGTERM)
    state = runner.train()
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 2
    assert find_latest_checkpoint(work) == osp.join(work, 'iter_2.pth')
    payload = torch.load(osp.join(work, 'iter_2.pth'))
    assert payload['step'] == 2 and payload['meta']['preempted']
    assert payload['meta']['iter'] == 2


def test_init_model_reads_runner_checkpoint_and_recovers_meta(tree, tmp_path):
    runner = Runner(tiny_cfg(tree, **{'train_cfg.max_iters': 1}),
                    work_dir=str(tmp_path), device='cpu')
    runner.train()
    path = osp.join(tmp_path, 'iter_1.pth')
    model = init_model(runner.cfg, path, device='cpu')
    for name, want in runner.model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[name], want, rtol=0, atol=0)
    assert list(model.dataset_meta['classes']) == list(runner.dataset_meta['classes'])
    bare = str(tmp_path / 'bare.pth')
    torch.save(runner.model.state_dict(), bare)
    recovered = init_model(runner.cfg, bare, device='cpu').dataset_meta
    assert len(recovered['classes']) == 19 and recovered['palette'][0] == [128, 64, 128]


def test_inference_model_needs_no_cv2_or_pil(tree, tmp_path, monkeypatch):
    """The repaired fault: a PNG path, and a 1280x720 frame that the keep-ratio
    ``Resize(scale=(2048, 1024))`` scales, without cv2 or PIL."""
    cfg = tiny_cfg(tree)
    cfg.test_dataloader.dataset.pipeline[1]['scale'] = (2048, 1024)
    model = init_model(cfg, device='cpu')
    path = str(tmp_path / 'frame.png')
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    imageio.imwrite(path, frame[:200, :300])
    for name in ('cv2', 'PIL', 'PIL.Image'):
        monkeypatch.setitem(sys.modules, name, None)
    from_path = inference_model(model, path)
    assert from_path['pred_sem_seg'].shape == (200, 300)
    assert from_path['metainfo']['img_path'] == path
    res = inference_model(model, frame)
    assert res['pred_sem_seg'].shape == (720, 1280)
    assert res['metainfo']['img_shape'] == (1024, 1820)
    assert np.isfinite(res['seg_logits']).all()


def test_clis_run_without_cv2_pil_or_jax(tree, tmp_path):
    work = str(tmp_path / 'cli')
    cfg_path = str(tmp_path / 'tiny.py')
    tiny_cfg(tree).dump(cfg_path)
    code = f'''
import runpy, sys
for name in ('cv2', 'PIL', 'jax', 'flax', 'lednet_tpu'):
    sys.modules[name] = None
sys.argv = ['torch_port_train.py', {cfg_path!r}, '--work-dir', {work!r},
            '--device', 'cpu', '--cfg-options', 'train_cfg.max_iters=2',
            'train_cfg.val_interval=2', 'default_hooks.checkpoint.interval=2']
runpy.run_path('tools/torch_port_train.py', run_name='__main__')
sys.argv = ['torch_port_test.py', {cfg_path!r}, {work + '/iter_2.pth'!r},
            '--work-dir', {work!r}, '--device', 'cpu', '--out', {work + '/preds'!r}]
runpy.run_path('tools/torch_port_test.py', run_name='__main__')
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    val = [l for l in lines if l.startswith('val @ 2: ')]
    assert len(val) == 1
    with open(osp.join(work, 'test_results.json')) as f:
        assert json.loads(lines[-1]) == json.load(f)
    assert str(json.loads(lines[-1])) == val[0][len('val @ 2: '):]
    assert sorted(os.listdir(osp.join(work, 'preds'))) == \
        [f'pred_{i:06d}.png' for i in range(3)]


def test_unported_options_raise(tree, tmp_path):
    sys.path.insert(0, osp.join(REPO, 'tools'))
    try:
        import torch_port_test
        import torch_port_train
    finally:
        sys.path.pop(0)
    with pytest.raises(NotImplementedError, match='ROADMAP: multi-GPU'):
        torch_port_train.main(['cfg.py', '--launcher', 'pytorch'])
    with pytest.raises(NotImplementedError, match='ROADMAP: multi-GPU'):
        torch_port_test.main(['cfg.py', 'x.pth', '--launcher', 'slurm'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            Runner(tiny_cfg(tree), work_dir=str(tmp_path))
    for key, value, item in (('val_spatial_shard', True, 'ROADMAP: multi-GPU'),
                             ('default_hooks.visualization.draw', True,
                              'ROADMAP: visualization')):
        runner = Runner(tiny_cfg(tree, **{key: value}), work_dir=str(tmp_path),
                        device='cpu')
        with pytest.raises(NotImplementedError, match=item):
            runner.val()


def test_val_matches_jax_runner(tree, tmp_path, conv_depthwise):
    import lednet_tpu
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu.engine.state import TrainState as JTrainState
    lednet_tpu.register_all_modules()
    one_at_a_time = {'val_batch_size': 1}       # one small JAX compile
    jrunner = JRunner(tiny_cfg(tree, JConfig, **one_at_a_time),
                      work_dir=str(tmp_path / 'jax'))
    params, stats = random_variables(jrunner.model, jnp.zeros((1, 64, 64, 3)),
                                     seed=4, train=False)
    variables = jax_variables(params, stats)
    # the eval step reads only the weights: no jitted init, no optimizer
    # state to compile
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.val()

    runner = Runner(tiny_cfg(tree, **one_at_a_time), work_dir=str(tmp_path / 'port'),
                    device='cpu')
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    got = runner.val()
    assert 1.0 < want['aAcc'] < 95.0 and want['mIoU'] > 0.1   # not degenerate
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


# the flagship's SESP call sites at bs=1, 1024x1024 (Cin, n, H, W, rates,
# stride), as in tests/test_torch_port_kernels.py
FLAGSHIP_SESP = [(64, 16, 128, 128, (1, 2, 3, 4), 2), (128, 32, 64, 64, (1, 1, 2, 3), 1),
                 (64, 16, 128, 128, (1, 1, 1, 1), 1), (128, 32, 64, 64, (1, 2, 3, 4), 2),
                 (256, 64, 32, 32, (1, 1, 2, 3), 1), (64, 32, 128, 128, (1, 1, 1, 1), 1),
                 (256, 64, 32, 32, (1, 2, 3, 4), 2), (512, 32, 16, 16, (1, 1, 2, 3), 1)]
GRID_YZ = 65535          # CUDA's limit on gridDim.y and gridDim.z
INT_MAX = 2**31 - 1


@pytest.mark.parametrize('cin,n,H,W,rates,stride', FLAGSHIP_SESP)
def test_val_shape_launch_geometry_fits_the_card(cin, n, H, W, rates, stride):
    """Val runs the kernels at 8 x 1024 x 2048 (a batch of val_batch_size
    Cityscapes frames): every SESP site's map twice as wide, batch 8.
    Kernel D's launches fit one CTA's shared memory and CUDA's grid limits;
    the stem convs (B) and the BasicBlock pair (C) at that shape too."""
    from lednet_tpu_torch.ops.kernels import conv3x3
    from lednet_tpu_torch.ops.kernels.sesp_pyramid import (SMEM_BYTES,
                                                           fused_config,
                                                           reduce_config)
    B, k, W = 8, 4, 2 * W
    H2, W2 = -(-H // stride), -(-W // stride)
    for v2 in (True, False):
        cfg = fused_config(B, H, W, n, k, rates, stride, v2)
        assert cfg.smem <= SMEM_BYTES
        tiles = -(-H2 // cfg.th) * -(-W2 // cfg.tw)
        assert cfg.ctas == tiles * -(-k * n // cfg.oc) * B * cfg.cs
        # grid (tiles * cs, C / oc, B)
        assert tiles * cfg.cs <= INT_MAX and -(-k * n // cfg.oc) <= GRID_YZ
    ppt, opt = reduce_config(B, H * W, n)
    assert -(-H * W // (16 * ppt)) <= INT_MAX and -(-n // (16 * opt)) <= GRID_YZ
    assert B * max(cin, k * n) * H * W < 2**63       # size_t offsets
    stem = conv3x3.stem_config(B, 32, 1024, 2048, True)
    pair = conv3x3.block_config(B, 32, 256, 512)
    assert stem.smem <= conv3x3.SMEM_BYTES and pair.smem <= conv3x3.SMEM_BYTES
    assert pair.grid[1] <= GRID_YZ and pair.grid[2] == B
