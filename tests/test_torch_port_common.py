"""PyTorch port: shared helpers of the ``test_torch_port_*`` files, and the
port's ground rules (no JAX imports, no silent CPU run, no fallback from a
requested kernel) and its weight bridge.

The helpers give flax modules random, non-trivial variables straight from a
numpy seed (shapes from ``jax.eval_shape``, so nothing is compiled), move them
into the port through ``lednet_tpu_torch.convert``, and convert layouts.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lednet_tpu_torch
from lednet_tpu_torch.convert import (flax_to_state_dict, load_npz_variables,
                                      save_npz_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, 'configs/LED_Net/lednet_80k_cityscapes-1024x1024.py')

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def one_thread():
    """One torch thread inside the test, the caller's count restored after.
    torch's multi-threaded CPU autograd aborts the process after the XLA
    CPU runtime has run in it, and six test workers each running torch
    (and XLA) on every core oversubscribe the machine.  Port test files use
    it on every test (``pytestmark``)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture
def conv_depthwise(monkeypatch):
    """The JAX LED-Net's depthwise convs, inside the test, as one grouped
    ``lax.conv`` each: the JAX SESP's own ``dw_impl='conv'`` form
    (``lednet_tpu/models/espnet.py:291-297``) in place of the nine shifted
    multiply-adds of ``_dw_shift`` (:92), which every LED-Net forward off
    the TPU takes.  ``_dw_shift`` is documented as the same map (its
    docstring); the sum of its nine taps rounds in another order, which
    moved the flagship's float32 train step's loss by 6e-8 and
    ``grad_norm`` by 4e-6 relative.  XLA:CPU traces and compiles that step
    in 28 s instead of 79 (the whole-model LED-Net tests are tier-1's
    largest share of compile time).  The JAX package is not changed."""
    import jax
    import lednet_tpu.models.espnet as espnet

    def grouped(x, kernel, d, stride=1):
        return jax.lax.conv_general_dilated(
            x, kernel.astype(x.dtype), (stride, stride), ((d, d), (d, d)),
            rhs_dilation=(d, d), dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
            feature_group_count=x.shape[-1])
    monkeypatch.setattr(espnet, '_dw_shift', grouped)


def _fill(path, shape, rng):
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ''
    if leaf == 'kernel' or leaf.startswith('spp_dw'):
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape) / np.sqrt(fan_in)
    if parent == 'bn' and leaf == 'scale':
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if leaf == 'alpha':
        return 0.25 + 0.1 * rng.standard_normal(shape)
    if leaf == 'mean':
        return 0.1 * rng.standard_normal(shape)
    if leaf == 'var':
        return rng.uniform(0.5, 1.5, shape)
    return 0.1 * rng.standard_normal(shape)     # biases, bias tables


def random_variables(module, *args, seed=0, **kwargs):
    """(params, batch_stats) as nested numpy float32 dicts for a flax module
    applied to ``args``, with random weights and BN running stats."""
    shapes = _plain(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)))
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        return {k: fill(v, path + (k,)) if isinstance(v, dict)
                else _fill(path + (k,), v.shape, rng).astype(np.float32)
                for k, v in tree.items()}

    return fill(shapes['params']), fill(shapes.get('batch_stats', {}))


def _plain(tree):
    return {k: _plain(v) if hasattr(v, 'items') else v for k, v in tree.items()}


def jax_variables(params, stats):
    return {'params': jax.tree_util.tree_map(jnp.asarray, params),
            'batch_stats': jax.tree_util.tree_map(jnp.asarray, stats)}


def load_port(module, params, stats):
    """Load converted flax variables into a port module (strict) in eval."""
    module.load_state_dict(flax_to_state_dict(params, stats))
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                                 .transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12)


# ------------------------------------------------------------------ rules
PORT_MODULES = ('lednet_tpu_torch', 'lednet_tpu_torch.models', 'lednet_tpu_torch.apis',
                'lednet_tpu_torch.convert', 'lednet_tpu_torch.engine',
                'lednet_tpu_torch.engine.runner', 'lednet_tpu_torch.engine.checkpoint',
                'lednet_tpu_torch.engine.loggers', 'lednet_tpu_torch.ops.kernels',
                'lednet_tpu_torch.datasets', 'lednet_tpu_torch.datasets.imageio',
                'lednet_tpu_torch.datasets.synthetic', 'lednet_tpu_torch.native',
                'lednet_tpu_torch.native.reference', 'lednet_tpu_torch.evaluation',
                'lednet_tpu_torch.ops.point_loss',
                'lednet_tpu_torch.models.decode_heads.knet_head',
                'lednet_tpu_torch.models.decode_heads.maskformer_head',
                'lednet_tpu_torch.models.decode_heads.deform_pixel_decoder')
PORT_CLIS = ('tools/torch_port_train.py', 'tools/torch_port_test.py')


def test_import_pulls_in_no_jax():
    """The port's modules and its train/test CLIs import no JAX, flax or
    JAX-package module, and no cv2 or PIL."""
    code = ('import runpy, sys; '
            f'[__import__(m) for m in {PORT_MODULES!r}]; '
            f'[runpy.run_path(p) for p in {PORT_CLIS!r}]; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "lednet_tpu", "cv2", "PIL")]; print(bad)')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_init_model_defaults_to_cuda():
    from lednet_tpu_torch.apis import init_model
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        init_model(FLAGSHIP)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a GPU, or without the rest of the repo beside it, the smoke
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    src = os.path.join(REPO, 'chip_smoke.py')
    for cwd, script in ((REPO, src), (str(tmp_path), str(tmp_path / 'chip_smoke.py'))):
        if cwd != REPO:
            with open(src) as f, open(script, 'w') as g:
                g.write(f.read())
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=''))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


# ------------------------------------------------------------------ bridge
def test_flax_to_state_dict_maps_every_leaf():
    from lednet_tpu.models.espnet import SESP as JSESP
    from lednet_tpu_torch.models.espnet import SESP
    x = jnp.zeros((1, 8, 8, 16))
    params, stats = random_variables(JSESP(16, 16, spatial=False), x)
    sd = flax_to_state_dict(params, stats)
    port = SESP(16, 16, spatial=False)
    assert set(sd) == set(port.state_dict())
    np.testing.assert_array_equal(
        sd['proj_1x1.conv.weight'].numpy(),
        params['proj_1x1']['conv']['kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd['spp_dw2'].numpy()[:, 0], params['spp_dw2'][:, :, 0].transpose(2, 0, 1))
    np.testing.assert_array_equal(sd['br_after_cat_norm.bn.running_var'].numpy(),
                                  stats['br_after_cat_norm']['bn']['var'])


def test_npz_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    params = {'_backbone': {'a': {'conv': {'kernel': rng.standard_normal((3, 3, 2, 4))}}}}
    stats = {'_backbone': {'a': {'norm': {'bn': {'mean': rng.standard_normal(4),
                                                 'var': rng.random(4)}}}}}
    path = str(tmp_path / 'ckpt.npz')
    save_npz_variables(path, params, stats)
    p2, s2 = load_npz_variables(path)
    sd = flax_to_state_dict(p2, s2)
    np.testing.assert_array_equal(sd['backbone.a.conv.weight'].numpy(),
                                  params['_backbone']['a']['conv']['kernel']
                                  .transpose(3, 2, 0, 1).astype(np.float32))
    assert int(sd['backbone.a.norm.bn.num_batches_tracked']) == 0
    assert lednet_tpu_torch.__version__
