"""PyTorch port: LED-Net's bricks against ``lednet_tpu`` on the CPU in float32,
with the same random weights and BatchNorm running stats moved from the flax
variables through ``lednet_tpu_torch.convert``.

Tolerance: max|port - jax| <= 1e-5 * max|jax| for every brick (float32
arithmetic in another order; no reduction here is long enough to need more).
The SESP cases also run the kernel path's host-side glue (BatchNorm folding,
dense grouped 1x1s, tail selection) through kernel D's plain version, and the
fold-cache tests show that the kernel paths' cached operands follow every
change of the weights they are folded from.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lednet_tpu.models import aff as jaff
from lednet_tpu.models import espnet as jesp
from lednet_tpu.models import getb as jgetb
from lednet_tpu.models import layers as jlayers
from lednet_tpu.models import seam as jseam
from lednet_tpu.models.decode_heads import led_head as jhead
from lednet_tpu_torch.models import aff, espnet, getb, layers, seam
from lednet_tpu_torch.models.backbones.lednet import LEDNet
from lednet_tpu_torch.models.decode_heads import led_head
from lednet_tpu_torch.ops.kernels import conv3x3
from test_torch_port_common import (jax_variables, load_port, nchw, nhwc,
                                    random_variables, rel_err)
from test_torch_port_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

TOL = 1e-5
BN = dict(type='SyncBN')


def _run(jmod, tmod, *inputs, seed=0):
    """Apply both modules to the same NHWC numpy inputs; return
    (port output as NHWC, jax output)."""
    jin = [jnp.asarray(a) for a in inputs]
    params, stats = random_variables(jmod, *jin, seed=seed, train=False)
    ref = jmod.apply(jax_variables(params, stats), *jin, train=False)
    load_port(tmod, params, stats)
    with torch.no_grad():
        out = tmod(*[nchw(a) for a in inputs])
    return nhwc(out), np.asarray(ref)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('order,act', [
    (('conv', 'norm', 'act'), dict(type='ReLU')),
    (('norm', 'act', 'conv'), dict(type='ReLU')),
    (('conv', 'norm', 'act'), None),
])
def test_conv_module(rng, order, act):
    j = jlayers.ConvModule(8, 12, 3, stride=2, padding=1, norm_cfg=BN,
                           act_cfg=act, order=order)
    t = layers.ConvModule(8, 12, 3, stride=2, padding=1, norm_cfg=BN,
                          act_cfg=act, order=order)
    out, ref = _run(j, t, _x(rng, 2, 11, 14, 8))
    assert out.shape == ref.shape and rel_err(out, ref) < TOL


@pytest.mark.parametrize('stride,downsample,act_out', [(1, False, True),
                                                       (2, True, False)])
def test_basic_block(rng, stride, downsample, act_out):
    cout = 16 if downsample else 8
    j = jlayers.BasicBlock(8, cout, stride=stride, downsample=downsample,
                           norm_cfg=BN, act_out=act_out)
    t = layers.BasicBlock(8, cout, stride=stride, downsample=downsample,
                          norm_cfg=BN, act_out=act_out)
    out, ref = _run(j, t, _x(rng, 2, 12, 10, 8))
    assert out.shape == ref.shape and rel_err(out, ref) < TOL


def test_seam(rng):
    out, ref = _run(jseam.SEAM(16), seam.SEAM(16), _x(rng, 2, 16, 20, 16))
    assert out.shape == ref.shape and rel_err(out, ref) < TOL


def test_muti_aff(rng):
    j, t = jaff.MutiAFF(16), aff.MutiAFF(16)
    out, ref = _run(j, t, _x(rng, 2, 24, 20, 16), _x(rng, 2, 24, 20, 16))
    assert out.shape == ref.shape and rel_err(out, ref) < TOL


@pytest.mark.parametrize('hw', [(16, 24), (12, 20), (3, 5)])   # reflect pads < and >= size
def test_getb_block(rng, hw):
    j = jgetb.GETBBlock(32, 8, mlp_ratio=2.0, window_size=8)
    t = getb.GETBBlock(32, 8, mlp_ratio=2.0, window_size=8)
    out, ref = _run(j, t, _x(rng, 2, *hw, 32))
    assert out.shape == ref.shape and rel_err(out, ref) < TOL


# (in, out, stride, spatial, down_method, r_lim): the flagship's SESP kinds
SESP_CASES = [
    (16, 16, 1, True, 'esp', 7),      # spatial1/2: residual tail
    (16, 32, 1, True, 'esp', 7),      # spatial3: act tail
    (32, 32, 1, False, 'esp', 7),     # context block1: rates (1, 1, 2, 3)
    (16, 16, 2, False, 'avg', 9),     # down-sampler: stride 2, plain tail
    (64, 16, 1, False, 'esp', 7),     # spp: wide input, act tail
    (16, 16, 2, False, 'esp', 7),     # stride-2 context block + avg shortcut
]


@pytest.mark.parametrize('cin,cout,stride,spatial,down,r_lim', SESP_CASES)
def test_sesp_module_and_kernel_glue(rng, cin, cout, stride, spatial, down,
                                     r_lim):
    kw = dict(stride=stride, spatial=spatial, down_method=down, r_lim=r_lim)
    j, t = jesp.SESP(cin, cout, **kw), espnet.SESP(cin, cout, **kw)
    x = _x(rng, 2, 11, 14, cin)
    out, ref = _run(j, t, x)
    assert out.shape == ref.shape and rel_err(out, ref) < TOL
    with torch.no_grad():
        glue = nhwc(t.kernel_forward(nchw(x), impl='plain'))
    assert rel_err(glue, ref) < TOL


def test_cespb_downsampling_stage(rng):
    j = jesp.CESPB(16, 32, stride=2, num_blocks=2, spatial=False)
    t = espnet.CESPB(16, 32, stride=2, num_blocks=2, spatial=False)
    out, ref = _run(j, t, _x(rng, 2, 16, 18, 16))
    assert out.shape == ref.shape and rel_err(out, ref) < TOL


def test_led_head_predict(rng):
    """head / head_x1 / head_x2 + the logit pyramid at ceil sizes."""
    j = jhead.LEDHead(in_channels=32, channels=16, num_classes=3,
                      dropout_ratio=0.0, norm_cfg=BN)
    t = led_head.LEDHead(in_channels=32, channels=16, num_classes=3,
                         dropout_ratio=0.0, norm_cfg=BN)
    size = (50, 78)                            # odd: ceil(50/4) = 13 etc.
    c3, c5 = _x(rng, 1, 7, 10, 16), _x(rng, 1, 7, 10, 32)
    x1, x2 = _x(rng, 1, 25, 39, 8), _x(rng, 1, 13, 20, 8)
    jin = [jnp.asarray(a) for a in (c3, c5, x1, x2)]
    params, stats = random_variables(j, tuple(jin), train=False)
    jl = j.apply(jax_variables(params, stats), tuple(jin), train=False,
                 with_aux=False)
    ref = j.predict_by_feat(jl, size)
    load_port(t, params, stats)
    with torch.no_grad():
        tl = t(tuple(nchw(a) for a in (c3, c5, x1, x2)), with_aux=False)
        out = nhwc(t.predict_by_feat(tl, size))
    assert out.shape == ref.shape == (1, 50, 78, 3)
    assert rel_err(out, ref) < TOL


# ------------------------------------------------------------ fold caches
def _edits(part):
    """In-place edits of a conv weight, a running stat and a BatchNorm bias
    inside ``part``, as ``no_grad`` code (a checkpoint loader, a smoke test)
    makes them."""
    convs = [m for m in part.modules() if isinstance(m, torch.nn.Conv2d)]
    bns = [m for m in part.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    return [lambda: convs[-1].weight.mul_(1.5),
            lambda: bns[0].running_var.add_(0.5),
            lambda: bns[-1].bias.sub_(0.2)]


def _check_fold_cache(module, part, kernel, reference, x):
    """``kernel(m, x)`` (a kernel path run by the plain versions) folds once,
    then follows in-place edits, ``load_state_dict`` and a deep copy moved
    with ``.to('cpu')``, always equal to ``reference(m, x)`` (the module
    form); the cache is not part of ``state_dict()``.  ``part(m)`` is the
    submodule whose weights are folded."""
    saved = copy.deepcopy(module.state_dict())
    with torch.no_grad():
        first = kernel(module, x)
        cached = module._operand_cache
        assert rel_err(first.numpy(), reference(module, x).numpy()) < TOL
        np.testing.assert_array_equal(kernel(module, x).numpy(), first.numpy())
        assert module._operand_cache is cached          # nothing re-folded
        before = first
        for edit in _edits(part(module)):
            edit()
            out = kernel(module, x)
            assert module._operand_cache is not cached
            cached = module._operand_cache
            assert np.abs(out.numpy() - before.numpy()).max() > 1e-4
            assert rel_err(out.numpy(), reference(module, x).numpy()) < TOL
            before = out
        module.load_state_dict(saved)
        out = kernel(module, x)
        np.testing.assert_array_equal(out.numpy(), first.numpy())
        twin = copy.deepcopy(module).to('cpu')
        _edits(part(twin))[0]()
        out = kernel(twin, x)
        assert rel_err(out.numpy(), reference(twin, x).numpy()) < TOL
        np.testing.assert_array_equal(kernel(module, x).numpy(),
                                      first.numpy())
    assert not [key for key in module.state_dict() if 'cache' in key]


def test_sesp_fold_cache_follows_weight_changes(rng):
    j = jesp.SESP(16, 16, spatial=False)
    t = espnet.SESP(16, 16, spatial=False)
    x = _x(rng, 1, 9, 11, 16)
    params, stats = random_variables(j, jnp.asarray(x), seed=1, train=False)
    load_port(t, params, stats)
    _check_fold_cache(t, lambda m: m, lambda m, v: m.kernel_forward(v, 'plain'),
                      lambda m, v: m.module_forward(v), nchw(x))


def test_stem_fold_cache_follows_weight_changes(rng):
    t = LEDNet(channels=8, ppm_channels=32).eval()
    gen = torch.Generator().manual_seed(0)
    layers.init_weights(t, gen)
    with torch.no_grad():
        for m in t.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
    stem = lambda m: torch.nn.ModuleList([m.stem_conv1, m.stem_conv2,
                                          m.stem_block1, m.stem_block2])

    def kernel(m, v):
        """The kernel path, and kernels B's and C's cached pre-split weights
        against a fresh fold of the current weights: the cached split and
        fragment order follow every edit as the folded weights do."""
        out = m.kernel_stem(v, 'plain')[2]
        w1, _, w2, _, ws, _, (f1, f2), fp = m._operand_cache[1]
        fresh = m._fold_stem()
        for a, b in zip((w1, w2, ws), (fresh[0], fresh[2], fresh[4])):
            assert torch.equal(a, b)
        split = conv3x3.tf32_split
        assert all(map(torch.equal, conv3x3.unpack_conv1_fragments(f1),
                       split(fresh[0])))
        assert all(map(torch.equal, conv3x3.unpack_conv_fragments(f2),
                       split(fresh[2])))
        for i in range(4):
            assert all(map(torch.equal, conv3x3.unpack_conv_fragments(fp[i]),
                           split(fresh[4][i])))
        return out
    _check_fold_cache(t, stem, kernel, lambda m, v: m.module_stem(v)[2],
                      nchw(_x(rng, 1, 24, 32, 3)))
