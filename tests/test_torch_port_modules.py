"""PyTorch port: LED-Net's bricks against ``lednet_tpu`` on the CPU in float32,
with the same random weights and BatchNorm running stats moved from the flax
variables through ``lednet_tpu_torch.convert``.

Tolerance: max|port - jax| <= 1e-5 * max|jax| for every brick (float32
arithmetic in another order; no reduction here is long enough to need more).
The SESP cases also run the kernel path's host-side glue (BatchNorm folding,
dense grouped 1x1s, tail selection) through kernel D's plain version.
"""
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
from lednet_tpu_torch.models.decode_heads import led_head
from test_torch_port_common import (jax_variables, load_port, nchw, nhwc,
                                    random_variables, rel_err)

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
