"""PyTorch port: each CUDA kernel's plain PyTorch version against the JAX
package's Pallas kernel run by the Pallas interpreter on the CPU
(``interpret=True``), at the contracts of ``tests/test_pallas_kernels.py``:
bit-exact for the normalization, relative error 1e-5 in float32 (2e-2 for a
bfloat16 stem input) for the convs and the SESP block.

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds each
of them against these plain versions there.  Here the tests also pin the
dispatch rule: asking for the kernel on a CPU tensor raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lednet_tpu.ops.pallas.conv_block import basic_pair_packed
from lednet_tpu.ops.pallas.s2d_input import normalize_s2d
from lednet_tpu.ops.pallas.sesp_pyramid import bn_fold as jbn_fold
from lednet_tpu.ops.pallas.sesp_pyramid import dense_grouped as jdense_grouped
from lednet_tpu.ops.pallas.sesp_pyramid import sesp_block as jsesp_block
from lednet_tpu.ops.pallas.stem_conv import stem_convs_packed
from lednet_tpu.ops.s2d import (depth_to_space, pack_s1_conv_weights,
                                pack_s2_conv_weights, space_to_depth)
from lednet_tpu_torch.ops.kernels import (basic_pair, normalize_image,
                                          sesp_block, stem_convs)
from lednet_tpu_torch.ops.kernels.sesp_pyramid import bn_fold, dense_grouped
from test_torch_port_common import nchw, nhwc, rel_err

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


# ------------------------------------------------------- A: normalization
@pytest.mark.parametrize('shape,flip', [((1, 32, 128, 3), True),
                                        ((2, 16, 256, 3), True),
                                        ((1, 32, 128, 3), False)])
def test_normalize_plain_matches_pallas_bit_exact(rng, shape, flip):
    x = rng.integers(0, 255, shape).astype(np.float32)
    out = normalize_image(torch.from_numpy(x), MEAN, STD, flip=flip,
                          out_dtype=torch.bfloat16)
    # the JAX kernel keeps file channel order with flipped statistics
    m = np.asarray(MEAN[::-1] if flip else MEAN, np.float32)
    s = np.asarray(STD[::-1] if flip else STD, np.float32)
    packed = normalize_s2d(jnp.asarray(x), jnp.asarray(m), jnp.asarray(s),
                           interpret=True)
    ref = np.asarray(depth_to_space(packed, 4).astype(jnp.float32))
    if flip:
        ref = ref[..., ::-1]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(out.float()), ref)


def test_normalize_plain_float32_output(rng):
    x = rng.integers(0, 255, (1, 8, 12, 3)).astype(np.float32)
    out = normalize_image(torch.from_numpy(x), MEAN, STD, flip=True,
                          out_dtype=torch.float32)
    ref = (x[..., ::-1] - np.float32(MEAN)) / np.float32(STD)
    np.testing.assert_array_equal(nhwc(out), ref.astype(np.float32))


# ------------------------------------------------------- B: stem convs
@pytest.mark.parametrize('dtype,tol', [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_stem_convs_plain_matches_pallas(rng, dtype, tol):
    H, W, c = 48, 64, 8
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 3, c)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
    b1 = rng.standard_normal(c).astype(np.float32)
    b2 = rng.standard_normal(c).astype(np.float32)
    xp = space_to_depth(jnp.asarray(x, dtype), 4)
    wb1 = pack_s2_conv_weights(jnp.asarray(w1), 2).astype(dtype)
    wb2 = pack_s2_conv_weights(jnp.asarray(w2), 1).astype(dtype)
    h, x2_ref = stem_convs_packed(xp, wb1, jnp.tile(jnp.asarray(b1), 4)[None],
                                  wb2, jnp.asarray(b2)[None], interpret=True)
    x1_ref = depth_to_space(h, 2)
    xt = nchw(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    x1, x2 = stem_convs(xt, _oihw(w1), _t(b1), _oihw(w2), _t(b2))
    assert x1.dtype == x2.dtype == torch.float32
    assert rel_err(nhwc(x1), np.asarray(x1_ref, np.float32)) < tol
    assert rel_err(nhwc(x2), np.asarray(x2_ref, np.float32)) < tol


# ------------------------------------------------------- C: BasicBlock pair
def test_basic_pair_plain_matches_pallas(rng):
    B, H, W, C = 1, 8, 16, 32
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ws = [(rng.standard_normal((3, 3, C, C)) * 0.1).astype(np.float32)
          for _ in range(4)]
    bs = [(rng.standard_normal(C) * 0.1).astype(np.float32) for _ in range(4)]
    wb = jnp.stack([pack_s1_conv_weights(jnp.asarray(w), 4) for w in ws])
    bb = jnp.stack([jnp.tile(jnp.asarray(b), 4)[None] for b in bs])
    ref = basic_pair_packed(jnp.asarray(x).reshape(B, H, W // 4, 4 * C), wb, bb,
                            interpret=True).reshape(B, H, W, C)
    out = basic_pair(nchw(x), torch.stack([_oihw(w) for w in ws]),
                     torch.stack([_t(b) for b in bs]))
    assert rel_err(nhwc(out), np.asarray(ref)) < 1e-5


# ------------------------------------------------------- D: SESP block
def _sesp_operands(rng, cin, n, k):
    C = k * n
    f = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    return dict(wred=f(cin, n), bred=f(n), a1=f(n, sc=0.1),
                dw1=f(k, 3, 3, n), dw2=f(k, 3, 3, n),
                s2=1 + f(C, sc=0.1), b2=f(C), a2=f(C, sc=0.1),
                wexp=f(C, C, sc=0.1), bexp=f(C), a3=f(C, sc=0.1))


@pytest.mark.parametrize('tail,stride,with_v2,cin,n,H,W,rates', [
    ('residual', 1, True, 32, 8, 10, 12, (1, 2, 3, 4)),
    ('residual', 1, False, 32, 8, 10, 12, (1, 1, 1, 1)),
    ('act', 1, True, 64, 8, 9, 13, (1, 1, 2, 3)),
    ('plain', 1, True, 32, 8, 10, 12, (1, 2, 3, 4)),
    ('plain', 2, True, 16, 8, 11, 12, (1, 2, 3, 4)),
    ('plain', 2, False, 16, 8, 10, 12, (1, 2, 3, 4)),
    ('plain', 2, True, 256, 64, 8, 10, (1, 2, 3, 4)),   # context3's C=256 block
])
def test_sesp_block_plain_matches_pallas(rng, tail, stride, with_v2, cin, n,
                                         H, W, rates):
    k = 4
    o = _sesp_operands(rng, cin, n, k)
    if not with_v2:
        o['dw2'] = None
    x = rng.standard_normal((2, H, W, cin)).astype(np.float32)
    ja = {key: None if v is None else jnp.asarray(v) for key, v in o.items()}
    ref = jsesp_block(jnp.asarray(x), ja['wred'], ja['bred'], ja['a1'], ja['dw1'],
                      ja['dw2'], ja['s2'], ja['b2'], ja['a2'], ja['wexp'],
                      ja['bexp'], ja['a3'], rates=rates, stride=stride,
                      tail=tail, exact=True, interpret=True)
    dw = lambda a: None if a is None else _t(a.transpose(0, 3, 1, 2))
    out = sesp_block(nchw(x), _t(o['wred'].T), _t(o['bred']), _t(o['a1']),
                     dw(o['dw1']), dw(o['dw2']), _t(o['s2']), _t(o['b2']),
                     _t(o['a2']), _t(o['wexp'].T), _t(o['bexp']), _t(o['a3']),
                     rates=rates, stride=stride, tail=tail)
    assert out.shape == (2, k * n, -(-H // stride), -(-W // stride))
    assert rel_err(nhwc(out), np.asarray(ref)) < 1e-5


def test_fold_helpers_match_jax(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    scale, bias, mean = f(6), f(6), f(6)
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    s_j, b_j = jbn_fold(*(jnp.asarray(a) for a in (scale, bias, mean, var)))
    s_t, b_t = bn_fold(*(_t(a) for a in (scale, bias, mean, var)))
    assert rel_err(s_t.numpy(), np.asarray(s_j)) < 1e-6
    assert rel_err(b_t.numpy(), np.asarray(b_j)) < 1e-6
    kern = f(1, 1, 3, 8)          # flax grouped 1x1: (1, 1, Ci/g, Co), g = 4
    dense_j = np.asarray(jdense_grouped(jnp.asarray(kern), 4))   # (Ci, Co)
    dense_t = dense_grouped(_t(kern.transpose(3, 2, 0, 1)), 4)   # (Co, Ci)
    np.testing.assert_array_equal(dense_t.numpy(), dense_j.T)


# ------------------------------------------------------- dispatch rule
def _cpu_calls():
    x3 = torch.zeros(1, 8, 8, 3)
    x = torch.zeros(1, 8, 8, 8)
    w = torch.zeros(8, 8, 3, 3)
    b = torch.zeros(8)
    return {
        'normalize_image': lambda: normalize_image(x3, MEAN, STD, impl='cuda'),
        'stem_convs': lambda: stem_convs(x, w, b, w, b, impl='cuda'),
        'basic_pair': lambda: basic_pair(x, torch.zeros(4, 8, 8, 3, 3),
                                         torch.zeros(4, 8), impl='cuda'),
        'sesp_block': lambda: sesp_block(
            x, torch.zeros(2, 8), torch.zeros(2), torch.zeros(2),
            torch.zeros(4, 2, 3, 3), None, *[torch.zeros(8)] * 3,
            torch.zeros(8, 8), torch.zeros(8), torch.zeros(8),
            rates=(1, 1, 1, 1), impl='cuda'),
    }


@pytest.mark.parametrize('op', ['normalize_image', 'stem_convs', 'basic_pair',
                                'sesp_block'])
def test_cuda_impl_on_cpu_tensor_raises(op):
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        _cpu_calls()[op]()
