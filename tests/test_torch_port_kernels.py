"""PyTorch port: each CUDA kernel's plain PyTorch version against the JAX
package's Pallas kernel run by the Pallas interpreter on the CPU
(``interpret=True``), at the contracts of ``tests/test_pallas_kernels.py``:
bit-exact for the normalization, relative error 1e-5 in float32 (2e-2 for a
bfloat16 stem input) for the convs, the SESP block and the SESP pyramid.

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds each
of them against these plain versions there.  Here the tests also pin the
dispatch rule (asking for the kernel on a CPU tensor raises), the host side
of kernels B's and C's 3xTF32 tensor-core convs (the TF32 split of the
weights, their mma fragment order, an emulation of the arithmetic within
1e-6 of the float32 conv) and every kernel's launch geometry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lednet_tpu.ops.pallas.conv_block import basic_pair_packed
from lednet_tpu.ops.pallas.s2d_input import normalize_s2d
from lednet_tpu.ops.pallas.sesp_pyramid import bn_fold as jbn_fold
from lednet_tpu.ops.pallas.sesp_pyramid import dense_grouped as jdense_grouped
from lednet_tpu.ops.pallas.sesp_pyramid import sesp_block as jsesp_block
from lednet_tpu.ops.pallas.sesp_pyramid import sesp_pyramid as jsesp_pyramid
from lednet_tpu.ops.pallas.stem_conv import stem_convs_packed
from lednet_tpu.ops.s2d import (depth_to_space, pack_s1_conv_weights,
                                pack_s2_conv_weights, space_to_depth)
from lednet_tpu_torch.ops.kernels import (basic_pair, normalize_image,
                                          sesp_block, sesp_pyramid, stem_convs)
from lednet_tpu_torch.ops.kernels import conv3x3
from lednet_tpu_torch.ops.kernels.sesp_pyramid import (E_CTAS_PER_SM, SMS,
                                                       SMEM_BYTES, THREADS,
                                                       TMA_BOX_MAX,
                                                       bn_fold, dense_grouped,
                                                       fused_config,
                                                       fused_smem,
                                                       PyramidGeometry,
                                                       pyramid_geometry,
                                                       pyramid_tile,
                                                       reduce_config,
                                                       sesp_pyramid_plain)
from test_torch_port_common import nchw, nhwc, rel_err
from test_torch_port_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

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


# ------------------------------------------------ B and C: the 3xTF32 core
TOL_KERNEL = 1e-5     # chip_smoke.py: kernels against their plain versions


def _low13(t):
    return (t.contiguous().view(torch.int32) & 0x1FFF).abs().max().item()


def _folded(rng, cout, cin):
    """A conv weight with a seeded eval BatchNorm folded in, as the model's
    ``_fold_stem`` makes them (kaiming scale, running var in 0.5 .. 1.5)."""
    w = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (cout * 9))
    scale = 1 + 0.1 * rng.standard_normal(cout)
    var = rng.uniform(0.5, 1.5, cout)
    return _t(w * (scale / np.sqrt(var + 1e-5))[:, None, None, None])


def test_tf32_split_of_the_weights(rng):
    """hi has its low 13 mantissa bits zero (a TF32 value), lo too, and
    hi + lo gives back the weight within 2^-21 of it."""
    w = _folded(rng, 32, 32) * _t(10.0 ** rng.uniform(-3, 3, (32, 1, 1, 1)))
    hi, lo = conv3x3.tf32_split(w)
    assert _low13(hi) == 0 and _low13(lo) == 0
    err = ((hi.double() + lo.double() - w.double()).abs() / w.double().abs())
    assert err.max().item() <= 2.0 ** -21
    # rounding to nearest: hi is never further than half a TF32 ulp
    assert ((w - hi).abs() / w.abs()).max().item() <= 2.0 ** -11


@pytest.mark.parametrize('C', [16, 32])
def test_conv_fragments_round_trip_and_order(rng, C):
    """Unpacking the fragment order gives back the split weights exactly,
    and lane 4 g + t of (chunk q, tap, n-tile) holds
    b0 = W[8 n + g, 8 q + t, tap], b1 = W[8 n + g, 8 q + t + 4, tap]."""
    w = _folded(rng, C, C)
    f = conv3x3.conv_fragments(w)
    assert f.shape == (C // 8, 9, C // 8, 32, 4) and f.is_contiguous()
    hi, lo = conv3x3.tf32_split(w)
    uh, ul = conv3x3.unpack_conv_fragments(f)
    assert torch.equal(uh, hi) and torch.equal(ul, lo)
    for q, tap, n, lane in [(0, 0, 0, 0), (C // 8 - 1, 8, C // 8 - 1, 31),
                            (1, 4, 0, 13)]:
        g, t = divmod(lane, 4)
        ky, kx = divmod(tap, 3)
        assert f[q, tap, n, lane, 0] == hi[8 * n + g, 8 * q + t, ky, kx]
        assert f[q, tap, n, lane, 1] == hi[8 * n + g, 8 * q + t + 4, ky, kx]
        assert f[q, tap, n, lane, 2] == lo[8 * n + g, 8 * q + t, ky, kx]
        assert f[q, tap, n, lane, 3] == lo[8 * n + g, 8 * q + t + 4, ky, kx]
    w1 = _folded(rng, C, 3)
    f1 = conv3x3.conv1_fragments(w1)
    assert f1.shape == (4, C // 8, 32, 4)
    h1, l1 = conv3x3.tf32_split(w1)
    u1h, u1l = conv3x3.unpack_conv1_fragments(f1)
    assert torch.equal(u1h, h1) and torch.equal(u1l, l1)
    k = f1.reshape(4, C // 8, 8, 4, 4)          # k >= 27 is zero padding
    assert (k[3, :, :, 3, 0] == 0).all() and (k[3, :, :, :, 1] == 0).all()


def _emulated_3xtf32(x, w, stride, x_exact=False):
    """The kernels' arithmetic: a = a_hi + a_lo and w = w_hi + w_lo split to
    TF32, a_lo w_hi + a_hi w_lo + a_hi w_hi summed in float32 (a_lo w_lo
    dropped; a_lo = 0 for an input exact in TF32, such as bf16)."""
    xh, xl = conv3x3.tf32_split(x)
    wh, wl = conv3x3.tf32_split(w)
    conv = lambda a, b: F.conv2d(a, b, stride=stride, padding=1)
    out = conv(xh, wl) + conv(xh, wh)
    return out if x_exact else conv(xl, wh) + out


@pytest.mark.parametrize('stride', [1, 2])
def test_3xtf32_conv_emulation_holds_the_kernel_tolerance(rng, stride):
    """At flagship-like statistics (C = 32, 64 x 64, folded weights from a
    seeded BatchNorm, a ReLU'd input) the 3xTF32 arithmetic stays within a
    tenth of chip_smoke.py's kernel tolerance of the float32 conv, and the
    bf16-input form of stem_conv1 (two products) does too."""
    x = F.relu(_t(rng.standard_normal((1, 32, 64, 64))))
    w = _folded(rng, 32, 32)
    ref = F.conv2d(x.double(), w.double(), stride=stride, padding=1)
    emu = _emulated_3xtf32(x, w, stride)
    assert rel_err(emu.numpy(), ref.numpy()) <= TOL_KERNEL / 10
    f32 = F.conv2d(x, w, stride=stride, padding=1)
    assert rel_err(emu.numpy(), f32.numpy()) <= TOL_KERNEL / 10
    img = _t(rng.standard_normal((1, 3, 64, 64))).bfloat16().float()
    w1 = _folded(rng, 32, 3)
    ref1 = F.conv2d(img.double(), w1.double(), stride=2, padding=1)
    emu1 = _emulated_3xtf32(img, w1, 2, x_exact=True)
    assert rel_err(emu1.numpy(), ref1.numpy()) <= TOL_KERNEL / 10


# kernel B's inputs and kernel C's maps: the flagship's, then the ragged
# shapes chip_smoke.py checks on the card
STEM_SHAPES = [(1, 1024, 1024, 32), (2, 250, 378, 32), (2, 200, 264, 32),
               (2, 37, 45, 32), (1, 7, 9, 32), (2, 250, 378, 16)]
PAIR_SHAPES = [(1, 256, 256, 32), (2, 37, 70, 32), (2, 36, 64, 32),
               (1, 5, 11, 32), (2, 37, 70, 16)]


@pytest.mark.parametrize('B,H,W,C', STEM_SHAPES)
def test_stem_launch_config_fits_the_card(B, H, W, C):
    """Kernel B: 256 threads, one persistent CTA per SM at most (and none
    without a tile), its shared memory within 227 KB for a bf16 and a
    float32 image, and tiles that cover x2."""
    for bf16 in (True, False):
        cfg = conv3x3.stem_config(B, C, H, W, bf16)
        h2, w2 = -(-(-(-H // 2)) // 2), -(-(-(-W // 2)) // 2)
        assert cfg.threads == conv3x3.THREADS == 256
        assert cfg.smem <= conv3x3.SMEM_BYTES
        assert cfg.tiles == B * -(-h2 // cfg.th) * -(-w2 // cfg.tw)
        assert cfg.grid == (min(cfg.tiles, conv3x3.SMS), 1, 1)
        assert cfg.th * cfg.tw == 16 * 8        # one m-tile per warp


@pytest.mark.parametrize('B,H,W,C', PAIR_SHAPES)
def test_pair_launch_config_fits_the_card(B, H, W, C):
    """Kernel C: 256 threads, a grid of tiles that covers the map, and the
    weight ring, x with its 2-pixel halo and h within 227 KB."""
    cfg = conv3x3.block_config(B, C, H, W)
    assert cfg.threads == 256 and cfg.smem <= conv3x3.SMEM_BYTES
    assert cfg.grid == (-(-W // cfg.tw), -(-H // cfg.th), B)
    assert cfg.grid[0] * cfg.tw >= W and cfg.grid[1] * cfg.th >= H
    with pytest.raises(ValueError, match='compiled for C'):
        conv3x3.block_config(1, 24, 16, 16)


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


# the flagship's 11 SESP call sites (bs=1, 1024x1024, k=4):
# (Cin, n, H, W, rates, stride) with H x W the block's input map
FLAGSHIP_SESP = [
    (64, 16, 128, 128, (1, 2, 3, 4), 2),     # context1.down.eesp
    (128, 32, 64, 64, (1, 1, 2, 3), 1),      # context1.block1
    (64, 16, 128, 128, (1, 1, 1, 1), 1),     # spatial1/2 block0/1 (x4)
    (128, 32, 64, 64, (1, 2, 3, 4), 2),      # context2.down.eesp
    (256, 64, 32, 32, (1, 1, 2, 3), 1),      # context2.block1
    (64, 32, 128, 128, (1, 1, 1, 1), 1),     # spatial3.block0
    (256, 64, 32, 32, (1, 2, 3, 4), 2),      # context3.down.eesp
    (512, 32, 16, 16, (1, 1, 2, 3), 1),      # spp
]


@pytest.mark.parametrize('cin,n,H,W,rates,stride', FLAGSHIP_SESP)
def test_sesp_launch_configs_fit_the_card(cin, n, H, W, rates, stride):
    """Kernel D's fused launch gets a geometry that the kernel takes (256
    threads, whole thread tiles, power-of-two tiles, chunks and clusters)
    within one CTA's shared memory (227 KB), with and without the v2 stage
    (kernel E's geometry: ``test_pyramid_geometry_fits_the_card``)."""
    k = 4
    C = k * n
    H2, W2 = -(-H // stride), -(-W // stride)
    for v2 in (True, False):
        cfg = fused_config(1, H, W, n, k, rates, stride, v2)
        assert (cfg.th * cfg.tw // cfg.ppt) * (cfg.oc // 4) == THREADS
        assert cfg.tw % cfg.ppt == 0 and cfg.ppt in (2, 4)
        pow2 = lambda v: v & (v - 1) == 0
        assert pow2(cfg.th) and pow2(cfg.tw) and pow2(cfg.jc)
        assert cfg.smem == fused_smem(H, W, n, k, rates, stride, v2, cfg.th,
                                      cfg.tw, cfg.oc, cfg.jc, cfg.cs) \
            <= SMEM_BYTES
        assert cfg.cs in (1, 2, 4, 8) and cfg.oc % cfg.cs == 0
        assert cfg.cs <= -(-n // cfg.jc)             # every CTA has a chunk
        assert cfg.ctas == (-(-H2 // cfg.th) * -(-W2 // cfg.tw)
                            * -(-C // cfg.oc) * cfg.cs)
    ppt, opt = reduce_config(1, H * W, n)
    assert ppt in (1, 4) and opt in (1, 2, 4) and n <= 16 * opt  # x read once


# ------------------------------------------------------- E: SESP pyramid
@pytest.mark.parametrize('H,W', [(12, 20), (13, 21)])
@pytest.mark.parametrize('rates', [(1, 2, 3, 4), (1, 1, 2, 3)])
@pytest.mark.parametrize('stride,with_v2', [(1, True), (1, False),
                                            (2, True), (2, False)])
def test_sesp_pyramid_plain_matches_pallas(rng, H, W, rates, stride,
                                           with_v2):
    n, k = 16, len(rates)
    red = rng.standard_normal((2, H, W, n)).astype(np.float32)
    dw1 = (rng.standard_normal((k, 3, 3, n)) * 0.3).astype(np.float32)
    dw2 = ((rng.standard_normal((k, 3, 3, n)) * 0.3).astype(np.float32)
           if with_v2 else None)
    ref = jsesp_pyramid(jnp.asarray(red), jnp.asarray(dw1),
                        None if dw2 is None else jnp.asarray(dw2),
                        rates=rates, stride=stride, interpret=True)
    dw = lambda a: None if a is None else _t(a.transpose(0, 3, 1, 2))
    out = sesp_pyramid(nchw(red), dw(dw1), dw(dw2), rates, stride)
    assert out.shape == (2, k * n, -(-H // stride), -(-W // stride))
    assert rel_err(nhwc(out), np.asarray(ref)) < 1e-5


# kernel E's pyramid shapes: the flagship's 8 (bs 1 at 1024x1024, the input
# maps of FLAGSHIP_SESP), the val set's (Runner.val's 8 x 1024 x 2048: B=8,
# W doubled) and ragged ones (W % 4 != 0: the cp.async path; maps smaller
# than one tile; k = 1, 2, 3): (B, n, H, W, rates, stride)
PYRAMID_SHAPES = (
    [(1, n, H, W, rates, s) for _, n, H, W, rates, s in FLAGSHIP_SESP]
    + [(8, n, H, 2 * W, rates, s) for _, n, H, W, rates, s in FLAGSHIP_SESP]
    + [(2, 16, 13, 21, (1, 2, 3, 4), 1), (2, 16, 13, 21, (1, 2, 3, 4), 2),
       (1, 32, 7, 9, (1, 1, 2, 3), 1), (2, 32, 250, 378, (1, 1, 1, 1), 1),
       (2, 16, 37, 70, (2, 3, 4), 2), (1, 16, 5, 6, (1, 2), 1),
       (3, 8, 40, 41, (3,), 2)])


@pytest.mark.parametrize('B,n,H,W,rates,stride', PYRAMID_SHAPES)
def test_pyramid_geometry_fits_the_card(B, n, H, W, rates, stride):
    """Kernel E's launch, with and without the v2 stage: its shared memory
    within one CTA's 227 KB and the layout's own sum; the CTAs per SM it
    claims fit the SM's 228 KB (1 KB reserved per CTA) and the kernel's
    launch bound; a TMA box of at most 256 a side whose rows are a whole
    number of 16-byte units; TMA exactly where W % 4 == 0 (cp.async
    otherwise, and for a red that is not 16-byte aligned); a persistent
    grid of at most the resident CTAs, with items covering the map."""
    k = len(rates)
    H2, W2 = -(-H // stride), -(-W // stride)
    for v2 in (True, False):
        geo = pyramid_geometry(B, H, W, n, k, rates, stride, v2)
        th, tw, m2, ca = geo.th, geo.tw, geo.m2, geo.ca
        sh, su, sp, rh, rw = geo.sh, geo.su, geo.sp, geo.rh, geo.rw
        assert geo == pyramid_tile(B, H, W, n, rates, stride, v2, th, tw,
                                   geo.stages, geo.tma)
        # the head (mbarriers, two buffers of 4 x 24 taps), the ring of
        # 128-byte-aligned boxes, the k sums (v2)
        assert geo.box % 32 == 0 and rh * rw <= geo.box < rh * rw + 32
        assert geo.smem == 4 * (32 + 2 * 96 + geo.stages * geo.box
                                + (k * sh * sp if v2 else 0)) <= SMEM_BYTES
        assert geo.ctas_per_sm == E_CTAS_PER_SM
        assert geo.ctas_per_sm * (geo.smem + 1024) <= 228 * 1024
        assert max(rh, rw) <= TMA_BOX_MAX and (4 * rw) % 16 == 0
        assert geo.tma == (W % 4 == 0)
        assert not pyramid_geometry(B, H, W, n, k, rates, stride, v2,
                                    False).tma
        assert geo.stages in (2, 3) and tw in (16, 32) and th in (8, 16, 32, 64)
        assert m2 == (max(rates) + 1 if v2 else 0)
        assert ca % 4 == 0 and m2 <= ca < m2 + 4
        assert (sh, su) == (th + 2 * m2, tw + 2 * ca)
        assert sp % 8 == 4 and sp >= su and rw % 8 == 4
        assert geo.items == B * n * -(-H2 // th) * -(-W2 // tw)
        assert geo.grid == min(geo.items, SMS * geo.ctas_per_sm)
        # stage 1's box covers the grown tile's windows: rows of every rate,
        # aligned float4 windows from column stride * u
        assert rh >= (sh - 1) * stride + 1 + 2 * max(rates)
        assert rw >= stride * (su - 8) + (16 if stride == 1 else 24)


def _geometry(rates, stride, v2, th, tw):
    """A kernel E launch at a given tile (as ``pyramid_geometry`` builds
    one), to reach every tile size the chooser can pick."""
    return pyramid_tile(1, 64, 64, 1, rates, stride, v2, th, tw, 3, True)


def emulate_pyramid(red, dw1, dw2, rates, stride, geo):
    """Kernel E's work decomposition in torch (``csrc/sesp_pyramid.cu``):
    for each item (plane, output tile), the red box the TMA load brings
    (zeros outside H x W), stage 1's k branch sums over the grown tile read
    from aligned float4 windows of the box (8-wide strips), the HFF running
    sum, zeros outside H2 x W2, stage 2's v2 from aligned windows of the sums,
    and the masked store.  Every index is checked
    against the buffer it reads; every output must be written once."""
    B, n, H, W = red.shape
    k, rmax = len(rates), max(rates)
    H2, W2 = -(-H // stride), -(-W // stride)
    th, tw, m2, ca = geo.th, geo.tw, geo.m2, geo.ca
    sh, su, sp, rh, rw = geo.sh, geo.su, geo.sp, geo.rh, geo.rw
    v2 = dw2 is not None
    out = torch.full((B, k * n, H2, W2), float('nan'))
    writes = torch.zeros(out.shape, dtype=torch.int64)
    tiles_w = -(-W2 // tw)
    tiles = -(-H2 // th) * tiles_w
    v = torch.arange(sh).view(-1, 1)
    u = torch.arange(su).view(1, -1)
    q8, i = u // 8 * 8, u % 8
    for item in range(B * n * tiles):
        p, t = divmod(item, tiles)
        b, c = divmod(p, n)
        oh0, ow0 = t // tiles_w * th, t % tiles_w * tw
        r0, c0 = (oh0 - m2) * stride - rmax, (ow0 - ca) * stride - 4
        box = torch.zeros(rh, rw)
        rr, cc = slice(max(r0, 0), min(r0 + rh, H)), slice(max(c0, 0), min(c0 + rw, W))
        box[rr.start - r0:rr.stop - r0, cc.start - c0:cc.stop - c0] = \
            red[b, c, rr, cc]
        acc = []
        for g, d in enumerate(rates):
            conv = torch.zeros(sh, su)
            for ky in range(3):
                row = v * stride + rmax + (ky - 1) * d
                assert 0 <= row.min() and row.max() < rh
                start = q8 * stride              # the float4 window
                width = 16 if stride == 1 else 24
                assert start.max() + width <= rw and (start % 4 == 0).all()
                for kx in range(3):
                    e = 4 + (kx - 1) * d + stride * i
                    assert 0 <= e.min() and e.max() < width
                    conv = conv + dw1[g, c, ky, kx] * box[row, start + e]
            acc.append(conv if g == 0 else conv + acc[-1])
        oh, ow = oh0 - m2 + v, ow0 - ca + u
        if v2:
            inside = (oh >= 0) & (oh < H2) & (ow >= 0) & (ow < W2)
            S = [torch.where(inside, a, torch.zeros(())) for a in acc]
            r, q = torch.arange(th).view(-1, 1), torch.arange(tw).view(1, -1)
            res = []
            for g, d in enumerate(rates):
                d2, A = d + 1, -(-(d + 1) // 4) * 4
                o = torch.zeros(th, tw)
                for ky in range(3):
                    row = r + m2 + (ky - 1) * d2
                    assert 0 <= row.min() and row.max() < sh
                    start = q // 8 * 8 + ca - A  # the float4 window
                    assert start.min() >= 0 and start.max() + 8 + 2 * A <= sp
                    assert (start % 4 == 0).all()
                    for kx in range(3):
                        e = A + (kx - 1) * d2 + q % 8
                        assert (start + e).max() < su     # a computed sum
                        o = o + dw2[g, c, ky, kx] * S[g][row, start + e]
                res.append(o)
        else:
            res = [a[:th, :tw] for a in acc]
        hh, ww = min(th, H2 - oh0), min(tw, W2 - ow0)
        for g in range(k):
            out[b, g * n + c, oh0:oh0 + hh, ow0:ow0 + ww] = res[g][:hh, :ww]
            writes[b, g * n + c, oh0:oh0 + hh, ow0:ow0 + ww] += 1
    assert (writes == 1).all()
    return out


# (B, n, H, W, rates, stride, v2, tile): odd sizes, maps smaller than one
# tile, stride 2, k = 1..4, v2 on and off; tile None is the chooser's pick
EMULATED = [
    (2, 3, 13, 21, (1, 2, 3, 4), 1, True, None),
    (2, 3, 13, 21, (1, 2, 3, 4), 2, True, None),
    (2, 3, 13, 21, (1, 1, 2, 3), 1, False, None),
    (1, 2, 5, 7, (1, 1, 2, 3), 1, True, None),
    (1, 2, 5, 7, (1, 2, 3, 4), 2, False, None),
    (1, 2, 37, 45, (1, 1, 1, 1), 1, True, (32, 32)),
    (1, 2, 70, 45, (1, 1, 1, 1), 1, False, (64, 32)),
    (1, 2, 67, 70, (1, 2, 3, 4), 2, True, (32, 32)),
    (1, 2, 40, 33, (4,), 2, False, (16, 16)),
    (2, 2, 19, 18, (2, 3), 1, True, (8, 16)),
    (1, 3, 18, 30, (1, 3, 2), 1, True, None),
    (1, 3, 18, 30, (4, 1, 1), 2, False, None),
]


@pytest.mark.parametrize('B,n,H,W,rates,stride,v2,tile', EMULATED)
def test_pyramid_emulation_matches_plain(rng, B, n, H, W, rates, stride, v2,
                                         tile):
    k = len(rates)
    red = _t(rng.standard_normal((B, n, H, W)))
    dw1 = _t(rng.standard_normal((k, n, 3, 3)) * 0.3)
    dw2 = _t(rng.standard_normal((k, n, 3, 3)) * 0.3) if v2 else None
    geo = (pyramid_geometry(B, H, W, n, k, rates, stride, v2) if tile is None
           else _geometry(rates, stride, v2, *tile))
    emu = emulate_pyramid(red, dw1, dw2, rates, stride, geo)
    ref = sesp_pyramid_plain(red, dw1, dw2, rates, stride)
    assert emu.shape == ref.shape
    assert rel_err(emu.numpy(), ref.numpy()) <= 1e-6


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
        'sesp_pyramid': lambda: sesp_pyramid(
            torch.zeros(1, 2, 8, 8), torch.zeros(4, 2, 3, 3), None,
            (1, 2, 3, 4), impl='cuda'),
    }


@pytest.mark.parametrize('op', ['normalize_image', 'stem_convs', 'basic_pair',
                                'sesp_block', 'sesp_pyramid'])
def test_cuda_impl_on_cpu_tensor_raises(op):
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        _cpu_calls()[op]()
