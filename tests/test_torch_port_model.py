"""PyTorch port: the whole inference slice against ``lednet_tpu`` on the CPU.

Both packages load the flagship config
(``configs/LED_Net/lednet_80k_cityscapes-1024x1024.py``) cut to a test size
(LEDNet channels 8, ppm_channels 32, head 32->16, 2 classes); the port gets
the flax model's random weights and BatchNorm running stats through
``lednet_tpu_torch.convert``.  ``out_dtype`` is overridden to float32: with
bfloat16 the JAX eval stem casts its folded weights to bfloat16
(``lednet.py:115-116``) and the comparison would measure rounding rather than
the algorithm.  Pass: max|port - jax| <= 1e-4 * max|jax| over the logits and
argmax agreement >= 99.9%, at 128x128 and at the odd 100x156 (ceil sizing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lednet_tpu.config import Config as JConfig
from lednet_tpu.registry import MODELS as JMODELS
from lednet_tpu_torch.apis import inference_model, init_model
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import save_npz_variables
from test_torch_port_common import (FLAGSHIP, jax_variables, load_port, nchw,
                                    random_variables, rel_err)

SMALL = {'model.backbone.channels': 8, 'model.backbone.ppm_channels': 32,
         'model.decode_head.in_channels': 32, 'model.decode_head.channels': 16,
         'model.decode_head.num_classes': 2}
F32 = dict(SMALL, **{'model.data_preprocessor.out_dtype': 'float32'})
SHAPES = [(128, 128), (100, 156)]


def _images(shape, n=1, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape + (3,),
                                                dtype=np.uint8)


@pytest.fixture(scope='module')
def pair():
    import lednet_tpu
    lednet_tpu.register_all_modules()
    jcfg = JConfig.fromfile(FLAGSHIP)
    jcfg.merge_from_dict(F32)
    jmodel = JMODELS.build(dict(jcfg.model))
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    params, stats = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)),
                                     seed=3, train=False)
    variables = jax_variables(params, stats)
    jpredict = jax.jit(lambda v, x: jmodel.apply(v, x, method='predict'))

    def jax_logits(imgs):
        x, _, _ = jpre(jnp.asarray(imgs), None, training=False)
        return np.asarray(jpredict(variables, x))

    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(F32)
    model = init_model(cfg, device='cpu')
    load_port(model, params, stats)
    return dict(jax_logits=jax_logits, model=model, params=params, stats=stats,
                cfg=cfg)


def _port_logits(model, imgs, impl=None):
    with torch.no_grad():
        x, _, _ = model.data_preprocessor(torch.from_numpy(imgs), impl=impl)
        return model.predict(x, impl).numpy()


@pytest.mark.parametrize('shape', SHAPES)
def test_predict_matches_jax(pair, shape):
    imgs = _images(shape, n=2)
    ref = pair['jax_logits'](imgs)
    out = _port_logits(pair['model'], imgs)
    assert out.shape == ref.shape == (2,) + shape + (2,)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= 1e-4
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.999, agree


@pytest.mark.parametrize('shape', SHAPES)
def test_kernel_stem_glue_matches_module_stem(pair, shape):
    """The stem's kernel path (BatchNorm folded into kernels B and C, run by
    their plain versions) against the module form, inside the port."""
    bb = pair['model'].backbone
    x = nchw(np.random.default_rng(1).standard_normal((1,) + shape + (3,)))
    with torch.no_grad():
        kernel = bb.kernel_stem(x, 'plain')
        module = bb.module_stem(x)
    for a, b in zip(kernel, module):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), b.numpy()) < 1e-5


def test_preprocessor_bfloat16_bit_exact():
    """The flagship's bf16 preprocessing, unchanged config, both packages."""
    import lednet_tpu
    lednet_tpu.register_all_modules()
    from lednet_tpu_torch.models.data_preprocessor import SegDataPreProcessor
    jcfg = JConfig.fromfile(FLAGSHIP)
    jpre = JMODELS.build(dict(jcfg.model.data_preprocessor))
    pre = SegDataPreProcessor(**dict(Config.fromfile(FLAGSHIP).model.data_preprocessor))
    imgs = _images((32, 48), n=2, seed=5)
    ref, _, _ = jpre(jnp.asarray(imgs), None, training=False)
    out, _, pad = pre(torch.from_numpy(imgs))
    assert out.dtype == torch.bfloat16 and pad == (0, 0)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_init_model_loads_npz_checkpoint(pair, tmp_path):
    path = str(tmp_path / 'lednet_small.npz')
    save_npz_variables(path, pair['params'], pair['stats'])
    model = init_model(pair['cfg'], checkpoint=path, device='cpu')
    imgs = _images((64, 64), seed=2)
    np.testing.assert_array_equal(_port_logits(model, imgs),
                                  _port_logits(pair['model'], imgs))


def test_inference_model_crops_padding(pair):
    """An odd-sized BGR image goes through padding to /32 and back."""
    img = _images((100, 156), seed=4)[0]
    res = inference_model(pair['model'], img)
    assert res['pred_sem_seg'].shape == (100, 156)
    assert res['seg_logits'].shape == (100, 156, 2)
    assert np.isfinite(res['seg_logits']).all()
    np.testing.assert_array_equal(res['pred_sem_seg'],
                                  res['seg_logits'].argmax(-1))
    assert res['metainfo']['ori_shape'] == (100, 156)


def test_inference_model_runs_in_float32_and_restores_flags(pair,
                                                            monkeypatch):
    """``inference_model`` runs the model with TF32 off (cuDNN's default
    float32 convs in TF32 change the flagship's logits by more than the
    1e-3 bound on the card) and gives the caller's flags back."""
    seen = []
    model = pair['model']
    predict = model.predict

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return predict(*args, **kw)
    monkeypatch.setattr(model, 'predict', spy)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        inference_model(model, _images((64, 64), seed=5)[0])
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
