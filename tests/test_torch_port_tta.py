"""PyTorch port: the Apple Branch slice's data and merge pieces against
``lednet_tpu`` on the CPU.

- ``native.fused_resize_crop_flip`` equals ``lednet_tpu.native``'s
  function bit for bit (bilinear and nearest, flips, crops at the edges,
  1 and 3 channels, up- and down-scales).
- ``FusedRandomResizeCropFlip`` given ``RandomState(s)`` equals the JAX
  transform after ``np.random.seed(s)``: image, labels and metas exact, its
  ``cat_max_ratio`` re-draw loop included (sparse branch labels make it
  re-draw).
- ``TestTimeAug`` on a JPEG of the fabricated branch tree gives the JAX
  package's 12 views (inputs, labels, metas) exactly, and ``collate`` the
  JAX collate's batch.
- ``postprocess_logits`` (no flip, horizontal and vertical flips, 1 and 2
  channels, with and without the resize to ``ori_shape``) and
  ``merge_tta_probs`` (1 and 2 channels) within 1e-6 of JAX's, relative
  to JAX's largest value (the bilinear resize rounds differently: 5e-6 on
  logits of magnitude 10), predictions equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lednet_tpu.datasets  # noqa: F401  (registers the JAX transforms)
from lednet_tpu import native as jnative
from lednet_tpu.config import Config as JConfig
from lednet_tpu.datasets import basesegdataset as jds
from lednet_tpu.datasets import loader as jloader
from lednet_tpu.datasets.transforms import fused as jfused
from lednet_tpu.models.segmentors import encoder_decoder as jed
from lednet_tpu.models.segmentors import seg_tta as jtta
from lednet_tpu_torch import native
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.datasets import basesegdataset as ds
from lednet_tpu_torch.datasets import loader
from lednet_tpu_torch.datasets.synthetic import branch_frame, make_branch_tree
from lednet_tpu_torch.datasets.transforms.fused import FusedRandomResizeCropFlip
from lednet_tpu_torch.models.segmentors.encoder_decoder import postprocess_logits
from lednet_tpu_torch.models.segmentors.seg_tta import merge_tta_probs
from test_torch_port_common import REPO, rel_err
from test_torch_port_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

BRANCH = f'{REPO}/configs/LED_Net/lednet_80k_branch-512x1024.py'
MERGE_TOL = 1e-6


def test_fused_resize_crop_flip_bit_exact_with_jax():
    rng = np.random.default_rng(0)
    for _ in range(400):
        sh, sw = rng.integers(1, 80, 2)
        c = int(rng.choice([1, 3]))
        src = rng.integers(0, 256, (sh, sw, c) if c == 3 else (sh, sw), dtype=np.uint8)
        rh, rw = (int(v) for v in rng.integers(1, 160, 2))
        ch, cw = int(rng.integers(1, rh + 1)), int(rng.integers(1, rw + 1))
        cy, cx = int(rng.integers(0, rh - ch + 1)), int(rng.integers(0, rw - cw + 1))
        flip, nearest = bool(rng.integers(2)), bool(rng.integers(2))
        args = (src, (rh, rw), (cy, cx), (ch, cw), flip, nearest)
        np.testing.assert_array_equal(native.fused_resize_crop_flip(*args),
                                      jnative.fused_resize_crop_flip(*args))
    with pytest.raises(ValueError, match='does not fit'):
        native.fused_resize_crop_flip(src, (4, 4), (1, 0), (4, 4), False)


def _branch_sample(seed, hw=(270, 480)):
    img, labels = branch_frame(np.random.default_rng(seed), hw)
    return dict(img=img, gt_seg_map=labels, seg_fields=['gt_seg_map'],
                img_shape=hw, ori_shape=hw)


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 7])
def test_fused_transform_matches_jax(seed):
    kw = dict(scale=(2048, 512), crop_size=(256, 256), ratio_range=(0.5, 2.0),
              cat_max_ratio=0.75, flip_prob=0.5)
    sample = _branch_sample(seed)
    got = FusedRandomResizeCropFlip(**kw)(dict(sample, seg_fields=['gt_seg_map']),
                                          np.random.RandomState(seed))
    np.random.seed(seed)
    want = jfused.FusedRandomResizeCropFlip(**kw)(dict(sample, seg_fields=['gt_seg_map']))
    for key in ('img', 'gt_seg_map'):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ('img_shape', 'scale_factor', 'flip', 'flip_direction'):
        assert got[key] == want[key], key


def test_fused_transform_redraws_like_jax():
    """A crop that lands on background only is drawn again: with the label
    map all background but a corner, the loop runs to its limit in both."""
    sample = _branch_sample(11)
    sample['gt_seg_map'] = np.zeros_like(sample['gt_seg_map'])
    sample['gt_seg_map'][:4, :4] = 1
    kw = dict(scale=(512, 256), crop_size=(64, 64), cat_max_ratio=0.75)
    for seed in range(4):
        rs = np.random.RandomState(seed)
        got = FusedRandomResizeCropFlip(**kw)(dict(sample, seg_fields=['gt_seg_map']), rs)
        np.random.seed(seed)
        want = jfused.FusedRandomResizeCropFlip(**kw)(dict(sample, seg_fields=['gt_seg_map']))
        np.testing.assert_array_equal(got['img'], want['img'])
        # both generators are at the same point: the same number of draws
        assert rs.randint(1 << 30) == np.random.randint(1 << 30)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return make_branch_tree(str(tmp_path_factory.mktemp('branch')), 1, 1,
                            size_hw=(90, 150), portrait_hw=(120, 90), seed=3)


@pytest.mark.parametrize('index', [0, 1])
def test_test_time_aug_views_and_collate_match_jax(tree, index):
    """The config's ``tta_pipeline`` on a landscape frame and on the portrait
    frame (EXIF orientation 6) of the fabricated tree."""
    kw = dict(data_root=tree, ann_file='val.txt', img_suffix='.jpg',
              data_prefix=dict(img_path='JPEGImages', seg_map_path='SegmentationClassPNG'))
    port = ds.PascalVOCDataset(pipeline=Config.fromfile(BRANCH).tta_pipeline, **kw)
    jax_ds = jds.PascalVOCDataset(pipeline=JConfig.fromfile(BRANCH).tta_pipeline, **kw)
    got = port.prepare(index, np.random.RandomState(0))['tta_views']
    np.random.seed(0)
    want = jax_ds[index]['tta_views']
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['inputs'], w['inputs'])
        np.testing.assert_array_equal(g['gt_seg_map'], w['gt_seg_map'])
        assert g['metainfo'] == w['metainfo']
    assert [v['metainfo']['flip'] for v in got] == [False, True] * 6
    assert got[-1]['inputs'].shape[0] > 1.7 * got[0]['metainfo']['ori_shape'][0]
    batch, jbatch = loader.collate([{'tta_views': got}]), jloader.collate([{'tta_views': want}])
    assert batch['metainfo'] == jbatch['metainfo']
    np.testing.assert_array_equal(batch['gt_seg_map'], jbatch['gt_seg_map'])
    assert batch['tta_views'] is got
    with pytest.raises(ValueError, match='batch size 1'):
        loader.collate([{'tta_views': got}] * 2)


def _logits(shape, seed):
    return (3.0 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize('channels', [1, 2])
@pytest.mark.parametrize('flip', [None, 'horizontal', 'vertical'])
@pytest.mark.parametrize('ori_shape', [None, (45, 61)])
def test_postprocess_logits_matches_jax(channels, flip, ori_shape):
    x = _logits((2, 40, 56, channels), seed=channels)
    kw = dict(ori_shape=ori_shape, flip=flip is not None,
              flip_direction=flip or 'horizontal', out_channels=channels,
              threshold=0.3)
    want_logits, want_pred = jed.postprocess_logits(jnp.asarray(x), (8, 8), **kw)
    got_logits, got_pred = postprocess_logits(torch.from_numpy(x), (8, 8), **kw)
    assert got_logits.shape == want_logits.shape
    assert rel_err(got_logits.numpy(), want_logits) <= MERGE_TOL
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
    assert got_pred.dtype == torch.int32


@pytest.mark.parametrize('channels', [1, 2])
def test_merge_tta_probs_matches_jax(channels):
    views = [_logits((30, 42, channels), seed=10 + i) for i in range(12)]
    want_mean, want_pred = jtta.merge_tta_probs([jnp.asarray(v) for v in views])
    got_mean, got_pred = merge_tta_probs([torch.from_numpy(v) for v in views])
    assert rel_err(got_mean.numpy(), want_mean) <= MERGE_TOL
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
