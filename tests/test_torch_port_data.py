"""PyTorch port: the data pipeline and ``IoUMetric`` against ``lednet_tpu``
and cv2/PIL on the CPU.

- PNG codec (``lednet_tpu_torch.datasets.imageio``): files written by
  ``cv2.imwrite`` and by PIL decode exactly as ``cv2.imread`` and
  ``np.array(PIL.Image.open(...))`` read them (BGR, gray, BGRA, gray +
  alpha, palette -> indices at 8 and 4 bits); files of the port's encoder
  with each of the five row filters read back exactly, by cv2 too; the
  host library's unfilter equals its numpy reference.
- Host library (``lednet_tpu_torch.native``): the bilinear and nearest
  resize equal ``cv2.resize`` exactly (measured: bit-exact at every shape
  tried, the exact 2x reduction included), and equal their numpy
  references; BGR->HSV equals cv2 exactly; HSV->BGR is within 1 level of
  cv2 with at least 99.9% of values exact (measured: all exact; it is
  float arithmetic, with the truncating vector body of cv2 in blocks of 32
  pixels and a rounding tail), and equals its numpy reference exactly.
  Threads that reach its build together build it once.
- Transforms: the port's given ``np.random.RandomState(s)`` against the JAX
  package's after ``np.random.seed(s)``, over several seeds.  RandomCrop (its
  redraw loop too), RandomFlip and PackSegInputs exact; Resize and
  RandomResize exact shapes, labels and images; PhotoMetricDistortion with
  each branch forced: brightness and contrast exact, saturation and hue
  within 1 level and at least 99.9% exact.
- Dataset and loader: ``CityscapesDataset`` on a fabricated two-city tree
  gives the JAX ``data_list``; its items through the train pipeline match
  JAX's per sample within the bounds above; the samplers give the JAX index
  streams for each seed, rank and world size; ``collate`` is exact; the
  loader gives the same batches at 1 and 4 workers.
- ``IoUMetric`` against JAX's on the same random predictions and labels
  (255s and out-of-range labels included): metrics within 1e-9, the same
  ``table()``.
"""
import itertools
import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import lednet_tpu.datasets  # noqa: F401  (registers the JAX transforms)
from lednet_tpu.datasets import basesegdataset as jds
from lednet_tpu.datasets import loader as jloader
from lednet_tpu.datasets.transforms import formatting as jfmt
from lednet_tpu.datasets.transforms import transforms as jtf
from lednet_tpu.evaluation.iou_metric import IoUMetric as JIoUMetric
from lednet_tpu_torch import native
from lednet_tpu_torch.datasets import imageio
from lednet_tpu_torch.datasets import basesegdataset as ds
from lednet_tpu_torch.datasets import loader
from lednet_tpu_torch.datasets.synthetic import fake_frame, make_cityscapes_tree
from lednet_tpu_torch.datasets.transforms import formatting as fmt
from lednet_tpu_torch.datasets.transforms import transforms as tf
from lednet_tpu_torch.evaluation import IoUMetric
from lednet_tpu_torch.native import reference

SEEDS = (0, 1, 2, 3, 7)
HSV_MAX_DIFF = 1            # HSV->BGR against cv2: levels
HSV_MIN_EXACT = 0.999       # and the share of exact values


def _img(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c) if c else (h, w), dtype=np.uint8)


def _assert_hsv_close(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= HSV_MAX_DIFF
    assert (diff == 0).mean() >= HSV_MIN_EXACT


# ------------------------------------------------------------------ PNG codec
@pytest.mark.parametrize('filter_type', range(5))
@pytest.mark.parametrize('channels', [0, 2, 3, 4])
def test_png_encoder_filters_round_trip(tmp_path, filter_type, channels):
    rng = np.random.default_rng(filter_type * 10 + channels)
    img = _img(rng, 23, 37, channels)
    path = str(tmp_path / 'x.png')
    with open(path, 'wb') as f:
        f.write(imageio.encode_png(img, filter_type=filter_type))
    pixels, palette = imageio.decode_png(open(path, 'rb').read())
    assert palette is None
    np.testing.assert_array_equal(pixels, img)
    # cv2 reads the port's files as the port does
    np.testing.assert_array_equal(imageio.imread(path, 'unchanged'),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(imageio.imread(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize('channels', [0, 3, 4])
def test_png_files_of_cv2_decode_as_cv2_and_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = _img(rng, 61, 90, channels)
    # a smooth ramp plus noise makes libpng's adaptive filter pick every type
    ramp = np.arange(90, dtype=np.uint8).reshape((1, 90) + (1,) * (img.ndim - 2))
    img = img // 4 + ramp
    path = str(tmp_path / 'cv.png')
    cv2.imwrite(path, img)
    for flag, cv_flag in (('color', cv2.IMREAD_COLOR),
                          ('unchanged', cv2.IMREAD_UNCHANGED)):
        np.testing.assert_array_equal(imageio.imread(path, flag),
                                      cv2.imread(path, cv_flag))
    if not channels:
        np.testing.assert_array_equal(imageio.imread(path, 'grayscale'),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    with Image.open(path) as im:
        np.testing.assert_array_equal(imageio.imread_pil(path), np.array(im))


@pytest.mark.parametrize('n_colors', [5, 200])
def test_png_palette_of_pil_reads_as_indices(tmp_path, n_colors):
    """A PIL palette PNG (bit depth 4 for 5 colors, 8 for 200) reads as its
    indices like PIL, and expanded to BGR like cv2."""
    rng = np.random.default_rng(n_colors)
    idx = rng.integers(0, n_colors, (45, 67), dtype=np.uint8)
    im = Image.fromarray(idx, 'P')
    im.putpalette(rng.integers(0, 256, 3 * n_colors).tolist())
    path = str(tmp_path / 'pal.png')
    im.save(path)
    with Image.open(path) as im2:
        np.testing.assert_array_equal(imageio.imread_pil(path), np.array(im2))
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))


def test_png_gray_alpha_and_port_palette(tmp_path):
    rng = np.random.default_rng(5)
    ga = _img(rng, 20, 30, 2)
    path = str(tmp_path / 'ga.png')
    with open(path, 'wb') as f:
        f.write(imageio.encode_png(ga, filter_type=4))
    with Image.open(path) as im:
        np.testing.assert_array_equal(imageio.imread_pil(path), np.array(im))
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))
    idx = rng.integers(0, 7, (20, 30), dtype=np.uint8)
    pal = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    with open(path, 'wb') as f:
        f.write(imageio.encode_png(idx, palette=pal, filter_type=3))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.array(im), idx)
    np.testing.assert_array_equal(imageio.imread_pil(path), idx)
    np.testing.assert_array_equal(imageio.imread(path), pal[idx][..., ::-1])


def test_imwrite_round_trips_bgr_and_rejects_corruption(tmp_path):
    rng = np.random.default_rng(9)
    img = _img(rng, 31, 17)
    path = str(tmp_path / 'w.png')
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    data = bytearray(open(path, 'rb').read())
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match='CRC'):
        imageio.decode_png(bytes(data))
    with pytest.raises(FileNotFoundError):
        imageio.imread(str(tmp_path / 'missing.png'))


def test_native_build_is_safe_across_threads(tmp_path, monkeypatch):
    """The loader's threads reach the host library's build together at
    their first sample: one builds, the others find its result (a compiler
    that takes a while makes the threads overlap)."""
    import subprocess
    import threading
    import time

    def slow_compiler(cmd, **kw):
        with open(cmd[cmd.index('-o') + 1], 'wb') as f:
            f.write(b'lib')
        time.sleep(0.2)         # the compiler's output is written; it exits
        return subprocess.CompletedProcess(cmd, 0, '', '')
    monkeypatch.setattr(native, 'BUILD_ROOT', tmp_path)
    monkeypatch.setattr(native.subprocess, 'run', slow_compiler)
    results = []

    def build():
        try:
            results.append(native.build())
        except Exception as e:      # collected, then held below
            results.append(e)
    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(results)) == 1 and isinstance(results[0], os.PathLike), results
    assert [p.name for p in tmp_path.rglob('*') if p.is_file()] == [native.LIB_NAME]


@pytest.mark.parametrize('bpp', [1, 3, 4])
def test_unfilter_matches_reference(bpp):
    rng = np.random.default_rng(bpp)
    h, rowbytes = 9, 7 * bpp
    rows = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    rows[:, 0] = np.arange(h) % 5
    raw = rows.tobytes()
    np.testing.assert_array_equal(native.png_unfilter(raw, h, rowbytes, bpp),
                                  reference.png_unfilter(raw, h, rowbytes, bpp))
    rows[3, 0] = 9
    with pytest.raises(ValueError, match='row 3'):
        native.png_unfilter(rows.tobytes(), h, rowbytes, bpp)


# --------------------------------------------------------------- host library
RESIZE_CASES = [((37, 53), (96, 64), 3), ((100, 150), (301, 77), 3),
                ((64, 64), (33, 200), 1), ((128, 128), (64, 64), 3),
                ((50, 60), (60, 50), 3), ((20, 30), (7, 11), 2),
                ((1, 5), (9, 3), 3), ((128, 256), (300, 150), 0)]


@pytest.mark.parametrize('src_hw,dst_wh,c', RESIZE_CASES)
def test_resize_matches_cv2_exactly(src_hw, dst_wh, c):
    rng = np.random.default_rng(sum(src_hw) + c)
    img = _img(rng, *src_hw, c)
    for interp, ours, ref in (
            (cv2.INTER_LINEAR, native.resize_linear, reference.resize_linear),
            (cv2.INTER_NEAREST, native.resize_nearest, reference.resize_nearest)):
        want = cv2.resize(img, dst_wh, interpolation=interp)
        if img.ndim == 3 and c == 1:
            want = want[..., None]
        got = ours(img, dst_wh)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ref(img, dst_wh), got)


def test_hsv_conversions_against_cv2_and_reference():
    rng = np.random.default_rng(0)
    img = _img(rng, 40, 101)      # 3 vector blocks of 32 and a tail of 5
    hsv = native.bgr2hsv(img)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    np.testing.assert_array_equal(hsv, reference.bgr2hsv(img))
    # every (H, S, V) at one V per row: body and tail both see all of them
    h, s = np.meshgrid(np.arange(180), np.arange(256), indexing='ij')
    grid = np.stack([h.ravel(), s.ravel(),
                     rng.integers(0, 256, h.size)], -1).astype(np.uint8)
    for width in (32 * 9, 37):
        x = grid[:grid.shape[0] // width * width].reshape(-1, width, 3)
        got = native.hsv2bgr(x)
        _assert_hsv_close(got, cv2.cvtColor(x, cv2.COLOR_HSV2BGR))
        np.testing.assert_array_equal(got, reference.hsv2bgr(x))


# ----------------------------------------------------------------- transforms
def _results(rng, h=96, w=160, classes=5, img=None, seg=None):
    img = _img(rng, h, w) if img is None else img
    seg = rng.integers(0, classes, (h, w)).astype(np.uint8) if seg is None else seg
    return dict(img=img, gt_seg_map=seg, seg_fields=['gt_seg_map'],
                img_shape=(h, w), ori_shape=(h, w), img_path='a.png',
                seg_map_path='a_gt.png', sample_idx=3, reduce_zero_label=False)


def _copy(results):
    return {k: (v.copy() if isinstance(v, np.ndarray) else
                list(v) if isinstance(v, list) else v) for k, v in results.items()}


def _jax_then_port(jax_t, port_t, results, seed):
    np.random.seed(seed)
    want = jax_t(_copy(results))
    got = port_t(_copy(results), np.random.RandomState(seed))
    return want, got


def _assert_same(want, got, img_exact=True):
    assert set(want) == set(got)
    for k in want:
        if k == 'img' and not img_exact:
            assert want[k].shape == got[k].shape
            _assert_hsv_close(got[k], want[k])
        elif isinstance(want[k], np.ndarray):
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert want[k] == got[k], k


@pytest.mark.parametrize('seed', SEEDS)
def test_random_crop_and_its_redraw_match_jax(seed):
    rng = np.random.default_rng(seed)
    # one class over most of the map: most crops are redrawn, some up to 10x
    seg = np.zeros((96, 160), np.uint8)
    seg[60:, 120:] = rng.integers(1, 4, (36, 40))
    seg[rng.random(seg.shape) < 0.05] = 255
    for cat_max_ratio in (0.75, 1.0):
        want, got = _jax_then_port(
            jtf.RandomCrop((48, 64), cat_max_ratio=cat_max_ratio),
            tf.RandomCrop((48, 64), cat_max_ratio=cat_max_ratio),
            _results(rng, seg=seg), seed)
        _assert_same(want, got)
    # crops larger than the image clip to it
    want, got = _jax_then_port(jtf.RandomCrop((128, 64), 0.75),
                               tf.RandomCrop((128, 64), 0.75),
                               _results(rng), seed)
    _assert_same(want, got)


@pytest.mark.parametrize('seed', SEEDS)
def test_random_flip_and_pack_match_jax(seed):
    rng = np.random.default_rng(seed)
    for prob, direction in ((0.5, 'horizontal'), (0.5, 'vertical'),
                            (1.0, 'horizontal'), (None, 'horizontal')):
        want, got = _jax_then_port(jtf.RandomFlip(prob, direction),
                                   tf.RandomFlip(prob, direction),
                                   _results(rng), seed)
        _assert_same(want, got)
        packed_want = jfmt.PackSegInputs()(_copy(want))
        packed = fmt.PackSegInputs()(_copy(got))
        _assert_same({k: v for k, v in packed_want.items() if k != 'metainfo'},
                     {k: v for k, v in packed.items() if k != 'metainfo'})
        assert packed['metainfo'] == packed_want['metainfo']


@pytest.mark.parametrize('seed', SEEDS)
def test_resize_and_random_resize_match_jax(seed):
    rng = np.random.default_rng(seed)
    for jt, pt in ((jtf.Resize(scale=(256, 128), keep_ratio=True),
                    tf.Resize(scale=(256, 128), keep_ratio=True)),
                   (jtf.Resize(scale=(100, 70)), tf.Resize(scale=(100, 70))),
                   (jtf.Resize(scale_factor=0.5, keep_ratio=True),
                    tf.Resize(scale_factor=0.5, keep_ratio=True)),
                   (jtf.RandomResize((320, 160), (0.5, 2.0)),
                    tf.RandomResize((320, 160), (0.5, 2.0)))):
        want, got = _jax_then_port(jt, pt, _results(rng, 90, 150), seed)
        _assert_same(want, got)


def _coin_seed(first_draw_is_one: bool) -> int:
    """The first seed whose first ``randint(2)`` is 1 (or 0)."""
    return next(s for s in itertools.count()
                if np.random.RandomState(s).randint(2) == int(first_draw_is_one))


@pytest.mark.parametrize('branch', ['_brightness', '_contrast', '_saturation',
                                    '_hue'])
def test_photometric_branches_forced_match_jax(branch):
    rng = np.random.default_rng(1)
    img = _img(rng, 64, 100)
    jt, pt = jtf.PhotoMetricDistortion(), tf.PhotoMetricDistortion()
    for taken in (True, False):
        seed = _coin_seed(taken)
        np.random.seed(seed)
        want = getattr(jt, branch)(img.copy())
        got = getattr(pt, branch)(img.copy(), np.random.RandomState(seed))
        if branch in ('_brightness', '_contrast') or not taken:
            np.testing.assert_array_equal(got, want)
        else:
            assert not np.array_equal(got, img)
            _assert_hsv_close(got, want)


@pytest.mark.parametrize('seed', SEEDS)
def test_photometric_distortion_matches_jax(seed):
    rng = np.random.default_rng(seed)
    want, got = _jax_then_port(jtf.PhotoMetricDistortion(),
                               tf.PhotoMetricDistortion(),
                               _results(rng, 64, 100), seed)
    _assert_same(want, got, img_exact=False)


def test_random_transforms_need_a_generator():
    rng = np.random.default_rng(0)
    for t in (tf.RandomCrop((8, 8)), tf.RandomFlip(0.5),
              tf.RandomResize((64, 32)), tf.PhotoMetricDistortion()):
        with pytest.raises(ValueError, match='RandomState'):
            t(_results(rng))


# ----------------------------------------------------------- dataset, loader
@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('cityscapes'))
    return make_cityscapes_tree(root, n_train=5, n_val=2, size_hw=(96, 192),
                                cities=('bonn', 'aachen'), seed=3)


TRAIN_PIPELINE = [
    dict(type='LoadImageFromFile'), dict(type='LoadAnnotations'),
    dict(type='RandomResize', scale=(192, 96), ratio_range=(0.5, 2.0),
         keep_ratio=True),
    dict(type='RandomCrop', crop_size=(64, 64), cat_max_ratio=0.75),
    dict(type='RandomFlip', prob=0.5), dict(type='PhotoMetricDistortion'),
    dict(type='PackSegInputs')]


def _datasets(tree, split='train', pipeline=TRAIN_PIPELINE):
    kw = dict(data_root=tree, data_prefix=dict(img_path=f'leftImg8bit/{split}',
                                               seg_map_path=f'gtFine/{split}'),
              pipeline=pipeline)
    return jds.CityscapesDataset(**kw), ds.CityscapesDataset(**kw)


def test_fake_tree_is_a_cityscapes_tree(tree):
    img, lbl = fake_frame(np.random.default_rng(0), (64, 128))
    assert img.shape == (64, 128, 3) and img.dtype == np.uint8
    assert set(np.unique(lbl)) <= set(range(19)) | {255}
    assert 0.01 < (lbl == 255).mean() < 0.03
    names = sorted(os.listdir(osp.join(tree, 'leftImg8bit', 'train')))
    assert names == ['aachen', 'bonn']
    first = sorted(os.listdir(osp.join(tree, 'gtFine', 'val', 'bonn')))[0]
    assert first.endswith('_gtFine_labelTrainIds.png')
    assert cv2.imread(osp.join(tree, 'gtFine', 'val', 'bonn', first),
                      cv2.IMREAD_UNCHANGED).ndim == 2


def test_cityscapes_dataset_lists_like_jax(tree):
    for split in ('train', 'val'):
        jset, pset = _datasets(tree, split)
        assert pset.data_list == jset.data_list
        assert pset.metainfo == jset.metainfo
        assert len(pset) == {'train': 5, 'val': 2}[split]
    voc = dict(data_root=tree, data_prefix=dict(img_path='leftImg8bit/val'))
    assert ds.PascalVOCDataset(img_suffix='.png', **voc).data_list == \
        jds.PascalVOCDataset(img_suffix='.png', **voc).data_list
    assert ds.PascalVOCDataset(**voc).metainfo == jds.PascalVOCDataset(**voc).metainfo


@pytest.mark.parametrize('seed', (0, 4))
def test_cityscapes_items_match_jax(tree, seed):
    jset, pset = _datasets(tree)
    for idx in range(len(pset)):
        np.random.seed(seed + idx)
        want = jset[idx]
        got = pset.prepare(idx, np.random.RandomState(seed + idx))
        np.testing.assert_array_equal(got['gt_seg_map'], want['gt_seg_map'])
        assert got['inputs'].shape == want['inputs'].shape
        _assert_hsv_close(got['inputs'], want['inputs'])
        assert got['metainfo'] == want['metainfo']
    # the test pipeline draws nothing: exact
    test_pipeline = [dict(type='LoadImageFromFile'),
                     dict(type='Resize', scale=(256, 128), keep_ratio=True),
                     dict(type='LoadAnnotations'), dict(type='PackSegInputs')]
    jset, pset = _datasets(tree, 'val', test_pipeline)
    for idx in range(len(pset)):
        want, got = jset[idx], pset[idx]
        for key in ('inputs', 'gt_seg_map'):
            np.testing.assert_array_equal(got[key], want[key])
        assert got['metainfo'] == want['metainfo']


@pytest.mark.parametrize('seed,rank,world', [(0, 0, 1), (3, 0, 2), (3, 1, 2),
                                             (5, 2, 3)])
def test_samplers_match_jax(seed, rank, world):
    for shuffle in (True, False):
        want = jloader.InfiniteSampler(7, shuffle, seed, rank, world)
        got = loader.InfiniteSampler(7, shuffle, seed, rank, world)
        assert list(itertools.islice(got, 30)) == list(itertools.islice(want, 30))
        want = jloader.DefaultSampler(7, shuffle, seed, rank, world)
        got = loader.DefaultSampler(7, shuffle, seed, rank, world)
        assert list(got) == list(want) and len(got) == len(want)


def test_collate_matches_jax():
    rng = np.random.default_rng(0)
    items = [dict(inputs=_img(rng, h, w), gt_seg_map=rng.integers(0, 5, (h, w), dtype=np.int32),
                  metainfo=dict(sample_idx=i))
             for i, (h, w) in enumerate([(32, 40), (32, 40), (20, 40), (32, 17)])]
    for batch in (items[:2], items):
        want, got = jloader.collate(batch), loader.collate(batch)
        assert set(got) == set(want)
        for key in ('inputs', 'gt_seg_map'):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        assert got['metainfo'] == want['metainfo']
        out = {}
        into = loader.collate(batch, lambda k, s, d: out.setdefault(k, np.full(s, 7, d)))
        for key in ('inputs', 'gt_seg_map'):
            assert into[key] is out[key]
            np.testing.assert_array_equal(into[key], want[key])


def test_loader_batches_do_not_depend_on_workers(tree):
    _, pset = _datasets(tree)

    def batches(workers):
        dl = loader.DataLoader(pset, batch_size=2, num_workers=workers,
                               sampler=loader.InfiniteSampler(len(pset), seed=1),
                               prefetch=2, seed=11)
        return list(itertools.islice(dl, 4))
    one, four = batches(1), batches(4)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a['inputs'], b['inputs'])
        np.testing.assert_array_equal(a['gt_seg_map'], b['gt_seg_map'])
        assert a['metainfo'] == b['metainfo']
    # each sample's generator follows its position in the stream
    idx = one[0]['metainfo'][1]['sample_idx']
    solo = pset.prepare(idx, loader.sample_rng(11, 1))
    np.testing.assert_array_equal(one[0]['inputs'][1], solo['inputs'])


def test_loader_surfaces_worker_errors_and_finite_epochs(tree):
    _, pset = _datasets(tree)
    dl = loader.build_dataloader(dict(
        batch_size=2, num_workers=2, sampler=dict(type='DefaultSampler'),
        dataset=dict(type='CityscapesDataset', data_root=tree,
                     data_prefix=dict(img_path='leftImg8bit/train',
                                      seg_map_path='gtFine/train'),
                     pipeline=TRAIN_PIPELINE)))
    assert [len(b['metainfo']) for b in dl] == [2, 2, 1] and len(dl) == 3
    pset.data_list[2]['img_path'] += '.missing'
    bad = loader.DataLoader(pset, batch_size=2, num_workers=2)
    with pytest.raises(FileNotFoundError):
        list(bad)
    with pytest.raises(ValueError, match='CUDA'):
        loader.DevicePrefetcher(bad, 'cpu')


# ------------------------------------------------------------------ IoUMetric
@pytest.mark.parametrize('seed', (0, 1, 2))
def test_iou_metric_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_classes = 6
    kw = dict(iou_metrics=['mIoU', 'mDice', 'mFscore'])
    jm, pm = JIoUMetric(**kw), IoUMetric(**kw)
    for names in (None, [f'c{i}' for i in range(n_classes)]):
        jm.class_names = pm.class_names = names
    for _ in range(3):
        pred = rng.integers(0, n_classes - 1, (2, 24, 40))   # one class never predicted
        label = rng.integers(0, n_classes, (2, 24, 40))
        label[rng.random(label.shape) < 0.1] = 255
        label[0, 0, :5] = n_classes + 3               # not ignored, out of range
        jm.process(pred, label, n_classes)
        pm.process(torch.from_numpy(pred), torch.from_numpy(label), n_classes)
    want, got = jm.compute_metrics(), pm.compute_metrics()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9 or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert pm.table() == jm.table()


def test_iou_metric_writes_predictions(tmp_path):
    pm = IoUMetric(output_dir=str(tmp_path / 'out'), format_only=True)
    pred = torch.randint(0, 19, (3, 8, 12), generator=torch.Generator().manual_seed(0))
    pm.process(pred, pred, 19)
    files = sorted(os.listdir(tmp_path / 'out'))
    assert files == [f'pred_{i:06d}.png' for i in range(3)]
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / 'out' / files[2]), cv2.IMREAD_UNCHANGED),
        pred[2].numpy().astype(np.uint8))
    with pytest.raises(RuntimeError, match='no samples'):
        pm.compute_metrics()


@pytest.mark.parametrize('backend', ['pillow', 'cv2'])
@pytest.mark.parametrize('reduce_zero_label', [None, True, False])
def test_load_annotations_matches_jax(tmp_path, backend, reduce_zero_label):
    """Palette, gray and color label PNGs through ``LoadAnnotations`` with
    ``reduce_zero_label`` and a ``label_map``, port against JAX."""
    from lednet_tpu.datasets.transforms import loading as jloading
    from lednet_tpu_torch.datasets.transforms import loading
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 6, (20, 30), dtype=np.uint8)
    pal = rng.integers(0, 256, (6, 3), dtype=np.uint8)
    files = {'pal.png': imageio.encode_png(idx, palette=pal),
             'gray.png': imageio.encode_png(idx),
             'rgb.png': imageio.encode_png(pal[idx])}
    for name, data in files.items():
        path = str(tmp_path / name)
        with open(path, 'wb') as f:
            f.write(data)
        for label_map in (None, {1: 4, 4: 1}):
            item = dict(seg_map_path=path, reduce_zero_label=True,
                        label_map=label_map)
            want = jloading.LoadAnnotations(reduce_zero_label, backend)(
                dict(item, seg_fields=[]))
            got = loading.LoadAnnotations(reduce_zero_label, backend)(
                dict(item, seg_fields=[]))
            assert got['gt_seg_map'].dtype == want['gt_seg_map'].dtype
            np.testing.assert_array_equal(got['gt_seg_map'], want['gt_seg_map'])
            assert got['seg_fields'] == want['seg_fields'] == ['gt_seg_map']
