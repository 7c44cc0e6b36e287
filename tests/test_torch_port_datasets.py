"""PyTorch port: the dataset wrappers, the dataset classes and ``Pad`` of
the VOC + SBD aug, COCO-Stuff, iSAID, LoveDA, Potsdam, Vaihingen and
retina configs, against ``lednet_tpu`` on the CPU, on trees fabricated by
``lednet_tpu_torch.datasets.synthetic`` at small sizes.

- Every config these datasets unblock (HRNet-W18/W18-Small/W48 on VOC aug
  at 20k and 40k, iSAID, LoveDA, Potsdam and Vaihingen; BiSeNetV1 R-18,
  R-50 and R-101 on COCO-Stuff 164k, with and without ``in1k-pre``) and
  the four retina base files (``RepeatDataset`` with ``times=40000``)
  build their train, val and test loaders, read unchanged but for their
  data roots, into the datasets the JAX package builds: the same types,
  lengths (``times x n`` for the retina sets), ``metainfo`` and items'
  infos (every index, or, through ``RepeatDataset``, the first and last
  of each repeat's edge and negative ones).
- ``ConcatDataset`` and ``RepeatDataset``: every index and every negative
  index maps to the JAX wrapper's child item; ``IndexError`` past either
  end (the JAX ``RepeatDataset`` takes any index modulo n; the port's
  raises, as a sequence does); ``metainfo`` is the first child's or the
  inner one's; a lazy wrapper reads no file until ``full_init``.
- Items through the configs' train pipelines (``RandomResize`` ->
  ``RandomCrop`` -> ``RandomFlip`` -> ``PhotoMetricDistortion`` [-> ``Pad``]
  -> ``PackSegInputs``): ``prepare(idx, RandomState(s))`` exactly equal to
  JAX's ``dataset[idx]`` after ``np.random.seed(s)``, images, labels and
  metas, over three seeds per index, through the wrappers.
- ``Pad`` exactly as JAX's: to a size that the image already fills (a
  no-op but for ``pad_shape``), to a larger one, to a size divisor, with
  ``pad_val`` as a dict, on two seg fields.
- Each new dataset class: ``METAINFO``, default suffixes and
  ``reduce_zero_label`` (0 -> 255, x -> x - 1, against the raw file) and
  its file listing as the JAX class's.  iSAID's labels under both
  ``LoadAnnotations`` backends, on 1-channel files and on 3-channel color
  files (pillow reads the R plane, cv2 the B plane), as JAX's.
- ``Runner.val`` against the JAX ``Runner.val`` within 0.05 points of aAcc
  and mIoU (aAcc between 1 and 99): HRNet on VOC aug (a 21-class head
  under the 2-class ``PascalVOCDataset`` meta, so labels 2..20 fall out of
  both packages' histograms) and BiSeNetV1 on COCO-Stuff (171 classes),
  each cut to a test width; ``chip_smoke.data_root_options``, the CLIs'
  data roots through the wrappers.

torch runs on one thread in every test here (``one_thread``).
"""
import glob
import os
import os.path as osp

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from lednet_tpu.config import Config as JConfig
from lednet_tpu.datasets import build_dataloader as jbuild_dataloader
from lednet_tpu.datasets import more_datasets as jmore
from lednet_tpu.datasets.transforms import loading as jloading
from lednet_tpu.datasets.transforms import transforms as jtf
from lednet_tpu.engine.state import TrainState as JTrainState
import lednet_tpu_torch.datasets as pds
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import flax_to_state_dict
from lednet_tpu_torch.datasets import build_dataloader, imageio, synthetic
from lednet_tpu_torch.datasets.transforms import loading
from lednet_tpu_torch.datasets.transforms import transforms as tf
from test_torch_port_common import REPO, jax_variables
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_zoo import _small_bisenet, loss_variables

pytestmark = pytest.mark.usefixtures('one_thread')

METRIC_TOL = 0.05          # percentage points, port val against JAX val
BIAS_LIFT = 2.0
LOADERS = ('train_dataloader', 'val_dataloader', 'test_dataloader')
# config name -> (config, the tree it reads)
CONFIGS = {}
for _v in ('hr18', 'hr18s', 'hr48'):
    for _it in ('20k', '40k'):
        CONFIGS[f'{_v}-voc12aug-{_it}'] = (
            f'configs/hrnet/fcn_{_v}_4xb4-{_it}_voc12aug-512x512.py', 'voc')
    CONFIGS[f'{_v}-isaid'] = (f'configs/hrnet/fcn_{_v}_4xb4-80k_isaid-896x896.py',
                              'isaid')
    for _ds in ('loveda', 'potsdam', 'vaihingen'):
        CONFIGS[f'{_v}-{_ds}'] = (
            f'configs/hrnet/fcn_{_v}_4xb4-80k_{_ds}-512x512.py', _ds)
for _r in ('r18', 'r50', 'r101'):
    for _pre in ('', '-in1k-pre'):
        CONFIGS[f'bisenetv1-{_r}{_pre}-coco-stuff164k'] = (
            f'configs/bisenetv1/bisenetv1_{_r}-d32{_pre}_4xb4-160k_'
            'coco-stuff164k-512x512.py', 'coco')
for _ds in ('drive', 'stare', 'chase_db1', 'hrf'):
    CONFIGS[f'base-{_ds}'] = (f'configs/_base_/datasets/{_ds}.py', _ds)
RETINA_SUFFIX = {'drive': '_manual1.png', 'stare': '.ah.png',
                 'chase_db1': '_1stHO.png', 'hrf': '.png'}


@pytest.fixture(scope='module', autouse=True)
def registered():
    import lednet_tpu
    lednet_tpu.register_all_modules()


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """Every fabricated tree, small: kind -> root."""
    base = tmp_path_factory.mktemp('trees')
    out = {
        'voc': synthetic.make_voc_aug_tree(
            str(base / 'voc'), n_train=2, n_aug=3, n_val=2,
            sizes_hw=((60, 80), (80, 60)), seed=80),
        'coco': synthetic.make_coco_stuff_tree(str(base / 'coco'), n_train=2,
                                               n_val=2, size_hw=(48, 64),
                                               seed=81),
        'isaid': synthetic.make_isaid_tree(str(base / 'isaid'), n_train=2,
                                           n_val=2, size_hw=(64, 64), seed=82),
        'isaid_color': _color_labels(synthetic.make_isaid_tree(
            str(base / 'isaid_color'), n_train=2, n_val=1, size_hw=(40, 48),
            seed=83)),
        'loveda': synthetic.make_loveda_tree(str(base / 'loveda'), n_train=2,
                                             n_val=2, size_hw=(64, 64),
                                             seed=84),
    }
    for i, kind in enumerate(('potsdam', 'vaihingen')):
        out[kind] = synthetic.make_isprs_tree(str(base / kind), n_train=2,
                                              n_val=2, size_hw=(48, 48),
                                              seed=85 + i)
    for i, (kind, suffix) in enumerate(sorted(RETINA_SUFFIX.items())):
        out[kind] = synthetic.make_drive_tree(str(base / kind), n_train=2,
                                              n_val=1, size_hw=(40, 36),
                                              seed=87 + i)
        for path in glob.glob(osp.join(out[kind], 'annotations', '*', '*')):
            os.rename(path, path.replace('_manual1.png', suffix))
    return out


def _color_labels(root):
    """The iSAID tree with each label file holding its classes' palette
    colors, as the raw release stores them; returns ``root``."""
    colors = np.asarray(pds.iSAIDDataset.METAINFO['palette'], np.uint8)
    for path in glob.glob(osp.join(root, 'ann_dir', '*', '*')):
        labels = imageio.imread(path, 'unchanged')
        imageio.imwrite(path, colors[:, ::-1][labels])    # BGR, as cv2 writes
    return root


def _loader_cfgs(cls, config, root):
    """The config's three loader configs with their data roots at ``root``."""
    cfg = cls.fromfile(osp.join(REPO, config))
    return {k: dict(cfg[k], dataset=pds.configure_datasets(cfg[k]['dataset'], data_root=root))
            for k in LOADERS}


def _pair(config, root, key='train_dataloader'):
    """(JAX dataset, port dataset) of loader ``key`` of ``config``."""
    jds = jbuild_dataloader(_loader_cfgs(JConfig, config, root)[key]).dataset
    pset = build_dataloader(_loader_cfgs(Config, config, root)[key]).dataset
    return jds, pset


def _infos_equal(jds, pset, indices):
    for i in indices:
        assert pset.get_data_info(i) == jds.get_data_info(i), i


# ------------------------------------------------------------------ runner
# the heaviest tests first: pytest-xdist hands them out in file order
NARROW_HRNET = {
    'model.backbone.extra': dict(
        stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                    num_blocks=(1,), num_channels=(8,)),
        stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                    num_blocks=(1, 1), num_channels=(4, 8)),
        stage3=dict(num_modules=1, num_branches=3, block='BASIC',
                    num_blocks=(1, 1, 1), num_channels=(4, 8, 12)),
        stage4=dict(num_modules=1, num_branches=4, block='BASIC',
                    num_blocks=(1, 1, 1, 1), num_channels=(4, 8, 12, 16))),
    'model.decode_head.in_channels': [4, 8, 12, 16],
    'model.decode_head.channels': 40}


RUNNER_VAL = {
    'voc12aug-hr18': ('configs/hrnet/fcn_hr18_4xb4-20k_voc12aug-512x512.py',
                      'voc', NARROW_HRNET, (80, 64), 21, 2),
    'coco-stuff164k-bisenetv1-r18': (
        'configs/bisenetv1/bisenetv1_r18-d32_4xb4-160k_coco-stuff164k-512x512.py',
        'coco', None, (64, 48), 171, 171),
}


@pytest.mark.parametrize('name', sorted(RUNNER_VAL))
def test_runner_val_matches_jax(name, trees, tmp_path):
    """``Runner.val`` on the tree's two val frames, the test pipeline's
    resize set to the frames' own size (the config's 2048x512 would make
    them 512 rows), the model cut to a test width with the config's head
    classes and the logit of the frames' commonest label lifted by
    BIAS_LIFT: aAcc and mIoU within 0.05 points of the JAX Runner's, over
    the dataset's classes (2 for VOC aug: its labels 2..20 and the head's
    predictions of them fall out of both packages' histograms)."""
    from lednet_tpu.engine.runner import Runner as JRunner
    from lednet_tpu_torch.engine.runner import Runner
    config, kind, narrow, scale, head_classes, classes = RUNNER_VAL[name]
    narrow = narrow or _small_bisenet(osp.join(REPO, config), 171)
    root = trees[kind]
    options = dict(narrow, **{'val_dataloader.num_workers': 2,
                              'val_batch_size': 1, 'vis_backends': None})

    def cfg_of(cls):
        cfg = cls.fromfile(osp.join(REPO, config))
        cfg.merge_from_dict(options)
        for k in LOADERS:
            cfg[k]['dataset'] = pds.configure_datasets(cfg[k]['dataset'], data_root=root)
        cfg.val_dataloader.dataset.pipeline[1]['scale'] = scale
        return cfg
    jrunner = JRunner(cfg_of(JConfig), work_dir=str(tmp_path / 'jax'))
    params, stats = loss_variables(jrunner.model, (1, 64, 64),
                                   n_classes=head_classes, seed=90)
    # random weights seldom pick a labelled class (VOC aug counts 2 of the
    # head's 21): lift the logit of the val frames' commonest label, which
    # then wins about half of the pixels
    val_set = build_dataloader(dict(cfg_of(Config).val_dataloader)).dataset
    counts = sum(np.bincount(val_set[i]['gt_seg_map'].ravel(), minlength=256)
                 for i in range(len(val_set)))
    params['_decode_head']['cls']['conv_seg']['bias'][
        np.argmax(counts[:classes])] += BIAS_LIFT
    variables = jax_variables(params, stats)
    jrunner.state = JTrainState(step=jnp.asarray(0, jnp.int32),
                                params=variables['params'],
                                batch_stats=variables['batch_stats'], opt_state=())
    want = jrunner.val()

    runner = Runner(cfg_of(Config), work_dir=str(tmp_path / 'port'),
                    device='cpu')
    assert runner.model.decode_head.cls.conv_seg.out_channels == head_classes
    runner.model.load_state_dict(flax_to_state_dict(params, stats))
    got = runner.val()
    assert len(val_set.metainfo['classes']) == classes
    assert 1.0 < want['aAcc'] < 99.0 and want['mIoU'] > 0.0
    for key in ('aAcc', 'mIoU'):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


# ------------------------------------------------------------------ items
ITEMS = {'voc12aug': ('hr18-voc12aug-20k', 5), 'coco-stuff164k':
         ('bisenetv1-r50-coco-stuff164k', 2), 'isaid': ('hr18s-isaid', 2),
         'loveda': ('hr18-loveda', 2), 'potsdam': ('hr48-potsdam', 2),
         'vaihingen': ('hr18-vaihingen', 2), 'drive': ('base-drive', 2)}


@pytest.mark.parametrize('name', sorted(ITEMS))
def test_train_items_match_jax(name, trees):
    """Each index of the config's train loader (VOC aug: 2 train + 3 aug
    frames through ``ConcatDataset``; DRIVE: the first repeat and the last
    of ``RepeatDataset``'s 40000) through the config's train pipeline, the
    port given ``RandomState(s)`` and JAX seeded with ``s``, three seeds
    each: images, labels and metas exactly equal."""
    key, n = ITEMS[name]
    config, kind = CONFIGS[key]
    jds, pset = _pair(config, trees[kind])
    indices = list(range(n)) + ([len(pset) - 1] if len(pset) > n else [])
    shapes = set()
    for idx in indices:
        for seed in (idx, 100 + idx, 200 + idx):
            np.random.seed(seed)
            want = jds[idx]
            got = pset.prepare(idx, np.random.RandomState(seed))
            assert set(got) == set(want) == {'inputs', 'gt_seg_map', 'metainfo'}
            for k in ('inputs', 'gt_seg_map'):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got['metainfo'] == want['metainfo']
            shapes.add(got['inputs'].shape)
    if name == 'voc12aug':      # Pad fills every crop to 512x512
        assert shapes == {(512, 512, 3)}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_config_loaders_match_jax(name, trees):
    """The config's train, val and test loaders (data roots only set)
    build the JAX package's datasets: type, length, ``metainfo``, items'
    infos."""
    config, kind = CONFIGS[name]
    for key in LOADERS:
        jds, pset = _pair(config, trees[kind], key)
        assert type(pset).__name__ == type(jds).__name__, key
        assert len(pset) == len(jds) > 0, key
        assert pset.metainfo == jds.metainfo, key
        if type(pset).__name__ == 'RepeatDataset':
            n = len(pset.dataset)
            assert pset.times == 40000 and len(pset) == 40000 * n == 40000 * 2
            assert pset.dataset.data_list == jds.dataset.data_list
            _infos_equal(jds, pset, [0, n - 1, n, len(pset) - 1, -1, -n - 1])
        else:
            _infos_equal(jds, pset, range(-len(pset), len(pset)))
    if kind == 'voc':
        jds, pset = _pair(config, trees[kind])
        assert [len(d) for d in pset.datasets] == [2, 3]
        assert pset.get_data_info(2)['seg_map_path'].endswith(
            'SegmentationClassAug/2008_000000.png')


# ------------------------------------------------------------------ wrappers
def _wrappers(trees):
    """(JAX, port) ``ConcatDataset`` of a Potsdam and a LoVeDA train set
    (different metainfo: the first child's wins) and ``RepeatDataset`` of
    the DRIVE train set, 3 times."""
    potsdam = dict(type='PotsdamDataset', data_root=trees['potsdam'],
                   data_prefix=dict(img_path='img_dir/train',
                                    seg_map_path='ann_dir/train'))
    loveda = dict(potsdam, type='LoveDADataset', data_root=trees['loveda'])
    drive = dict(type='DRIVEDataset', data_root=trees['drive'],
                 data_prefix=dict(img_path='images/training',
                                  seg_map_path='annotations/training'))
    concat = dict(type='ConcatDataset', datasets=[potsdam, loveda, potsdam],
                  ignore_keys=['classes', 'palette'])
    repeat = dict(type='RepeatDataset', dataset=drive, times=3)
    return {name: (_build_jax(c), _build_port(c))
            for name, c in (('concat', concat), ('repeat', repeat))}


def _build_jax(cfg):
    from lednet_tpu.registry import DATASETS
    return DATASETS.build(dict(cfg))


def _build_port(cfg):
    from lednet_tpu_torch.registry import DATASETS
    return DATASETS.build(dict(cfg))


@pytest.mark.parametrize('name', ['concat', 'repeat'])
def test_wrapper_indexing_matches_jax(name, trees):
    """Every index from -len to len-1 lands on the JAX wrapper's item; one
    past either end raises ``IndexError``; ``metainfo`` is the first
    child's (Potsdam's over LoveDA's) or the inner dataset's."""
    jds, pset = _wrappers(trees)[name]
    n = {'concat': 6, 'repeat': 6}[name]
    assert len(pset) == len(jds) == n
    _infos_equal(jds, pset, range(-n, n))
    for idx in (n, -n - 1):
        with pytest.raises(IndexError):
            pset.get_data_info(idx)
        with pytest.raises(IndexError):
            pset.prepare(idx, np.random.RandomState(0))
        if name == 'concat':        # the JAX repeat takes any index mod n
            with pytest.raises(IndexError):
                jds.get_data_info(idx)
    assert pset.metainfo == jds.metainfo
    want = (pds.PotsdamDataset if name == 'concat' else pds.DRIVEDataset).METAINFO
    assert pset.metainfo['classes'] == want['classes']
    if name == 'concat':
        assert pset.get_data_info(2)['seg_map_path'] == \
            pset.datasets[1].get_data_info(0)['seg_map_path']
        assert pset.get_data_info(2)['reduce_zero_label'] is True
    else:
        assert pset.get_data_info(-1) == pset.dataset.get_data_info(1)


def test_lazy_wrapper_reads_no_file(tmp_path):
    """``lazy_init`` reaches the children: a wrapper over a missing split
    list builds, gives its children's metainfo, and raises only at
    ``full_init``."""
    voc = dict(type='PascalVOCDataset', data_root=str(tmp_path),
               data_prefix=dict(img_path='JPEGImages'),
               ann_file='ImageSets/Segmentation/train.txt')
    concat = _build_port(dict(type='ConcatDataset', datasets=[voc, voc],
                              lazy_init=True))
    assert concat.metainfo['classes'] == ('background', 'branch')
    with pytest.raises(FileNotFoundError):
        concat.full_init()
    with pytest.raises(FileNotFoundError):
        _build_port(dict(type='RepeatDataset', dataset=voc, times=2))


def test_configure_datasets_reaches_every_dataset():
    """The test CLI's ``--tta`` swap and a tree's data roots, through
    wrappers; the config given is not changed."""
    tta = [dict(type='LoadImageFromFile')]
    plain = dict(type='CityscapesDataset', pipeline=[])
    cfg = dict(type='RepeatDataset', times=2, dataset=dict(
        type='ConcatDataset', datasets=[plain, dict(plain)]))
    out = pds.configure_datasets(cfg, pipeline=tta, data_root='d')
    assert out['dataset']['datasets'] == [dict(plain, pipeline=tta, data_root='d')] * 2
    assert out['times'] == 2 and 'pipeline' not in out
    assert cfg['dataset']['datasets'][0]['pipeline'] == []
    assert pds.configure_datasets(plain, pipeline=tta) == dict(plain, pipeline=tta)


@pytest.mark.parametrize('name', ['hr18-voc12aug-20k', 'base-hrf', 'hr18s-isaid'])
def test_chip_smoke_data_root_options(name, trees):
    """``chip_smoke.data_root_options``, the CLIs' options of phases
    10-15: merged into the config as the CLIs merge them, every loader
    lists the tree's files, as the config with its roots set does."""
    import chip_smoke
    config, kind = CONFIGS[name]
    options = chip_smoke.data_root_options(Config.fromfile(osp.join(REPO, config)),
                                           trees[kind])
    cfg = Config.fromfile(osp.join(REPO, config))
    cfg.merge_from_dict(dict(kv.split('=', 1) for kv in options))
    want = _loader_cfgs(Config, config, trees[kind])
    for key in LOADERS:
        got = build_dataloader(dict(cfg[key])).dataset
        ref = build_dataloader(want[key]).dataset
        assert len(got) == len(ref) > 0
        _infos_equal(ref, got, range(min(len(got), 8)))


# ------------------------------------------------------------------ Pad
PADS = {'size_filled': (dict(size=(32, 40)), (36, 44)),
        'size_larger': (dict(size=(32, 40)), (20, 27)),
        'size_divisor': (dict(size_divisor=16), (37, 50)),
        'pad_val_dict': (dict(size=(48, 48), pad_val=dict(img=7, seg=9)),
                         (30, 41))}


@pytest.mark.parametrize('name', sorted(PADS))
def test_pad_matches_jax(name):
    """Bottom-right padding, image with ``pad_val``, both seg fields with
    ``seg_pad_val``; ``pad_shape`` and ``img_shape`` the padded size."""
    kw, (h, w) = PADS[name]
    rng = np.random.default_rng(91)
    results = dict(img=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                   gt_seg_map=rng.integers(0, 5, (h, w)).astype(np.uint8),
                   gt_edge_map=rng.integers(0, 2, (h, w)).astype(np.uint8),
                   seg_fields=['gt_seg_map', 'gt_edge_map'], img_shape=(h, w))
    copy = lambda: {k: v.copy() if isinstance(v, np.ndarray) else list(v)  # noqa: E731
                    for k, v in results.items()}
    want = jtf.Pad(**kw)(copy())
    got = tf.Pad(**kw)(copy(), np.random.RandomState(0))
    assert set(got) == set(want)
    for k in ('img', 'gt_seg_map', 'gt_edge_map'):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['pad_shape'] == want['pad_shape'] == got['img_shape'] == \
        want['img_shape'] == got['img'].shape[:2]
    th, tw = got['pad_shape']
    expect = {'size_filled': (36, 44), 'size_larger': (32, 40),
              'size_divisor': (48, 64), 'pad_val_dict': (48, 48)}[name]
    assert (th, tw) == expect
    np.testing.assert_array_equal(got['img'][:h, :w], results['img'])
    img_val, seg_val = (7, 9) if name == 'pad_val_dict' else (0, 255)
    assert (got['img'][h:] == img_val).all() and (got['img'][:, w:] == img_val).all()
    for k in ('gt_seg_map', 'gt_edge_map'):
        assert (got[k][h:] == seg_val).all() and (got[k][:, w:] == seg_val).all()
    with pytest.raises(ValueError):
        tf.Pad()


# ------------------------------------------------------------------ classes
CLASSES = {'COCOStuffDataset': ('coco', 'images/val2017', 'annotations/val2017'),
           'iSAIDDataset': ('isaid', 'img_dir/val', 'ann_dir/val'),
           'LoveDADataset': ('loveda', 'img_dir/val', 'ann_dir/val'),
           'PotsdamDataset': ('potsdam', 'img_dir/val', 'ann_dir/val'),
           'VaihingenDataset': ('vaihingen', 'img_dir/val', 'ann_dir/val'),
           'ISPRSDataset': ('vaihingen', 'img_dir/val', 'ann_dir/val')}


@pytest.mark.parametrize('name', sorted(CLASSES))
def test_dataset_class_matches_jax(name, trees):
    """``METAINFO``, suffixes, ``reduce_zero_label``, the file listing and
    the loaded image and labels (0 -> 255, x -> x - 1 where the class
    reduces, against the raw file), as the JAX class's."""
    kind, img, ann = CLASSES[name]
    kw = dict(data_root=trees[kind],
              data_prefix=dict(img_path=img, seg_map_path=ann),
              pipeline=[dict(type='LoadImageFromFile'),
                        dict(type='LoadAnnotations')])
    pset, jset = getattr(pds, name)(**kw), getattr(jmore, name)(**kw)
    assert pset.METAINFO == jset.METAINFO
    assert (pset.img_suffix, pset.seg_map_suffix, pset.reduce_zero_label) == \
        (jset.img_suffix, jset.seg_map_suffix, jset.reduce_zero_label)
    assert pset.data_list == jset.data_list and len(pset) == 2
    reduces = name not in ('COCOStuffDataset', 'iSAIDDataset')
    assert pset.reduce_zero_label == reduces
    for idx in range(len(pset)):
        got, want = pset[idx], jset[idx]
        np.testing.assert_array_equal(got['img'], want['img'])
        np.testing.assert_array_equal(got['gt_seg_map'], want['gt_seg_map'])
        raw = imageio.imread(got['seg_map_path'], 'unchanged')
        assert raw.ndim == 2
        if reduces:
            assert (raw == 0).any()
            np.testing.assert_array_equal(
                got['gt_seg_map'], np.where(raw == 0, 255, raw.astype(int) - 1))
        else:
            np.testing.assert_array_equal(got['gt_seg_map'], raw)


@pytest.mark.parametrize('backend', ['pillow', 'cv2'])
@pytest.mark.parametrize('tree', ['isaid', 'isaid_color'])
def test_isaid_label_planes_match_jax(tree, backend, trees):
    """iSAID labels through ``LoadAnnotations``: a 1-channel file gives
    its labels under both backends; a 3-channel color file its first plane,
    R under pillow and B under cv2, as the JAX package reads them."""
    paths = sorted(glob.glob(osp.join(trees[tree], 'ann_dir', '*',
                                      '*_instance_color_RGB.png')))
    assert len(paths) == (3 if tree == 'isaid_color' else 4)
    for path in paths:
        results = dict(seg_map_path=path, reduce_zero_label=False,
                       seg_fields=[])
        want = jloading.LoadAnnotations(imdecode_backend=backend)(dict(results))
        got = loading.LoadAnnotations(imdecode_backend=backend)(
            dict(results, seg_fields=[]), None)
        np.testing.assert_array_equal(got['gt_seg_map'], want['gt_seg_map'])
        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if tree == 'isaid':
            assert raw.ndim == 2
            np.testing.assert_array_equal(got['gt_seg_map'], raw)
        else:
            assert raw.ndim == 3 and not (raw[..., 0] == raw[..., 2]).all()
            plane = raw[..., 2] if backend == 'pillow' else raw[..., 0]
            np.testing.assert_array_equal(got['gt_seg_map'], plane)
