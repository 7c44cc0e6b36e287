"""Fabricated dataset trees, for runs without the datasets.

:func:`make_cityscapes_tree`:
``leftImg8bit/{train,val}/<city>/<name>_leftImg8bit.png`` and
``gtFine/{train,val}/<city>/<name>_gtFine_labelTrainIds.png``, written with
the port's PNG encoder.  Each label map is a grid of rectangular blocks of
random trainIds (0-18) with about 2% of pixels at 255 (ignored); each image
is its labels' Cityscapes palette colors plus Gaussian noise, so a model can
learn the map from the image.

:func:`make_branch_tree`: the VOC layout of the Apple Branch config
(``configs/_base_/datasets/apple_branch.py``): ``JPEGImages/<name>.jpg``
photos written with the port's JPEG encoder, ``SegmentationClassPNG/
<name>.png`` palette label maps (0 background, 1 branch) and the
``train.txt`` / ``val.txt`` name lists.  Each frame is a smooth, noisy
green-grey background crossed by thin, branching brown strokes (the branch
class: sparse and a few pixels wide); an optional portrait frame is stored
turned on its side with an EXIF orientation tag, as phone photos are.

:func:`make_ade20k_tree`: the ADEChallengeData2016 layout of the SegNeXt
configs: ``images/{training,validation}/<name>.jpg`` written with the
port's JPEG encoder and ``annotations/{training,validation}/<name>.png``
gray label maps of 0..150 (0 the unlabelled "other", which
``reduce_zero_label`` ignores: drawn like the classes, and about 5% of
the pixels besides), frames in turn at each size of
``sizes_hw``, so that the val images come in shapes of different aspect.
Each label map is a grid of blocks of random labels; each image is its
labels' ADE20K palette colors plus Gaussian noise.

:func:`make_drive_tree`: the layout of the DRIVE config
(``configs/unet/fcn_unet_s5-d16_drive-64x64.py``):
``images/{training,validation}/<n>.png`` fundus-like frames (584x565 by
default, DRIVE's size) and ``annotations/{training,validation}/
<n>_manual1.png`` gray vessel labels, 0 background and 1 vessel.  Each
frame is a reddish disc (the field of view) on black with a bright optic
disc, from which six vessel trees branch out, darker and a few pixels
wide; no label lies outside the disc.

:func:`make_pascal_context_tree`: the VOC2010 layout of the Pascal Context
configs (``configs/_base_/datasets/pascal_context{,_59}.py``):
``JPEGImages/<name>.jpg`` baseline JPEGs written with the port's encoder, in
turn landscape 500x375 and portrait 375x500, ``SegmentationClassContext/
<name>.png`` gray labels 0..59 (0 the background, which the 59-class set
ignores) and the ``ImageSets/SegmentationContext/{train,val}.txt`` lists.
Each label map is a grid of blocks of random labels; each image is its
labels' Pascal Context palette colors plus Gaussian noise.

:func:`make_voc_aug_tree`: the VOC2012 + SBD layout of
``configs/_base_/datasets/pascal_voc12_aug.py``: ``JPEGImages/<name>.png``
(the fork's ``PascalVOCDataset`` reads ``.png``), ``SegmentationClass/
<name>.png`` palette label maps (VOC's color map; indices 0..20, most of
them background, 255 on object borders) for the train and val names,
``SegmentationClassAug/<name>.png`` gray label maps for the aug names,
and the ``ImageSets/Segmentation/{train,aug,val}.txt`` lists.

:func:`make_coco_stuff_tree`: the COCO-Stuff 164k layout of
``configs/_base_/datasets/coco-stuff164k.py``: ``images/{train2017,
val2017}/<12 digits>.jpg`` and ``annotations/{train2017,val2017}/
<12 digits>_labelTrainIds.png`` gray labels 0..170, about 5% at 255.

:func:`make_isaid_tree`, :func:`make_loveda_tree`, :func:`make_isprs_tree`
(Potsdam and Vaihingen): the ``img_dir/{train,val}`` and
``ann_dir/{train,val}`` layout of ``configs/_base_/datasets/{isaid,loveda,
potsdam,vaihingen}.py``, ``.png`` tiles at each set's tile size.  iSAID's
labels (``<tile>_instance_color_RGB.png``) are gray 0..15, as its
converter writes them.  LoveDA's (0..7) and the ISPRS sets' (0..6) use 0
for no data, which ``reduce_zero_label`` ignores.

Each label map is a grid of blocks of random labels; each image is its
labels' palette colors plus Gaussian noise.

Everything follows from ``seed``.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np

from lednet_tpu_torch.datasets import imageio
from lednet_tpu_torch.datasets.metainfo import (ADE20K_PALETTE,
                                                APPLE_BRANCH_PALETTE,
                                                CITYSCAPES_PALETTE,
                                                COCOSTUFF_PALETTE,
                                                ISAID_PALETTE, ISPRS_PALETTE,
                                                LOVEDA_PALETTE,
                                                PASCAL_CONTEXT_PALETTE)


def fake_frame(rng: np.random.Generator, size_hw: Tuple[int, int],
               grid: Tuple[int, int] = (8, 16), ignored: float = 0.02,
               noise: float = 20.0, palette=CITYSCAPES_PALETTE,
               class_p: Optional[Sequence[float]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(BGR uint8 image, uint8 labels) of ``size_hw``: labels of
    ``len(palette)`` classes (Cityscapes' trainIds by default), drawn per
    block uniformly or with the probabilities ``class_p``, about
    ``ignored`` of them at 255."""
    h, w = size_hw
    gh, gw = grid
    cells = (rng.integers(0, len(palette), (gh, gw)) if class_p is None else
             rng.choice(len(palette), (gh, gw), p=class_p))
    rows = np.minimum(np.arange(h) * gh // h, gh - 1)
    cols = np.minimum(np.arange(w) * gw // w, gw - 1)
    labels = cells[rows][:, cols].astype(np.uint8)
    palette_bgr = np.asarray(palette, np.float32)[:, ::-1]
    img = palette_bgr[labels] + rng.normal(0.0, noise, (h, w, 3)).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if ignored:
        labels[rng.random((h, w)) < ignored] = 255
    return img, labels


def make_cityscapes_tree(root: str, n_train: int = 12, n_val: int = 4,
                         size_hw: Tuple[int, int] = (1024, 2048),
                         cities: Sequence[str] = ('aachen', 'bremen'),
                         seed: int = 0, level: int = 1) -> str:
    """Write the tree under ``root`` (frames spread over ``cities`` in
    turn); returns ``root``.  ``level`` is zlib's (1: fast)."""
    rng = np.random.default_rng(seed)
    for split, n in (('train', n_train), ('val', n_val)):
        for i in range(n):
            city = cities[i % len(cities)]
            name = f'{city}_{i:06d}_000019'
            img, labels = fake_frame(rng, size_hw)
            for kind, suffix, arr in (('leftImg8bit', 'leftImg8bit', img),
                                      ('gtFine', 'gtFine_labelTrainIds', labels)):
                d = osp.join(root, kind, split, city)
                os.makedirs(d, exist_ok=True)
                imageio.imwrite(osp.join(d, f'{name}_{suffix}.png'), arr,
                                level=level)
    return root


def _stroke(labels: np.ndarray, p0, p1, radius: float) -> None:
    """Mark the pixels within ``radius`` of the segment p0-p1 ((y, x))."""
    h, w = labels.shape
    r = int(np.ceil(radius))
    y0, y1 = int(max(min(p0[0], p1[0]) - r, 0)), int(min(max(p0[0], p1[0]) + r + 1, h))
    x0, x1 = int(max(min(p0[1], p1[1]) - r, 0)), int(min(max(p0[1], p1[1]) + r + 1, w))
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    d = np.asarray(p1, np.float32) - np.asarray(p0, np.float32)
    t = ((yy - p0[0]) * d[0] + (xx - p0[1]) * d[1]) / max(float(d @ d), 1e-6)
    t = np.clip(t, 0.0, 1.0)
    dist2 = (yy - p0[0] - t * d[0]) ** 2 + (xx - p0[1] - t * d[1]) ** 2
    labels[y0:y1, x0:x1][dist2 <= radius * radius] = 1


def branch_frame(rng: np.random.Generator, size_hw: Tuple[int, int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(BGR uint8 image, uint8 labels: 0 background, 1 branch) of
    ``size_hw``: three strokes from the bottom edge, each splitting in two,
    four times, thinner and shorter at every split, on a smooth background
    with Gaussian noise of std 12."""
    trunks, depth, noise = 3, 4, 12.0
    h, w = size_hw
    labels = np.zeros((h, w), np.uint8)
    scale = min(h, w)
    stack = [((h - 1.0, rng.uniform(0.1, 0.9) * w), -np.pi / 2 +
              rng.uniform(-0.4, 0.4), 0.35 * scale, max(scale / 90.0, 1.5), 0)
             for _ in range(trunks)]
    while stack:
        start, angle, length, radius, level = stack.pop()
        end = (start[0] + length * np.sin(angle), start[1] + length * np.cos(angle))
        _stroke(labels, start, end, radius)
        if level < depth:
            for side in (-1.0, 1.0):
                stack.append((end, angle + side * rng.uniform(0.2, 0.7),
                              length * rng.uniform(0.5, 0.75),
                              max(radius * 0.7, 1.0), level + 1))
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    tone = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
    background = np.empty((h, w, 3), np.float32)
    background[..., 0] = 90 + 40 * yy + 20 * tone[0] * xx      # B
    background[..., 1] = 130 + 30 * xx + 20 * tone[1] * yy     # G
    background[..., 2] = 100 + 30 * yy * xx + 20 * tone[2]     # R
    branch = np.array([40, 70, 110], np.float32) + rng.normal(0, 8, 3)
    img = np.where(labels[..., None] == 1, branch, background)
    img = img + rng.normal(0.0, noise, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), labels


def make_branch_tree(root: str, n_train: int = 8, n_val: int = 4,
                     size_hw: Tuple[int, int] = (1080, 1920),
                     portrait_hw: Optional[Tuple[int, int]] = None,
                     seed: int = 0) -> str:
    """Write the Apple Branch tree under ``root`` (JPEG quality 95, 4:2:0,
    cv2's default); returns ``root``.
    ``portrait_hw`` (upright height, width) adds one frame, listed in both
    splits, whose JPEG holds the frame turned 90 degrees counter-clockwise
    and EXIF orientation 6, so that a reader that applies the tag gets it
    upright, at the size of its label map."""
    rng = np.random.default_rng(seed)
    for sub in ('JPEGImages', 'SegmentationClassPNG'):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    palette = np.asarray(APPLE_BRANCH_PALETTE, np.uint8)

    def write(name, hw, orientation=0):
        img, labels = branch_frame(rng, hw)
        if orientation:
            img = np.ascontiguousarray(np.rot90(img))     # stored on its side
        imageio.imwrite(osp.join(root, 'JPEGImages', name + '.jpg'), img,
                        orientation=orientation)
        with open(osp.join(root, 'SegmentationClassPNG', name + '.png'), 'wb') as f:
            f.write(imageio.encode_png(labels, palette=palette))
        return name

    splits = {'train': [write(f'train_{i:04d}', size_hw) for i in range(n_train)],
              'val': [write(f'val_{i:04d}', size_hw) for i in range(n_val)]}
    if portrait_hw is not None:
        name = write('portrait_0000', portrait_hw, orientation=6)
        for names in splits.values():
            names.append(name)
    for split, names in splits.items():
        with open(osp.join(root, f'{split}.txt'), 'w', encoding='utf-8') as f:
            f.write(''.join(n + '\n' for n in names))
    return root


def make_ade20k_tree(root: str, n_train: int = 8, n_val: int = 4,
                     sizes_hw: Sequence[Tuple[int, int]] = ((480, 640),
                                                            (720, 480)),
                     unlabelled: float = 0.05, seed: int = 0) -> str:
    """Write the ADE20K tree under ``root`` (JPEG quality 95, 4:2:0);
    returns ``root``.  Frame i of each split has size ``sizes_hw[i % n]``;
    label 0 (ignored after ``reduce_zero_label``) is drawn like any of the
    150 classes, with the color gray, and about ``unlabelled`` of the
    pixels are 0 besides, as ADE20K leaves some pixels unlabelled."""
    rng = np.random.default_rng(seed)
    palette = [[128, 128, 128]] + list(ADE20K_PALETTE)
    for split, n in (('training', n_train), ('validation', n_val)):
        for sub in ('images', 'annotations'):
            os.makedirs(osp.join(root, sub, split), exist_ok=True)
        for i in range(n):
            name = f'ADE_{"train" if split == "training" else "val"}_{i:08d}'
            hw = sizes_hw[i % len(sizes_hw)]
            img, labels = fake_frame(rng, hw, grid=(6, 8), ignored=0.0,
                                     palette=palette)
            labels[rng.random(hw) < unlabelled] = 0
            imageio.imwrite(osp.join(root, 'images', split, name + '.jpg'), img)
            imageio.imwrite(osp.join(root, 'annotations', split, name + '.png'),
                            labels)
    return root


def fundus_frame(rng: np.random.Generator, size_hw: Tuple[int, int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(BGR uint8 image, uint8 labels: 0 background, 1 vessel) of
    ``size_hw``: six vessel trees from the optic disc, each splitting in
    two three times, thinner at every split, inside a circular field of
    view, with Gaussian noise of std 8."""
    h, w = size_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx, radius = (h - 1) / 2.0, (w - 1) / 2.0, 0.47 * min(h, w)
    fov = (yy - cy) ** 2 + (xx - cx) ** 2 <= radius * radius
    disc = (cy + rng.uniform(-0.1, 0.1) * h,
            cx + rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 0.3) * w)
    labels = np.zeros((h, w), np.uint8)
    scale = min(h, w)
    stack = [(disc, angle, 0.3 * scale, max(scale / 150.0, 1.5), 0)
             for angle in rng.uniform(0, 2 * np.pi, 6)]
    while stack:
        start, angle, length, width, level = stack.pop()
        end = (start[0] + length * np.sin(angle), start[1] + length * np.cos(angle))
        _stroke(labels, start, end, width)
        if level < 3:
            for side in (-1.0, 1.0):
                stack.append((end, angle + side * rng.uniform(0.3, 0.8),
                              length * rng.uniform(0.5, 0.8),
                              max(width * 0.7, 1.0), level + 1))
    labels[~fov] = 0
    shade = 1.0 - 0.3 * np.hypot(yy - cy, xx - cx) / radius
    img = np.array([40, 80, 170], np.float32) * shade[..., None]
    img[labels == 1] = np.array([30, 45, 110], np.float32) + rng.normal(0, 5, 3)
    bright = (yy - disc[0]) ** 2 + (xx - disc[1]) ** 2 <= (0.07 * scale) ** 2
    img[bright & (labels == 0)] = (150, 200, 240)
    img = img + rng.normal(0.0, 8.0, (h, w, 3)).astype(np.float32)
    img[~fov] = 0
    return np.clip(img, 0, 255).astype(np.uint8), labels


def make_drive_tree(root: str, n_train: int = 4, n_val: int = 2,
                    size_hw: Tuple[int, int] = (584, 565), seed: int = 0) -> str:
    """Write the DRIVE tree under ``root`` (PNG; training frames numbered
    from 21, validation frames from 1, as DRIVE's are); returns ``root``."""
    rng = np.random.default_rng(seed)
    for split, n, first in (('training', n_train, 21), ('validation', n_val, 1)):
        for sub in ('images', 'annotations'):
            os.makedirs(osp.join(root, sub, split), exist_ok=True)
        for i in range(n):
            name = f'{first + i:02d}'
            img, labels = fundus_frame(rng, size_hw)
            imageio.imwrite(osp.join(root, 'images', split, name + '.png'), img)
            imageio.imwrite(osp.join(root, 'annotations', split,
                                     name + '_manual1.png'), labels)
    return root


def make_pascal_context_tree(root: str, n_train: int = 4, n_val: int = 2,
                             sizes_hw: Sequence[Tuple[int, int]] = ((375, 500),
                                                                    (500, 375)),
                             seed: int = 0) -> str:
    """Write the Pascal Context tree under ``root`` (JPEG quality 95, 4:2:0;
    frame i of each split has size ``sizes_hw[i % n]``); returns ``root``."""
    rng = np.random.default_rng(seed)
    for sub in ('JPEGImages', 'SegmentationClassContext',
                'ImageSets/SegmentationContext'):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    for split, n, year in (('train', n_train, 2008), ('val', n_val, 2009)):
        names = []
        for i in range(n):
            name = f'{year}_{i:06d}'
            img, labels = fake_frame(rng, sizes_hw[i % len(sizes_hw)],
                                     grid=(6, 8), ignored=0.0,
                                     palette=PASCAL_CONTEXT_PALETTE)
            imageio.imwrite(osp.join(root, 'JPEGImages', name + '.jpg'), img)
            imageio.imwrite(osp.join(root, 'SegmentationClassContext',
                                     name + '.png'), labels)
            names.append(name)
        with open(osp.join(root, 'ImageSets/SegmentationContext', f'{split}.txt'),
                  'w', encoding='utf-8') as f:
            f.write(''.join(n + '\n' for n in names))
    return root


def _voc_colormap(n: int = 256) -> np.ndarray:
    """VOC's (n, 3) RGB label color map (class 1 is (128, 0, 0), 255 is
    (224, 224, 192)): bit k of a label's three low bits sets bit 7 - k of
    its R, G and B."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c, r, g, b = i, 0, 0, 0
        for k in range(8):
            r |= ((c >> 0) & 1) << (7 - k)
            g |= ((c >> 1) & 1) << (7 - k)
            b |= ((c >> 2) & 1) << (7 - k)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def _borders(labels: np.ndarray) -> np.ndarray:
    """``labels`` with 255 on every pixel whose right or lower neighbour
    has another label (VOC's object outlines)."""
    out = labels.copy()
    out[:, :-1][labels[:, :-1] != labels[:, 1:]] = 255
    out[:-1][labels[:-1] != labels[1:]] = 255
    return out


# VOC's photos are mostly background: a block is class 0 with p 0.6
_VOC_CLASS_P = [0.6] + [0.02] * 20


def make_voc_aug_tree(root: str, n_train: int = 6, n_aug: int = 6,
                      n_val: int = 2,
                      sizes_hw: Sequence[Tuple[int, int]] = ((375, 500),
                                                             (500, 375)),
                      seed: int = 0) -> str:
    """Write the VOC2012 + SBD tree under ``root`` (frame i of each list
    has size ``sizes_hw[i % n]``); returns ``root``."""
    rng = np.random.default_rng(seed)
    cmap = _voc_colormap()
    for sub in ('JPEGImages', 'SegmentationClass', 'SegmentationClassAug',
                'ImageSets/Segmentation'):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    for split, n, year in (('train', n_train, 2007), ('aug', n_aug, 2008),
                           ('val', n_val, 2009)):
        names = []
        for i in range(n):
            name = f'{year}_{i:06d}'
            img, labels = fake_frame(rng, sizes_hw[i % len(sizes_hw)],
                                     grid=(6, 8), ignored=0.0,
                                     palette=cmap[:21].tolist(),
                                     class_p=_VOC_CLASS_P)
            labels = _borders(labels)
            imageio.imwrite(osp.join(root, 'JPEGImages', name + '.png'), img)
            if split == 'aug':
                imageio.imwrite(osp.join(root, 'SegmentationClassAug',
                                         name + '.png'), labels)
            else:
                with open(osp.join(root, 'SegmentationClass', name + '.png'),
                          'wb') as f:
                    f.write(imageio.encode_png(labels, palette=cmap))
            names.append(name)
        with open(osp.join(root, 'ImageSets/Segmentation', f'{split}.txt'),
                  'w', encoding='utf-8') as f:
            f.write(''.join(n + '\n' for n in names))
    return root


def _split_tree(root: str, dirs: Tuple[str, str], splits, size_hw,
                palette, img_suffix: str, seg_suffix: str, name,
                rng: np.random.Generator, zero_ignored: bool = False,
                ignored: float = 0.0) -> str:
    """Write ``<dirs[0]>/<split>/<name><img_suffix>`` images and
    ``<dirs[1]>/<split>/<name><seg_suffix>`` labels for each (split, n) of
    ``splits``; with ``zero_ignored`` label 0 is drawn too (gray) and
    ``palette`` is classes 1..."""
    colors = [[128, 128, 128]] + list(palette) if zero_ignored else list(palette)
    for split, n in splits:
        for sub in dirs:
            os.makedirs(osp.join(root, sub, split), exist_ok=True)
        for i in range(n):
            img, labels = fake_frame(rng, size_hw, grid=(6, 8),
                                     ignored=ignored, palette=colors)
            stem = name(split, i)
            imageio.imwrite(osp.join(root, dirs[0], split, stem + img_suffix),
                            img)
            imageio.imwrite(osp.join(root, dirs[1], split, stem + seg_suffix),
                            labels)
    return root


def make_coco_stuff_tree(root: str, n_train: int = 6, n_val: int = 2,
                         size_hw: Tuple[int, int] = (480, 640),
                         seed: int = 0) -> str:
    """Write the COCO-Stuff 164k tree under ``root`` (JPEG quality 95,
    4:2:0); returns ``root``."""
    return _split_tree(
        root, ('images', 'annotations'),
        (('train2017', n_train), ('val2017', n_val)), size_hw,
        COCOSTUFF_PALETTE, '.jpg', '_labelTrainIds.png',
        lambda split, i: f'{(1 if split == "train2017" else 2) * 10**6 + i:012d}',
        np.random.default_rng(seed), ignored=0.05)


def make_isaid_tree(root: str, n_train: int = 6, n_val: int = 2,
                    size_hw: Tuple[int, int] = (896, 896), seed: int = 0) -> str:
    """Write the iSAID tree of 896x896 patches under ``root``; returns
    ``root``."""
    return _split_tree(
        root, ('img_dir', 'ann_dir'), (('train', n_train), ('val', n_val)),
        size_hw, ISAID_PALETTE, '.png', '_instance_color_RGB.png',
        lambda split, i: f'P{i:04d}_0_896_0_896', np.random.default_rng(seed))


def make_loveda_tree(root: str, n_train: int = 6, n_val: int = 2,
                     size_hw: Tuple[int, int] = (1024, 1024),
                     seed: int = 0) -> str:
    """Write the LoveDA tree of 1024x1024 tiles under ``root``; returns
    ``root``."""
    return _split_tree(
        root, ('img_dir', 'ann_dir'), (('train', n_train), ('val', n_val)),
        size_hw, LOVEDA_PALETTE, '.png', '.png',
        lambda split, i: str((0 if split == 'train' else 2522) + i),
        np.random.default_rng(seed), zero_ignored=True)


def make_isprs_tree(root: str, n_train: int = 6, n_val: int = 2,
                    size_hw: Tuple[int, int] = (512, 512),
                    seed: int = 0) -> str:
    """Write a Potsdam / Vaihingen tree of 512x512 tiles under ``root``;
    returns ``root``."""
    return _split_tree(
        root, ('img_dir', 'ann_dir'), (('train', n_train), ('val', n_val)),
        size_hw, ISPRS_PALETTE, '.png', '.png',
        lambda split, i: f'{2 if split == "train" else 3}_10_{i * 512}_0_'
                         f'{i * 512 + 512}_512',
        np.random.default_rng(seed), zero_ignored=True)
