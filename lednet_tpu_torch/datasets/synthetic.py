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
                                                CITYSCAPES_PALETTE)


def fake_frame(rng: np.random.Generator, size_hw: Tuple[int, int],
               grid: Tuple[int, int] = (8, 16), ignored: float = 0.02,
               noise: float = 20.0, palette=CITYSCAPES_PALETTE
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(BGR uint8 image, uint8 labels) of ``size_hw``: labels of
    ``len(palette)`` classes (Cityscapes' trainIds by default), about
    ``ignored`` of them at 255."""
    h, w = size_hw
    gh, gw = grid
    cells = rng.integers(0, len(palette), (gh, gw))
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
