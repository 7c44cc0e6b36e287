"""A fabricated Cityscapes-layout tree, for runs without the dataset.

``leftImg8bit/{train,val}/<city>/<name>_leftImg8bit.png`` and
``gtFine/{train,val}/<city>/<name>_gtFine_labelTrainIds.png``, written with
the port's PNG encoder.  Each label map is a grid of rectangular blocks of
random trainIds (0-18) with about 2% of pixels at 255 (ignored); each image
is its labels' Cityscapes palette colors plus Gaussian noise, so a model can
learn the map from the image.  Everything follows from ``seed``.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Sequence, Tuple

import numpy as np

from lednet_tpu_torch.datasets import imageio
from lednet_tpu_torch.datasets.metainfo import CITYSCAPES_PALETTE


def fake_frame(rng: np.random.Generator, size_hw: Tuple[int, int],
               grid: Tuple[int, int] = (8, 16), ignored: float = 0.02,
               noise: float = 20.0) -> Tuple[np.ndarray, np.ndarray]:
    """(BGR uint8 image, uint8 trainId labels) of ``size_hw``."""
    h, w = size_hw
    gh, gw = grid
    cells = rng.integers(0, len(CITYSCAPES_PALETTE), (gh, gw))
    rows = np.minimum(np.arange(h) * gh // h, gh - 1)
    cols = np.minimum(np.arange(w) * gw // w, gw - 1)
    labels = cells[rows][:, cols].astype(np.uint8)
    palette_bgr = np.asarray(CITYSCAPES_PALETTE, np.float32)[:, ::-1]
    img = palette_bgr[labels] + rng.normal(0.0, noise, (h, w, 3)).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.uint8)
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
