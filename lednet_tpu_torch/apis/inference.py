"""High-level inference APIs: ``init_model`` and ``inference_model``.

Counterpart of ``lednet_tpu/apis/inference.py`` (``init_model`` :24,
``inference_model`` :84).  ``init_model`` returns the segmentor itself (an
``nn.Module`` in eval mode on ``device``) with ``cfg``, ``data_preprocessor``
and ``dataset_meta`` attached.  Entry points run on ``'cuda'`` unless the
caller passes ``device='cpu'``; with no GPU they raise.

The test pipeline (``LoadImageFromFile``/``LoadImageFromNDArray`` -> keep-ratio
``Resize`` -> ``PackSegInputs``) runs on numpy.  ``cv2`` is imported only to
read an image file or to resize an image whose size changes; numpy images
already at the pipeline's scale need neither.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import flax_to_state_dict, load_npz_variables
from lednet_tpu_torch.models.layers import init_weights
from lednet_tpu_torch.models.segmentors.encoder_decoder import postprocess_logits
from lednet_tpu_torch.registry import MODELS


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; CUDA without a GPU raises (no silent CPU run)."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           'on the CPU')
    return device


def init_model(config: Union[str, Config], checkpoint: Optional[str] = None,
               device=None, cfg_options: Optional[dict] = None,
               generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Build the segmentor from a config.

    checkpoint: a ``.npz`` of flax variables (converted by
        :mod:`lednet_tpu_torch.convert`) or a file saved with ``torch.save``
        holding a port ``state_dict`` (optionally under ``'state_dict'`` with
        ``'meta'`` beside it).  Without one, weights are initialised from
        ``generator`` (seed 0 when omitted).
    """
    import lednet_tpu_torch.models  # noqa: F401  (registers the modules)
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    if cfg_options:
        cfg.merge_from_dict(cfg_options)
    model = MODELS.build(dict(cfg.model))
    meta: Dict = {}
    if checkpoint is None:
        init_weights(model, generator or torch.Generator().manual_seed(0))
    else:
        if checkpoint.endswith('.npz'):
            state_dict = flax_to_state_dict(*load_npz_variables(checkpoint))
        else:
            state_dict = torch.load(checkpoint, map_location='cpu')
            if 'state_dict' in state_dict:
                meta = state_dict.get('meta', {}).get('dataset_meta', {})
                state_dict = state_dict['state_dict']
        model.load_state_dict(state_dict)
    pre_cfg = cfg.model.get('data_preprocessor') or cfg.get('data_preprocessor')
    model.cfg = cfg
    model.data_preprocessor = MODELS.build(dict(pre_cfg)) if pre_cfg else None
    model.dataset_meta = meta
    return model.to(device).eval()


# ---- test pipeline ----------------------------------------------------------
def _rescale_size(old_size: Tuple[int, int], scale) -> Tuple[int, int]:
    """mmcv ``rescale_size``: (w, h) target for a keep-ratio resize."""
    w, h = old_size
    factor = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


def _load(item: Dict) -> Dict:
    if 'img' not in item:
        import cv2
        img = cv2.imread(item['img_path'], cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(item['img_path'])
        item['img'] = img
    else:
        item['img_path'] = None
    item['img_shape'] = item['ori_shape'] = item['img'].shape[:2]
    return item


def _resize(item: Dict, t: Dict) -> Dict:
    """The test pipeline's ``Resize(scale=..., keep_ratio=True)``."""
    if t.get('scale') is None or not t.get('keep_ratio'):
        raise NotImplementedError(f'test Resize {t} is later work in the port')
    img = item['img']
    h, w = img.shape[:2]
    new_w, new_h = _rescale_size((w, h), t['scale'])
    if (new_w, new_h) != (w, h):
        import cv2
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    item.update(img=img, img_shape=(new_h, new_w),
                scale_factor=(new_w / w, new_h / h))
    return item


_META_KEYS = ('img_path', 'ori_shape', 'img_shape', 'scale_factor')


def _prepare_data(imgs, cfg) -> Tuple[List[Dict], bool]:
    """Run the config's test pipeline minus ``LoadAnnotations``."""
    is_batch = isinstance(imgs, (list, tuple))
    imgs = list(imgs) if is_batch else [imgs]
    steps = [dict(t) for t in cfg.test_dataloader.dataset.pipeline
             if t['type'] != 'LoadAnnotations']
    data = []
    for img in imgs:
        item = dict(img=img) if isinstance(img, np.ndarray) else dict(img_path=img)
        for t in steps:
            if t['type'] in ('LoadImageFromFile', 'LoadImageFromNDArray'):
                item = _load(item)
            elif t['type'] == 'Resize':
                item = _resize(item, t)
            elif t['type'] != 'PackSegInputs':
                raise NotImplementedError(f"test transform {t['type']} is later "
                                          'work in the port')
        data.append(dict(inputs=np.ascontiguousarray(item['img']),
                         metainfo={k: item.get(k) for k in _META_KEYS}))
    return data, is_batch


@torch.inference_mode()
def inference_model(model: torch.nn.Module, img, batch_size: int = 1,
                    impl: Optional[str] = None) -> Union[dict, Sequence[dict]]:
    """Whole-image inference on BGR uint8 numpy images (or file paths);
    returns dict(s) with ``pred_sem_seg`` (H, W) int32, ``seg_logits``
    (H, W, C) float32 and ``metainfo``.  Same-shape inputs run in batches of
    ``batch_size``.  ``impl`` selects the kernels (``'cuda'``) or the plain
    module forms (``'plain'``); ``None`` follows the model's device."""
    data, is_batch = _prepare_data(img, model.cfg)
    device = next(model.parameters()).device
    groups: Dict = {}
    padded = []
    for idx, item in enumerate(data):
        arr = item['inputs']
        pad_h, pad_w = (-arr.shape[0]) % 32, (-arr.shape[1]) % 32
        if pad_h or pad_w:
            arr = np.pad(arr, ((0, pad_h), (0, pad_w), (0, 0)))
        padded.append((arr, pad_h, pad_w))
        groups.setdefault(arr.shape, []).append(idx)

    results: list = [None] * len(data)
    step = max(batch_size, 1)
    for indices in groups.values():
        for c in range(0, len(indices), step):
            chunk = indices[c:c + step]
            inputs = torch.from_numpy(np.stack([padded[i][0] for i in chunk]))
            inputs = inputs.to(device)
            if model.data_preprocessor is not None:
                inputs, _, _ = model.data_preprocessor(inputs, impl=impl)
            else:
                inputs = inputs.float()
            logits = model.predict(inputs, impl)
            for j, i in enumerate(chunk):
                meta = data[i]['metainfo']
                pad_h, pad_w = padded[i][1], padded[i][2]
                extra_h = logits.shape[1] - (inputs.shape[1] - pad_h)
                extra_w = logits.shape[2] - (inputs.shape[2] - pad_w)
                seg_logits, pred = postprocess_logits(
                    logits[j:j + 1], (extra_h, extra_w),
                    ori_shape=tuple(meta['ori_shape']))
                results[i] = dict(pred_sem_seg=pred[0].cpu().numpy(),
                                  seg_logits=seg_logits[0].float().cpu().numpy(),
                                  metainfo=meta)
    return results if is_batch else results[0]
