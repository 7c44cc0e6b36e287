"""High-level inference APIs: ``init_model`` and ``inference_model``.

Counterpart of ``lednet_tpu/apis/inference.py`` (``init_model`` :24,
``inference_model`` :84, its cached eval step :72).  ``init_model`` returns
the segmentor itself (an ``nn.Module`` in eval mode on ``device``) with
``cfg``, ``data_preprocessor`` and ``dataset_meta`` attached.  Entry points run on ``'cuda'`` unless the
caller passes ``device='cpu'``; with no GPU they raise.

The test pipeline (``LoadImageFromFile``/``LoadImageFromNDArray`` -> keep-ratio
``Resize`` -> ``PackSegInputs``) runs through the port's transforms on numpy:
PNG files decode with the port's own codec and resizes run in its host
library, so neither cv2 nor PIL is imported.  Without a ``dataset_meta`` in
the checkpoint, ``init_model`` takes the classes and palette of the config's
test dataset class, as ``lednet_tpu/apis/inference.py:38-48`` does.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lednet_tpu_torch.config import Config
from lednet_tpu_torch.convert import flax_to_state_dict, load_npz_variables
from lednet_tpu_torch.datasets import Compose
from lednet_tpu_torch.engine.state import EvalStep, float32_math, make_eval_step
from lednet_tpu_torch.models.layers import init_weights
from lednet_tpu_torch.models.segmentors.encoder_decoder import postprocess_logits
from lednet_tpu_torch.registry import DATASETS, MODELS


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
    model.dataset_meta = meta or _config_dataset_meta(cfg)
    return model.to(device).eval()


def _config_dataset_meta(cfg) -> Dict:
    """The classes and palette of the config's test dataset class (without
    reading its files), or {} when the config names none."""
    ds_cfg = (cfg.get('test_dataloader') or {}).get('dataset')
    if not ds_cfg or ds_cfg.get('type') not in DATASETS:
        return {}
    ds_cfg = dict(ds_cfg, lazy_init=True, pipeline=[])
    return DATASETS.build(ds_cfg).metainfo


# ---- test pipeline ----------------------------------------------------------
def _prepare_data(imgs, cfg) -> Tuple[List[Dict], bool]:
    """Run the config's test pipeline minus ``LoadAnnotations`` through the
    port's transforms (its PNG codec and cv2-equivalent resize); arrays
    enter through ``LoadImageFromNDArray``."""
    is_batch = isinstance(imgs, (list, tuple))
    imgs = list(imgs) if is_batch else [imgs]
    steps = [dict(t) for t in cfg.test_dataloader.dataset.pipeline
             if t['type'] != 'LoadAnnotations']
    from_array = Compose([dict(type='LoadImageFromNDArray')] + steps[1:])
    from_file = Compose(steps)
    data = []
    for img in imgs:
        if isinstance(img, np.ndarray):
            item = from_array(dict(img=img, seg_fields=[]))
        else:
            item = from_file(dict(img_path=img, seg_fields=[]))
        data.append(item)
    return data, is_batch


def _cached_eval_step(model: torch.nn.Module) -> EvalStep:
    """One eval step per model, kept on it, so that its graphs are captured
    once per input shape (a fresh step per call would capture every call)."""
    step = model.__dict__.get('_eval_step')
    if step is None:
        step = make_eval_step(model, model.data_preprocessor,
                              mode=model.test_cfg.get('mode', 'whole'))
        model._eval_step = step
    return step


@torch.inference_mode()
def inference_model(model: torch.nn.Module, img, batch_size: int = 1,
                    impl: Optional[str] = None) -> Union[dict, Sequence[dict]]:
    """Whole-image inference on BGR uint8 numpy images (or file paths);
    returns dict(s) with ``pred_sem_seg`` (H, W) int32, ``seg_logits``
    (H, W, C) float32 and ``metainfo``.  Same-shape inputs run in batches of
    ``batch_size``, each through the model's eval step
    (:func:`lednet_tpu_torch.engine.make_eval_step`): on a CUDA model a
    replayed CUDA graph of the kernel path, on a CPU model the eager
    forward.  ``impl='plain'`` runs the plain module forms eagerly instead,
    and ``impl='cuda'`` insists on the kernels.  The model runs in full
    float32 (:func:`lednet_tpu_torch.engine.float32_math`), whatever the
    caller's TF32 flags."""
    with float32_math():
        return _inference(model, img, batch_size, impl)


def _plain_forward(model, inputs):
    if model.data_preprocessor is not None:
        inputs, _, _ = model.data_preprocessor(inputs, impl='plain')
    return model.predict(inputs, 'plain')


def _inference(model, img, batch_size, impl):
    data, is_batch = _prepare_data(img, model.cfg)
    device = next(model.parameters()).device
    if impl == 'cuda' and device.type != 'cuda':
        raise ValueError(f"impl='cuda' needs a CUDA model; it is on {device}")
    if impl not in (None, 'cuda', 'plain'):
        raise ValueError(f"impl must be 'cuda', 'plain' or None, got {impl!r}")
    forward = (functools.partial(_plain_forward, model) if impl == 'plain'
               else _cached_eval_step(model))
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
            x = inputs.to(device)
            logits = forward(x if model.data_preprocessor is not None else x.float())
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
