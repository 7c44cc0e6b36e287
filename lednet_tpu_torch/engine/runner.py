"""Runner: config -> components -> the train, val and test loops.

Counterpart of ``lednet_tpu/engine/runner.py`` (``Runner`` :34, ``train``
:56, ``val`` :174, ``test`` :338, ``init_state`` :347, ``load`` :357) on one
GPU (or the CPU, ``device='cpu'``):

- ``train`` builds the train loader and the optimizer, runs
  :func:`lednet_tpu_torch.engine.make_train_step` (eager, module forms)
  with batches copied to the card ahead of use
  (:class:`lednet_tpu_torch.datasets.DevicePrefetcher`), logs every
  ``default_hooks.logger.interval`` steps with one host sync there (none per
  step), checkpoints every ``default_hooks.checkpoint.interval`` and at the
  end, runs ``val`` every ``train_cfg.val_interval``, and on SIGTERM or
  SIGINT saves a checkpoint and returns.  ``resume`` restores the step, the
  weights and the optimizer state (so the lr schedule continues); the
  sampler starts over, as in the JAX package.
- ``val`` pads each image to a multiple of ``eval_pad_multiple`` (128),
  stacks same-shape images into chunks of ``val_batch_size`` (8; the last
  chunk padded with copies of its last image), runs the eval step in the
  model's ``test_cfg.mode``, whole or slide
  (:func:`lednet_tpu_torch.engine.make_eval_step`: one CUDA graph per shape
  on the kernel path, A-D for LED-Net and A for the zoo; a slide crop
  larger than the padded image raises, as in the JAX package),
  crops and resizes the logits to each image's ``ori_shape``
  (``postprocess_logits``) and feeds :class:`IoUMetric`.  A cascade
  (OCRNet, PointRend) predicts with its last head, whose config ``val``
  reads (the JAX package's ``Runner.val`` reads ``decode_head`` as a dict
  and raises on a cascade's list).
  A test-time-augmented sample (the ``tta_pipeline``'s ``TestTimeAug``)
  runs each view alone through the same eval step, padded to the bucket;
  its logits are cropped, un-flipped and resized to the original frame, and
  the views' mean probabilities give the prediction (``merge_tta_probs``).

``val_spatial_shard``, the visualization hook's ``draw=True`` and the
single-logit head (``out_channels=1``) raise ``NotImplementedError``
(ROADMAP: multi-GPU, visualization, single-logit binary head).
"""
from __future__ import annotations

import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from lednet_tpu_torch.apis.inference import resolve_device
from lednet_tpu_torch.config import Config
from lednet_tpu_torch.datasets.loader import DevicePrefetcher, build_dataloader
from lednet_tpu_torch.engine.checkpoint import (find_latest_checkpoint,
                                                load_checkpoint, save_checkpoint)
from lednet_tpu_torch.engine.loggers import ScalarLogger
from lednet_tpu_torch.engine.optim import build_optimizer
from lednet_tpu_torch.engine.state import (TrainState, create_train_state,
                                           make_eval_step, make_train_step)
from lednet_tpu_torch.models.layers import init_weights
from lednet_tpu_torch.models.segmentors.cascade_encoder_decoder import \
    predicting_head_cfg
from lednet_tpu_torch.models.segmentors.encoder_decoder import (
    build_segmentor, postprocess_logits)
from lednet_tpu_torch.models.segmentors.seg_tta import merge_tta_probs
from lednet_tpu_torch.registry import METRICS, MODELS


class Runner:
    def __init__(self, cfg: Config, work_dir: Optional[str] = None,
                 device=None, seed: int = 0):
        """Build the model on ``device`` (``'cuda'`` unless the caller
        passes ``'cpu'``; without a GPU it raises), its weights initialised
        from ``seed``; a model that is not a segmentor (DSNet's) raises
        ``TypeError``."""
        import lednet_tpu_torch.datasets  # noqa: F401  (registers them)
        import lednet_tpu_torch.evaluation  # noqa: F401
        import lednet_tpu_torch.models  # noqa: F401
        self.cfg = cfg
        self.device = resolve_device(device)
        self.work_dir = work_dir or cfg.get('work_dir') or './work_dirs/run'
        os.makedirs(self.work_dir, exist_ok=True)
        self.seed = seed
        model_cfg = dict(cfg.model)
        with torch.device(self.device):   # no host copy of the weights first
            self.model = build_segmentor(model_cfg)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        pre_cfg = model_cfg.get('data_preprocessor') or cfg.get('data_preprocessor')
        self.preprocessor = MODELS.build(dict(pre_cfg)) if pre_cfg else None
        self.test_mode = (model_cfg.get('test_cfg') or {}).get('mode', 'whole')
        # TensorBoard where the config's visualizer names it (the LED
        # configs' default_runtime does) and it imports
        backends = cfg.get('vis_backends') or []
        self.logger = ScalarLogger(self.work_dir, use_tensorboard=any(
            dict(b).get('type') == 'TensorboardVisBackend' for b in backends))
        self.state: Optional[TrainState] = None
        self.dataset_meta: Dict = {}
        self.ckpt_meta: Dict = {}
        self._eval_step = None

    # ------------------------------------------------------------------ train
    def train(self, resume: bool = False) -> TrainState:
        # preemption: SIGTERM/SIGINT save a checkpoint before returning
        preempted = {'flag': False}

        def on_signal(signum, frame):
            preempted['flag'] = True
        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:
                pass  # not the main thread

        try:
            return self._train(resume, preempted)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    def _train(self, resume: bool, preempted: Dict) -> TrainState:
        cfg = self.cfg
        train_cfg = cfg.get('train_cfg', {}) or {}
        max_iters = train_cfg.get('max_iters', 80000)
        val_interval = train_cfg.get('val_interval', 0)
        hooks = cfg.get('default_hooks', {}) or {}
        log_interval = (hooks.get('logger') or {}).get('interval', 50)
        ckpt_interval = (hooks.get('checkpoint') or {}).get('interval', 5000)

        loader = build_dataloader(dict(cfg.train_dataloader), seed=self.seed)
        self.dataset_meta = loader.dataset.metainfo
        if self.state is None:
            self.init_state()
        state = self.state
        if resume:
            latest = find_latest_checkpoint(self.work_dir)
            if latest:
                state, meta = load_checkpoint(latest, state)
                print(f'resumed from {latest} at step {state.step} '
                      f'(iter {meta.get("iter")}), lr '
                      f'{state.lr_schedule(state.step):.6e}', flush=True)
        train_step = make_train_step(self.model, state.optimizer,
                                     self.preprocessor,
                                     amp=bool(cfg.get('bf16', False)))
        depth = int(cfg.get('device_prefetch', 2))
        if self.device.type == 'cuda' and depth > 0:
            data_iter = iter(DevicePrefetcher(loader, self.device, depth))
        else:
            data_iter = iter(loader)
        meta = dict(dataset_meta=self.dataset_meta)

        try:
            t_last, wait, last_step = time.perf_counter(), 0.0, state.step
            for it in range(state.step, max_iters):
                if preempted['flag']:
                    path = save_checkpoint(self.work_dir, state,
                                           meta=dict(meta, preempted=True))
                    print(f'preempted: saved {path}; resume with --resume',
                          flush=True)
                    return state
                t0 = time.perf_counter()
                batch = next(data_iter)
                wait += time.perf_counter() - t0
                inputs, labels = self._batch_to_device(batch)
                state, logs = train_step(state, inputs, labels)
                self.state = state
                step = it + 1
                if step % log_interval == 0 or step == max_iters:
                    names = list(logs)
                    values = torch.stack([logs[k].float() for k in names]).tolist()
                    now = time.perf_counter()
                    n = step - last_step
                    logs = dict(zip(names, values))
                    self.logger.log(step, logs)
                    self.logger.console(step, max_iters, logs,
                                        lr=state.lr_schedule(step),
                                        iter_time=(now - t_last) / n,
                                        data_time=wait / n,
                                        memory_mb=self._peak_memory_mb())
                    t_last, wait, last_step = now, 0.0, step
                t_pause = time.perf_counter()
                if ckpt_interval and step % ckpt_interval == 0:
                    save_checkpoint(self.work_dir, state, meta=meta)
                if val_interval and step % val_interval == 0 and \
                        'val_dataloader' in cfg:
                    metrics = self.val()
                    self.logger.log(step, metrics, prefix='val/')
                    print(f'val @ {step}: {metrics}', flush=True)
                # checkpoints and val stay out of the logged iteration time
                t_last += time.perf_counter() - t_pause
            save_checkpoint(self.work_dir, state, meta=meta)
            return state
        finally:
            data_iter.close()

    def _peak_memory_mb(self) -> Optional[float]:
        if self.device.type != 'cuda':
            return None
        return torch.cuda.max_memory_allocated(self.device) / 2**20

    def _batch_to_device(self, batch):
        inputs = torch.as_tensor(batch['inputs']).to(self.device)
        labels = torch.as_tensor(batch['gt_seg_map']).to(self.device).long()
        if 'gt_edge_map' in batch:
            labels = dict(gt_seg_map=labels, gt_edge_map=torch.as_tensor(
                batch['gt_edge_map']).to(self.device).long())
        return inputs, labels

    # ---------------------------------------------------------------- val/test
    def eval_step(self):
        """The runner's eval step, kept across ``val`` calls so that its
        graphs are captured again only when the weights change."""
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.model, self.preprocessor,
                                             mode=self.test_mode)
        return self._eval_step

    def val(self, loader_key: str = 'val_dataloader',
            evaluator_key: str = 'val_evaluator') -> Dict[str, float]:
        cfg = self.cfg
        if cfg.get('val_spatial_shard'):
            raise NotImplementedError('val_spatial_shard is later work in the '
                                      'port (ROADMAP: multi-GPU)')
        vis = (cfg.get('default_hooks') or {}).get('visualization') or {}
        if vis.get('draw'):
            raise NotImplementedError('the visualization hook (draw=True) is '
                                      'later work in the port (ROADMAP: '
                                      'visualization)')
        if predicting_head_cfg(cfg.model).get('out_channels', 2) == 1:
            raise NotImplementedError('the single-logit binary head is later '
                                      'work in the port (ROADMAP: single-logit '
                                      'binary head)')
        loader = build_dataloader(dict(cfg[loader_key]), seed=self.seed)
        metainfo = loader.dataset.metainfo
        num_classes = len(metainfo.get('classes', [])) or 2
        metric = METRICS.build(dict(cfg.get(evaluator_key) or dict(type='IoUMetric')))
        metric.class_names = metainfo.get('classes')
        eval_step = self.eval_step()
        vb = max(1, int(cfg.get('val_batch_size', 8)))

        def flush(items):
            n = len(items)
            items = items + [items[-1]] * (vb - n)   # one shape per chunk
            xs = np.stack([np.asarray(it['inputs']) for it in items])
            _, pred = self._predict(eval_step, xs, items[0]['metainfo'])
            labels = np.stack([np.asarray(it['gt_seg_map']) for it in items[:n]])
            metric.process(pred[:n], torch.from_numpy(labels).to(pred.device),
                           num_classes)

        pending: Dict[Any, list] = {}
        for batch in loader:
            if 'tta_views' in batch:
                _, pred = self.predict_tta(batch['tta_views'], eval_step)
                metric.process(pred[None], torch.from_numpy(
                    np.asarray(batch['gt_seg_map'])).to(pred.device), num_classes)
                continue
            for i, meta in enumerate(batch['metainfo']):
                item = dict(inputs=batch['inputs'][i],
                            gt_seg_map=batch['gt_seg_map'][i], metainfo=meta)
                key = (tuple(np.shape(item['inputs'])),
                       tuple(meta.get('ori_shape') or ()))
                pending.setdefault(key, []).append(item)
                if len(pending[key]) == vb:
                    flush(pending.pop(key))
        for items in pending.values():
            flush(items)
        results = metric.compute_metrics()
        print(metric.table(), flush=True)
        return results

    def _predict(self, eval_step, xs: np.ndarray, meta: Dict, flip: bool = False,
                 flip_direction: str = 'horizontal'):
        """(B, h, w, 3) images of one shape, padded to a multiple of
        ``eval_pad_multiple``, through ``eval_step``: (logits, prediction)
        cropped, un-flipped and resized to ``meta``'s ``ori_shape``."""
        bucket = int(self.cfg.get('eval_pad_multiple', 128))
        h, w = xs.shape[1:3]
        pad_h, pad_w = (-h) % bucket, (-w) % bucket
        if pad_h or pad_w:
            xs = np.pad(xs, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
        logits = eval_step(torch.from_numpy(xs).to(self.device))
        return postprocess_logits(
            logits, (logits.shape[1] - h, logits.shape[2] - w),
            ori_shape=tuple(meta.get('ori_shape') or ()) or None,
            flip=flip, flip_direction=flip_direction)

    def predict_tta(self, views, eval_step=None):
        """One sample's test-time views (a ``tta_views`` list), each alone
        through ``eval_step`` (the runner's by default; any callable from
        (1, H, W, 3) images to logits): (mean probabilities (H, W, C),
        prediction (H, W)) in the original frame."""
        eval_step = eval_step or self.eval_step()
        view_logits = []
        for view in views:
            meta = view['metainfo']
            logits, _ = self._predict(
                eval_step, np.asarray(view['inputs'])[None], meta,
                flip=bool(meta.get('flip')),
                flip_direction=meta.get('flip_direction') or 'horizontal')
            view_logits.append(logits[0])
        return merge_tta_probs(view_logits)

    def test(self, checkpoint: Optional[str] = None) -> Dict[str, float]:
        if checkpoint:
            self.load(checkpoint)
        if self.state is None:
            raise RuntimeError('no weights: pass a checkpoint')
        key = 'test_dataloader' if 'test_dataloader' in self.cfg else 'val_dataloader'
        ekey = 'test_evaluator' if 'test_evaluator' in self.cfg else 'val_evaluator'
        return self.val(key, ekey)

    # ------------------------------------------------------------------- utils
    def init_state(self) -> TrainState:
        """The optimizer and the train state of the current weights."""
        opt, schedule = build_optimizer(self.model, self.cfg.get('optim_wrapper'),
                                        self.cfg.get('param_scheduler'))
        self.state = create_train_state(self.model, opt, schedule)
        return self.state

    def load(self, checkpoint: str) -> Dict:
        """Load a checkpoint of :func:`save_checkpoint` (weights, optimizer
        state, step); returns its meta."""
        if self.state is None:
            self.init_state()
        self.state, meta = load_checkpoint(checkpoint, self.state)
        self.ckpt_meta = meta
        self.dataset_meta = meta.get('dataset_meta', {})
        return meta
