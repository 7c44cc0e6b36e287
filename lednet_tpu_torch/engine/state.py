"""Train state, the train step and the eval step.

Counterpart of ``lednet_tpu/engine/state.py`` (``TrainState`` :25,
``create_train_state`` :45, ``parse_losses`` :56, ``make_train_step`` :62,
``make_eval_step`` :107).  The JAX package jits both steps.  In the port:

- the train step runs eagerly: forward in train mode (module forms,
  BatchNorm on batch statistics with torch's unbiased running variance, as
  ``lednet_tpu/models/layers.py:95-123`` reproduces), backward, one
  optimizer update.  The model and optimizer are updated in place; the
  state carries them and the step count.
- the eval step on a CUDA model is a CUDA graph of preprocess +
  ``predict`` (or, in slide mode, ``predict_slide``: the crop gather, the
  batched forward and every accumulate) on the kernel path, captured once
  per input (B, H, W, dtype) after one eager warm-up, and replayed; on a
  CPU model it runs eagerly.  A graph bakes in
  the model's weights and the operands folded from them, so the step keys
  its graphs on every parameter's and buffer's ``_version`` and storage and
  captures again after an optimizer step or a ``load_state_dict``, as the
  JAX step, which takes the weights as an argument, never goes stale.  It
  keeps the graphs of the :data:`MAX_GRAPHS` input shapes used last, all
  in one memory pool.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from lednet_tpu_torch.engine.optim import OptimWrapper


@dataclasses.dataclass
class TrainState:
    """The training state: the step count, and the model, optimizer and lr
    schedule that the train step updates in place."""
    step: int
    model: nn.Module
    optimizer: OptimWrapper
    lr_schedule: Callable[[int], float]


def create_train_state(model: nn.Module, optimizer: OptimWrapper,
                       lr_schedule: Callable[[int], float]) -> TrainState:
    """The state at step 0 of an initialised model (``init_model`` or
    ``MODELS.build`` + ``init_weights``) and its optimizer
    (:func:`lednet_tpu_torch.engine.optim.build_optimizer`)."""
    return TrainState(step=0, model=model, optimizer=optimizer,
                      lr_schedule=lr_schedule)


def parse_losses(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """mmengine semantics: the total is the sum of every 'loss'-keyed term."""
    return sum(v for k, v in losses.items() if 'loss' in k.split('.')[-1])


class _LossOf(nn.Module):
    """``model.loss`` as a module's forward, for ``torch.func.functional_call``
    (which calls a module with its parameters swapped for others)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, inputs, labels):
        return self.model.loss(inputs, labels)


def make_train_step(model: nn.Module, optimizer: OptimWrapper,
                    preprocessor=None, amp: bool = False) -> Callable:
    """The train step ``(state, inputs, labels) -> (state, logs)``.

    inputs: (B, H, W, 3) images (raw BGR when ``preprocessor`` is given,
    which then normalizes and pads them and the labels); labels: (B, H, W)
    or a dict with ``gt_seg_map``.  ``logs`` holds the model's losses (as
    detached device tensors), their total ``loss`` and the global norm of
    the raw gradients ``grad_norm``.  The update uses the lr of
    ``state.lr_schedule(state.step)``.

    ``amp=True`` (a config's ``bf16 = True``) computes the loss in
    bfloat16 as the JAX step does (``lednet_tpu/engine/state.py:78-82``):
    every floating parameter and the input are cast to bfloat16 inside the
    loss by an autograd-tracked cast, so that the whole forward runs in
    bfloat16 (BatchNorm normalizes in float32 and casts back, its running
    stats stay float32) and the gradients land on the float32 master
    weights, which the optimizer updates in float32.  No loss scaling:
    bfloat16 has float32's exponent range.  ``torch.autocast`` is not
    used: it picks each op's dtype by its own lists, per device, and ran
    BatchNorm's backward in bfloat16, which took the ``-amp-`` BiSeNetV2
    step far from JAX's (``tests/test_torch_port_bisenetv2_hrnet.py``).
    The caller's TF32 flags apply.
    """
    loss_of = _LossOf(model)

    def step_fn(state: TrainState, inputs, labels) -> Tuple[TrainState, Dict]:
        if not model.training:
            model.train()
        if preprocessor is not None:
            inputs, labels, _ = preprocessor(inputs, labels, training=True)
        if amp:
            low = {f'model.{n}': p.to(torch.bfloat16)
                   for n, p in model.named_parameters()}
            losses = torch.func.functional_call(
                loss_of, low, (inputs.to(torch.bfloat16), labels))
        else:
            losses = model.loss(inputs, labels)
        total = parse_losses(losses)
        optimizer.zero_grad()
        total.backward()
        grad_norm = optimizer.step(state.lr_schedule(state.step))
        logs = {k: v.detach() for k, v in losses.items()}
        logs['loss'] = total.detach()
        logs['grad_norm'] = grad_norm
        return dataclasses.replace(state, step=state.step + 1), logs

    return step_fn


@contextlib.contextmanager
def float32_math():
    """Float32 convs and matmuls in full float32 inside, the caller's flags
    restored after.  torch's defaults let cuDNN run float32 convs in TF32
    (10-bit mantissas); on the flagship that moves the logits by a few 1e-3 of
    their largest value and flips pixels of the argmax."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# the graphs an eval step keeps, one per input shape, least recently used
# dropped first: two frame sizes' test-time views (6 scales each) and val
# shapes.  They share one memory pool: each graph keeps only its output
# there, and the pool's temporaries are those of the largest forward.
MAX_GRAPHS = 16


class EvalStep:
    """``step(inputs) -> logits``: preprocess + ``model.predict`` (mode
    ``'whole'``) or ``model.predict_slide`` (``'slide'``) in eval mode and
    full float32 (:func:`float32_math`), (B, H, W, 3) images in, (B, H, W,
    C) logits out.  See :func:`make_eval_step`."""

    def __init__(self, model: nn.Module, preprocessor=None, mode: str = 'whole'):
        if mode not in ('whole', 'slide'):
            raise ValueError(f'unknown eval mode {mode!r}')
        self.model = model
        self.mode = mode
        self.preprocessor = preprocessor
        self.captures = 0            # graphs captured so far
        self._graphs: Dict[tuple, tuple] = collections.OrderedDict()
        self._weights: Optional[tuple] = None
        self._pool = None            # the memory pool the graphs share

    def __getstate__(self):
        # a copy (``copy.deepcopy`` of the model) or a pickle holds no graph
        return dict(self.__dict__, _graphs=collections.OrderedDict(),
                    _weights=None, _pool=None)

    def weights_key(self) -> tuple:
        """What the graphs depend on: every parameter's and buffer's
        version counter and storage, read from each module's own tables on
        every call (one pass over the modules, about half the host time of
        ``parameters()`` + ``buffers()``)."""
        return tuple((t._version, t.data_ptr()) for m in self.model.modules()
                     for t in (*m._parameters.values(), *m._buffers.values())
                     if t is not None)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """The eager forward that a graph captures."""
        if self.preprocessor is not None:
            inputs, _, _ = self.preprocessor(inputs, None, training=False)
        if self.mode == 'slide':
            return self.model.predict_slide(inputs)
        return self.model.predict(inputs)

    def __call__(self, inputs: torch.Tensor) -> torch.Tensor:
        model = self.model
        training = model.training
        if training:
            model.eval()
        try:
            with float32_math(), torch.no_grad():
                device = next(model.parameters()).device
                if device.type != 'cuda':
                    return self.forward(inputs.to(device))
                return self._replay(inputs, device)
        finally:
            if training:
                model.train()

    def _replay(self, inputs: torch.Tensor, device: torch.device) -> torch.Tensor:
        weights = self.weights_key()
        if weights != self._weights:
            self._graphs.clear()      # they hold operands of older weights
            self._pool = None
            self._weights = weights
        key = (tuple(inputs.shape), inputs.dtype)
        entry = self._graphs.get(key)
        if entry is None:
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.popitem(last=False)    # frees its memory pool
            entry = self._graphs[key] = self._capture(inputs, device)
        self._graphs.move_to_end(key)
        static_in, graph, static_out = entry
        static_in.copy_(inputs)
        graph.replay()
        # the caller keeps results across replays, which overwrite static_out;
        # so may another graph's replay: they share the pool's temporaries
        return static_out.clone()

    def _capture(self, inputs: torch.Tensor, device: torch.device) -> tuple:
        """Warm up eagerly, then capture the forward on a side stream.  The
        warm-up builds the kernel library and the operand caches, sets the
        kernels' shared-memory attributes and lets cuDNN pick its
        algorithms, all outside capture.  The capture is thread-local, so
        other threads may call CUDA meanwhile.  A failed capture raises.

        Every graph of the step allocates from one pool.  That is safe
        because the step replays one graph at a time and copies its output
        out before the next replay: the temporaries of one graph may then
        overwrite another's output, which is rewritten at its own next
        replay.  ``static_in`` lies outside the pool."""
        with torch.inference_mode(False):
            static_in = torch.empty(inputs.shape, dtype=inputs.dtype,
                                    device=device)
        static_in.copy_(inputs)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.forward(static_in)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of other threads (a data loader's pinned
        # allocations and event waits) must not invalidate the capture
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode='thread_local'):
            static_out = self.forward(static_in)
        if self._pool is None:
            self._pool = graph.pool()
        self.captures += 1
        return static_in, graph, static_out


def make_eval_step(model: nn.Module, preprocessor=None,
                   mode: str = 'whole') -> EvalStep:
    """The eval step ``step(inputs) -> logits`` at the (padded) input
    resolution.

    On a CUDA model it replays a CUDA graph of preprocess + ``predict``
    (``mode='slide'``: ``predict_slide``, with the model's ``test_cfg``
    crop and stride) through the kernels, one per input (B, H, W, dtype),
    captured at the first call of each shape after an eager warm-up and
    again whenever a parameter or buffer of the model changed (an
    optimizer step, ``load_state_dict``, ``.to()``); it keeps the graphs
    of the last
    :data:`MAX_GRAPHS` shapes, in one memory pool, and returns a copy of
    the graph's output.  A step replays one graph at a time: do not call
    one step from two threads at once.
    It never runs eagerly in place of a graph: a failed capture raises.  On
    a CPU model (``device='cpu'``) it runs eagerly.  Another ``mode``
    raises ``ValueError``.
    """
    return EvalStep(model, preprocessor, mode)
