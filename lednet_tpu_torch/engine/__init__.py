"""Training and evaluation steps (counterpart of ``lednet_tpu/engine``'s
``optim.py`` and ``state.py``)."""
from lednet_tpu_torch.engine.optim import (OptimWrapper, build_lr_schedule,
                                           build_optimizer, param_multipliers)
from lednet_tpu_torch.engine.state import (EvalStep, TrainState,
                                           create_train_state, float32_math,
                                           make_eval_step, make_train_step,
                                           parse_losses)

__all__ = ['EvalStep', 'OptimWrapper', 'TrainState', 'build_lr_schedule',
           'build_optimizer', 'create_train_state', 'float32_math',
           'make_eval_step', 'make_train_step', 'param_multipliers',
           'parse_losses']
