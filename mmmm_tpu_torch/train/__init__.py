"""Training of the port: the optimizer (``optim.py``) and the LoRA training
step (``step.py``)."""
from .optim import AdamW, OptimizerConfig, make_optimizer
from .step import TrainState, effective_params, init_train_state, make_step_fn, make_train_step

__all__ = ["AdamW", "OptimizerConfig", "TrainState", "effective_params", "init_train_state",
           "make_optimizer", "make_step_fn", "make_train_step"]
