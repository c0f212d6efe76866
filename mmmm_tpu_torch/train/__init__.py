"""Training of the port: the optimizer (``optim.py``), the LoRA training
step (``step.py``) and the ``.npz`` adapter and parameter files
(``checkpoint.py``)."""
from .optim import AdamW, OptimizerConfig, make_optimizer
from .step import TrainState, effective_params, init_train_state, make_step_fn, make_train_step

__all__ = ["AdamW", "OptimizerConfig", "TrainState", "effective_params", "init_train_state",
           "make_optimizer", "make_step_fn", "make_train_step"]
