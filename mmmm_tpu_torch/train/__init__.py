"""Training of the port: the optimizer (``optim.py``), the LoRA training
step (``step.py``), the training loop (``trainer.py``), and the step
checkpoints and ``.npz`` adapter and parameter files (``checkpoint.py``)."""
from .checkpoint import CheckpointManager
from .optim import AdamW, OptimizerConfig, make_optimizer
from .step import (TrainState, effective_params, init_train_state, make_step_fn, make_train_step,
                   place_state)
from .trainer import Trainer, TrainerConfig

__all__ = ["AdamW", "CheckpointManager", "OptimizerConfig", "TrainState", "Trainer",
           "TrainerConfig", "effective_params", "init_train_state", "make_optimizer",
           "make_step_fn", "make_train_step", "place_state"]
