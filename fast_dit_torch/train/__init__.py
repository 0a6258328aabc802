"""Training: the step (on one process or a mesh of ranks), its optimizer
routes and the trainer CLI (`python -m fast_dit_torch.train`, in `cli.py`)."""

from .mixed_precision import MasterWeightsOptimizer, get_master_params, masterize
from .train_lib import (TrainState, create_train_state, ema_state_dict,
                        make_sharded_train_step, make_train_step, update_ema)

__all__ = ["TrainState", "create_train_state", "update_ema", "make_train_step",
           "make_sharded_train_step",
           "ema_state_dict", "MasterWeightsOptimizer", "masterize", "get_master_params"]
