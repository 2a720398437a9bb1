"""repro_torch.train — optimizer and train-step factories."""
from repro_torch.train.optimizer import OptimizerConfig, adamw_update, init_opt_state
from repro_torch.train.trainstep import init_train_state, make_train_step

__all__ = ["OptimizerConfig", "adamw_update", "init_opt_state",
           "init_train_state", "make_train_step"]
