from repro_torch.train.optimizer import AdamState, adam_update, init_adam, lr_schedule
from repro_torch.train.steps import init_train_state, make_train_step

__all__ = ["AdamState", "adam_update", "init_adam", "init_train_state", "lr_schedule", "make_train_step"]
