from repro_torch.train.optimizer import (
    AdamState,
    adam_update,
    dequantize_blockwise,
    init_adam,
    lr_schedule,
    quantize_blockwise,
    sgd_update,
)
from repro_torch.train.steps import apply_remat, init_train_state, make_eval_step, make_train_step

__all__ = [
    "AdamState",
    "adam_update",
    "apply_remat",
    "dequantize_blockwise",
    "init_adam",
    "init_train_state",
    "lr_schedule",
    "make_eval_step",
    "make_train_step",
    "quantize_blockwise",
    "sgd_update",
]
