"""Training and evaluation steps (PyTorch)."""

from m4depth_tpu_torch.train.step import (
    Batch,
    Optimizer,
    TrainState,
    batch_camera,
    create_train_state,
    data_parallel,
    make_lr_schedule,
    make_optimizer,
    make_streaming_eval_step,
    make_train_step,
    make_windowed_eval_step,
)

__all__ = [
    "Batch", "Optimizer", "TrainState", "batch_camera", "create_train_state",
    "data_parallel", "make_lr_schedule",
    "make_optimizer", "make_streaming_eval_step", "make_train_step",
    "make_windowed_eval_step",
]
