"""Training and evaluation steps (PyTorch)."""

from m4depth_tpu_torch.train.step import (
    Batch,
    Optimizer,
    TrainState,
    adam_update_,
    batch_camera,
    compile_streaming_eval_step,
    compile_train_step,
    compile_windowed_eval_step,
    create_train_state,
    data_parallel,
    make_lr_schedule,
    make_optimizer,
    make_streaming_eval_step,
    make_train_step,
    make_windowed_eval_step,
)

__all__ = [
    "Batch", "Optimizer", "TrainState", "adam_update_", "batch_camera",
    "compile_streaming_eval_step", "compile_train_step",
    "compile_windowed_eval_step", "create_train_state",
    "data_parallel", "make_lr_schedule",
    "make_optimizer", "make_streaming_eval_step", "make_train_step",
    "make_windowed_eval_step",
]
