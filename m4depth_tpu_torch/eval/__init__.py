"""Evaluation protocols (PyTorch)."""

from m4depth_tpu_torch.eval.evaluator import (
    evaluate,
    evaluate_streaming,
    evaluate_windowed,
    metrics_to_validation_perfs,
    write_perfs,
)

__all__ = [
    "evaluate", "evaluate_streaming", "evaluate_windowed",
    "metrics_to_validation_perfs", "write_perfs",
]
