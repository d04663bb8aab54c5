"""Scalar and image logging: a JSONL metrics stream, and TensorBoard when
it imports. Counterpart of ``m4depth_tpu/utils/logging.py``.

The JSONL stream has no dependency. TensorBoard goes through
``torch.utils.tensorboard``, which needs the ``tensorboard`` package; where
it does not import, images go to PNG files instead when an image writer
(cv2 or PIL) imports, and are skipped otherwise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: Optional[str], use_tensorboard: bool = True):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    pass
                else:
                    self._tb = SummaryWriter(log_dir)

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    prefix: str = "") -> None:
        record = {"step": step, "time": time.time()}
        record.update({prefix + k: float(v) for k, v in scalars.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(prefix + k, float(v), step)
            self._tb.flush()

    def log_images(self, step: int, images: Dict[str, np.ndarray]) -> None:
        """images: name -> [h, w, c] float array in [0, 1]."""
        if self._tb is not None:
            for k, v in images.items():
                self._tb.add_image(k, np.clip(np.asarray(v), 0, 1), step,
                                   dataformats="HWC")
            self._tb.flush()
        elif self.log_dir:
            from m4depth_tpu_torch.data.decode import imwrite

            img_dir = os.path.join(self.log_dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            for k, v in images.items():
                arr = (np.clip(np.asarray(v), 0, 1) * 255).astype(np.uint8)
                try:
                    imwrite(os.path.join(img_dir, f"{k}_{step:08d}.png"),
                            arr)
                except ImportError:
                    return  # no image writer on this host: JSONL only

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
