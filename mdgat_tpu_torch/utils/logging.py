"""Scalar logging: tensorboard (when available) + JSONL.

The reference logs two scalars per epoch via tensorboardX
(``Train/val_loss``, ``Train/epoch_loss`` — ``train.py:309-310``); the
same tag names are kept for continuity. JSONL is always written so runs
are inspectable without TF tooling. A copy of ``mdgat_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class ScalarLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(log_dir)
            except ImportError:
                self.tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        self.jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
