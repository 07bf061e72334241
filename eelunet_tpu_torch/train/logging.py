"""Metric logging: JSONL always, TensorBoard when it imports (counterpart of
``eelunet_tpu/train/logging.py``).

Reference: TB scalars Loss/train, Loss/val, Metrics/{Dice, Mean IoU, Mean
Dice, Boundary F1} under runs/{name}/{timestamp} (train.py:93-96,
119,135-138,192).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=run_dir)
        except Exception:  # tensorboard is optional
            self._tb = None

    def log(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def log_epoch(self, epoch: int, train_loss: float, val_loss: float,
                  metrics: Dict[str, float]):
        scalars = {"Loss/train": train_loss, "Loss/val": val_loss}
        name_map = {  # reference scalar names (train.py:135-138)
            "dice": "Metrics/Dice",
            "miou": "Metrics/Mean IoU",
            "mdice": "Metrics/Mean Dice",
            "boundary_f1": "Metrics/Boundary F1",
        }
        for k, tb_name in name_map.items():
            if k in metrics:
                scalars[tb_name] = metrics[k]
        self.log(epoch, scalars)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
