"""Training-event writer (the port's own copy of the scalar part of
``arflow_tpu/utils/summary.py``): an append-only ``events.jsonl`` of
scalars, and a TensorBoard writer beside it when ``tensorboardX`` or
``torch.utils.tensorboard`` imports. Image summaries are not written.
"""

from __future__ import annotations

import importlib
import json
import os
import time


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = str(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "events.jsonl"), "a")
        self._tb = None
        for mod in ("tensorboardX", "torch.utils.tensorboard"):
            try:
                self._tb = importlib.import_module(mod).SummaryWriter(self.log_dir)
                break
            except Exception:
                continue

    def add_scalar(self, tag: str, value, step: int):
        rec = {"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
