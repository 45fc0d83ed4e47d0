"""Training-event writer (the port's own copy of
``arflow_tpu/utils/summary.py``): an append-only ``events.jsonl`` of
scalars and image records, and a TensorBoard writer beside it when
``tensorboardX`` or ``torch.utils.tensorboard`` imports. Images are saved
as PNG files under ``<log_dir>/images/<tag with / as _>_<step>.png``
(``.npy`` where PIL does not import), each with a row ``{t, tag, image,
step}``.
"""

from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np


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

    def _record(self, rec: dict):
        self._f.write(json.dumps({"t": time.time(), **rec}) + "\n")
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int):
        self._record({"tag": tag, "value": float(value), "step": int(step)})
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_image(self, tag: str, image: np.ndarray, step: int):
        """image: (H, W, C) float in [0, 1] (clipped, then ``* 255`` cast
        to uint8) or uint8."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        path = os.path.join(img_dir, f"{tag.replace('/', '_')}_{step}.png")
        try:
            from PIL import Image

            Image.fromarray(img.squeeze()).save(path)
        except Exception:
            np.save(path + ".npy", img)
        self._record({"tag": tag, "image": path, "step": int(step)})
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def add_images(self, tag: str, images: np.ndarray, step: int):
        """Each of (B, H, W, C) images as ``{tag}/{i}``."""
        for i, img in enumerate(np.asarray(images)):
            self.add_image(f"{tag}/{i}", img, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
