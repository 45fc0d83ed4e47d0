"""Base training loop (port of ``arflow_tpu/training/trainer.py``).

One device, eager PyTorch: the step (forward, loss, backward, optimizer
update) runs on the model's device, and the loader's NHWC batches, numpy
arrays or tensors, are moved there in the model's dtype. The step's scalars
stay on the device until a print or record boundary, where they are fetched
in one transfer and replayed into the meters and the log; the NaN guard
runs at that flush and names the iteration that went non-finite.

What the JAX trainer does and this one does not yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item, at the point where
it would take effect: the device mesh, ``remat``, ``nan_revert``,
``resume``, the ``stage1`` loss switch and checkpoint writing. Scalar
summaries go to the logger; image summaries are not written.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from arflow_tpu_torch.models import load_pretrained
from arflow_tpu_torch.training.optim import create_optimizer

# cfg.train keys the port's trainer cannot honour yet -> their ROADMAP.md item.
_NOT_PORTED = {
    "remat": "queue 1, 'config switches' (train.remat)",
    "nan_revert": "queue 1, 'config switches' (train.nan_revert)",
    "resume": "queue 1, 'checkpoints'",
    "valid_masks": "queue 1, 'main-path entry points' (KITTI metrics)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md {item}")


class BaseTrainer:
    def __init__(self, train_loader, valid_loader, model, loss_func, _log,
                 save_root, cfg, model_cfg=None, full_cfg=None, mesh=None):
        if mesh is not None:
            raise not_ported("training on a device mesh",
                             "queue 1, 'parallel'")
        for key, item in _NOT_PORTED.items():
            if cfg.get(key):
                raise not_ported(f"train.{key}", item)
        self._log = _log
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.full_cfg = full_cfg
        self.save_root = str(save_root)
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.model = model
        self.loss_func = loss_func

        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.i_epoch = 0
        self.i_iter = 0
        self.optimizer = None  # lazy, from the first batch
        self.generator = None
        self._pending_metrics = []  # (i_iter, i_step, batch size, device row)

    # -- init ---------------------------------------------------------------

    def _ensure_init(self):
        """At the first batch: the weights (the model's own seeded init, or
        ``cfg.pretrained_model``), the optimizer and the dropout generator."""
        if self.optimizer is not None:
            return
        if self.cfg.get("pretrained_model"):
            self._log.info("=> using pre-trained weights %s.",
                           self.cfg.pretrained_model)
            loaded = load_pretrained(self.cfg.pretrained_model,
                                     self.model_cfg, device="cpu")
            self.model.load_state_dict(loaded.state_dict(), strict=True)
        else:
            self._log.info("=> Train from scratch.")
        steps_per_epoch = max(1, min(self.cfg.epoch_size,
                                     len(self.train_loader)))
        self.optimizer = create_optimizer(self.cfg, self.model, steps_per_epoch)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.get("seed", 0) + 7919)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _run_one_epoch(self):
        raise NotImplementedError

    def _validate_with_gt(self):
        raise NotImplementedError

    # -- main loop ------------------------------------------------------------

    def train(self):
        for _ in range(self.i_epoch, self.cfg.epoch_num):
            self._run_one_epoch()
            if self.i_epoch % self.cfg.valid_freq == 0 and self.valid_loader:
                errors, error_names = self._validate_with_gt()
                valid_res = " ".join(
                    "{}: {:.2f}".format(*t) for t in zip(error_names, errors)
                )
                self._log.info(" * Epoch %d %s", self.i_epoch, valid_res)

    # -- helpers --------------------------------------------------------------

    def save_model(self, error, name):
        raise not_ported(f"checkpoint writing ({name}, error {error:.4f})",
                         "queue 1, 'checkpoints'")

    def _begin_epoch(self):
        """Pin the loader's shuffle order to the epoch; refuse a ``stage1``
        loss switch that is due."""
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(self.i_epoch)
        stage1 = (self.full_cfg or {}).get("stage1")
        if stage1 is not None and self.i_epoch >= stage1.epoch:
            raise not_ported("the stage1 loss switch",
                             "queue 1, 'main-path entry points'")

    def _summary(self, tag, value, step):
        self._log.info("summary %s %.6g at %d", tag, value, step)

    def _queue_step_metrics(self, metrics, batch_size, i_step, key_meters,
                            key_meter_names, am_batch_time, am_data_time):
        """Queue a step's device-side metric row; flush at a print or
        record boundary."""
        self._pending_metrics.append((self.i_iter, i_step, batch_size, metrics))
        if (self.i_iter % self.cfg.record_freq == 0
                or self.i_iter % self.cfg.print_freq == 0):
            self._flush_metrics(key_meters, key_meter_names, am_batch_time,
                                am_data_time)

    def _flush_metrics(self, key_meters, key_meter_names, am_batch_time,
                       am_data_time):
        if not self._pending_metrics:
            return
        rows = torch.stack([m for *_, m in self._pending_metrics]).cpu().tolist()
        for (it, step, n, _), row in zip(self._pending_metrics, rows):
            if not np.isfinite(row[0]):
                raise FloatingPointError(
                    f"non-finite training loss ({row[0]}) at iter {it} "
                    f"(epoch {self.i_epoch}, step {step})"
                )
            key_meters.update(row, n)
            if it % self.cfg.record_freq == 0:
                for v, name in zip(key_meters.val, key_meter_names):
                    self._summary("Train_" + name, v, it)
            if it % self.cfg.print_freq == 0:
                self._log.info(
                    "%d:%04d/%04d Time %s Data %s Info %s",
                    self.i_epoch, step, self.cfg.epoch_size,
                    am_batch_time, am_data_time, key_meters,
                )
        self._pending_metrics.clear()


class Timer:
    def __init__(self):
        self.end = time.time()

    def lap(self):
        now = time.time()
        dt = now - self.end
        self.end = now
        return dt
