"""Base training loop (port of ``arflow_tpu/training/trainer.py``).

One device, eager PyTorch: the step (forward, loss, backward, optimizer
update) runs on the model's device, and the loader's NHWC batches, numpy
arrays or tensors, are moved there in the model's dtype. The step's scalars
stay on the device until a print or record boundary, where they are fetched
in one transfer and replayed into the meters and the log; the NaN guard
runs at that flush and names the iteration that went non-finite.

Checkpoints are ``.pth.tar`` files (``training/checkpoint.py``): the
model's ``state_dict``, the optimizer's state, the schedule's step count,
the state of the generator that level dropout (and the ELBO loss's noise)
draw from, and the epoch, iteration and best-error counters. ``train.resume`` restores all of them, so a resumed
run continues an unbroken one bit for bit where the data is the same (the
augmentation's draws are not in a checkpoint, in either package).

What the JAX trainer does and this one does not yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item, at the point where
it would take effect: the device mesh, ``remat``, ``nan_revert`` and the
``stage1`` loss switch. Scalar summaries go to the logger and to
``events.jsonl`` in ``save_root`` (and TensorBoard where it imports),
opened at the first scalar; image summaries are not written.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from arflow_tpu_torch.models import load_pretrained
from arflow_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from arflow_tpu_torch.training.optim import create_optimizer
from arflow_tpu_torch.utils.summary import SummaryWriter

# cfg.train keys the port's trainer cannot honour yet -> their ROADMAP.md item.
_NOT_PORTED = {
    "remat": "queue 1, 'config switches' (train.remat)",
    "nan_revert": "queue 1, 'config switches' (train.nan_revert)",
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
        if cfg.get("checkpoint_backend") == "orbax":
            raise ValueError(
                "checkpoint_backend 'orbax' belongs to the JAX package "
                "(arflow_tpu); the port writes .pth.tar")
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
        self.summary_writer = None  # opened at the first scalar
        self.best_error = np.inf
        self.i_epoch = 0
        self.i_iter = 0
        self.optimizer = None  # lazy, from the first batch
        self.generator = None
        self._resume_ckpt = None  # read by train(), applied at the first batch
        self._pending_metrics = []  # (i_iter, i_step, batch size, device row)

    # -- init ---------------------------------------------------------------

    def _ensure_init(self):
        """At the first batch: the weights (the model's own seeded init, or
        ``cfg.pretrained_model``), the optimizer and the dropout generator;
        then, where ``train`` read a ``cfg.resume`` checkpoint, its state
        over all of them."""
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
        if self._resume_ckpt is not None:
            self._restore_resume()

    def _restore_resume(self):
        """The weights, the optimizer's state, the schedule's step count
        and the dropout generator's state of the checkpoint that ``train``
        read at ``cfg.resume``, as ``save_model`` wrote them; then the
        checkpoint is dropped."""
        ckpt, self._resume_ckpt = self._resume_ckpt, None
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        self.optimizer.optimizer.load_state_dict(ckpt["optimizer"])
        self.optimizer.count = int(ckpt["opt_count"])
        self.generator.set_state(ckpt["generator"])

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _run_one_epoch(self):
        raise NotImplementedError

    def _validate_with_gt(self):
        raise NotImplementedError

    def _valid_freq(self) -> int:
        """Validate after every this many epochs: ``valid_freq``, or
        ``val_epoch_size`` where a config names it so (the lowrank,
        mixture, gmm and non-diagonal ELBO configs and both MSE configs;
        the JAX trainer reads only ``valid_freq`` and fails on them)."""
        if "valid_freq" in self.cfg:
            return self.cfg.valid_freq
        return self.cfg.val_epoch_size

    # -- main loop ------------------------------------------------------------

    def train(self):
        # The loop's bounds and the first set_epoch need the counters now;
        # the rest of the state waits for the optimizer (_ensure_init).
        if self.optimizer is None and self.cfg.get("resume"):
            ckpt = load_checkpoint(self.cfg.resume)
            self._log.info("=> resuming from %s (epoch %d, iter %d)",
                           self.cfg.resume, int(ckpt["epoch"]),
                           int(ckpt["i_iter"]))
            self.i_epoch = int(ckpt["epoch"])
            self.i_iter = int(ckpt["i_iter"])
            self.best_error = float(ckpt["best_error"])
            self._resume_ckpt = ckpt
        for _ in range(self.i_epoch, self.cfg.epoch_num):
            self._run_one_epoch()
            if self.i_epoch % self._valid_freq() == 0 and self.valid_loader:
                errors, error_names = self._validate_with_gt()
                valid_res = " ".join(
                    "{}: {:.2f}".format(*t) for t in zip(error_names, errors)
                )
                self._log.info(" * Epoch %d %s", self.i_epoch, valid_res)

    # -- helpers --------------------------------------------------------------

    def save_model(self, error, name):
        """Write ``{name}_ckpt.pth.tar`` in ``save_root``, and copy it to
        ``{name}_model_best.pth.tar`` when ``error`` is the best yet."""
        is_best = error < self.best_error
        if is_best:
            self.best_error = error
        state = {
            "state_dict": {k: v.detach().cpu()
                           for k, v in self.model.state_dict().items()},
            "epoch": self.i_epoch,
            "i_iter": self.i_iter,
            "best_error": float(self.best_error),
            "optimizer": self.optimizer.optimizer.state_dict(),
            "opt_count": self.optimizer.count,
            "generator": self.generator.get_state(),
        }
        save_checkpoint(self.save_root, state, name, is_best)

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
        if self.summary_writer is None:
            self.summary_writer = SummaryWriter(self.save_root)
        self.summary_writer.add_scalar(tag, value, step)

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
