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
draw from, that of the generator the augmentation on the card draws from
where a config asks for it, and the epoch, iteration and best-error
counters. ``train.resume`` restores all of them, so a resumed run continues
an unbroken one bit for bit where the data is the same (the host
augmentation's draws are not in a checkpoint, in either package).

The JAX trainer's switches:

- ``train.nan_revert``: a step whose loss or any gradient is not finite
  changes nothing: no optimizer update (parameters, Adam moments and the
  schedule's count stay), and the BatchNorm running statistics that its
  forward updated are restored from a copy taken before it. The step
  counts in ``nan_skips``, and the flush warns instead of raising. It costs
  one read of a device flag per step.
- ``train.remat``: the model forward runs in
  ``models.layers.rematerialized()``: each pyramid level, decoder level and
  the refinement is checkpointed with the JAX package's ``dots_saveable``
  policy (convolution outputs kept, the rest recomputed in the backward,
  one region at a time). Level dropout draws outside the regions, so the
  masks are drawn once.
- ``stage1``: at the first epoch >= ``stage1.epoch``, ``stage1.loss``
  updates the loss's config, once; a resume past that epoch applies it too.

The device mesh raises ``NotImplementedError`` naming its ``ROADMAP.md``
item. Summaries go to ``events.jsonl`` in ``save_root`` (and TensorBoard
where it imports), opened at the first one: scalars, also to the logger,
and the validations' images, as PNG files under ``save_root/images``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from arflow_tpu_torch.models import load_pretrained
from arflow_tpu_torch.models.layers import rematerialized
from arflow_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from arflow_tpu_torch.training.optim import create_optimizer
from arflow_tpu_torch.utils.summary import SummaryWriter


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md {item}")


class BaseTrainer:
    def __init__(self, train_loader, valid_loader, model, loss_func, _log,
                 save_root, cfg, model_cfg=None, full_cfg=None, mesh=None):
        if mesh is not None:
            raise not_ported("training on a device mesh",
                             "queue 1, 'parallel'")
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
        self.device_photometric = None  # (sample_params, apply) on the card
        self.aug_generator = None
        self._resume_ckpt = None  # read by train(), applied at the first batch
        self._pending_metrics = []  # (i_iter, i_step, batch size, device row)
        self.nan_skips = 0  # steps reverted by nan_revert
        self._stage1_fired = False

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
        if self.device_photometric is not None:
            self.aug_generator = torch.Generator(device=self.device).manual_seed(
                self.cfg.get("seed", 0) + 104729)
        if self._resume_ckpt is not None:
            self._restore_resume()

    def _restore_resume(self):
        """The weights, the optimizer's state, the schedule's step count
        and the generators' states of the checkpoint that ``train`` read at
        ``cfg.resume``, as ``save_model`` wrote them; then the checkpoint is
        dropped. An augmentation generator that the checkpoint lacks (a run
        without augmentation on the card) keeps its seed."""
        ckpt, self._resume_ckpt = self._resume_ckpt, None
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        self.optimizer.optimizer.load_state_dict(ckpt["optimizer"])
        self.optimizer.count = int(ckpt["opt_count"])
        self.generator.set_state(ckpt["generator"])
        if self.aug_generator is not None and "aug_generator" in ckpt:
            self.aug_generator.set_state(ckpt["aug_generator"])
        self.nan_skips = int(ckpt.get("nan_skips", 0))

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- the step ---------------------------------------------------------------

    def _step(self, forward, loss_of) -> dict:
        """One optimizer step: the model's outputs ``forward(generator)``
        (level dropout drawing from the trainer's generator), the loss terms
        ``loss_of(outputs)`` (a dict with ``'total'``), the backward and the
        update, with ``nan_revert`` and ``remat`` as the module's docstring
        says. Returns the loss terms."""
        revert = bool(self.cfg.get("nan_revert"))
        before = [b.clone() for b in self.model.buffers()] if revert else None
        with (rematerialized() if self.cfg.get("remat")
              else contextlib.nullcontext()):
            res = forward(self.generator)
        out = loss_of(res)
        self.optimizer.zero_grad()
        out["total"].backward()
        if revert and not self._finite(out["total"]):
            with torch.no_grad():
                for b, old in zip(self.model.buffers(), before):
                    b.copy_(old)
            self.optimizer.zero_grad()
            self.nan_skips += 1
        else:
            self.optimizer.step()
        return out

    def _finite(self, total: torch.Tensor) -> bool:
        """Whether ``total`` and every parameter's gradient are finite: one
        read of a device flag."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flags = torch.isfinite(total.detach()).reshape(1)
        if grads:
            norms = torch.stack(torch._foreach_norm(grads, float("inf")))
            flags = torch.cat([flags, torch.isfinite(norms)])
        return bool(flags.all())

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
        if self.aug_generator is not None:
            state["aug_generator"] = self.aug_generator.get_state()
        if self.cfg.get("nan_revert"):  # as the JAX state has it
            state["nan_skips"] = self.nan_skips
        save_checkpoint(self.save_root, state, name, is_best)

    def _begin_epoch(self):
        """Pin the loader's shuffle order to the epoch; apply a due
        ``stage1`` loss switch."""
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(self.i_epoch)
        self._maybe_stage1()

    def _maybe_stage1(self):
        """The scheduled loss-config switch: ``>=`` with a fired flag, as
        the JAX trainer has it, so that a run resumed past the switch epoch
        applies it too."""
        stage1 = (self.full_cfg or {}).get("stage1")
        if (stage1 is not None and not self._stage1_fired
                and self.i_epoch >= stage1.epoch):
            self._stage1_fired = True
            self.loss_func.cfg.update(stage1.loss)
            self._log.info("=> stage1: loss config updated with %s at epoch %d",
                           dict(stage1.loss), self.i_epoch)

    def _writer(self) -> SummaryWriter:
        if self.summary_writer is None:
            self.summary_writer = SummaryWriter(self.save_root)
        return self.summary_writer

    def _summary(self, tag, value, step):
        self._log.info("summary %s %.6g at %d", tag, value, step)
        self._writer().add_scalar(tag, value, step)

    def _images(self, tag, images):
        """(B, H, W, C) images in [0, 1] as ``{tag}/{i}`` at this epoch."""
        self._writer().add_images(tag, np.asarray(images), self.i_epoch)

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
                if self.cfg.get("nan_revert"):
                    # _step did not apply it; the row stays out of the
                    # meters.
                    self._log.warning(
                        "non-finite training loss (%s) at iter %d (epoch %d, "
                        "step %d): update reverted (nan_revert)", row[0], it,
                        self.i_epoch, step)
                    continue
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
